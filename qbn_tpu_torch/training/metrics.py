"""Streaming metrics over explicit state (port of
qbn_tpu/training/metrics.py).

Classification: error, NLL (-sum one_hot*log(p+1e-8) / N), Brier (sum (p-one_hot)^2 / N),
predictive entropy (-sum p*log(p+1e-8) / N), and the 10-bin l1 expected
calibration error binned on max-probability confidence (torchmetrics
CalibrationError(n_bins=10, norm='l1') semantics). Regression: the
Gaussian NLL of the predictive (mean, var), squared and absolute error.
Each is a (sum, count) accumulator updated per batch.
"""

from __future__ import annotations

import math

import torch

ECE_BINS = 10


def cls_metrics_init(n_bins: int = ECE_BINS, device="cpu"):
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {
        "errors": z(),
        "nll_sum": z(),
        "brier_sum": z(),
        "entropy_sum": z(),
        "count": z(),
        "ece_conf": z(n_bins),
        "ece_acc": z(n_bins),
        "ece_count": z(n_bins),
    }


def cls_metrics_update(state, probs, target):
    """Accumulate one batch of (B, C) probabilities and (B,) labels."""
    probs = probs.to(torch.float32)
    target = target.to(probs.device)
    n_bins = state["ece_count"].shape[0]
    preds = torch.argmax(probs, dim=1)
    correct = (preds == target).to(torch.float32)
    one_hot = torch.zeros_like(probs)
    one_hot[torch.arange(probs.shape[0], device=probs.device), target] = 1.0
    logp = torch.log(probs + 1e-8)
    conf = torch.max(probs, dim=1).values
    # bucketize(conf, linspace(0, 1, n+1), right=True) - 1, clamped: a
    # confidence exactly on a float32 boundary lands in the UPPER bin and
    # conf == 1.0 in the top bin
    boundaries = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float32,
                                device=probs.device)
    bin_idx = torch.clamp(
        (conf[:, None] >= boundaries[None, 1:]).sum(dim=1), 0, n_bins - 1)
    # the per-bin sums as a reduction over a one-hot mask, not index_add:
    # on the card index_add adds floats atomically, in no fixed order, and
    # a split's ECE would change from run to run in its last bits
    hits = (bin_idx[:, None] == torch.arange(
        n_bins, device=probs.device)[None, :]).to(torch.float32)
    return {
        "errors": state["errors"] + torch.sum(1.0 - correct),
        "nll_sum": state["nll_sum"] + torch.sum(-one_hot * logp),
        "brier_sum": state["brier_sum"] + torch.sum((probs - one_hot) ** 2),
        "entropy_sum": state["entropy_sum"] + torch.sum(-probs * logp),
        "count": state["count"] + float(target.shape[0]),
        "ece_conf": state["ece_conf"] + torch.sum(hits * conf[:, None], 0),
        "ece_acc": state["ece_acc"] + torch.sum(hits * correct[:, None], 0),
        "ece_count": state["ece_count"] + torch.sum(hits, 0),
    }


def cls_metrics_compute(state):
    count = torch.clamp(state["count"], min=1.0)
    bin_n = state["ece_count"]
    safe_n = torch.clamp(bin_n, min=1.0)
    acc = state["ece_acc"] / safe_n
    conf = state["ece_conf"] / safe_n
    ece = torch.sum(torch.where(bin_n > 0, torch.abs(acc - conf) * bin_n,
                                torch.zeros_like(bin_n)))
    ece = ece / torch.clamp(torch.sum(bin_n), min=1.0)
    return {
        "error": state["errors"] / count,
        "nll": state["nll_sum"] / count,
        "brier": state["brier_sum"] / count,
        "entropy": state["entropy_sum"] / count,
        "ece": ece,
    }


def reg_metrics_init(device="cpu"):
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"nll_sum": z, "se_sum": z, "ae_sum": z, "count": z}


def reg_metrics_update(state, mean, var, target):
    """Accumulate one batch of predictive (mean, var) and targets."""
    mean = mean.reshape(-1).to(torch.float32)
    var = var.reshape(-1).to(torch.float32)
    target = target.reshape(-1).to(torch.float32).to(mean.device)
    err = target - mean
    nll = torch.sum(0.5 * torch.log(2.0 * math.pi * var + 1e-8)
                    + err ** 2 / (2.0 * var + 1e-8))
    return {
        "nll_sum": state["nll_sum"] + nll,
        "se_sum": state["se_sum"] + torch.sum(err ** 2),
        "ae_sum": state["ae_sum"] + torch.sum(torch.abs(err)),
        "count": state["count"] + float(target.shape[0]),
    }


def reg_metrics_compute(state):
    count = torch.clamp(state["count"], min=1.0)
    mse = state["se_sum"] / count
    return {
        "nll": state["nll_sum"] / count,
        "mse": mse,
        "rmse": torch.sqrt(mse),
        "mae": state["ae_sum"] / count,
    }
