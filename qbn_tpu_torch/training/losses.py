"""ELBO-style losses (port of qbn_tpu/training/losses.py).

  classification ('whole'):  n_points * NLL(log(p + 1e-8), y) * multiplier
                             + gamma * KL / n_batches
  classification ('batch'):  NLL(log(p + 1e-8), y)
                             + gamma * KL / (batch * n_batches)
  regression ('whole'):      n_points * mean_B sum_D [ (y-mu)^2/(var+1e-8)
                             + log(var + 1e-8) ] * multiplier
                             + gamma * KL / n_batches
  regression ('batch'):      as above without n_points/multiplier and with
                             KL / (batch * n_batches)

Each returns (loss, main_obj, kl_term). `batch` is target.shape[0]
unless given (a data-parallel step's global batch, whose rows a rank
holds only some of).
"""

from __future__ import annotations

import torch


def classification_loss(probs, target, kl, gamma, n_batches, n_points,
                        scaling: str = "batch", loss_multiplier: float = 1.0,
                        batch=None):
    """Negative log likelihood of (B, C) softmax outputs for (B,) integer
    labels + the scaled KL."""
    logp = torch.log(probs + 1e-8)
    nll = -torch.mean(torch.take_along_dim(logp, target[:, None], dim=1))
    if scaling == "whole":
        ce = n_points * nll * loss_multiplier
        kl_term = kl / n_batches
    elif scaling == "batch":
        ce = nll
        kl_term = kl / ((batch or target.shape[0]) * n_batches)
    else:
        raise NotImplementedError("Other scaling not implemented!")
    loss = ce + gamma * kl_term
    return loss, ce, kl_term


def regression_loss(output, target, kl, gamma, n_batches, n_points,
                    scaling: str = "batch", loss_multiplier: float = 1.0,
                    batch=None):
    """Heteroscedastic Gaussian NLL of output = (mean, var), each (B, D),
    + the scaled KL."""
    mean, var = output
    precision = 1.0 / (var + 1e-8)
    point = torch.sum(precision * (target - mean) ** 2
                      + torch.log(var + 1e-8), dim=1)
    het = torch.mean(point, dim=0)
    if scaling == "whole":
        het = n_points * het * loss_multiplier
        kl_term = kl / n_batches
    elif scaling == "batch":
        kl_term = kl / ((batch or target.shape[0]) * n_batches)
    else:
        raise NotImplementedError("Other scaling not implemented!")
    loss = het + gamma * kl_term
    return loss, het, kl_term
