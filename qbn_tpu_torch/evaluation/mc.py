"""Monte-Carlo predictive evaluation of a converted BBB model (port of the
INT merged path of qbn_tpu/evaluation/mc.py).

Per batch: ONE launch of the posterior-draw kernel draws S int8 weight
samples of every stochastic layer (`draw_sampled_weights`), ONE forward
in the merged layout computes every sample (`mc_predict`), and the
probabilities are averaged over samples (`aggregate`) and folded into the
metric state. `evaluate` is the entry point.
"""

from __future__ import annotations

import time
from typing import Iterable, List, Optional, Sequence

import torch

from qbn_tpu_torch.convert import to_device
from qbn_tpu_torch.ops.sample_weights import QPARAM_KEYS, draw_layers, pack_layers
from qbn_tpu_torch.training import metrics as M
from qbn_tpu_torch.utils import resolve_device


def presample_plan(state):
    """Stochastic quantised blocks of a state: [(path, w_lo, w_hi)], path
    the keys of the block's 'q' entry under 'qconst'. None if there are
    none."""
    qconst = state.get("qconst")
    if qconst is None:
        return None
    plan = []

    def walk(node, path):
        if not isinstance(node, dict):
            return
        if "w_codes" in node and "is_stoch" in node:
            if int(node["is_stoch"]) == 1:
                plan.append((path, int(node["w_lo"]), int(node["w_hi"])))
            return
        for k, v in node.items():
            walk(v, path + (k,))

    walk(qconst, ())
    return plan or None


def plan_layers(state, plan):
    """The draw's inputs of each plan entry, in plan order:
    [(w_codes, std_codes, qparams, w_lo, w_hi)]."""
    layers = []
    for (path, w_lo, w_hi) in plan:
        node = state["qconst"]
        for k in path:
            node = node[k]
        layers.append((node["w_codes"], node["std_codes"],
                       {k: node[k] for k in QPARAM_KEYS}, w_lo, w_hi))
    return layers


def draw_sampled_weights(state, plan, samples: int,
                         generator: Optional[torch.Generator] = None,
                         noise: Optional[Sequence[torch.Tensor]] = None):
    """Bulk posterior draw following a presample_plan, in one kernel
    launch on the card. Returns the 'sampled' tree: a 'w' leaf of shape
    (S, *w_codes.shape) int8 beside each block's 'q' entry.

    noise (testing): one (S, *w_codes.shape) float32 tensor per plan
    entry."""
    codes = draw_layers(pack_layers(plan_layers(state, plan), samples),
                        generator, noise)
    return sampled_tree(plan, codes)


def sampled_tree(plan, codes):
    """The 'sampled' collection: each plan entry's codes as a 'w' leaf
    under the block's path (its 'q' key dropped)."""
    out = {}
    for (path, _lo, _hi), c in zip(plan, codes):
        cursor = out
        for k in path[:-1]:
            cursor = cursor.setdefault(k, {})
        cursor["w"] = c
    return out


def mc_predict(model, state, x, *, samples: int, plan=None,
               generator: Optional[torch.Generator] = None,
               presampled=None, up_to: Optional[str] = None):
    """All-samples predictive outputs (S, B, classes): one merged-layout
    forward over weights drawn here (or given as `presampled`)."""
    if presampled is None:
        presampled = draw_sampled_weights(
            state, plan or presample_plan(state), samples, generator)
    out = model(x, {**state, "sampled": presampled}, up_to=up_to)
    if up_to is not None:
        return out
    return out.transpose(0, 1)               # (B, S, C) -> (S, B, C)


def aggregate(outs):
    """Classification predictive: mean of probabilities over samples."""
    return torch.mean(outs, dim=0)


def evaluate(model, state, batches: Iterable, samples: int,
             generator: Optional[torch.Generator] = None, device="cuda"):
    """INT8 MC evaluation over (x, y) batches: x (B, H, W, C) float32
    images, y (B,) labels (numpy or torch).

    Returns (metric_state, [aggregated (B, classes) probabilities per
    batch], [seconds per batch, host clock around work that ends in a
    device synchronise])."""
    device = resolve_device(device)
    state = to_device(state, device)
    plan = presample_plan(state)
    metric_state = M.cls_metrics_init(device=device)
    probs: List[torch.Tensor] = []
    seconds: List[float] = []
    with torch.no_grad():
        for x, y in batches:
            t0 = time.perf_counter()
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            y = torch.as_tensor(y, dtype=torch.int64, device=device)
            outs = mc_predict(model, state, x, samples=samples, plan=plan,
                              generator=generator)
            agg = aggregate(outs)
            metric_state = M.cls_metrics_update(metric_state, agg, y)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            seconds.append(time.perf_counter() - t0)
            probs.append(agg)
    return metric_state, probs, seconds
