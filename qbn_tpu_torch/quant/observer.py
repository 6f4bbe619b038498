"""Moving-average min/max observers as pure functions over explicit state
(port of qbn_tpu/quant/observer.py).

Observer state is a dict {'min_val', 'max_val'} of float32 0-d tensors,
carried in a model's 'quant' collection as batch norm's running statistics
are carried in 'batch_stats'. The first update adopts the batch extrema
(the state starts at +-inf as a sentinel); later updates move each
extremum by 0.01 of its distance to the batch's. The qparams widen the
range to include zero, floor the scale at float32 eps, and round and clamp
the zero point. Inside a data-parallel forward (ops/collectives.py) the
batch extrema are those of the global batch: an all-reduce over the
ranks' rows before the moving average.
"""

from __future__ import annotations

import numpy as np
import torch

from qbn_tpu_torch.ops.collectives import data_group, global_extrema

AVERAGING_CONSTANT = 0.01
SCALE_EPS = float(np.finfo(np.float32).eps)


def obs_init(device=None):
    """Fresh observer state: sentinel extrema mark 'not yet initialised'."""
    return {"min_val": torch.tensor(float("inf"), device=device),
            "max_val": torch.tensor(float("-inf"), device=device)}


def obs_update(state, x, averaging_constant: float = AVERAGING_CONSTANT):
    """One moving-average min/max update of `state` by the tensor x;
    returns the new state (no gradient flows into it)."""
    x = x.detach().to(torch.float32)
    mn, mx = torch.min(x), torch.max(x)
    group = data_group()
    if group is not None:
        mn, mx = global_extrema(mn, mx, group)
    old_mn, old_mx = state["min_val"], state["max_val"]
    fresh = torch.isinf(old_mn)
    return {"min_val": torch.where(
                fresh, mn, old_mn + averaging_constant * (mn - old_mn)),
            "max_val": torch.where(
                fresh, mx, old_mx + averaging_constant * (mx - old_mx))}


def calculate_qparams(min_val, max_val, qmin: int, qmax: int):
    """Per-tensor affine (scale float32, zero point int32) from observed
    extrema; an uninitialised state (inf sentinels) gives scale 1.0, zero
    point 0."""
    min_val = torch.as_tensor(min_val, dtype=torch.float32)
    max_val = torch.as_tensor(max_val, dtype=torch.float32)
    fresh = torch.isinf(min_val)
    zero = torch.zeros((), device=min_val.device)
    min_val = torch.where(fresh, zero, min_val)
    max_val = torch.where(fresh, zero, max_val)
    min_neg = torch.minimum(min_val, zero)
    max_pos = torch.maximum(max_val, zero)
    # a divisor on the tensor's device: PyTorch divides a CUDA tensor by
    # a host scalar as a multiply by its reciprocal, which is not always
    # the correctly rounded quotient qbn_tpu computes
    levels = torch.tensor(float(qmax - qmin), device=min_val.device)
    scale = (max_pos - min_neg) / levels
    scale = torch.clamp(scale, min=SCALE_EPS)
    scale = torch.where(fresh, torch.ones_like(scale), scale)
    zero_point = qmin - torch.round(min_neg / scale)
    zero_point = torch.clamp(zero_point, qmin, qmax)
    zero_point = torch.where(fresh, zero, zero_point).to(torch.int32)
    return scale, zero_point
