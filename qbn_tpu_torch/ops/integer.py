"""Integer inference ops on zero-point-removed int8 codes (port of
qbn_tpu/ops/integer.py).

The convs, `int_conv_merged` (per-sample weights in the merged layout)
and `int_conv` (one set of weights, per-sample or shared activations),
live in `ops/int_conv.py` beside their kernel: on a CUDA tensor they
launch `csrc/int_conv.cu`, on a CPU tensor they run their plain versions.
The dense layers stay here: their integer sums come from matrix products
in a float type that holds them exactly, float32 (TF32 off) while every
partial sum stays below 2^24 (K <= 1040, qbn_tpu's bound) and float64
above it, followed by the float32 requant epilogue in qbn_tpu's order.
"""

from __future__ import annotations

import torch

from qbn_tpu_torch.ops.int_conv import (  # noqa: F401  (the ops' API)
    conv_sum, int_conv, int_conv_merged, requant_out)
from qbn_tpu_torch.utils import full_float32

_F32_EXACT_K = (1 << 24) // (127 * 127)          # 1040


def exact_dtype(k: int) -> torch.dtype:
    """The float type whose matrix-product sums of K products of int8
    codes are exact."""
    return torch.float32 if k <= _F32_EXACT_K else torch.float64


def int_dense_merged(x_codes, x_scale, w_codes, w_scale, w_zp, bias,
                     out_scale, out_zp, a_lo: int, a_hi: int,
                     relu: bool = False, shared_x: bool = False):
    """All-samples quantised dense in the merged layout.

    x_codes: (B, S, F) int8 codes, or (B, F) when shared_x.
    w_codes: (S, F, O) int8 per-sample weight codes.
    Returns (B, S, O) int8 codes.
    """
    s, f, o = w_codes.shape
    dt = exact_dtype(f)
    xs = x_codes.to(dt)
    if shared_x:
        xs = xs.unsqueeze(1).expand(-1, s, -1)
    with full_float32():     # TF32 would round the integer sums
        # (S, B, F) @ (S, F, O) -> (B, S, O)
        acc = torch.bmm(xs.transpose(0, 1), w_codes.to(dt)).transpose(0, 1)
    rowsum = x_codes.to(torch.int64).sum(-1)
    rowsum = rowsum[:, None, None] if shared_x else rowsum[..., None]
    corr = w_zp.to(torch.int64) * rowsum
    if dt == torch.float32:
        acc_f = (acc - corr.to(torch.float32)) * (x_scale * w_scale)
    else:   # qbn_tpu's int32 route: the correction is taken in integers
        acc_f = ((acc.to(torch.int64) - corr).to(torch.float32)
                 * (x_scale * w_scale))
    if bias is None:
        bias = torch.zeros((o,), dtype=torch.float32, device=x_codes.device)
    return requant_out(acc_f, bias, out_scale, out_zp, relu, a_lo, a_hi)


def int_dense(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
              out_zp, a_lo: int, a_hi: int, relu: bool = False):
    """Quantised dense with one set of weights (port of qbn_tpu's int_dense;
    its vmap rules for per-sample x, and for per-member everything, run
    this same function per sample).

    x_codes: (..., F) int8 codes: (B, F), or (S, B, F) per sample.
    w_codes: (F, O) int8 weight codes.
    Returns (..., O) int8 codes.

    qbn_tpu takes the zero-point correction in float32 whatever the depth
    (its w_zp is a float32 scalar): f32(acc) - f32(zw * f32(rowsum))."""
    f = w_codes.shape[0]
    dt = exact_dtype(f)
    f32 = torch.float32
    with full_float32():     # TF32 would round the integer sums
        acc = torch.matmul(x_codes.to(dt), w_codes.to(dt))
    rowsum = x_codes.to(torch.int32).sum(-1, keepdim=True).to(f32)
    acc_f = (acc.to(f32) - w_zp.to(f32) * rowsum) * (x_scale * w_scale)
    return requant_out(acc_f, bias, out_scale, out_zp, relu, a_lo, a_hi)
