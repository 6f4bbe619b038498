"""Integer inference ops on zero-point-removed int8 codes (port of the
merged-layout half of qbn_tpu/ops/integer.py).

Activations travel as codes u = q - zp (int8), so dequant(u) = u * scale
and conv zero padding is padding with the zero point. Only the weight zero
point zw needs a correction:
    conv:  u * (w - zw) = conv(u, w) - zw * winsum(u)
qbn_tpu picks one of two formulations by contraction depth K, and the
port keeps both, with the same float32 epilogue, so that the int8 codes
are bitwise equal:
  * K <= 520: the weights are centered, (w - zw), and the correction
    vanishes; acc_f = acc * (sx * sw);
  * K > 520: acc and the window sum are taken apart and
    acc_f = (f32(acc) - zw * f32(winsum)) * (sx * sw).
Requantisation then runs in qbn_tpu's order: + bias, / out_scale, round
half to even, + out_zp, clip to 0..255, quantised ReLU (max with out_zp),
the sub-8-bit clip, - out_zp.

The integer sums themselves come from library convolutions and matrix
products, as XLA computed them for qbn_tpu, in a float type that holds
them exactly. Matrix products take float32 (TF32 off) while every partial
sum stays below 2^24 (K <= 1040, qbn_tpu's bound) and float64 above it.
Convolutions always take float64: for some float32 3x3 shapes cuDNN picks
an algorithm (Winograd-like) that is not exact on integers, e.g. the
stage-1 48->48 conv at B=256, S=100 came out 0.125 off on an H100.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qbn_tpu_torch.utils import full_float32

_F32_EXACT_K = (1 << 24) // (127 * 127)          # 1040
_CENTERED_K = (1 << 24) // (254 * 127)           # 520


def exact_dtype(k: int) -> torch.dtype:
    """The float type whose matrix-product sums of K products of int8
    codes are exact."""
    return torch.float32 if k <= _F32_EXACT_K else torch.float64


def conv_sum(x, w, stride, padding: int, groups: int):
    """Exact integer conv sums in NHWC, in float64.

    x: (B, H, W, C) integer-valued codes; w: (O, C/groups, kh, kw)
    integer-valued weights. Returns (B, H', W', O) float64."""
    xn = x.to(torch.float64).permute(0, 3, 1, 2)          # NCHW view
    y = F.conv2d(xn, w.to(torch.float64), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def _requant_out(acc_f, bias, out_scale, out_zp, relu, a_lo, a_hi):
    """Float-requantise an accumulator to zero-point-removed int8 codes.

    out_scale / out_zp are 0-d tensors on the accumulator's device: a CPU
    scalar divisor would make PyTorch multiply by its reciprocal."""
    y = acc_f
    if bias is not None:
        y = y + bias
    zp = out_zp.to(torch.float32)
    q = torch.round(y / out_scale) + zp
    q = torch.clamp(q, 0, 255)
    if relu:
        q = torch.maximum(q, zp)            # quantised ReLU: max(code, zp)
    q = torch.clamp(q, a_lo, a_hi)
    return (q - zp).to(torch.int8)


def _padding(padding) -> int:
    (p0, p1), (p2, p3) = padding
    if not p0 == p1 == p2 == p3:
        raise ValueError(f"only symmetric padding is supported: {padding}")
    return int(p0)


def int_conv_merged(x_codes, x_scale, w_codes, w_scale, w_zp, bias,
                    out_scale, out_zp, strides, padding,
                    a_lo: int, a_hi: int, relu: bool = False,
                    shared_x: bool = False, residual=None,
                    res_scale=None, res_out_scale=None, res_out_zp=None,
                    res_relu: bool = False):
    """All-samples quantised conv in the MERGED channel layout.

    x_codes: (B, H, W, S*cin) int8 codes, sample-major channel groups, or
      (B, H, W, cin) when shared_x (the stem: one image, S weights).
    w_codes: (S, kh, kw, cin, cout) int8 per-sample weight codes.
    strides: (sh, sw); padding: ((p, p), (p, p)).
    residual (optional): (B, H', W', S*cout) int8 codes at scale
      res_scale; the quantised add (dequant both, add, requant to
      res_out_scale/zp, optional ReLU) then follows the conv's requant.
    Returns (B, H', W', S*cout) int8 codes.
    """
    s, kh, kw, cin, cout = w_codes.shape
    k = kh * kw * cin
    groups = 1 if shared_x else s
    pad = _padding(padding)
    f32 = torch.float32
    # (S, kh, kw, cin, cout) -> (S*cout, cin, kh, kw): group g = sample g
    w = w_codes.to(f32).permute(0, 4, 3, 1, 2).reshape(s * cout, cin, kh, kw)
    scale = x_scale * w_scale
    if k <= _CENTERED_K:
        acc = conv_sum(x_codes, w - w_zp.to(f32), strides, pad, groups)
        acc_f = acc.to(f32) * scale
    else:
        acc = conv_sum(x_codes, w, strides, pad, groups)
        n_ws = 1 if shared_x else s
        ones = torch.ones((n_ws, cin, kh, kw), dtype=f32,
                          device=x_codes.device)
        winsum = conv_sum(x_codes, ones, strides, pad, groups)
        b, ho, wo = acc.shape[:3]
        corr = w_zp.to(f32) * winsum.to(f32)                # (B,H',W',n_ws)
        acc_f = (acc.to(f32).reshape(b, ho, wo, s, cout) - corr[..., None]
                 ) * scale
    b, ho, wo = acc_f.shape[:3]
    acc_f = acc_f.reshape(b, ho, wo, s, cout)
    out = _requant_out(acc_f, bias, out_scale, out_zp, relu, a_lo, a_hi)
    if residual is not None:
        res = residual.reshape(b, ho, wo, s, cout)
        y = out.to(f32) * out_scale + res.to(f32) * res_scale
        out = _requant_out(y, None, res_out_scale, res_out_zp, res_relu,
                           a_lo, a_hi)
    return out.reshape(b, ho, wo, s * cout)


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
    return _requant_out(acc_f, bias, out_scale, out_zp, relu, a_lo, a_hi)
