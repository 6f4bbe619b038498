"""Per-tensor affine quantisation and fake quantisation with the
straight-through gradient (port of qbn_tpu/quant/fake_quant.py).

`quantize` rounds x / scale and then adds the zero point; `fake_quantize`
rounds x / scale + zp: the two are kept apart, as in qbn_tpu, because they
round differently on a tie. Rounding is half to even (torch.round, as
jnp.round). The straight-through estimator passes a unit gradient where
the UNCLAMPED code lies in [qmin, qmax] and zero elsewhere.
"""

from __future__ import annotations

import torch


def quantize(x, scale, zero_point, qmin: int, qmax: int,
             dtype=torch.int8):
    """Integer codes clamp(round(x / scale) + zp, qmin, qmax)."""
    scale = torch.as_tensor(scale).detach()
    zp = torch.as_tensor(zero_point).detach().to(torch.float32)
    q = torch.round(x.detach() / scale) + zp
    return torch.clamp(q, qmin, qmax).to(dtype)


def dequantize(q, scale, zero_point):
    """Codes back to float: (q - zp) * scale."""
    zp = torch.as_tensor(zero_point).to(torch.float32)
    return (q.to(torch.float32) - zp) * scale


def fake_quantize(x, scale, zero_point, qmin: int, qmax: int):
    """Quantise-dequantise round trip: the value
    (clamp(round(x / scale + zp)) - zp) * scale, computed as qbn_tpu's
    x + stop_gradient(y - x) inside the range; the gradient 1 inside the
    range and 0 outside."""
    scale = torch.as_tensor(scale, dtype=torch.float32).detach()
    zp = torch.as_tensor(zero_point).detach().to(torch.float32)
    q = torch.round(x / scale + zp)
    mask = (q >= qmin) & (q <= qmax)
    y = ((torch.clamp(q, qmin, qmax) - zp) * scale).detach()
    return torch.where(mask, x + (y - x.detach()), y)
