"""The seeded int8 posterior draw, written down plainly from its
definition (Bayes-by-backprop at A7/W8, qbn_tpu's quantised draw):

* the 32 random bits of element e of layer l's (S, *shape) block are lane
  e % 4 of Philox-4x32-10 (Salmon et al., SC'11) at counter
  (e // 4, l, offset low, offset high) and key (seed low, seed high);
* the normal is the inverse CDF of the top 23 bits as a uniform in (0, 1]
  through qbn_tpu's polynomial approximation (`_fast_ndtri`), each float32
  multiply and add rounded alone;
* the code is the quantised product and sum: eps_q = clip(round(eps /
  (3/127))), prod = requant(std * eps_q * 3/127) on the mul grid, then
  requant(w + prod) on the add grid, clipped to the weight bounds.

Plain PyTorch on int64 and float32 tensors; it imports nothing of the
program.
"""

from __future__ import annotations

import math

import torch

NOISE_SCALE = 0.02362204724409449        # 3 / 127, the noise code's grid
QPARAM_KEYS = ("w_scale", "w_zp", "std_scale", "std_zp", "mul_scale",
               "mul_zp", "add_scale", "add_zp")

_MASK = 0xFFFFFFFF
_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)
_NDTRI_P = (3.8635427531285984e-07, -2.2181696909391053e-05,
            4.998516805939583e-04, -5.330584717241403e-03,
            1.871923104980722e-02, 3.274856508869327e-01,
            1.253253317085791e+00)
_LN1P_P = (-0.054862281195485675, 0.21640848062706985,
           -0.4640705966769647, 0.995426624186825,
           0.00014158395336088888)
_LN2 = 0.6931471805599453


def _mulhilo(a, m: int):
    """(hi, lo) words of a * m, a uint32 values in int64, m a constant."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int):
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M[0])
        hi1, lo1 = _mulhilo(c2, _M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W[0]) & _MASK, (k1 + _W[1]) & _MASK
    return c0, c1, c2, c3


def random_bits(seed: int, offset: int, layer: int, count: int, device):
    calls = -(-count // 4)
    c = torch.arange(calls, dtype=torch.int64, device=device)
    full = [torch.full_like(c, v) for v in
            (layer & _MASK, offset & _MASK, (offset >> 32) & _MASK)]
    out = philox(c, *full, seed & _MASK, (seed >> 32) & _MASK)
    return torch.stack(out, dim=1).reshape(-1)[:count]


def _c(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def normals(bits):
    """Inverse-CDF normals of random bits (float32)."""
    dev = bits.device
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    u = _c(2.0, dev) - f
    one = _c(1.0, dev)
    t = _c(2.0, dev) * u - one
    v = (one - t) * (one + t)
    vb = v.view(torch.int32)
    e = ((vb >> 23) - 127).to(torch.float32)
    m = ((vb & 0x7FFFFF) | 0x3F800000).view(torch.float32)
    z = m - one
    p = _c(_LN1P_P[0], dev)
    for k in _LN1P_P[1:]:
        p = p * z + _c(k, dev)
    w = torch.minimum(-(e * _c(_LN2, dev) + p), _c(16.0, dev))
    q = _c(_NDTRI_P[0], dev)
    for k in _NDTRI_P[1:]:
        q = q * w + _c(k, dev)
    return t * q


def quantised_sample(w_codes, std_codes, qp, eps, w_lo: int, w_hi: int):
    """(S, *shape) int8 codes of w + std * eps on the add grid; qp the
    layer's eight constants as float32 0-d tensors on eps's device."""
    f32 = torch.float32
    eps_q = torch.clamp(torch.round(eps * _c(1.0 / NOISE_SCALE, eps.device)),
                        -128, 127)
    std_f = (std_codes.to(f32) - qp["std_zp"]) * qp["std_scale"]
    prod = torch.clamp(torch.round(
        std_f * (eps_q * _c(NOISE_SCALE, eps.device))
        * torch.reciprocal(qp["mul_scale"])) + qp["mul_zp"], -128, 127)
    w_f = (w_codes.to(f32) - qp["w_zp"]) * qp["w_scale"]
    prod_f = (prod - qp["mul_zp"]) * qp["mul_scale"]
    ws = torch.clamp(torch.round((w_f + prod_f)
                                 * torch.reciprocal(qp["add_scale"]))
                     + qp["add_zp"], -128, 127)
    return torch.clamp(ws, max(w_lo, -128), min(w_hi, 127)).to(torch.int8)


def stochastic_layers(qconst, path=()):
    """[(path, node)] of every quantised Bayes-by-backprop block of a
    qconst tree, in the tree's order (the draw's layer index)."""
    out = []
    for k, v in qconst.items():
        if not isinstance(v, dict):
            continue
        if "w_codes" in v and "is_stoch" in v:
            if int(v["is_stoch"]) == 1:
                out.append((path + (k,), v))
        else:
            out += stochastic_layers(v, path + (k,))
    return out


def draw(qconst, samples: int, seed: int, offset: int, device):
    """{block path: (S, *shape) int8 codes} of every stochastic block
    (the path of the block, its "q" entry dropped)."""
    out = {}
    for li, (path, node) in enumerate(stochastic_layers(qconst)):
        w = node["w_codes"].to(device)
        shape = (samples,) + tuple(w.shape)
        eps = normals(random_bits(seed, offset, li, math.prod(shape),
                                  device)).reshape(shape)
        qp = {k: torch.as_tensor(node[k]).to(device=device,
                                               dtype=torch.float32)
              for k in QPARAM_KEYS}
        out[path[:-1]] = quantised_sample(w, node["std_codes"].to(device), qp,
                                     eps, int(node["w_lo"]),
                                     int(node["w_hi"]))
    return out
