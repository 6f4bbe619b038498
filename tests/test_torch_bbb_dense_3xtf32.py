"""The numerics of csrc/bbb_dense.cu's 3xTF32 products, emulated on the CPU.

The kernel splits each float32 operand a into hi = rna_tf32(a) and
lo = rna_tf32(a - hi) and takes a*b as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b on
the tensor cores (mma.sync m16n8k8: eight exact products added into a
float32 accumulator per instruction), over the wrapper's split of K, the
partials added in split order. The emulation below does the same in torch
and is held to chip_smoke.py's bounds of float64 (copied here): the
float32 dot-product bound gamma_K * sum |a_k b_k| (`dense_bound`) at the
LeNet's shapes, and at those and the regression MLP's shapes the bound
derived for the 3xTF32 products (`dense_bound_3xtf32`), which the kernel
is held to on the card. A helper of these tests; nothing on the main
path uses it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.ops.pallas.bbb_dense import local_reparam_dense_fused

from qbn_tpu_torch.ops import bbb_dense as bd

# (B, K, N): LeNet's fc_0 and fc_1 at the training batch, and a ragged shape
SHAPES = [(256, 2450, 500), (256, 500, 10), (250, 333, 77)]


def rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the float32 bit pattern: round to the nearest
    value with 10 stored mantissa bits, ties away from zero (add half of
    the 13 dropped bits to the magnitude, then clear them)."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = ((bits + 0x1000) & 0xFFFFE000)
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def split(a: torch.Tensor):
    hi = rna_tf32(a)
    return hi, rna_tf32(a - hi)


def mma_3xtf32(a: torch.Tensor, b: torch.Tensor, k_begin: int, k_end: int):
    """sum over k in [k_begin, k_end) of a[:, k] b[k, :] as the kernel takes
    it: per k8 step, the three TF32 products (each exact in float64) added
    into the float32 accumulator one instruction at a time."""
    a_hi, a_lo = (t.double() for t in split(a))
    b_hi, b_lo = (t.double() for t in split(b))
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k0 in range(k_begin, k_end, 8):
        k1 = min(k0 + 8, k_end)
        for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
            part = pa[:, k0:k1] @ pb[k0:k1]
            acc = (acc.double() + part).to(torch.float32)
    return acc


def emulate(x, w, sp, eps, sms=132):
    """The kernel's result, emulated: 3xTF32 products of x and w, and of
    x*x and sp*sp (squared in float32), per split of K, the partials added
    in split order, then mean + sqrt(1e-8 + var) * eps in float32."""
    b, k = x.shape
    n = w.shape[1]
    splits, k_chunk = bd.split_k(b, k, n, sms)
    x2, s2 = x * x, sp * sp
    mean = torch.zeros((b, n), dtype=torch.float32)
    var = torch.zeros((b, n), dtype=torch.float32)
    for s in range(splits):
        k0, k1 = s * k_chunk, min(k, (s + 1) * k_chunk)
        mean = mean + mma_3xtf32(x, w, k0, k1)
        var = var + mma_3xtf32(x2, s2, k0, k1)
    return mean + torch.sqrt(1e-8 + var) * eps


def dense_bound(x, w, sp, eps):
    """chip_smoke.py's bound: gamma_K * sum_k |a_k b_k| on each float32
    dot product, carried through sqrt(1e-8 + var), plus 4 ulps of the
    result. Returns (float64 reference, bound)."""
    x64, w64, s64, e64 = (t.double() for t in (x, w, sp, eps))
    k = x.shape[1]
    u = 2.0 ** -24
    gamma = k * u / (1 - k * u)
    var = (x64 * x64) @ (s64 * s64)
    std = torch.sqrt(1e-8 + var)
    ref = x64 @ w64 + std * e64
    bound = (gamma * (x64.abs() @ w64.abs()) + gamma * var / (2 * std)
             * e64.abs() + 4 * u * ref.abs())
    return ref, bound


def dense_bound_3xtf32(x, w, sp, eps, splits, k_chunk):
    """chip_smoke.py's bound of the 3xTF32 kernel (derived there): 3.001 *
    2^-22 of |a b| per product missed by the split, gamma_M of the
    magnitudes for M = 3 ceil(min(K, k_chunk) / 8) roundings of 2^-22 per
    mma.sync plus one per split, 2 u more on the variance's float32
    squares, and the epilogue's roundings. Returns (float64 reference,
    bound)."""
    x64, w64, s64, e64 = (t.double() for t in (x, w, sp, eps))
    k = x.shape[1]
    u = 2.0 ** -24
    m = 3 * math.ceil(min(k, k_chunk) / 8) + (splits if splits > 1 else 0)
    gamma = m * 2.0 ** -22 / (1 - m * 2.0 ** -22)
    c = 3.001 * 2.0 ** -22 + gamma * (1 + 2.0 ** -9)
    var = (x64 * x64) @ (s64 * s64)
    std = torch.sqrt(1e-8 + var)
    ref = x64 @ w64 + std * e64
    err_v = (c * (1 + 2 * u) + 2.001 * u) * var
    low = torch.sqrt(torch.clamp(1e-8 + var - err_v, min=0.0))
    before = (c * (x64.abs() @ w64.abs()) + err_v / (std + low)
              * e64.abs() + 3 * u * std * e64.abs())
    return ref, before * (1 + u) + u * ref.abs()


def _inputs(seed, b, k, n):
    """chip_smoke.py's operands: activations of either sign, the BBB
    init's U(-0.01, 0.01) means, softplus(-3 +- 0.5) stds, normals."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, k).astype(np.float32)
    w = rng.uniform(-0.01, 0.01, (k, n)).astype(np.float32)
    sp = np.log1p(np.exp(-3 + rng.uniform(-0.5, 0.5, (k, n)))).astype(
        np.float32)
    eps = rng.randn(b, n).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, w, sp, eps))


E = 2.0 ** -11          # half a TF32 unit in the last place at 1.0


@pytest.mark.parametrize("value,want", [
    (0.0, 0.0),
    (-0.0, -0.0),
    (1.0, 1.0),
    (1 + E, 1 + 2 * E),                        # a tie: away from zero
    (-(1 + E), -(1 + 2 * E)),
    (1 + 3 * E, 1 + 4 * E),                    # a tie above an odd unit
    (1 + E - 2.0 ** -23, 1.0),                 # just below the tie
    (1 + E + 2.0 ** -23, 1 + 2 * E),           # just above it
    (-(1 + 2 * E), -(1 + 2 * E)),              # already a TF32 value
    (2 - 2.0 ** -23, 2.0),                     # carries into the exponent
    (-(2 - 2.0 ** -23), -2.0),
])
def test_rna_tf32_hand_picked(value, want):
    a = torch.tensor([value], dtype=torch.float32)
    got = rna_tf32(a)
    assert float(got) == float(np.float32(want))
    assert math.copysign(1, float(got)) == math.copysign(1, float(want))
    assert int(got.view(torch.int32)) & 0x1FFF == 0


def test_split_is_exact_to_22_bits():
    """hi + lo carries a to within 2^-22 of |a| (hi to 2^-11), over a
    spread of magnitudes and both signs."""
    rng = np.random.RandomState(3)
    a = torch.from_numpy((rng.randn(100_000) * 10.0 ** rng.uniform(
        -20, 20, 100_000)).astype(np.float32))
    hi, lo = split(a)
    a64 = a.double()
    assert float(((hi.double() - a64).abs() / a64.abs()).max()) <= 2.0 ** -11
    rel = ((hi.double() + lo.double() - a64).abs() / a64.abs()).max()
    assert float(rel) <= 2.0 ** -22


@pytest.mark.parametrize("shape", SHAPES, ids=["fc_0", "fc_1", "ragged"])
def test_3xtf32_within_dense_bound(shape):
    b, k, n = shape
    x, w, sp, eps = _inputs(sum(shape), b, k, n)
    got = emulate(x, w, sp, eps)
    ref, bound = dense_bound(x, w, sp, eps)
    ratio = float(((got.double() - ref).abs() / bound).max())
    assert got.shape == (b, n) and bool(torch.isfinite(got).all())
    assert ratio <= 1.0, ratio
    # and the plain float32 version is held to the same bound
    plain = bd.bbb_dense_plain(x, w, sp, eps)
    assert float(((plain.double() - ref).abs() / bound).max()) <= 1.0


# the regression MLP's shapes: housing's dense_0 (K=13) and heads (N=1),
# power's dense_0 (K=4), a hidden layer and power's ragged head
MLP_SHAPES = [(364, 13, 100), (1000, 4, 100), (364, 100, 1),
              (1000, 100, 100), (889, 100, 1)]


@pytest.mark.parametrize("shape", SHAPES + MLP_SHAPES, ids=[
    "fc_0", "fc_1", "ragged", "mlp_in", "mlp_in_power", "mlp_head",
    "mlp_hidden", "mlp_ragged"])
def test_3xtf32_within_its_bound(shape):
    """The emulation within the 3xTF32 bound (tighter than the float32
    one at large K, looser at the MLP's K of 4 and 13, where the split's
    3 * 2^-22 per product outweighs K roundings of 2^-24), and the plain
    float32 version within the float32 bound, at the LeNet's and the
    regression MLP's shapes."""
    b, k, n = shape
    x, w, sp, eps = _inputs(sum(shape), b, k, n)
    got = emulate(x, w, sp, eps)
    ref, bound = dense_bound_3xtf32(x, w, sp, eps, *bd.split_k(b, k, n, 132))
    assert got.shape == (b, n) and bool(torch.isfinite(got).all())
    ratio = float(((got.double() - ref).abs() / bound).max())
    assert ratio <= 1.0, ratio
    plain = bd.bbb_dense_plain(x, w, sp, eps)
    _ref, bound32 = dense_bound(x, w, sp, eps)
    assert float(((plain.double() - ref).abs() / bound32).max()) <= 1.0


def test_3xtf32_matches_qbn_tpu_kernel():
    """The emulation against qbn_tpu's Pallas kernel in interpret mode on
    the same inputs, within the sum of the two results' bounds."""
    b, k, n = 16, 64, 128
    x, w, sp, eps = _inputs(5, b, k, n)
    want = np.asarray(local_reparam_dense_fused(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
        jnp.asarray(sp.numpy()), 0, block_b=16,
        noise=jnp.asarray(eps.numpy()), interpret=True))
    got = emulate(x, w, sp, eps)
    _ref, bound = dense_bound(x, w, sp, eps)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert np.all(err <= 2 * bound.numpy()), float((err / bound).max())
