"""qbn_tpu_torch.ops.stochastic and ops.bbb_dense against qbn_tpu.

Inputs come from numpy with a seed; the noise is what qbn_tpu draws with
the same key (jax.random.normal), handed to the port through a QueueNoise,
so both compute on the same normals. The port runs its plain versions
here (CPU tensors); the CUDA kernel is held against the same plain version
on the card by chip_smoke.py.

Tolerances: float32 results of the same formula in two frameworks differ
by summation order only, so elementwise results (softplus, the weight
sample) agree to 1e-6 relative and products to 1e-5 relative; the custom
backward and the kernel's plain version use the tolerances of
tests/test_pallas.py (rtol 1e-4 / atol 1e-5 and 2e-5); the fc_0-sized
check against float64 uses the classical bound on a float32 dot product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.ops import stochastic as js
from qbn_tpu.ops.pallas.bbb_dense import local_reparam_dense_fused

from qbn_tpu_torch.ops import bbb_dense as bd
from qbn_tpu_torch.ops import stochastic as ts


def T(a):
    return torch.from_numpy(np.array(a))


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def _dense_inputs(seed, b, k, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    sp = rng.uniform(0.05, 0.2, (k, n)).astype(np.float32)
    return x, w, sp


def test_softplus_matches_logaddexp_above_20():
    x = np.linspace(-30, 60, 1001, dtype=np.float32)
    got = ts.softplus(T(x)).numpy()
    want = np.asarray(js.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # F.softplus returns x itself above 20; logaddexp adds log1p(e^-x)
    assert got[-1] == np.float32(60.0)
    np.testing.assert_allclose(ts.softplus(T(np.float32([-10.0, -3.0]))),
                               np.log1p(np.exp([-10.0, -3.0])), rtol=1e-6)


def test_kl_divergence_matches():
    rng = np.random.RandomState(0)
    mu = rng.uniform(-0.01, 0.01, (5, 5, 20, 50)).astype(np.float32)
    sigma = np.asarray(js.softplus(jnp.asarray(
        rng.uniform(-10.5, -9.5, mu.shape).astype(np.float32))))
    want = float(js.kl_divergence(jnp.asarray(mu), jnp.asarray(sigma),
                                  jnp.zeros_like(mu),
                                  jnp.full_like(sigma, 0.1)))
    got = float(ts.kl_divergence(T(mu), T(sigma), torch.zeros(mu.shape),
                                 torch.full(mu.shape, 0.1)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("bias", [False, True])
def test_local_reparam_dense_same_noise(bias):
    x, w, sp = _dense_inputs(1, 8, 64, 32)
    b = np.linspace(-1, 1, 32, dtype=np.float32) if bias else None
    key = jax.random.PRNGKey(3)
    want = np.asarray(js.local_reparam_dense(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sp), key,
        None if b is None else jnp.asarray(b)))
    noise = ts.QueueNoise([_normal(key, (8, 32))])
    got = ts.local_reparam_dense(T(x), T(w), T(sp), noise,
                                 None if b is None else T(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape", [
    # LeNet's two 5x5 pad-2 convs, small batch
    (2, 28, 28, 1, 20), (2, 14, 14, 20, 50)])
def test_local_reparam_conv_same_noise(shape):
    b, h, w_, cin, cout = shape
    rng = np.random.RandomState(4)
    x = rng.rand(b, h, w_, cin).astype(np.float32)
    w = rng.uniform(-0.01, 0.01, (5, 5, cin, cout)).astype(np.float32)
    sp = np.asarray(js.softplus(jnp.asarray(
        rng.uniform(-10.5, -2.0, w.shape).astype(np.float32))))
    key = jax.random.PRNGKey(5)
    want = np.asarray(js.local_reparam_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sp), key, (1, 1),
        [(2, 2), (2, 2)]))
    noise = ts.QueueNoise([_normal(key, (b, h, w_, cout))])
    got = ts.local_reparam_conv(T(x), T(w), T(sp), noise, (1, 1), 2)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_sample_weights_same_noise():
    rng = np.random.RandomState(6)
    w = rng.uniform(-0.01, 0.01, (2450, 500)).astype(np.float32)
    sp = rng.uniform(0.01, 0.1, w.shape).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(js.sample_weights(jnp.asarray(w), jnp.asarray(sp),
                                        key))
    got = ts.sample_weights(T(w), T(sp),
                            ts.QueueNoise([_normal(key, w.shape)]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _fused_grads(x, w, sp, noise, g):
    xt, wt, st = (T(a).clone().requires_grad_() for a in (x, w, sp))
    nt = T(noise).clone().requires_grad_()
    out = ts.LocalReparamDenseFused.apply(xt, wt, st, nt)
    return torch.autograd.grad(out, (xt, wt, st, nt), T(g))


def test_fused_backward_matches_qbn_tpu():
    b, k, n = 8, 32, 16
    x, w, sp = _dense_inputs(5, b, k, n)
    rng = np.random.RandomState(8)
    noise = rng.randn(b, n).astype(np.float32)
    g = rng.randn(b, n).astype(np.float32)
    got = _fused_grads(x, w, sp, noise, g)

    want_bwd = js._lrd_fused_bwd(tuple(map(jnp.asarray, (x, w, sp, noise))),
                                 jnp.asarray(g))

    def ref(x, w, sp, noise):
        mean = x @ w
        var = jnp.square(x) @ jnp.square(sp)
        return mean + jnp.sqrt(js.VAR_EPS + var) * noise

    _, vjp = jax.vjp(ref, *map(jnp.asarray, (x, w, sp, noise)))
    want_vjp = vjp(jnp.asarray(g))
    for a, b1, b2 in zip(got, want_bwd, want_vjp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b1), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(b2), rtol=1e-4,
                                   atol=1e-5)


def test_auto_fused_equals_unfused_forward_and_grads():
    """The fused path (custom backward) and the plain path (autograd of
    the formula) draw the same (B, N) noise and agree."""
    x, w, sp = _dense_inputs(9, 8, 48, 24)
    eps = np.random.RandomState(10).randn(8, 24).astype(np.float32)
    outs, grads = [], []
    for fused in (False, True):
        xt, wt, st = (T(a).clone().requires_grad_() for a in (x, w, sp))
        out = ts.local_reparam_dense_auto(xt, wt, st, ts.QueueNoise([eps]),
                                          fused=fused)
        outs.append(out.detach().numpy())
        grads.append(torch.autograd.grad(out.square().sum(), (xt, wt, st)))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("b,k,n,block_b", [(16, 64, 128, 128),
                                           (10, 16, 128, 8)])
def test_plain_matches_pallas_kernel(b, k, n, block_b):
    """bbb_dense_plain against qbn_tpu's kernel in interpret mode, with
    explicit noise; (10, 16, 128) is a batch that is not a multiple of
    qbn_tpu's block."""
    x, w, sp = _dense_inputs(2 + b, b, k, n)
    noise = np.random.RandomState(11).randn(b, n).astype(np.float32)
    want = np.asarray(local_reparam_dense_fused(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(sp), 0,
        block_b=block_b, noise=jnp.asarray(noise), interpret=True))
    got = bd.bbb_dense(T(x), T(w), T(sp), T(noise))
    assert got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_at_fc0_width_against_float64():
    """LeNet's fc_0 (K=2450, N=500) at B=8 against a float64 product.
    Tolerance: the classical bound on a float32 dot product of K terms,
    gamma_K * sum_k |a_k b_k| with gamma_K = K u / (1 - K u), u = 2^-24,
    for the mean and (through d sqrt(v) = dv / 2 sqrt(v)) the variance,
    plus a few ulps of the result."""
    b, k, n = 8, 2450, 500
    rng = np.random.RandomState(12)
    x = np.maximum(rng.randn(b, k), 0).astype(np.float32)   # post-ReLU
    w = rng.uniform(-0.01, 0.01, (k, n)).astype(np.float32)
    sp = np.log1p(np.exp(rng.uniform(-3.5, -2.5, (k, n)))).astype(np.float32)
    eps = rng.randn(b, n).astype(np.float32)
    got = bd.bbb_dense(T(x), T(w), T(sp), T(eps)).numpy().astype(np.float64)
    x64, w64, s64 = (a.astype(np.float64) for a in (x, w, sp))
    var = (x64 ** 2) @ (s64 ** 2)
    std = np.sqrt(1e-8 + var)
    want = x64 @ w64 + std * eps
    u = 2.0 ** -24
    gamma = k * u / (1 - k * u)
    bound = (gamma * (np.abs(x64) @ np.abs(w64))
             + gamma * var / (2 * std) * np.abs(eps)
             + 4 * u * np.abs(want))
    err = np.abs(got - want)
    assert np.all(err <= bound), float((err / bound).max())


def test_cpu_draws_from_generator_without_noise():
    x, w, sp = _dense_inputs(13, 4, 8, 6)
    g1 = torch.Generator().manual_seed(0)
    a = bd.bbb_dense(T(x), T(w), T(sp), generator=g1)
    eps = torch.randn((4, 6), generator=torch.Generator().manual_seed(0))
    b = bd.bbb_dense_plain(T(x), T(w), T(sp), eps)
    assert torch.equal(a, b)


@pytest.mark.parametrize("b,k,n", [(256, 2450, 500), (256, 500, 10),
                                   (250, 300, 77), (1, 1, 1), (8, 16, 64),
                                   (4096, 16, 2560)])
def test_split_k_partitions_k(b, k, n):
    """The wrapper's split of K: every split non-empty, k_chunk a multiple
    of the kernel's 32-deep step, the splits covering K exactly once."""
    splits, k_chunk = bd.split_k(b, k, n, sms=132)
    assert k_chunk % 32 == 0 and splits >= 1
    starts = [s * k_chunk for s in range(splits)]
    assert all(s < k for s in starts)
    assert starts[-1] + k_chunk >= k
    if (b, k, n) == (256, 2450, 500):          # fc_0: 32 tiles x 4 splits
        assert (splits, k_chunk) == (4, 640)


def test_queue_noise_checks_shape_and_order():
    q = ts.QueueNoise([np.zeros((2, 3)), np.ones((4,))])
    assert q((2, 3), "cpu").sum() == 0
    with pytest.raises(ValueError):
        q((3,), "cpu")
    with pytest.raises(RuntimeError):
        q((4,), "cpu")
