"""The port's quantisation primitives against qbn_tpu's, on the CPU:
the moving-average min/max observer, `calculate_qparams`, `quantize`,
`fake_quantize` (its value and its straight-through gradient) and the
batch-norm fold with the Bayes-by-backprop std. Inputs from numpy seeds;
parametrised over the bit widths and the signed (weight) and unsigned
(activation) bounds.

Tolerances: exact (bitwise) everywhere but the folded std, whose
softplus / softplusinv chain is computed by XLA:CPU's and torch's own
transcendentals, which differ in the last ulp: it is held within 4 ulps
of qbn_tpu's. The fold's weight and bias are bitwise: the port takes the
correctly rounded square root that XLA computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.quant import bn_fold as JB
from qbn_tpu.quant import fake_quant as JF
from qbn_tpu.quant import observer as JO
from qbn_tpu.quant.bounds import INT_BOUNDS, UINT_BOUNDS

from qbn_tpu_torch.quant import bn_fold as TB
from qbn_tpu_torch.quant import fake_quant as TF
from qbn_tpu_torch.quant import observer as TO

BOUNDS = ([("int", b, INT_BOUNDS[b]) for b in (8, 4, 2)]
          + [("uint", b, UINT_BOUNDS[b]) for b in (7, 3)])
IDS = [f"{k}{b}" for k, b, _ in BOUNDS]


def _x(seed, shape=(64, 33), scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(shift, scale, shape)).astype(np.float32)


def _states(xs):
    """The observer after each of xs, in both packages."""
    j, t = JO.obs_init(), TO.obs_init()
    out = []
    for x in xs:
        j = JO.obs_update(j, jnp.asarray(x))
        t = TO.obs_update(t, torch.from_numpy(x))
        out.append((j, t))
    return out


def test_observer_sequence_is_bitwise():
    """Fresh sentinel state, the first update adopting the batch extrema,
    then five moving-average updates."""
    xs = [_x(i, scale=1 + i, shift=0.3 * i) for i in range(6)]
    j0, t0 = JO.obs_init(), TO.obs_init()
    assert bool(torch.isinf(t0["min_val"])) and float(t0["min_val"]) > 0
    assert float(t0["max_val"]) == float(j0["max_val"])
    for i, (j, t) in enumerate(_states(xs)):
        for k in ("min_val", "max_val"):
            assert t[k].dtype == torch.float32
            assert float(t[k]) == float(j[k]), (i, k)
    assert float(_states(xs[:1])[0][1]["min_val"]) == float(xs[0].min())


@pytest.mark.parametrize("kind,bits,bounds", BOUNDS, ids=IDS)
def test_calculate_qparams_is_bitwise(kind, bits, bounds):
    """Observed ranges of either sign, all-positive, all-negative, a zero
    range (the eps floor) and the never-updated sentinel."""
    cases = [(-1.3, 2.7), (0.25, 9.5), (-4.0, -0.5), (0.0, 0.0),
             (-1e-9, 1e-9), (float("inf"), float("-inf")),
             (-0.0371, 0.0123)]
    for mn, mx in cases:
        js, jz = JO.calculate_qparams(np.float32(mn), np.float32(mx),
                                      *bounds)
        ts, tz = TO.calculate_qparams(torch.tensor(mn), torch.tensor(mx),
                                      *bounds)
        assert ts.dtype == torch.float32 and tz.dtype == torch.int32
        assert float(ts) == float(js), (mn, mx)
        assert int(tz) == int(jz), (mn, mx)


def _qparams(x, bounds):
    (j, t), = _states([x])
    return (JO.calculate_qparams(j["min_val"], j["max_val"], *bounds),
            TO.calculate_qparams(t["min_val"], t["max_val"], *bounds))


@pytest.mark.parametrize("kind,bits,bounds", BOUNDS, ids=IDS)
def test_quantize_and_fake_quantize_are_bitwise(kind, bits, bounds):
    """Codes and round trips on the observer's grid of x, and on a grid a
    quarter as wide (so that many values clamp); values on exact ties of
    x / scale + zp included, which round half to even."""
    x = _x(bits, scale=2.0, shift=1.0 if kind == "uint" else 0.0)
    for shrink in (1.0, 0.25):
        (js, jz), (ts, tz) = _qparams(x * shrink, bounds)
        ties = ((np.arange(-6, 7, dtype=np.float32) + 0.5)
                - float(jz)) * np.float32(js)
        for v in (x, ties):
            jq = JF.quantize(jnp.asarray(v), js, jz, *bounds)
            tq = TF.quantize(torch.from_numpy(v), ts, tz, *bounds)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            jf = JF.fake_quantize(jnp.asarray(v), js, jz, *bounds)
            tf = TF.fake_quantize(torch.from_numpy(v), ts, tz, *bounds)
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
            jd = JF.dequantize(jq, js, jz)
            td = TF.dequantize(tq, ts, tz)
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("kind,bits,bounds", BOUNDS, ids=IDS)
def test_fake_quantize_straight_through_gradient(kind, bits, bounds):
    """The gradient of sum(w * fake_quantize(x)): w inside the range of
    the UNCLAMPED code, 0 outside, bitwise against jax.grad; on a narrow
    grid a good part of the entries lies outside."""
    x = _x(10 + bits, scale=3.0)
    w = _x(20 + bits)
    (js, jz), (ts, tz) = _qparams(x * 0.3, bounds)
    jg = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * JF.fake_quantize(
        v, js, jz, *bounds)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    (torch.from_numpy(w) * TF.fake_quantize(tx, ts, tz, *bounds)).sum() \
        .backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    outside = int((np.asarray(jg) == 0).sum())
    assert 0 < outside < x.size


def _bn(seed, cout, cin=5):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        conv_w=rng.normal(0, 0.2, (3, 3, cin, cout)).astype(f),
        conv_std=rng.uniform(-9, -2, (3, 3, cin, cout)).astype(f),
        bn_rm=rng.normal(0, 0.3, cout).astype(f),
        bn_rv=rng.uniform(0.05, 2.0, cout).astype(f),
        bn_w=rng.uniform(0.5, 1.5, cout).astype(f),
        bn_b=rng.normal(0, 0.1, cout).astype(f))


@pytest.mark.parametrize("with_bias,with_std", [(False, True), (True, True),
                                                (True, False)])
def test_bn_fold(with_bias, with_std):
    a = _bn(7, 48)
    conv_b = (np.random.default_rng(8).normal(0, 0.1, 48).astype(np.float32)
              if with_bias else None)
    std = a["conv_std"] if with_std else None
    jw, jb, js = JB.fuse_conv_bn_weights(
        jnp.asarray(a["conv_w"]), None if conv_b is None else
        jnp.asarray(conv_b), None if std is None else jnp.asarray(std),
        jnp.asarray(a["bn_rm"]), jnp.asarray(a["bn_rv"]), 1e-5,
        jnp.asarray(a["bn_w"]), jnp.asarray(a["bn_b"]))

    def t(v):
        return None if v is None else torch.from_numpy(v)
    tw, tb, ts = TB.fuse_conv_bn_weights(
        t(a["conv_w"]), t(conv_b), t(std), t(a["bn_rm"]), t(a["bn_rv"]),
        1e-5, t(a["bn_w"]), t(a["bn_b"]))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    if not with_std:
        assert ts is None and js is None
        return
    # the chain softplusinv(softplus(std) * c) in float32 transcendentals
    # of two libraries: within 4 ulps, and both softplus back to within
    # 4 ulps of softplus(std) * c
    ulp = np.spacing(np.abs(np.asarray(js)))
    assert np.all(np.abs(ts.numpy() - np.asarray(js)) <= 4 * ulp)
    sp = np.logaddexp(ts.numpy().astype(np.float64), 0)
    want = (np.logaddexp(std.astype(np.float64), 0) * a["bn_w"]
            / np.sqrt(a["bn_rv"].astype(np.float64) + 1e-5))
    np.testing.assert_allclose(sp, want, rtol=1e-5)


def test_sqrt_rn_is_correctly_rounded():
    """The fold's square root: float32 roots of 10^6 values spread over
    the BN variances' range, against float64 rounded once (XLA's)."""
    x = np.random.default_rng(9).uniform(1e-6, 10.0, 10 ** 6) \
        .astype(np.float32)
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(TB.sqrt_rn(torch.from_numpy(x)).numpy(),
                                  want)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))),
                                  want)
