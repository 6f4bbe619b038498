"""The port's merged-layout integer ops against qbn_tpu's, bitwise.

Same int8 codes and float32 qparams (made with numpy from a seed) go
through qbn_tpu.ops.integer and qbn_tpu_torch.ops.integer at every conv
and dense shape of the CIFAR ResNet-18, at small B, S and spatial size.
The outputs are int8 codes from the same exact integer sums and the same
float32 epilogue, so they must be equal: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.models import layers as JL
from qbn_tpu.ops import integer as JI

from qbn_tpu_torch.models import layers as TL
from qbn_tpu_torch.ops import integer as TI

F32 = np.float32
# (kh, cin, cout, stride, spatial, shared_x): every conv of the ResNet-18
CONVS = [
    (3, 3, 24, 1, 8, True),        # stem (shared x enters the layout)
    (3, 24, 24, 1, 8, False),      # stage 0
    (3, 24, 48, 2, 8, False),      # stage 1 first conv, stride 2
    (1, 24, 48, 2, 8, False),      # stage 1 1x1 shortcut
    (3, 48, 48, 1, 4, False),
    (3, 48, 96, 2, 4, False),      # K = 432: centered
    (1, 48, 96, 2, 4, False),
    (3, 96, 96, 1, 4, False),      # K = 864: window-sum, float32
    (3, 96, 192, 2, 4, False),
    (1, 96, 192, 2, 4, False),
    (3, 192, 192, 1, 2, False),    # K = 1728: window-sum, past 2^24
]


def _qparams(rng):
    return dict(x_scale=F32(rng.uniform(0.05, 0.25)),
                w_scale=F32(rng.uniform(5e-4, 5e-3)),
                w_zp=np.int32(rng.integers(-80, 20)),
                out_scale=F32(rng.uniform(0.05, 0.3)),
                out_zp=np.int32(rng.integers(0, 75)))


def _run_conv(x, w, qp, bias, stride, pad, relu, shared, residual=None,
              res=None):
    kw = dict(strides=(stride, stride), padding=[(pad, pad)] * 2, a_lo=0,
              a_hi=127, relu=relu, shared_x=shared)
    jres, tres = {}, {}
    if residual is not None:
        jres = dict(residual=jnp.asarray(residual),
                    res_scale=jnp.asarray(res["res_scale"]),
                    res_out_scale=jnp.asarray(res["res_out_scale"]),
                    res_out_zp=jnp.asarray(res["res_out_zp"]),
                    res_relu=True)
        tres = dict(residual=torch.from_numpy(residual),
                    res_scale=torch.tensor(res["res_scale"]),
                    res_out_scale=torch.tensor(res["res_out_scale"]),
                    res_out_zp=torch.tensor(res["res_out_zp"]),
                    res_relu=True)
    j = JI.int_conv_merged(
        jnp.asarray(x), jnp.asarray(qp["x_scale"]), jnp.asarray(w),
        jnp.asarray(qp["w_scale"]), jnp.asarray(qp["w_zp"]),
        jnp.asarray(bias), jnp.asarray(qp["out_scale"]),
        jnp.asarray(qp["out_zp"]), **kw, **jres)
    t = TI.int_conv_merged(
        torch.from_numpy(x), torch.tensor(qp["x_scale"]), torch.from_numpy(w),
        torch.tensor(qp["w_scale"]), torch.tensor(qp["w_zp"]),
        torch.from_numpy(bias), torch.tensor(qp["out_scale"]),
        torch.tensor(qp["out_zp"]), **kw, **tres)
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kh,cin,cout,stride,hw,shared", CONVS)
def test_int_conv_merged_bitwise(kh, cin, cout, stride, hw, shared, relu):
    rng = np.random.default_rng(kh * 1000 + cin + cout + stride + relu)
    b, s = 2, 2
    xc = cin if shared else s * cin
    x = rng.integers(-127, 128, (b, hw, hw, xc)).astype(np.int8)
    w = rng.integers(-128, 128, (s, kh, kh, cin, cout)).astype(np.int8)
    bias = rng.normal(0, 0.5, cout).astype(F32)
    j, t = _run_conv(x, w, _qparams(rng), bias, stride, kh // 2, relu,
                     shared)
    assert t.dtype == np.int8 and t.shape == j.shape
    assert t.shape == (b, -(-hw // stride), -(-hw // stride), s * cout)
    np.testing.assert_array_equal(t, j)
    assert len(np.unique(t)) > 3            # not all clipped to one code


@pytest.mark.parametrize("kh,cin,cout,stride,hw", [
    (3, 24, 24, 1, 8), (3, 96, 96, 1, 4), (3, 192, 192, 1, 2)])
def test_int_conv_merged_fused_residual_bitwise(kh, cin, cout, stride, hw):
    rng = np.random.default_rng(cin)
    b, s = 2, 2
    x = rng.integers(-127, 128, (b, hw, hw, s * cin)).astype(np.int8)
    w = rng.integers(-128, 128, (s, kh, kh, cin, cout)).astype(np.int8)
    bias = rng.normal(0, 0.5, cout).astype(F32)
    residual = rng.integers(-60, 60, (b, hw, hw, s * cout)).astype(np.int8)
    res = dict(res_scale=F32(0.2), res_out_scale=F32(0.3),
               res_out_zp=np.int32(40))
    j, t = _run_conv(x, w, _qparams(rng), bias, stride, 1, False, False,
                     residual, res)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("x_sign,w_sign,w_zp", [
    (1, -1, 127), (-1, 1, -127), (1, 1, -125)])
def test_deep_conv_adversarial_codes_bitwise(x_sign, w_sign, w_zp):
    """K = 1728 with every code within 2 of the int8 edge: the raw sum
    and the window-sum correction both pass 2^24, where float32 keeps
    only even integers, so qbn_tpu's epilogue rounds them; the port must
    round exactly there (an exact integer subtraction would not)."""
    rng = np.random.default_rng(w_zp + 300 + 3 * x_sign)
    b, s, hw, cin, cout = 1, 2, 4, 192, 8
    x = (x_sign * rng.integers(125, 128, (b, hw, hw, s * cin))).astype(np.int8)
    w = (w_sign * rng.integers(126, 128, (s, 3, 3, cin, cout))).astype(np.int8)
    qp = dict(x_scale=F32(0.01), w_scale=F32(1e-6), w_zp=np.int32(w_zp),
              out_scale=F32(0.0037), out_zp=np.int32(60))
    j, t = _run_conv(x, w, qp, np.zeros(cout, F32), 1, 1, False, False)
    np.testing.assert_array_equal(t, j)
    # the sums are exact, and past 2^24
    wt = torch.from_numpy(w.astype(F32)).permute(0, 4, 3, 1, 2).reshape(
        s * cout, cin, 3, 3)
    acc = TI.conv_sum(torch.from_numpy(x), wt, (1, 1), 1, s)
    ones = torch.ones((s, cin, 3, 3))
    win = TI.conv_sum(torch.from_numpy(x), ones, (1, 1), 1, s)
    assert acc.dtype == torch.float64
    ref = np.zeros((b, hw, hw, s * cout), np.int64)
    xp = np.pad(x.astype(np.int64), ((0, 0), (1, 1), (1, 1), (0, 0)))
    for g in range(s):
        for dh in range(3):
            for dw in range(3):
                ref[..., g * cout:(g + 1) * cout] += np.einsum(
                    "bhwc,co->bhwo",
                    xp[:, dh:dh + hw, dw:dw + hw, g * cin:(g + 1) * cin],
                    w[g, dh, dw].astype(np.int64))
    np.testing.assert_array_equal(acc.numpy(), ref)
    assert np.abs(ref).max() > 2 ** 24
    # and the float32 epilogue of qbn_tpu is not the exact subtraction
    corr = np.repeat(w_zp * win.numpy().astype(np.int64), cout, axis=-1)
    exact = (ref - corr).astype(F32)
    rounded = (ref.astype(F32) - F32(w_zp) * np.repeat(
        win.numpy().astype(F32), cout, axis=-1))
    assert (exact != rounded).any()


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("f,o", [(192, 10), (1200, 16)])
def test_int_dense_merged_bitwise(f, o, relu, shared):
    rng = np.random.default_rng(f + o + relu + 2 * shared)
    b, s = 3, 2
    x = rng.integers(-127, 128, (b, f) if shared else (b, s, f)).astype(
        np.int8)
    w = rng.integers(-128, 128, (s, f, o)).astype(np.int8)
    qp = _qparams(rng)
    bias = rng.normal(0, 0.5, o).astype(F32) if relu else None
    kw = dict(a_lo=0, a_hi=127, relu=relu, shared_x=shared)
    j = JI.int_dense_merged(
        jnp.asarray(x), jnp.asarray(qp["x_scale"]), jnp.asarray(w),
        jnp.asarray(qp["w_scale"]), jnp.asarray(qp["w_zp"]),
        None if bias is None else jnp.asarray(bias),
        jnp.asarray(qp["out_scale"]), jnp.asarray(qp["out_zp"]), **kw)
    t = TI.int_dense_merged(
        torch.from_numpy(x), torch.tensor(qp["x_scale"]), torch.from_numpy(w),
        torch.tensor(qp["w_scale"]), torch.tensor(qp["w_zp"]),
        None if bias is None else torch.from_numpy(bias),
        torch.tensor(qp["out_scale"]), torch.tensor(qp["out_zp"]), **kw)
    assert t.shape == (b, s, o)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _merged(codes, s):
    scale, zp = F32(0.1), np.int32(30)
    return (JL.MergedQTensor(jnp.asarray(codes), jnp.asarray(scale),
                             jnp.asarray(zp), s=s),
            TL.MergedQTensor(torch.from_numpy(codes), torch.tensor(scale),
                             torch.tensor(zp), s=s))


def test_avg_pool_rounds_half_to_even_like_qbn_tpu():
    rng = np.random.default_rng(0)
    codes = rng.integers(-127, 128, (2, 4, 4, 6)).astype(np.int8)
    codes[0, :, :, 0] = 0
    codes[0, 0, :2, 0] = 4          # window sum 8: 0.5 -> 0
    codes[0, :, :, 1] = 0
    codes[0, 0, :3, 1] = 8          # window sum 24: 1.5 -> 2
    j, t = _merged(codes, 2)
    jo, to = JL.avg_pool(j, 4), TL.avg_pool(t, 4)
    np.testing.assert_array_equal(to.codes.numpy(), np.asarray(jo.codes))
    assert int(to.codes[0, 0, 0, 0]) == 0 and int(to.codes[0, 0, 0, 1]) == 2


def test_flatten_relu_dequant_like_qbn_tpu():
    rng = np.random.default_rng(1)
    codes = rng.integers(-127, 128, (2, 2, 3, 3 * 5)).astype(np.int8)
    j, t = _merged(codes, 3)
    jf, tf = JL.flatten(j), TL.flatten(t)
    assert tf.codes.shape == (2, 3, 2 * 3 * 5) and tf.s == 3
    np.testing.assert_array_equal(tf.codes.numpy(), np.asarray(jf.codes))
    np.testing.assert_array_equal(TL.relu(t).codes.numpy(),
                                  np.asarray(JL.relu(j).codes))
    np.testing.assert_array_equal(TL.dequant(t).numpy(),
                                  np.asarray(JL.dequant(j)))


def test_quantize_codes_like_qbn_tpu():
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0, 7.0, (4, 5, 6)).astype(F32)
    scale, zp = F32(0.0408), np.int32(60)
    j = JL.quantize_codes(jnp.asarray(x), jnp.asarray(scale),
                          jnp.asarray(zp), 0, 127)
    t = TL.quantize_codes(torch.from_numpy(x), torch.tensor(scale),
                          torch.tensor(zp), 0, 127)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
