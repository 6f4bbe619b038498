"""The port's int8 conv (qbn_tpu_torch.ops.int_conv) against qbn_tpu's
conv kernels and ops, bitwise.

On the CPU the port's entries run their plain versions: exact integer
sums (float64 library convs) and the float32 epilogue in qbn_tpu's order.
The same int8 codes and float32 qparams, made with numpy from a seed, go
through:
- qbn_tpu's Pallas K3 kernel `mc_group_conv(..., interpret=True)` at the
  shapes of tests/test_int_conv.py;
- qbn_tpu's `int_conv_merged` at stride 1 and 2, 1x1, shared x, K on both
  sides of 520 (centered weights) and of 1040 (float32 window-sum
  correction), relu on and off, and a_hi 127 / 63 / 3;
- the residual epilogue against the port's conv followed by its
  ResidualAdd, and against qbn_tpu's fused residual;
- qbn_tpu's Pallas K4 kernel `bconv(interpret=True)`, two convs chained,
  as tests/test_bconv.py chains them.
The outputs are int8 codes, so there is no tolerance. The kernel itself
(csrc/int_conv.cu) runs only on the card and is held against these plain
versions there by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.ops import integer as JI
from qbn_tpu.ops.pallas.bconv import bconv, pack_codes, unpack_codes
from qbn_tpu.ops.pallas.conv_gemm import mc_group_conv as j_mc_group_conv

from qbn_tpu_torch.models import layers as TL
from qbn_tpu_torch.ops import _build
from qbn_tpu_torch.ops import int_conv as IC
from qbn_tpu_torch.ops import integer as TI

F32 = np.float32


def _t(v):
    return torch.from_numpy(np.asarray(v))


@pytest.mark.parametrize("s,b,h,cin,cout",
                         [(3, 2, 8, 5, 7), (2, 3, 16, 24, 24)])
def test_mc_group_conv_matches_pallas_k3(s, b, h, cin, cout):
    rng = np.random.RandomState(11 + s)
    x = rng.randint(-100, 101, (s, b, h, h, cin)).astype(np.int8)
    w = rng.randint(-128, 128, (s, 3, 3, cin, cout)).astype(np.int8)
    bias = (rng.randn(cout) * 0.1).astype(F32)
    qp = (F32(0.02), F32(0.005), np.int32(-9), F32(0.03), np.int32(17))
    j = j_mc_group_conv(jnp.asarray(x), qp[0], jnp.asarray(w), qp[1], qp[2],
                        jnp.asarray(bias), qp[3], qp[4], 0, 127, relu=True,
                        interpret=True)
    t = IC.mc_group_conv(_t(x), _t(qp[0]), _t(w), _t(qp[1]), _t(qp[2]),
                         _t(bias), _t(qp[3]), _t(qp[4]), 0, 127, relu=True)
    assert t.shape == (s, b, h, h, cout) and t.dtype == torch.int8
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert len(np.unique(t.numpy())) > 3


def _qparams(rng):
    return dict(x_scale=F32(rng.uniform(0.05, 0.25)),
                w_scale=F32(rng.uniform(5e-4, 5e-3)),
                w_zp=np.int32(rng.integers(-80, 20)),
                out_scale=F32(rng.uniform(0.05, 0.3)),
                out_zp=np.int32(rng.integers(0, 75)))


def _both(x, w, qp, bias, stride, pad, relu, shared, a_hi, res=None):
    """qbn_tpu's int_conv_merged and the port's, on the same inputs."""
    kw = dict(strides=(stride, stride), padding=[(pad, pad)] * 2, a_lo=0,
              a_hi=a_hi, relu=relu, shared_x=shared)
    jres, tres = {}, {}
    if res is not None:
        jres = {k: jnp.asarray(v) for k, v in res.items()}
        tres = {k: _t(v) for k, v in res.items()}
        jres["res_relu"] = tres["res_relu"] = True
    j = JI.int_conv_merged(
        jnp.asarray(x), qp["x_scale"], jnp.asarray(w), qp["w_scale"],
        qp["w_zp"], None if bias is None else jnp.asarray(bias),
        qp["out_scale"], qp["out_zp"], **kw, **jres)
    t = IC.int_conv_merged(
        _t(x), _t(qp["x_scale"]), _t(w), _t(qp["w_scale"]), _t(qp["w_zp"]),
        None if bias is None else _t(bias), _t(qp["out_scale"]),
        _t(qp["out_zp"]), **kw, **tres)
    return np.asarray(j), t.numpy()


# (kh, cin, cout, stride, spatial, shared_x); K = kh * kh * cin
CONVS = [
    (3, 3, 8, 1, 6, True),         # the stem's form, K = 27
    (3, 3, 8, 2, 7, True),         # shared x, stride 2, odd size
    (1, 24, 16, 2, 6, False),      # 1x1 shortcut, K = 24
    (3, 57, 8, 1, 3, False),       # K = 513: centered
    (3, 58, 8, 2, 4, False),       # K = 522: window sum, stride 2
    (3, 115, 8, 1, 3, False),      # K = 1035: window sum, below 2^24
    (3, 116, 8, 1, 3, False),      # K = 1044: window sum, past 2^24
    (1, 600, 8, 1, 3, True),       # shared x on the window-sum path
]


@pytest.mark.parametrize("relu,a_hi", [(False, 127), (True, 127),
                                       (True, 63), (True, 3)])
@pytest.mark.parametrize("kh,cin,cout,stride,hw,shared", CONVS)
def test_int_conv_merged_matches_qbn_tpu(kh, cin, cout, stride, hw, shared,
                                         relu, a_hi):
    rng = np.random.default_rng(kh * 1000 + cin + stride + 7 * a_hi + relu)
    b, s = 2, 3
    xc = cin if shared else s * cin
    x = rng.integers(-127, 128, (b, hw, hw, xc)).astype(np.int8)
    w = rng.integers(-128, 128, (s, kh, kh, cin, cout)).astype(np.int8)
    bias = rng.normal(0, 0.5, cout).astype(F32)
    qp = _qparams(rng)
    if a_hi < 127:
        # a sub-8-bit grid: out_scale spreads the outputs over its 0..a_hi
        # codes (the conv's real outputs, from its exact sums), the zero
        # point mid-grid
        acc, win = IC.int_conv_sums(_t(x), _t(w), (stride, stride),
                                    [(kh // 2, kh // 2)] * 2, shared)
        y = ((acc.double() - int(qp["w_zp"]) * win.double()[..., None])
             * float(qp["x_scale"]) * float(qp["w_scale"]))
        qp["out_scale"] = F32(2 * float(y.std()) / (a_hi + 1))
        qp["out_zp"] = np.int32(a_hi // 2)
    j, t = _both(x, w, qp, bias, stride, kh // 2, relu, shared, a_hi)
    ho = (hw + 2 * (kh // 2) - kh) // stride + 1
    assert t.shape == (b, ho, ho, s * cout) and t.dtype == np.int8
    np.testing.assert_array_equal(t, j)
    q = t.astype(np.int32) + int(qp["out_zp"])
    assert q.min() >= 0 and q.max() <= a_hi
    assert len(np.unique(t)) > (2 if a_hi == 3 else 3)


@pytest.mark.parametrize("kh,cin,cout,stride,hw", [
    (3, 24, 24, 1, 6), (3, 96, 96, 1, 4), (3, 192, 16, 1, 2)])
def test_residual_epilogue_equals_conv_then_residual_add(kh, cin, cout,
                                                         stride, hw):
    rng = np.random.default_rng(cin + 5)
    b, s = 2, 2
    x = rng.integers(-127, 128, (b, hw, hw, s * cin)).astype(np.int8)
    w = rng.integers(-128, 128, (s, kh, kh, cin, cout)).astype(np.int8)
    bias = rng.normal(0, 0.5, cout).astype(F32)
    residual = rng.integers(-60, 60, (b, hw, hw, s * cout)).astype(np.int8)
    qp = _qparams(rng)
    res = dict(residual=residual, res_scale=F32(0.2),
               res_out_scale=F32(0.3), res_out_zp=np.int32(40))
    j, fused = _both(x, w, qp, bias, stride, 1, False, False, 127, res)
    np.testing.assert_array_equal(fused, j)
    # the port's conv, then its ResidualAdd (the main path's order)
    conv = IC.int_conv_merged(
        _t(x), _t(qp["x_scale"]), _t(w), _t(qp["w_scale"]), _t(qp["w_zp"]),
        _t(bias), _t(qp["out_scale"]), _t(qp["out_zp"]), (stride, stride),
        [(1, 1)] * 2, 0, 127)
    a = TL.MergedQTensor(conv, _t(qp["out_scale"]), _t(qp["out_zp"]), s=s)
    r = TL.MergedQTensor(_t(residual), _t(res["res_scale"]), _t(np.int32(3)),
                         s=s)
    added = TL.ResidualAdd(relu=True)(a, r, {"qconst": {"q": {
        "scale": _t(res["res_out_scale"]), "zp": _t(res["res_out_zp"])}}})
    np.testing.assert_array_equal(fused, added.codes.numpy())


def test_two_chained_convs_match_chained_bconv():
    """tests/test_bconv.py's chain: two 3x3 convs (phase 0 -> 1 -> 0 in
    bconv's packed layout) against the port's convs chained in the
    per-sample and in the merged layout, with no op between them."""
    key = jax.random.PRNGKey(2)
    s, b, h, c = 2, 4, 8, 4
    ks = jax.random.split(key, 3)
    x = jax.random.randint(ks[0], (s, b, h, h, c), -100, 101, jnp.int8)
    w1 = jax.random.randint(ks[1], (s, 3, 3, c, c), -127, 128, jnp.int8)
    w2 = jax.random.randint(ks[2], (s, 3, 3, c, c), -127, 128, jnp.int8)
    args1 = (0.02, 0.03, 11)   # x_scale, out_scale, out_zp
    args2 = (0.03, 0.05, 29)
    xp = jax.vmap(lambda xi: pack_codes(xi, 0))(x)
    y = bconv(xp, args1[0], w1, 0.004, 2, None, args1[1], args1[2],
              0, 127, phase=0, relu=True, interpret=True)
    y = bconv(y, args2[0], w2, 0.004, 2, None, args2[1], args2[2],
              0, 127, phase=1, relu=True, interpret=True)
    want = np.asarray(jax.vmap(lambda oi: unpack_codes(oi, 0))(y))

    tw1, tw2 = _t(np.asarray(w1)), _t(np.asarray(w2))
    t = _t(np.asarray(x))
    for tw, (xs, os_, oz) in ((tw1, args1), (tw2, args2)):
        t = IC.mc_group_conv(t, xs, tw, 0.004, 2, None, os_, oz, 0, 127,
                             relu=True)
    np.testing.assert_array_equal(t.numpy(), want)
    # merged layout: (S, B, H, W, C) -> (B, H, W, S*C), convs chained
    m = _t(np.asarray(x)).permute(1, 2, 3, 0, 4).reshape(b, h, h, s * c)
    for tw, (xs, os_, oz) in ((tw1, args1), (tw2, args2)):
        m = TI.int_conv_merged(m, xs, tw, 0.004, 2, None, os_, oz, (1, 1),
                               [(1, 1)] * 2, 0, 127, relu=True)
    np.testing.assert_array_equal(
        m.reshape(b, h, h, s, c).permute(3, 0, 1, 2, 4).numpy(), want)


@pytest.mark.parametrize("kh,cin,cout,stride,hw,shared", [
    (3, 3, 8, 1, 5, True), (3, 8, 8, 2, 6, False), (1, 12, 4, 2, 5, False)])
def test_raw_sums_equal_int64_windows(kh, cin, cout, stride, hw, shared):
    """The debug entry's sums (the kernel's raw int32 accumulator and
    window sum) against int64 sums over explicit windows."""
    rng = np.random.default_rng(hw + cin)
    b, s = 2, 3
    x = rng.integers(-128, 128, (b, hw, hw, cin if shared else s * cin)
                     ).astype(np.int8)
    w = rng.integers(-128, 128, (s, kh, kh, cin, cout)).astype(np.int8)
    pad = kh // 2
    acc, win = IC.int_conv_sums(_t(x), _t(w), (stride, stride),
                                [(pad, pad)] * 2, shared)
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ho = (hw + 2 * pad - kh) // stride + 1
    assert acc.shape == (b, ho, ho, s, cout) and win.shape == (b, ho, ho, s)
    assert acc.dtype == win.dtype == torch.int32
    for i in range(ho):
        for j in range(ho):
            patch = xp[:, i * stride:i * stride + kh,
                       j * stride:j * stride + kh]
            for g in range(s):
                xs = patch if shared else patch[..., g * cin:(g + 1) * cin]
                np.testing.assert_array_equal(
                    acc[:, i, j, g].numpy(),
                    np.einsum("bhwc,hwco->bo", xs, w[g].astype(np.int64)))
                np.testing.assert_array_equal(win[:, i, j, g].numpy(),
                                              xs.sum(axis=(1, 2, 3)))


def test_cpu_path_never_builds_the_kernel(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the CPU path reached the CUDA build")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(IC, "_lib", refuse)
    before = IC.launches
    rng = np.random.default_rng(3)
    x = _t(rng.integers(-127, 128, (1, 4, 4, 2 * 8)).astype(np.int8))
    w = _t(rng.integers(-128, 128, (2, 3, 3, 8, 4)).astype(np.int8))
    q = (0.1, 0.01, -3, 0.2, 10)
    out = TI.int_conv_merged(x, q[0], w, q[1], q[2], None, q[3], q[4],
                             (1, 1), [(1, 1)] * 2, 0, 127)
    assert out.shape == (1, 4, 4, 8)
    xs = x.reshape(1, 4, 4, 2, 8).permute(3, 0, 1, 2, 4).contiguous()
    assert IC.mc_group_conv(xs, q[0], w, q[1], q[2], None, q[3], q[4], 0,
                            127).shape == (2, 1, 4, 4, 4)
    assert IC.int_conv_sums(x, w, (1, 1), [(1, 1)] * 2)[0].shape == \
        (1, 4, 4, 2, 4)
    assert IC.launches == before


def test_wrapper_rejects_a_non_integer_zero_point():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((2, 3, 3, 4, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="w_zp"):
        IC.int_conv_merged(x, 0.1, w, 0.01, torch.tensor(-2.5), None, 0.2,
                           10, (1, 1), [(1, 1)] * 2, 0, 127)
    with pytest.raises(ValueError, match="symmetric"):
        IC.int_conv_merged(x, 0.1, w, 0.01, -2, None, 0.2, 10, (1, 1),
                           [(1, 0), (1, 1)], 0, 127)
