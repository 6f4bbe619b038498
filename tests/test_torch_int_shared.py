"""The port's ops with ONE set of weights for every sample, against
qbn_tpu's, bitwise, on the CPU (the plain versions; the kernel runs only
on the card, where chip_smoke.py holds it against them):

- `int_conv` against qbn_tpu's `int_conv` under each rule of its
  `_conv_core` vmap: no sample axis (a shared input, computed once),
  per-sample x with shared w (the samples folded into the batch),
  per-sample x and w (the port's `mc_group_conv`), and everything per
  member with per-member qparams (an ensemble: one port call a member);
- `int_conv_merged` with shared weights against qbn_tpu's merged conv
  with the weights broadcast;
- `int_dense` against qbn_tpu's `int_dense`, unbatched, per sample and
  per member, K on both sides of 1040;
- `max_pool` on codes, and the dropout INT multiply at 7 and 4 bits with
  the masks qbn_tpu draws (recorded by wrapping `jax.random.bernoulli` in
  the test) handed to the port;
- the shared-weight tile plan: one weight slice in the pixel body's shared
  memory, and the grid at B=256, S=100 of 32x32 images, which the samples
  on the kernel's sample axis keep inside CUDA's limits where folding
  them into the batch would not;
- the arguments the kernel reads: the ctypes structure field for field
  against csrc/int_conv.cu's QbnConvArgs, and the weight sample stride (0
  for shared weights).
The outputs are int8 codes: no tolerance.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.models import layers as JL
from qbn_tpu.ops import integer as JI

from chip_smoke import CONV_SHAPES
from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.models import layers as TL
from qbn_tpu_torch.ops import int_conv as IC
from qbn_tpu_torch.ops import integer as TI
from qbn_tpu_torch.ops.stochastic import QueueMasks

F32 = np.float32


def _t(v):
    return torch.from_numpy(np.asarray(v))


def _qparams(rng):
    return dict(x_scale=F32(rng.uniform(0.05, 0.25)),
                w_scale=F32(rng.uniform(5e-4, 5e-3)),
                w_zp=np.int32(rng.integers(-80, 20)),
                out_scale=F32(rng.uniform(0.05, 0.3)),
                out_zp=np.int32(rng.integers(0, 75)))


def _j_conv(x, qp, w, bias, stride, pad, relu):
    return JI.int_conv(x, qp["x_scale"], None, w, qp["w_scale"], qp["w_zp"],
                       bias, qp["out_scale"], qp["out_zp"], (stride, stride),
                       [(pad, pad)] * 2, 0, 127, relu=relu)


def _t_conv(x, qp, w, bias, stride, pad, relu, fn=IC.int_conv):
    return fn(_t(x), *(_t(qp[k]) for k in ("x_scale",)), _t(w),
              _t(qp["w_scale"]), _t(qp["w_zp"]), _t(bias),
              _t(qp["out_scale"]), _t(qp["out_zp"]), (stride, stride),
              [(pad, pad)] * 2, 0, 127, relu=relu)


# (kh, cin, cout, stride, spatial); K = kh * kh * cin on both sides of 520
# (centered weights) and 1040 (the window sum's float32 correction)
CONVS = [(3, 3, 8, 1, 6), (3, 8, 8, 2, 7), (1, 24, 16, 2, 6),
         (5, 20, 12, 1, 5), (3, 58, 8, 1, 3), (3, 116, 8, 1, 3)]


def _operands(kh, cin, cout, seed, lead):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, lead + (CONV_HW[kh, cin], ) * 2 + (cin,))
    w = rng.integers(-128, 128, (kh, kh, cin, cout)).astype(np.int8)
    bias = rng.normal(0, 0.5, cout).astype(F32)
    return rng, x.astype(np.int8), w, bias


CONV_HW = {(kh, cin): hw for kh, cin, _c, _s, hw in CONVS}


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kh,cin,cout,stride,hw", CONVS)
def test_int_conv_shared_input_matches_qbn_tpu(kh, cin, cout, stride, hw,
                                               relu):
    """No sample axis: the stem of MC-Dropout (its dropout comes after it),
    a pointwise conv; qbn_tpu's unbatched int_conv."""
    rng, x, w, bias = _operands(kh, cin, cout, kh + cin + relu, (2,))
    qp = _qparams(rng)
    j = _j_conv(jnp.asarray(x), qp, jnp.asarray(w), jnp.asarray(bias),
                stride, kh // 2, relu)
    t = _t_conv(x, qp, w, bias, stride, kh // 2, relu)
    assert t.dtype == torch.int8 and t.shape == j.shape
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert len(np.unique(t.numpy())) > 3


@pytest.mark.parametrize("kh,cin,cout,stride,hw", CONVS)
def test_int_conv_per_sample_x_shared_w_matches_qbn_tpu(kh, cin, cout,
                                                        stride, hw):
    """Per-sample activations, shared weights: qbn_tpu's vmap rule folds
    the samples into the batch (integer.py:339-360)."""
    s = 3
    rng, x, w, bias = _operands(kh, cin, cout, 7 * kh + cin, (s, 2))
    qp = _qparams(rng)
    j = jax.vmap(lambda xx: _j_conv(xx, qp, jnp.asarray(w),
                                    jnp.asarray(bias), stride, kh // 2,
                                    True))(jnp.asarray(x))
    t = _t_conv(x, qp, w, bias, stride, kh // 2, True)
    assert t.shape == j.shape == (s, 2) + j.shape[2:]
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the samples differ, so the fold kept them apart
    assert not np.array_equal(t.numpy()[0], t.numpy()[1])


@pytest.mark.parametrize("kh,cin,cout,stride,hw", CONVS[1:4])
def test_per_sample_x_and_w_matches_mc_group_conv(kh, cin, cout, stride, hw):
    """Per-sample activations and weights (integer.py:305-338, the BBB
    rule): qbn_tpu's vmapped int_conv against the port's mc_group_conv."""
    s = 2
    rng, x, _w, bias = _operands(kh, cin, cout, 3 * kh + cin, (s, 2))
    w = rng.integers(-128, 128, (s, kh, kh, cin, cout)).astype(np.int8)
    qp = _qparams(rng)
    j = jax.vmap(lambda xx, ww: _j_conv(xx, qp, ww, jnp.asarray(bias),
                                        stride, kh // 2, True))(
        jnp.asarray(x), jnp.asarray(w))
    t = IC.mc_group_conv(_t(x), _t(qp["x_scale"]), _t(w), _t(qp["w_scale"]),
                         _t(qp["w_zp"]), _t(bias), _t(qp["out_scale"]),
                         _t(qp["out_zp"]), 0, 127, relu=True,
                         strides=(stride, stride),
                         padding=[(kh // 2, kh // 2)] * 2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("kh,cin,cout,stride,hw", CONVS[2:5])
def test_ensemble_members_match_the_both_batched_rule(kh, cin, cout, stride,
                                                      hw):
    """Everything per member, the qparams too (integer.py:362-367, an
    SGHMC ensemble): one port call per member, its own scalars."""
    m = 3
    rng, x, _w, _b = _operands(kh, cin, cout, 5 * kh + cin, (m, 2))
    w = rng.integers(-128, 128, (m, kh, kh, cin, cout)).astype(np.int8)
    bias = rng.normal(0, 0.5, (m, cout)).astype(F32)
    qps = [_qparams(rng) for _ in range(m)]
    stacked = {k: np.stack([q[k] for q in qps]) for k in qps[0]}
    j = jax.vmap(lambda xx, ww, bb, qp: _j_conv(xx, qp, ww, bb, stride,
                                                kh // 2, True))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        {k: jnp.asarray(v) for k, v in stacked.items()})
    for i in range(m):
        t = _t_conv(x[i], qps[i], w[i], bias[i], stride, kh // 2, True)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j[i]))


@pytest.mark.parametrize("kh,cin,cout,stride,hw", CONVS[1:5])
def test_merged_layout_with_shared_weights(kh, cin, cout, stride, hw):
    """A deterministic conv on merged activations (layers.py:684-701):
    the port's int_conv_merged with (kh, kw, cin, cout) weights against
    qbn_tpu's with the weights broadcast over the samples, and its raw
    sums against the per-sample weights' sums."""
    s = 3
    rng, _x, w, bias = _operands(kh, cin, cout, 11 * kh + cin, (2,))
    x = rng.integers(-127, 128, (2, hw, hw, s * cin)).astype(np.int8)
    qp = _qparams(rng)
    kw = dict(strides=(stride, stride), padding=[(kh // 2, kh // 2)] * 2,
              a_lo=0, a_hi=127, relu=True)
    j = JI.int_conv_merged(jnp.asarray(x), qp["x_scale"],
                           jnp.broadcast_to(jnp.asarray(w), (s,) + w.shape),
                           qp["w_scale"], qp["w_zp"], jnp.asarray(bias),
                           qp["out_scale"], qp["out_zp"], **kw)
    t = IC.int_conv_merged(_t(x), _t(qp["x_scale"]), _t(w),
                           _t(qp["w_scale"]), _t(qp["w_zp"]), _t(bias),
                           _t(qp["out_scale"]), _t(qp["out_zp"]), **kw)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    acc, win = IC.int_conv_sums(_t(x), _t(w), kw["strides"], kw["padding"])
    acc5, win5 = IC.int_conv_sums(_t(x), _t(np.broadcast_to(w, (s,) + w.shape)
                                          .copy()), kw["strides"],
                                  kw["padding"])
    assert torch.equal(acc, acc5) and torch.equal(win, win5)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("f,o", [(192, 10), (500, 10), (2450, 50)])
def test_int_dense_matches_qbn_tpu(f, o, relu):
    """Unbatched, per-sample x (MC-Dropout) and per member (an ensemble),
    K on both sides of 1040 (qbn_tpu's float32 zero-point correction)."""
    rng = np.random.default_rng(f + o + relu)
    s, b = 3, 4
    x = rng.integers(-127, 128, (s, b, f)).astype(np.int8)
    w = rng.integers(-128, 128, (s, f, o)).astype(np.int8)
    bias = rng.normal(0, 0.5, (s, o)).astype(F32)
    qps = [_qparams(rng) for _ in range(s)]
    for qp in qps:
        qp["w_scale"] = F32(qp["w_scale"] / 20)

    def j_dense(xx, ww, bb, qp):
        return JI.int_dense(xx, qp["x_scale"], None, ww, qp["w_scale"],
                            qp["w_zp"], bb, qp["out_scale"], qp["out_zp"],
                            0, 127, relu=relu)

    def t_dense(xx, ww, bb, qp):
        return TI.int_dense(_t(xx), _t(qp["x_scale"]), _t(ww),
                            _t(qp["w_scale"]), _t(qp["w_zp"]), _t(bb),
                            _t(qp["out_scale"]), _t(qp["out_zp"]), 0, 127,
                            relu=relu).numpy()

    qp0 = qps[0]
    np.testing.assert_array_equal(
        t_dense(x[0], w[0], bias[0], qp0),
        np.asarray(j_dense(x[0], w[0], bias[0], qp0)))
    per_sample = jax.vmap(lambda xx: j_dense(xx, w[0], bias[0], qp0))(x)
    got = t_dense(x, w[0], bias[0], qp0)
    np.testing.assert_array_equal(got, np.asarray(per_sample))
    assert len(np.unique(got)) > 3
    stacked = {k: jnp.asarray(np.stack([q[k] for q in qps])) for k in qp0}
    members = jax.vmap(j_dense)(x, w, bias, stacked)
    for i in range(s):
        np.testing.assert_array_equal(t_dense(x[i], w[i], bias[i], qps[i]),
                                      np.asarray(members[i]))


@pytest.mark.parametrize("lead", [(2,), (3, 2)], ids=["shared", "per_sample"])
@pytest.mark.parametrize("window,stride,hw", [(2, 2, 8), (2, 2, 7),
                                              (3, 2, 9)])
def test_max_pool_on_codes_matches_qbn_tpu(lead, window, stride, hw):
    rng = np.random.default_rng(window + hw + len(lead))
    codes = rng.integers(-128, 128, lead + (hw, hw, 5)).astype(np.int8)
    sc, zp = F32(0.1), np.int32(3)
    def pool(c):
        return JL.max_pool(JL.QTensor(c, sc, zp), window, stride).codes

    j = pool(jnp.asarray(codes)) if len(lead) == 1 else jax.vmap(pool)(
        jnp.asarray(codes))
    cls = TL.QTensor if len(lead) == 1 else TL.SampleQTensor
    t = TL.max_pool(cls(_t(codes), _t(sc), _t(zp)), window, stride)
    assert isinstance(t, cls) and t.codes.dtype == torch.int8
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j))


# (activation bits, mul_scale, mul_zp, input shape): fine grids at 7 bits,
# coarse ones at 4 bits, and one of 2 or more, where the kept mask 1.0
# rounds to the zero point and every activation goes to zero, in qbn_tpu
# as in the reference (tests/test_mc_int_dropout.py)
DROPOUT_CASES = [(7, 0.0757, 19, (3, 4, 4, 6)), (7, 0.0311, 2, (5, 9)),
                 (4, 0.3282, 10, (3, 4, 4, 6)), (4, 1.8284, 0, (5, 9)),
                 (4, 4.031174, 0, (2, 3, 3, 8))]


@pytest.mark.parametrize("bits,ms,mz,shape", DROPOUT_CASES)
def test_dropout_int_multiply_matches_qbn_tpu(bits, ms, mz, shape,
                                              monkeypatch):
    """qbn_tpu's BernoulliDropout in int mode, its mask recorded as it is
    drawn, against the port's with that mask (one sample)."""
    p = 0.3
    a_hi = (1 << bits) - 1
    rng = np.random.default_rng(bits + len(shape))
    zp = np.int32(rng.integers(0, a_hi // 2))
    codes = (rng.integers(0, a_hi + 1, shape) - zp).astype(np.int8)
    scale = F32(0.05 * 2 ** (7 - bits))
    drawn = []
    real = jax.random.bernoulli

    def record(key, prob, mask_shape):
        mask = real(key, prob, mask_shape)
        drawn.append(np.asarray(mask))
        return mask

    monkeypatch.setattr(jax.random, "bernoulli", record)
    jmod = JL.BernoulliDropout(p, JL.QuantConfig(enabled=True, a_bits=bits))
    qc = {"mul_scale": jnp.asarray(ms, jnp.float32),
          "mul_zp": jnp.asarray(mz, jnp.int32)}
    j = jmod.apply({"qconst": {"q": qc}},
                   JL.QTensor(jnp.asarray(codes), scale, zp), mode="int",
                   rngs={"dropout": jax.random.PRNGKey(bits)})
    assert len(drawn) == 1
    tmod = TL.BernoulliDropout(p, QuantConfig(enabled=True, a_bits=bits))
    t = tmod(TL.QTensor(_t(codes), _t(scale), _t(zp)),
             {"qconst": {"q": {k: _t(np.asarray(v)) for k, v in qc.items()}}},
             QueueMasks([drawn[0][None]]))
    assert isinstance(t, TL.SampleQTensor) and t.codes.shape == (1,) + shape
    np.testing.assert_array_equal(t.codes.numpy()[0], np.asarray(j.codes))
    assert t.scale.dtype == torch.float32
    assert float(t.scale) == float(j.scale)
    assert 0 < drawn[0].mean() < 1
    if ms >= 2.0:
        assert not t.codes.numpy().any()     # the mask rounds to the zp
    else:
        assert t.codes.numpy().any()


B_FLAG, S_FLAG = 256, 100      # the flagship's eval batch and samples


@pytest.mark.parametrize("shape", [s for s in CONV_SHAPES if not s[6]],
                         ids=[s[0] for s in CONV_SHAPES if not s[6]])
def test_shared_weight_plan_by_shape(shape):
    """Per-sample x (S, B, H, W, cin) with shared weights at the flagship
    shapes: the 3x3 convs keep the halo body, the 1x1 convs the pixel body,
    whose shared memory now holds one weight slice for every group."""
    _name, cin, cout, k, stride, hw, _shared, _n = shape
    x = torch.zeros((2, 1, hw, hw, cin), dtype=torch.int8)
    w = torch.zeros((k, k, cin, cout), dtype=torch.int8)
    plan = IC.conv_plan(x, w, (stride, stride), [(k // 2, k // 2)] * 2)
    x_align = IC._align(x.data_ptr(), (hw * hw * cin, hw * cin, cin,
                                       hw * hw * cin))
    per_sample_w = IC.plan_conv(hw, hw, cin, cout, k, k, stride, k // 2,
                                False, x_align, 16)
    assert plan.design == per_sample_w.design == (
        "halo" if k == 3 else "pixel"), plan.reason
    if plan.design == "pixel":
        assert plan.smem_bytes == IC.pixel_smem(plan.bm, plan.bn, plan.kc,
                                                plan.sg, plan.pitch, 1)
        assert plan.smem_bytes <= IC._PIXEL_SMEM[plan.nt]
        assert plan.sg >= per_sample_w.sg
    else:
        assert plan == per_sample_w


def test_shared_input_and_weights_plan_the_stem_once():
    """The MC-Dropout stem: no sample axis and one set of weights, one
    launch of one sample (cin 3: the im2col body); the 3x3 and 1x1 convs
    of a pointwise forward take the per-sample plans at S=1."""
    for hw, cin, cout, k, stride, design in [(32, 3, 24, 3, 1, "im2col"),
                                             (32, 24, 24, 3, 1, "halo"),
                                             (32, 24, 48, 1, 2, "pixel")]:
        x = torch.zeros((256, hw, hw, cin), dtype=torch.int8)
        w = torch.zeros((k, k, cin, cout), dtype=torch.int8)
        plan = IC.conv_plan(x, w, (stride, stride), [(k // 2, k // 2)] * 2)
        assert plan.design == design, plan.reason
        grid = IC.launch_grid(plan, 256 * (hw // stride) ** 2, 1, cout)
        assert 1 in (grid[0], grid[2])


def test_grid_keeps_the_samples_off_the_pixel_tiles():
    """B=256, S=100, 32x32: the samples on the kernel's sample axis leave
    1024 tiles of 256 pixels per sample to the halo body; folded into the
    batch, 25,600 images would need 102,400, past the 65,535 CUDA allows
    in y (the pixel body puts its tiles in x)."""
    m, refused = B_FLAG * 32 * 32, []
    for shape in [s for s in CONV_SHAPES if not s[6] and s[5] == 32]:
        _name, cin, cout, k, stride, hw, _sh, _n = shape
        x = torch.zeros((2, 1, hw, hw, cin), dtype=torch.int8)
        w = torch.zeros((k, k, cin, cout), dtype=torch.int8)
        plan = IC.conv_plan(x, w, (stride, stride), [(k // 2, k // 2)] * 2)
        mo = m // (stride * stride)
        grid = IC.launch_grid(plan, mo, S_FLAG, cout)
        assert max(grid[1:]) <= 65535 and grid[0] <= 2 ** 31 - 1
        if plan.design == "pixel":      # pixel tiles ride x, samples z
            assert grid[0] == mo // plan.bm
            continue
        assert grid == (S_FLAG, mo // plan.bm, cout // plan.bn)
        if mo * S_FLAG // plan.bm > 65535:
            with pytest.raises(ValueError, match="limit"):
                IC.launch_grid(plan, mo * S_FLAG, 1, cout)
            refused.append(shape[0])
    assert refused == ["stage0 3x3"]


def _struct_fields():
    """QbnConvArgs's field names, in order, from csrc/int_conv.cu."""
    src = (Path(IC.__file__).parent.parent / "csrc" / "int_conv.cu")
    body = re.search(r"struct QbnConvArgs \{(.*?)\n\};", src.read_text(),
                     re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [n.strip().lstrip("*") for n in
                      decl.split(None, 1)[1].replace("*", " ").split(",")]
    return [n.split()[-1] for n in names]


def test_args_follow_the_kernel_struct():
    """The ctypes arguments are QbnConvArgs field for field, the weight
    sample stride right after the weight pointer."""
    fields = _struct_fields()
    assert fields == [n for n, _t in IC._Args._fields_]
    assert fields[fields.index("w") + 1] == "w_ss"


@pytest.mark.parametrize("shared", [True, False], ids=["shared_w", "per_w"])
def test_weight_sample_stride_in_the_arguments(shared):
    """What the kernel reads for S=3 samples of (B, H, W, cin) codes: a
    weight sample stride of 0 for one set of weights, K * cout for
    per-sample weights; the sample count and the activations' and
    outputs' sample strides either way."""
    s, b, h, cin, cout = 3, 2, 8, 24, 24
    x = torch.zeros((s, b, h, h, cin), dtype=torch.int8)
    w = torch.zeros(((3, 3, cin, cout) if shared else
                     (s, 3, 3, cin, cout)), dtype=torch.int8)
    out = torch.zeros((s, b, h, h, cout), dtype=torch.int8)
    args, plan = IC.conv_args(
        x, IC._sample_strides(b, h, h, cin), (b, h, h, cin), w, s, 1, 1,
        (h, h), out, IC._sample_strides(b, h, h, cout))
    assert args.w_ss == (0 if shared else 9 * cin * cout)
    assert (args.S, args.x_ss, args.o_ss) == (s, b * h * h * cin,
                                               b * h * h * cout)
    assert args.w == w.data_ptr() and plan.design == "halo"
