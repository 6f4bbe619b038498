"""The ImageNet ResNet-50 v1.5 (models/architectures.py ImageNetResNet,
Bottleneck) against its plain reference (qbn_tpu_torch/reference/
resnet50.py), on the CPU at a tiny size: widths (4, 4, 8, 8) x 4 and, so
that the deeper convs take the window-sum correction (K > 520), (4, 4, 8,
64) x 4; blocks [1, 1, 1, 1]; 32 x 32 images through the 7x7/2 stem and
the padded 3x3/2 pool; B=2, S=3; the port's init, QAT pass and convert.

- The INT8 Bayes-by-backprop predictive on the same drawn codes: the
  codes after the stem and its pool, after each stage and after the pool
  (at the wider widths, from stage 3 on), and each sample's
  probabilities, bitwise the reference's.
- The float forward on the same noise within float32 rounding of the
  reference: the two sum each conv in another order (channels-last
  library convs against NCHW ones) and take batch norm as a multiply by
  rsqrt against a divide by sqrt, each a rounding of about 6e-8 relative,
  which the 18 layers carry to about 1e-6; 1e-5 relative leaves a
  decade.
- The converted state: every conv and the head stochastic, an add grid
  per block.
- The route: one residual epilogue per block and no eager add, bitwise
  the blocks composed from ConvBlock then ResidualAdd.
- The padded int max pool equals the float pool of the dequantised codes,
  edges included, in every code layout.
- `normalize("imagenet")` uses torchvision's constants.
- `plan_conv` gives every ResNet-18 and LeNet shape the plan it had
  before the ResNet-50 (a snapshot), and every ResNet-50 shape its im2col
  body.
"""

import functools
import zlib

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.data import datasets as D
from qbn_tpu_torch.evaluation.mc import (
    PosteriorDraw, mc_predict, presample_plan)
from qbn_tpu_torch.models import factory
from qbn_tpu_torch.models import layers as TL
from qbn_tpu_torch.models.architectures import (
    CUTS, Bottleneck, ImageNetResNet)
from qbn_tpu_torch.ops import int_conv as ic
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.reference import resnet50 as R
from qbn_tpu_torch.utils import apply_model, convert_model, init_variables

B, S, HW = 2, 3, 32
BOUNDS = (0, 127)
ARCHS = {"w8": [4, 4, 8, 8], "w64": [4, 4, 8, 64]}


def _arch(widths):
    return {"widths": widths, "blocks": [1, 1, 1, 1], "input": [HW, HW, 3],
            "classes": 10}


def _model(widths, **kw):
    return ImageNetResNet(output_size=10, widths=tuple(widths),
                          num_blocks=(1, 1, 1, 1), **kw)


def _widened(tree, factor):
    return {k: _widened(t, factor) if isinstance(t, dict)
            else t * factor if k == "kernel" else t
            for k, t in tree.items()}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Tensors this small run faster on one intra-op thread, and leave the
    cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def bbb(name):
    """(arch, model, converted state, images, drawn codes) at ARCHS[name]:
    init (the kernels widened from BBB's U(-0.01, 0.01) so that the signal
    reaches the head), a QAT pass that fits the observers, convert, a
    seeded draw."""
    widths = ARCHS[name]
    model = _model(widths, stochastic=True, quant=QuantConfig(enabled=True))
    g = torch.Generator().manual_seed(5)
    x = torch.rand((B, HW, HW, 3), generator=g)
    v = tree_map(torch.Tensor.detach, init_variables(
        model, g, (HW, HW, 3), "cpu", quantized=True))
    v["params"] = _widened(v["params"], 10.0)
    with torch.no_grad():
        _o, _kl, v = apply_model(model, v, x, train=False, mode="qat",
                                 update_stats=True, noise=GeneratorNoise(g),
                                 masks=BernoulliMasks(g, 1))
    state = convert_model(model, v, x)
    sampled = PosteriorDraw(state, S)(torch.Generator().manual_seed(9))
    return _arch(widths), model, state, x, sampled


def _by_path(tree, path=()):
    out = {}
    for k, v in tree.items():
        if k == "w":
            out[path] = v
        else:
            out.update(_by_path(v, path + (k,)))
    return out


def _reference(arch, state, x, sampled, up_to, i):
    qc, codes = state["qconst"], _by_path(sampled)

    def weights(path):
        q = R._node(qc, path)["q"]
        return codes[path][i], q["add_scale"], q["add_zp"]
    return R.sample_codes(qc, x, arch, BOUNDS, weights, up_to)


# every cut at w8; at w64 the cuts past stage 3's K > 520 convs
@pytest.mark.parametrize("name, cut", [("w8", c) for c in CUTS + (None,)]
                         + [("w64", "stage3"), ("w64", None)])
def test_int_predictive_bitwise_against_the_reference(name, cut):
    arch, model, state, x, sampled = bbb(name)
    with torch.no_grad():
        got = mc_predict(model, state, x, samples=S, presampled=sampled,
                         up_to=cut)
        want = [_reference(arch, state, x, sampled, cut, i)
                for i in range(S)]
    if cut is None:
        for i in range(S):
            np.testing.assert_array_equal(
                got[i].numpy(), torch.softmax(want[i], dim=-1).numpy())
        return
    assert got.s == S
    codes = got.codes
    if cut != "pool":       # merged (B, H, W, S*C) -> per sample
        codes = codes.reshape(*codes.shape[:3], S, -1).movedim(3, 1)
    for i in range(S):
        np.testing.assert_array_equal(codes[:, i].numpy(), want[i].numpy())
    assert len(torch.unique(codes)) > 8       # the signal is alive


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_predictive_mean_bitwise(name):
    arch, model, state, x, sampled = bbb(name)
    from qbn_tpu_torch.evaluation.mc import aggregate
    with torch.no_grad():
        got = aggregate(mc_predict(model, state, x, samples=S,
                                   presampled=sampled))
        want = R.predictive(state["qconst"], x, arch, BOUNDS,
                            _by_path(sampled), S)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_converted_state(name):
    arch, model, state, _x, sampled = bbb(name)
    plan = presample_plan(state)
    blocks = R.blocks(arch)
    shortcuts = sum(sc for *_n, sc in blocks)
    assert len(plan) == 1 + 3 * len(blocks) + shortcuts + 1
    assert all(sum(v.shape) > 0 for v in _by_path(sampled).values())
    for name, *_r in blocks:
        add = state["qconst"][name]["add"]["q"]
        assert float(add["scale"]) > 0 and 0 <= int(add["zp"]) <= 127


class Calls:
    """The model's `int_conv_merged` calls (whether each carried a
    residual) and its eager adds, from its making to the test's end."""

    def __init__(self, monkeypatch):
        self.merged, self.adds = [], 0
        real_merged, real_add = TL.int_conv_merged, \
            TL.ResidualAdd._int_forward

        def merged(*args, **kwargs):
            self.merged.append(kwargs.get("residual") is not None)
            return real_merged(*args, **kwargs)

        def add(module, *args):
            self.adds += 1
            return real_add(module, *args)
        monkeypatch.setattr(TL, "int_conv_merged", merged)
        monkeypatch.setattr(TL.ResidualAdd, "_int_forward", add)


def eager_block_forward(self, x, variables, masks=None, *, mode="int",
                        **_kw):
    """A Bottleneck in int mode composed from ConvBlock then
    ResidualAdd: the add as a pass of its own."""
    def conv(name, inp):
        return getattr(self, name)(inp, TL.scope(variables, name), mode=mode)
    out = conv("conv_2", conv("conv_1", conv("conv_0", x)))
    shortcut = x if self.shortcut is None else conv("shortcut", x)
    return self.add(out, shortcut, TL.scope(variables, "add"))


@pytest.mark.parametrize("cut", ["stage1", None])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_adds_run_in_the_last_conv_epilogue(name, monkeypatch, cut):
    arch, model, state, x, sampled = bbb(name)
    n_blocks = len(R.blocks(arch))
    calls = Calls(monkeypatch)
    with torch.no_grad():
        got = mc_predict(model, state, x, samples=S, presampled=sampled,
                         up_to=cut)
        if cut is None:
            assert sum(calls.merged) == n_blocks and calls.adds == 0
            assert len(calls.merged) == 1 + 3 * n_blocks + sum(
                sc for *_n, sc in R.blocks(arch))
        monkeypatch.setattr(Bottleneck, "forward", eager_block_forward)
        want = mc_predict(model, state, x, samples=S, presampled=sampled,
                          up_to=cut)
    got = got if cut is None else got.codes
    want = want if cut is None else want.codes
    np.testing.assert_array_equal(got.numpy(), want.numpy())


class ReplayNoise:
    """Normals from a seeded generator, handed out in call order; the
    same seed gives the same sequence to the port and the reference."""

    def __init__(self, seed):
        self.g = torch.Generator().manual_seed(seed)

    def __call__(self, shape, device=None):
        return torch.randn(tuple(shape), generator=self.g)


def _float_state(model, seed):
    g = torch.Generator().manual_seed(seed)
    v = tree_map(torch.Tensor.detach, init_variables(
        model, g, (HW, HW, 3), "cpu"))
    v["params"] = _widened(v["params"], 10.0)

    def jitter(tree):
        out = {}
        for k, t in tree.items():
            if isinstance(t, dict):
                out[k] = jitter(t)
            elif k in ("bn_scale", "var"):
                out[k] = 0.5 + torch.rand(t.shape, generator=g)
            elif k in ("bn_bias", "mean"):
                out[k] = 0.1 * torch.randn(t.shape, generator=g)
            elif k == "std":        # noise that moves the output
                out[k] = torch.full_like(t, -4.0)
            else:
                out[k] = t
        return out
    v["params"], v["batch_stats"] = jitter(v["params"]), jitter(
        v["batch_stats"])
    return v


@pytest.mark.parametrize("widths", sorted(ARCHS))
def test_float_forward_within_rounding_of_the_reference(widths):
    model = _model(ARCHS[widths], stochastic=True)
    v = _float_state(model, 3)
    x = torch.rand((B, HW, HW, 3), generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        got = model(x, v, mode="float", train=False, noise=ReplayNoise(8))
        want = R.float_forward(v["params"], v["batch_stats"], x,
                               _arch(ARCHS[widths]), ReplayNoise(8))
    assert float(got.max()) < 0.99          # not saturated
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("layout", ["shared", "merged", "samples"])
@pytest.mark.parametrize("hw", [7, 8])
def test_padded_int_max_pool_is_the_float_pool(layout, hw):
    g = torch.Generator().manual_seed(hw)
    shape = {"shared": (2, hw, hw, 5), "merged": (2, hw, hw, 3 * 5),
             "samples": (3, 2, hw, hw, 5)}[layout]
    codes = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
    scale = torch.tensor(0.03)
    x = {"shared": TL.QTensor, "merged": TL.MergedQTensor,
         "samples": TL.SampleQTensor}[layout](codes, scale,
                                              torch.tensor(3))
    got = TL.max_pool(x, 3, 2, 1)
    flat = codes.reshape(-1, hw, hw, shape[-1]).to(torch.float32) * scale
    want = torch.nn.functional.max_pool2d(flat.permute(0, 3, 1, 2), 3, 2, 1)
    want = want.permute(0, 2, 3, 1).reshape(*shape[:-3], *want.shape[2:],
                                            shape[-1])
    assert type(got) is type(x) and got.codes.is_contiguous()
    np.testing.assert_array_equal(
        (got.codes.to(torch.float32) * scale).numpy(), want.numpy())
    # the float path pads alike
    fl = TL.max_pool(flat, 3, 2, 1)
    np.testing.assert_array_equal(
        fl.reshape(want.shape).numpy(), want.numpy())


def test_normalize_imagenet_uses_torchvision_constants():
    x = torch.rand((2, 4, 4, 3), generator=torch.Generator().manual_seed(1))
    mean = torch.tensor([0.485, 0.456, 0.406])
    inv_std = 1.0 / torch.tensor([0.229, 0.224, 0.225])
    np.testing.assert_array_equal(D.normalize(x, "imagenet").numpy(),
                                  ((x - mean) * inv_std).numpy())
    np.testing.assert_array_equal(D.normalize(x, None).numpy(), x.numpy())


def test_factory_builds_every_method():
    for suffix, method in (("", "pointwise"), ("_mc", "mcdropout"),
                           ("_bbb", "bbb"), ("_sgld", "sgld")):
        cfg = Config(model=f"conv_resnet50{suffix}", output_size=1000,
                     input_size=(224, 224, 3))
        model = factory.build_model(cfg)
        assert isinstance(model, ImageNetResNet) and model.method == method
        assert model.stochastic == (method == "bbb")
        assert (model.dropout_p > 0) == (method == "mcdropout")
        assert [len(n) for n in model.stages] == [3, 4, 6, 3]
        assert model.fc.features == 1000


# plan_conv's plans at every conv shape of the CIFAR ResNet-18 and the
# LeNet, as merged (S = 1, 20, 100) and shared-weight calls (B = 1, 256)
# align them: (plan_conv's arguments), (design, bm, nt, mt, wn, n_img,
# rows, h_in, w_in, pitch, vx, kc, ring, halo_bytes, smem_bytes, sg, crc32
# of the koff and pixoff tables)
PLANS = [
    ((32, 32, 3, 24, 3, 3, 1, 1, True, 1, 16, False),
     ('pixel', 128, 3, 1, 1, 0, 0, 0, 0, 48, 0, 32, 0, 0, 52992, 10,
      132773995)),
    ((32, 32, 3, 24, 3, 3, 1, 1, False, 1, 16, True),
     ('im2col', 128, 3, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 132773995)),
    ((32, 32, 24, 24, 3, 3, 1, 1, False, 8, 16, False),
     ('halo', 256, 3, 2, 1, 1, 8, 10, 34, 48, 8, 224, 1, 16320, 30752, 0,
      2538090411)),
    ((32, 32, 24, 24, 3, 3, 1, 1, False, 8, 16, True),
     ('halo', 256, 3, 2, 1, 1, 8, 10, 34, 48, 8, 224, 1, 16320, 30752, 0,
      2538090411)),
    ((32, 32, 24, 48, 3, 3, 2, 1, False, 8, 16, False),
     ('halo', 256, 6, 2, 1, 1, 16, 33, 33, 24, 8, 224, 1, 26136, 51712, 0,
      257526061)),
    ((32, 32, 24, 48, 3, 3, 2, 1, False, 8, 16, True),
     ('halo', 256, 6, 2, 1, 1, 16, 33, 33, 24, 8, 224, 1, 26136, 51712, 0,
      257526061)),
    ((32, 32, 24, 48, 1, 1, 2, 0, False, 8, 16, False),
     ('pixel', 128, 6, 1, 1, 0, 0, 0, 0, 112, 8, 32, 0, 0, 52736, 4,
      132773995)),
    ((32, 32, 24, 48, 1, 1, 2, 0, False, 8, 16, True),
     ('pixel', 128, 6, 1, 1, 0, 0, 0, 0, 144, 8, 32, 0, 0, 56064, 5,
      132773995)),
    ((16, 16, 48, 48, 3, 3, 1, 1, False, 16, 16, False),
     ('halo', 256, 6, 2, 1, 1, 16, 18, 18, 48, 16, 448, 1, 15552, 62848, 0,
      3145147792)),
    ((16, 16, 48, 48, 3, 3, 1, 1, False, 16, 16, True),
     ('halo', 256, 6, 2, 1, 1, 16, 18, 18, 48, 16, 448, 1, 15552, 62848, 0,
      3145147792)),
    ((16, 16, 48, 96, 3, 3, 2, 1, False, 16, 16, False),
     ('halo', 128, 12, 2, 2, 2, 8, 17, 17, 56, 8, 128, 2, 32368, 72752, 0,
      2529678165)),
    ((16, 16, 48, 96, 3, 3, 2, 1, False, 16, 16, True),
     ('halo', 128, 12, 2, 2, 2, 8, 17, 17, 56, 8, 128, 2, 32368, 72752, 0,
      2529678165)),
    ((16, 16, 48, 96, 1, 1, 2, 0, False, 16, 16, False),
     ('pixel', 128, 12, 1, 1, 0, 0, 0, 0, 112, 16, 64, 0, 0, 58880, 2,
      132773995)),
    ((16, 16, 48, 96, 1, 1, 2, 0, False, 16, 16, True),
     ('pixel', 128, 12, 1, 1, 0, 0, 0, 0, 176, 16, 64, 0, 0, 71680, 3,
      132773995)),
    ((8, 8, 96, 96, 3, 3, 1, 1, False, 16, 16, False),
     ('halo', 128, 12, 2, 2, 2, 8, 10, 10, 112, 16, 128, 2, 22400, 63200, 0,
      3443618727)),
    ((8, 8, 96, 96, 3, 3, 1, 1, False, 16, 16, True),
     ('halo', 128, 12, 2, 2, 2, 8, 10, 10, 112, 16, 128, 2, 22400, 63200, 0,
      3443618727)),
    ((8, 8, 96, 192, 3, 3, 2, 1, False, 16, 16, False),
     ('halo', 128, 12, 2, 2, 8, 4, 9, 9, 112, 16, 128, 2, 72576, 113376, 0,
      2517776234)),
    ((8, 8, 96, 192, 3, 3, 2, 1, False, 16, 16, True),
     ('halo', 128, 12, 2, 2, 8, 4, 9, 9, 112, 16, 128, 2, 72576, 113376, 0,
      2517776234)),
    ((8, 8, 96, 192, 1, 1, 2, 0, False, 16, 16, False),
     ('pixel', 128, 12, 1, 1, 0, 0, 0, 0, 112, 16, 96, 0, 0, 41984, 1,
      132773995)),
    ((8, 8, 96, 192, 1, 1, 2, 0, False, 16, 16, True),
     ('pixel', 128, 12, 1, 1, 0, 0, 0, 0, 208, 16, 96, 0, 0, 66560, 2,
      132773995)),
    ((4, 4, 192, 192, 3, 3, 1, 1, False, 16, 16, False),
     ('halo', 128, 12, 2, 2, 8, 4, 6, 6, 208, 16, 128, 2, 59904, 101568, 0,
      1638811881)),
    ((4, 4, 192, 192, 3, 3, 1, 1, False, 16, 16, True),
     ('halo', 128, 12, 2, 2, 8, 4, 6, 6, 208, 16, 128, 2, 59904, 101568, 0,
      1638811881)),
    ((28, 28, 1, 20, 5, 5, 1, 2, True, 1, 16, False),
     ('im2col', 128, 3, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 132773995)),
    ((28, 28, 1, 20, 5, 5, 1, 2, False, 1, 16, True),
     ('im2col', 128, 3, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 132773995)),
    ((14, 14, 20, 50, 5, 5, 1, 2, False, 4, 16, False),
     ('im2col', 128, 12, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 132773995)),
    ((14, 14, 20, 50, 5, 5, 1, 2, False, 4, 16, True),
     ('im2col', 128, 12, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 132773995)),
]


def _plan_id(key):
    h, w, cin, cout, kh, _kw, st, _pad, shared_x, x_align, _wa, shared_w = key
    return (f"{h}x{w}x{cin}-{cout}-{kh}x{kh}/{st}-a{x_align}"
            + "-shared_x" * shared_x + "-shared_w" * shared_w)


@pytest.mark.parametrize("key, want", PLANS,
                         ids=[_plan_id(k) for k, _w in PLANS])
def test_the_resnet18_and_lenet_shapes_keep_their_plan(key, want):
    p = ic.plan_conv(*key)
    got = (p.design, p.bm, p.nt, p.mt, p.wn, p.n_img, p.rows, p.h_in,
           p.w_in, p.pitch, p.vx, p.kc, p.ring, p.halo_bytes, p.smem_bytes,
           p.sg, zlib.crc32(repr((p.koff, p.pixoff)).encode()))
    assert got == want


def test_every_resnet50_conv_takes_the_im2col_body():
    """At B=256, S=20 in the merged layout: the stem (shared input, K =
    147) on the im2col body, the 52 1x1 and 3x3 convs of 64..2048
    channels, which the halo and pixel bodies decline, on the wide body."""
    model = factory.build_model(Config(model="conv_resnet50_bbb",
                                       output_size=1000))
    assert sum(isinstance(m, TL.ConvBlock) for m in model.modules()) == 53
    shapes = [(224, 3, 64, 7, 2, 3, True)]
    cin, hw = 64, 56
    for planes, blocks, stride in zip((64, 128, 256, 512), (3, 4, 6, 3),
                                      (1, 2, 2, 2)):
        for b in range(blocks):
            st = stride if b == 0 else 1
            shapes += [(hw, cin, planes, 1, 1, 0, False),
                       (hw, planes, planes, 3, st, 1, False)]
            ho = (hw - 1) // st + 1
            shapes.append((ho, planes, 4 * planes, 1, 1, 0, False))
            if b == 0:
                shapes.append((hw, cin, 4 * planes, 1, st, 0, False))
            cin, hw = 4 * planes, ho
    assert len(shapes) == 53
    designs = []
    for h, ci, co, k, st, pad, shared in shapes:
        c = ci if shared else 20 * ci
        strides = (h * h * c, h * c, c, 0 if shared else ci)
        plan = ic.plan_conv(h, h, ci, co, k, k, st, pad, shared,
                            ic._align(0, strides), 16)
        designs.append(plan.design)
        want = "im2col" if shared else "wide"
        assert plan.design == want, (h, ci, co, k, plan.reason)
    assert designs.count("wide") == 52 and designs[0] == "im2col"


def test_sixteen_epilogues_and_the_max_pool_span_a_forward(monkeypatch):
    """At the published depth ([3, 4, 6, 3], tiny widths): one residual
    epilogue per block, 16 a forward, no eager add, and the stem's max
    pool a span `op.max_pool` while the recorder is on."""
    from qbn_tpu_torch import profiling
    model = ImageNetResNet(output_size=10, widths=(4, 4, 8, 8),
                           stochastic=True, quant=QuantConfig(enabled=True))
    g = torch.Generator().manual_seed(2)
    x = torch.rand((1, HW, HW, 3), generator=g)
    v = tree_map(torch.Tensor.detach, init_variables(
        model, g, (HW, HW, 3), "cpu", quantized=True))
    state = convert_model(model, v, x)
    calls = Calls(monkeypatch)
    profiling.start()
    try:
        with torch.no_grad():
            mc_predict(model, state, x, samples=2,
                       generator=torch.Generator().manual_seed(1))
    finally:
        spans = profiling.stop()
    assert sum(calls.merged) == 16 and calls.adds == 0
    assert len(calls.merged) == 53
    assert [s.name for s in spans].count("op.max_pool") == 1
