"""The MC-Dropout site of INT8 evaluation (ops/dropout_site.py).

On the CPU, without a card: a model of csrc/dropout_site.cu in PyTorch and
numpy (its 2 x 256 table built entry by entry with the kernel's float32
operations, then the launch's plan walked item by item, thread by thread,
with the kernel's indexing of codes, mask and output) bitwise against the
plain version, at activation bits 7 down to 3, several site grids, shared
and per-sample 4-D inputs, dense inputs and channel counts that take every
vector width; and the plan's invariants at the ResNet-18's, LeNet's and
MLP's site shapes.

Marked `card` (skipped without an NVIDIA card; on the card machine, which
has no JAX, run with `python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_dropout_site.py`): the kernel bitwise against the plain
version at the 20 site shapes of the MC-Dropout ResNet-18 at S=20 and
B=256 and 16, and at the LeNet's and MLP's; 20 launches for one batch of
`evaluate`; the refusal of inputs it does not take.

This file imports no JAX. The outputs are int8 codes: no tolerance.
"""

import zlib

import numpy as np
import pytest
import torch

from chip_smoke import SITE_SHAPES
from qbn_tpu_torch.ops import dropout_site as DS

F32 = torch.float32
P_DROP = 0.15


def kernel_table(xs, ms, mz, a_lo, a_hi):
    """The kernel's shared-memory table, entry e of 512 as its loop builds
    it: code int8(e & 255), mask 1.0 from e = 256 on, each operation a
    float32 operation rounded alone."""
    e = torch.arange(512)
    m = (e >= 256).to(F32)
    code = (e & 255).to(torch.int8).to(F32)
    mzf = mz.to(F32)
    mask_q = torch.clamp(torch.round(m / ms) + mzf, 0.0, 255.0)
    mask_deq = (mask_q - mzf) * ms
    prod = (code * xs) * mask_deq
    q = torch.clamp(torch.round(prod / ms) + mzf, float(a_lo), float(a_hi))
    return (q.to(torch.int32) - mz.to(torch.int32)).to(torch.int8)


def kernel_model(x, mask, xs, ms, mz, a_lo, a_hi, x_align=16):
    """The kernel's output codes: the plan's items, threads and vectors,
    each code looked up in `kernel_table` at (mask row, code & 255)."""
    plan = DS.site_plan(x.shape, mask.shape, x_align)
    table = kernel_table(xs, ms, mz, a_lo, a_hi).numpy()
    xb = x.numpy().reshape(-1).view(np.uint8).astype(np.int64)
    mf = mask.numpy().reshape(-1)
    vec, c = plan.vec, plan.channels
    out = np.zeros(plan.samples * plan.batch * plan.pixels * c, np.int64)
    written = np.zeros(out.shape, np.int64)
    t = np.arange(plan.threads)
    c0 = (t % plan.vpp) * vec
    w = (t[None, :] + plan.threads * np.arange(DS._ITEMS)[:, None])
    byte = np.arange(vec)
    for item in range(plan.items):
        row, k = divmod(item, plan.chunks)
        start = k * plan.chunk_len
        ok = w < min(plan.chunk_len, plan.nvr - start)
        codes = xb[((row * plan.nvr + start + w[..., None]) * vec
                    + byte)[ok]]
        for s in range(plan.samples if plan.shared else 1):
            r = s * plan.batch + row if plan.shared else row
            keep = mf[r * c + c0[:, None] + byte] != 0   # (threads, vec)
            rows = np.broadcast_to(keep, w.shape + (vec,))[ok]
            dst = ((r * plan.nvr + start + w[..., None]) * vec + byte)[ok]
            out[dst] = table[codes | (rows.astype(np.int64) << 8)]
            written[dst] += 1
    assert (written == 1).all(), "the plan writes each output code once"
    shape = (plan.samples, *x.shape) if plan.shared else tuple(x.shape)
    return torch.from_numpy(out.astype(np.int8).reshape(shape))


# a layout: ((batch, *per-image shape), input shared by every sample)
LAYOUTS = {
    "stem-shared": ((6, 4, 4, 24), True),
    "stage0-c24": ((6, 4, 4, 24), False),
    "stage1-c48": ((6, 4, 4, 48), False),
    "lenet-c50": ((3, 3, 3, 50), False),
    "c10": ((3, 4, 4, 10), False),
    "ragged-b16": ((16, 2, 2, 96), False),
    "dense-sample": ((5, 500), False),
    "dense-shared": ((7, 100), True),
    "dense-c9": ((5, 9), False),
}
# (id, activation bits, x_scale, mul_scale, mul_zp, layout); a float
# mul_zp is passed as a float32 zero point
CASES = [
    ("a7-stem", 7, 0.0794982761, 0.0757, 19, "stem-shared"),
    ("a7-stage0", 7, 0.05, 0.0311, 2, "stage0-c24"),
    ("a7-stage1", 7, 0.1874899715, 0.2201, 0, "stage1-c48"),
    ("a7-ragged", 7, 0.0311, 0.0292, 7, "ragged-b16"),
    ("a7-dense", 7, 0.0421, 0.0438, 3, "dense-sample"),
    ("a6-dense-shared", 6, 0.11, 0.0943, 5, "dense-shared"),
    ("a6-c10", 6, 0.09, 0.105, 1, "c10"),
    ("a5-lenet", 5, 0.2, 0.173, 4, "lenet-c50"),
    ("a5-c9", 5, 0.3, 0.31, 0, "dense-c9"),
    ("a4-zp0", 4, 0.4, 0.3282, 0, "stage0-c24"),
    ("a4-rounds-to-zp", 4, 0.4, 4.031174, 0, "stem-shared"),
    ("a4-fine", 4, 0.3, 1.8284, 3, "stage1-c48"),
    ("a3-rounds-to-zp", 3, 0.8, 2.5, 1, "stage0-c24"),
    ("a3", 3, 0.8, 0.9, 2, "dense-sample"),
    ("a7-float-zp", 7, 0.05, 0.0311, 9.0, "c10"),
    ("a7-x-aligned-4", 7, 0.05, 0.0622, 11, "stage1-c48"),
]


def _site_inputs(case, samples=3):
    _id, bits, xs, ms, mz, layout = case
    (b, *feat), shared = LAYOUTS[layout]
    rng = np.random.default_rng(zlib.crc32(_id.encode()))
    lead = (b,) if shared else (samples, b)
    codes = torch.from_numpy(rng.integers(-128, 128, lead + tuple(feat))
                             .astype(np.int8))
    mfeat = tuple(feat) if len(feat) == 1 else (1,) * (len(feat) - 1) + (
        feat[-1],)
    mask = torch.from_numpy((rng.random((samples, b) + mfeat)
                             < 1 - P_DROP).astype(np.float32))
    zp = torch.tensor(mz, dtype=F32 if isinstance(mz, float) else
                      torch.int32)
    return codes, mask, torch.tensor(xs, dtype=F32), torch.tensor(
        ms, dtype=F32), zp, (0, (1 << bits) - 1)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_model_matches_plain(case):
    """The table over all 256 codes x both mask values, then the whole
    launch, bitwise the plain version; the output scale mul_scale *
    float32(1 / (1 - p))."""
    codes, mask, xs, ms, mz, (lo, hi) = _site_inputs(case)
    every = torch.arange(256).to(torch.int8).reshape(1, 1, 256)
    both = torch.tensor([0.0, 1.0]).reshape(2, 1, 1)
    want, _ = DS.dropout_site_plain(every, both, xs, ms, mz, lo, hi, 1.0)
    table = kernel_table(xs, ms, mz, lo, hi).reshape(2, 256)
    assert torch.equal(table, want.reshape(2, 256))
    assert not table[0].any()                # a dropped code goes to 0
    if float(ms) >= 2.0:                     # the kept mask rounds to zp
        assert not table.any()

    x_align = 4 if case[0].endswith("aligned-4") else 16
    got = kernel_model(codes, mask, xs, ms, mz, lo, hi, x_align)
    out, scale = DS.dropout_site(codes, mask, xs, ms, mz, lo, hi,
                                 1.0 / (1.0 - P_DROP))
    assert got.dtype == out.dtype == torch.int8
    assert torch.equal(got, out)
    assert out.shape == (mask.shape[0], *codes.shape[-(mask.ndim - 1):])
    assert scale.dtype == F32 and float(scale) == float(
        ms * torch.tensor(1.0 / (1.0 - P_DROP), dtype=F32))
    if float(ms) < 2.0:
        assert out.any()


# (x shape, mask shape) of the ResNet-18's sites at B=256, S=20, the
# LeNet's (28x28x20 shared, 14x14x50, dense 500) and the MLP's (dense 100,
# shared and per sample) at their batches
PLAN_SHAPES = [
    ((256, hw, hw, c) if shared else (20, 256, hw, hw, c),
     (20, 256, 1, 1, c)) for _n, hw, c, shared, _k in SITE_SHAPES] + [
    ((256, 28, 28, 20), (20, 256, 1, 1, 20)),
    ((20, 256, 14, 14, 50), (20, 256, 1, 1, 50)),
    ((20, 256, 500), (20, 256, 500)),
    ((1000, 100), (100, 1000, 100)),
    ((100, 364, 100), (100, 364, 100))]


@pytest.mark.parametrize("shapes", PLAN_SHAPES,
                         ids=[f"{a}" for a, _b in PLAN_SHAPES])
def test_plan_covers_each_row_with_one_channel_group_a_thread(shapes):
    x_shape, mask_shape = shapes
    plan = DS.site_plan(x_shape, mask_shape)
    c = plan.channels
    assert plan.vec == next(v for v in (16, 8, 4, 2, 1) if c % v == 0)
    assert plan.vpp * plan.vec == c and plan.threads % plan.vpp == 0
    assert plan.vpp <= plan.threads <= 1024 and plan.threads <= max(
        256, plan.vpp)
    assert plan.chunk_len % plan.vpp == 0
    assert plan.chunk_len <= DS._ITEMS * plan.threads
    assert plan.chunks * plan.chunk_len >= plan.nvr > (
        plan.chunks - 1) * plan.chunk_len
    rows = plan.batch * (1 if plan.shared else plan.samples)
    assert plan.items == rows * plan.chunks < 2 ** 31
    assert 1 <= plan.blocks <= plan.items
    assert plan.shared == (len(x_shape) == len(mask_shape) - 1)


def test_geometry_refuses_shapes_that_make_no_site():
    with pytest.raises(ValueError, match="do not make a site"):
        DS.site_geometry((3, 4, 4, 4, 8), (3, 4, 1, 1, 6))
    with pytest.raises(ValueError, match="do not make a site"):
        DS.site_geometry((2, 4, 4, 4, 8), (3, 4, 1, 1, 8))
    with pytest.raises(ValueError, match="do not make a site"):
        DS.site_geometry((4, 4, 4, 8), (3, 4, 1, 2, 8))


# -- on the card --------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _card_site(x_shape, mask_shape, dev, seed, xs=0.0794982761, ms=0.0757,
               mz=19, bits=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(-128, 128, x_shape, generator=g, device=dev,
                          dtype=torch.int8)
    mask = (torch.rand(mask_shape, generator=g, device=dev)
            < 1 - P_DROP).to(F32)
    args = (codes, mask, torch.tensor(xs, dtype=F32, device=dev),
            torch.tensor(ms, dtype=F32, device=dev),
            torch.tensor(mz, dtype=torch.int32, device=dev), 0,
            (1 << bits) - 1, 1.0 / (1.0 - P_DROP))
    got, scale = DS.dropout_site(*args)
    want, want_scale = DS.dropout_site_plain(*args)
    assert torch.equal(got, want), f"codes {x_shape}"
    assert torch.equal(scale, want_scale)
    return got


@pytest.mark.card
@pytest.mark.parametrize("batch", [256, 16])
def test_card_kernel_matches_plain_at_resnet_sites(card, batch):
    before = DS.launches
    for i, (_name, hw, c, shared, _n) in enumerate(SITE_SHAPES):
        lead = (batch,) if shared else (20, batch)
        _card_site(lead + (hw, hw, c), (20, batch, 1, 1, c), card, i)
    assert DS.launches - before == len(SITE_SHAPES)


@pytest.mark.card
@pytest.mark.parametrize("shapes", PLAN_SHAPES[-5:],
                         ids=[f"{a}" for a, _b in PLAN_SHAPES[-5:]])
def test_card_kernel_matches_plain_at_lenet_and_mlp_sites(card, shapes):
    _card_site(*shapes, card, 7, bits=4, ms=0.3282, mz=0)
    _card_site(*shapes, card, 8)


@pytest.mark.card
def test_card_one_batch_takes_one_launch_a_site(card):
    import chip_smoke as cs
    from qbn_tpu_torch.config import Config
    from qbn_tpu_torch.evaluation.mc import evaluate
    from qbn_tpu_torch.models.factory import build_model, load_trained

    _cfg, _model, state = load_trained(cs.EXP, device="cuda")
    mc, _pw, _ens = cs.method_states(state, 0, card)
    model = build_model(Config(model="conv_resnet_mc", q=True, p=cs.MC_P))
    rng = np.random.default_rng(0)
    data = [(rng.random((16, 32, 32, 3), dtype=np.float32),
             rng.integers(0, 10, 16))]
    before = DS.launches
    evaluate(model, mc, data, 4, torch.Generator(device=card).manual_seed(1),
             card)
    assert DS.launches - before == sum(n for *_s, n in SITE_SHAPES)


@pytest.mark.card
def test_card_site_takes_any_layout_of_its_input(card):
    """BernoulliDropout hands the kernel contiguous codes, whatever layout
    the layer before it left: the same codes as the plain version."""
    from qbn_tpu_torch.config import QuantConfig
    from qbn_tpu_torch.models import layers as TL
    from qbn_tpu_torch.ops.stochastic import QueueMasks
    g = torch.Generator(device=card).manual_seed(3)
    codes = torch.randint(-128, 128, (4, 6, 8, 8), generator=g, device=card,
                          dtype=torch.int8).permute(0, 2, 3, 1)
    mask = (torch.rand((3, 4, 1, 1, 6), generator=g, device=card)
            < 1 - P_DROP).to(F32)
    zp = torch.tensor(19, dtype=torch.int32, device=card)
    qc = {"qconst": {"q": {"mul_scale": torch.tensor(0.0757, device=card),
                           "mul_zp": zp}}}
    site = TL.BernoulliDropout(P_DROP, QuantConfig(enabled=True, a_bits=7))
    x = TL.QTensor(codes, torch.tensor(0.0794982761, device=card), zp)
    assert not codes.is_contiguous()
    before = DS.launches
    out = site(x, qc, QueueMasks([mask]))
    want, _ = DS.dropout_site_plain(codes, mask, x.scale, qc["qconst"]["q"][
        "mul_scale"], zp, 0, 127, 1.0 / (1.0 - P_DROP))
    assert DS.launches - before == 1 and torch.equal(out.codes, want)


@pytest.mark.card
def test_card_refuses_inputs_it_does_not_take(card):
    f = lambda t: torch.tensor(t, dtype=F32, device=card)  # noqa: E731
    codes = torch.zeros((2, 4, 4, 4, 8), dtype=torch.int8, device=card)
    mask = torch.ones((2, 4, 1, 1, 8), device=card)
    zp = torch.tensor(3, dtype=torch.int32, device=card)
    q = (f(0.1), f(0.2), zp, 0, 127, 1.25)
    with pytest.raises(ValueError, match="not contiguous"):
        DS.dropout_site(codes.transpose(2, 3), mask, *q)
    with pytest.raises(TypeError, match="dtype"):
        DS.dropout_site(codes.to(torch.int32), mask, *q)
    with pytest.raises(TypeError, match="dtype"):
        DS.dropout_site(codes, mask.to(torch.float64), *q)
    with pytest.raises(ValueError, match="do not make a site"):
        DS.dropout_site(codes, mask[:, :, :, :, :4].contiguous(), *q)
