"""The int8 conv kernel's wide body (qbn_tpu_torch/ops/int_conv.py
plan_conv, _wide_plan; csrc/int_conv.cu int_conv_kernel_wide), on the CPU:
which shapes it takes (the ResNet-50's 52 non-stem convs) and which it
declines, with the reason; its shared memory, sample groups and grid; and a
numpy emulation of what the kernel reads: the weights as the transposing
pass writes them, each CTA's A tile gathered through the plan's table of
taps in 16-byte pieces (equal to F.unfold's columns), its stages' products
and window sums, which give the plain version's sums, and through the plain
epilogue bitwise its codes."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import R50_SHAPES
from qbn_tpu_torch.ops import int_conv as ic

B, S = 256, 20           # the ResNet-50 cell's eval batch and samples
WIDE_SHAPES = [sh for sh in R50_SHAPES if not sh[6]]


def _merged_plan(shape, b=B, s=S):
    """The plan int_conv_merged takes at a ResNet-50 shape in the merged
    layout (B, H, W, S*cin)."""
    _name, cin, cout, k, stride, hw, shared = shape[:7]
    c = cin if shared else s * cin
    strides = (hw * hw * c, hw * c, c, 0 if shared else cin)
    return ic.plan_conv(hw, hw, cin, cout, k, k, stride, k // 2, shared,
                        ic._align(0, strides), 16)


def test_fifty_two_wide_convs_a_forward():
    assert len(WIDE_SHAPES) == 22
    assert sum(sh[7] for sh in WIDE_SHAPES) == 52
    assert sum(sh[7] for sh in R50_SHAPES) == 53


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=[sh[0] for sh in
                                                    WIDE_SHAPES])
def test_resnet50_shapes_plan_wide(shape):
    """128 output pixels a CTA, 128 channels (64 at cout 64), a ring of 3
    stages of 128 K bytes (4 at 64 channels), two CTAs an SM; a table
    entry per 16-byte piece of K, padded to whole stages."""
    _name, cin, cout, k, stride, hw = shape[:6]
    plan = _merged_plan(shape)
    assert plan.design == "wide", plan.reason
    assert plan.bm == 128 and plan.kc == 128
    assert plan.bn == (64 if cout == 64 else 128)
    assert plan.ring == (4 if cout == 64 else 3)
    kk = k * k * cin
    assert len(plan.koff) == -(-kk // 128) * 8 and not plan.pixoff
    assert plan.smem_bytes == ic.wide_smem(plan.bn, plan.ring, kk)
    assert plan.ring * (plan.bm + plan.bn) * plan.kc >= plan.bm * (
        plan.bn + 16)               # the staged codes fit in the ring
    assert plan.smem_bytes <= ic.SMEM_TWO_CTAS
    # the same plan with one set of weights for every sample
    assert ic.plan_conv(hw, hw, cin, cout, k, k, stride, k // 2, False, 16,
                        16, True) == plan


def test_the_stem_keeps_the_im2col_body():
    stem = R50_SHAPES[0]
    assert stem[6]
    plan = _merged_plan(stem)
    assert plan.design == "im2col"
    assert "shared" in plan.reason


# one shape per condition the wide body declines: (plan_conv args, why)
DECLINED = [
    ((14, 14, 24, 64, 3, 3, 2, 1, False, 8, 16), "cin 24 is not a multiple"),
    ((14, 14, 64, 160, 1, 1, 2, 0, False, 16, 16), "160 output channels"),
    ((14, 14, 64, 128, 1, 1, 1, 0, False, 8, 16), "16-byte pieces"),
    ((14, 14, 64, 128, 1, 1, 1, 0, False, 16, 8), "16-byte pieces"),
    ((14, 14, 64, 64, 5, 5, 1, 2, False, 16, 16), "a 5x5 kernel"),
    ((14, 14, 64, 64, 3, 3, 3, 1, False, 16, 16), "stride 3"),
    ((14, 14, 64, 128, 1, 1, 1, 0, True, 16, 16), "shared by every sample"),
]


@pytest.mark.parametrize("args,why", DECLINED, ids=[w for _a, w in DECLINED])
def test_declined_shapes_keep_the_im2col_body(args, why):
    plan = ic.plan_conv(*args)
    assert plan.design == "im2col" and why in plan.reason, plan.reason
    assert plan.bn == 8 * ic._im2col_nt(args[3])


def test_resnet18_shapes_never_reach_the_wide_body():
    """Its 3x3 convs keep the halo body and its stem and shortcuts the
    pixel body: the wide body is tried only where both decline."""
    from chip_smoke import CONV_SHAPES
    for _n, cin, cout, k, stride, hw, shared, _c in CONV_SHAPES:
        c = cin if shared else 100 * cin
        strides = (hw * hw * c, hw * c, c, 0 if shared else cin)
        plan = ic.plan_conv(hw, hw, cin, cout, k, k, stride, k // 2, shared,
                            ic._align(0, strides), 16)
        assert plan.design in ("halo", "pixel")


@pytest.mark.parametrize("samples", [1, 3, 7, 20, 100, 65535])
def test_sample_groups_keep_the_weights_in_l2(samples):
    for shape in WIDE_SHAPES:
        _name, cin, cout, k = shape[:4]
        plan = _merged_plan(shape)
        sg = ic.wide_sample_group(plan, samples, cout)
        groups = -(-samples // sg)
        assert 1 <= sg <= samples and groups * sg - samples < groups
        assert sg == 1 or sg * 16 * len(plan.koff) * cout <= \
            ic._WIDE_GROUP_BYTES


def _grid_tiles(plan, m, samples, cout):
    """(sample, pixel tile, channel tile) of every CTA of a launch, decoded
    from (blockIdx.x, blockIdx.y) as int_conv_kernel_wide decodes them;
    CTAs past the last sample dropped, as the kernel returns."""
    gx, gy, gz = ic.launch_grid(plan, m, samples, cout)
    assert gz == 1
    sg = ic.wide_sample_group(plan, samples, cout)
    n_tiles = cout // plan.bn
    bx, by = np.meshgrid(np.arange(gx), np.arange(gy), indexing="ij")
    rest = bx // n_tiles
    s = by * sg + rest % sg
    keep = s < samples
    return s[keep], (rest // sg)[keep], (bx % n_tiles)[keep]


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=[sh[0] for sh in
                                                    WIDE_SHAPES])
def test_the_grid_covers_every_tile_once(shape):
    _name, cin, cout, k, stride, hw = shape[:6]
    plan = _merged_plan(shape)
    ho = (hw - 1) // stride + 1
    m = B * ho * ho
    s, mt, nt = _grid_tiles(plan, m, S, cout)
    m_tiles = -(-m // plan.bm)
    hits = np.zeros((S, m_tiles, cout // plan.bn), np.int64)
    np.add.at(hits, (s, mt, nt), 1)
    assert (hits == 1).all()


def test_the_grid_fits_at_the_largest_shape():
    """Stage 0: 802,816 output pixels a sample; and at 65,535 samples."""
    shape = next(sh for sh in WIDE_SHAPES if sh[0] == "stage0 1x1 64-256")
    plan = _merged_plan(shape)
    m = B * 56 * 56
    assert m == 802_816
    gx, gy, gz = ic.launch_grid(plan, m, S, 256)
    assert gx == 6272 * 2 * 20 and gy == 1 and gz == 1
    gx, gy, gz = ic.launch_grid(plan, m, 65535, 256)
    assert gx <= 2 ** 31 - 1 and gy <= 65535
    with pytest.raises(ValueError, match="in x"):   # 2^26 pixel tiles
        ic.launch_grid(plan, 2 ** 33, S, 256)


# -- a numpy emulation of the kernel --------------------------------------

def _transposed(w):
    """The weights as int_conv_kernel_wide_wt writes them: each CTA (k
    tile of 64, channel tile of 64, sample) and thread (k quad kq, channel
    quad nw) writes wt[n0 + 4 nw + j, k0 + 4 kq + e] = w[k0 + 4 kq + e,
    n0 + 4 nw + j], nothing past K. Every byte is written once."""
    s, kh, kw, cin, cout = w.shape
    kk = kh * kw * cin
    src = w.reshape(s, kk, cout)
    wt = np.zeros((s, cout, kk), np.int64)
    hits = np.zeros((s, cout, kk), np.int64)
    for k0 in range(0, kk, 64):
        for n0 in range(0, cout, 64):
            for kq in range(16):
                if k0 + 4 * kq >= kk:
                    continue
                for nw in range(16):
                    for j in range(4):
                        for e in range(4):
                            n, k = n0 + 4 * nw + j, k0 + 4 * kq + e
                            wt[:, n, k] = src[:, k, n]
                            hits[:, n, k] += 1
    assert (hits == 1).all()
    return wt


def _wide_emulate(x, w, stride, pad, plan, samples):
    """The wide body's sums, CTA by CTA over its grid: thread tid's pixel
    r = tid // 2 gathers 16-byte pieces 2 i + tid % 2 of each stage through
    the table of taps (zero outside the image, past M and past K), the B
    rows come from the transposed weights (zero past K), and a stage's
    products run for its k32 steps below K. Returns acc (B, Ho, Wo, S,
    cout), win (B, Ho, Wo, S) as int64 and sample 0's gathered rows (M, K)."""
    _s, kh, kw, cin, cout = w.shape
    b, h, wd = x.shape[:3]
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    m_all, kk = b * ho * wo, kh * kw * cin
    kt_n = -(-kk // plan.kc)
    taps = np.asarray(plan.koff, np.int64)
    assert len(taps) == kt_n * 8
    wt = _transposed(w)
    acc = np.zeros((m_all, samples, cout), np.int64)
    win = np.zeros((m_all, samples), np.int64)
    rows0 = np.zeros((m_all, kk), np.int64)
    s_all, mt_all, nt_all = _grid_tiles(plan, m_all, samples, cout)
    for s, mt, nt in zip(s_all, mt_all, nt_all):
        m0, n0 = mt * plan.bm, nt * plan.bn
        mm = m0 + np.arange(plan.bm)
        ok = mm < m_all
        bi, rem = np.divmod(np.where(ok, mm, 0), ho * wo)
        h0 = rem // wo * stride - pad
        w0 = rem % wo * stride - pad
        a = np.zeros((plan.bm, kt_n * plan.kc), np.int64)
        for q, tap in enumerate(taps):
            if tap < 0:
                continue
            dh, dw, ci = tap >> 24, (tap >> 20) & 15, tap & 0xFFFFF
            assert ci + 16 <= cin             # a piece inside one tap
            hi, wi = h0 + dh, w0 + dw
            inside = ok & (hi >= 0) & (hi < h) & (wi >= 0) & (wi < wd)
            for r in np.nonzero(inside)[0]:
                a[r, 16 * q:16 * q + 16] = x[bi[r], hi[r], wi[r],
                                             s * cin + ci:s * cin + ci + 16]
        bt = np.zeros((plan.bn, kt_n * plan.kc), np.int64)
        bt[:, :kk] = wt[s, n0:n0 + plan.bn]
        part = np.zeros((plan.bm, plan.bn), np.int64)
        for k32 in range(0, kt_n * plan.kc, 32):
            if k32 < kk:
                part += a[:, k32:k32 + 32] @ bt[:, k32:k32 + 32].T
        acc[mm[ok], s, n0:n0 + plan.bn] = part[ok]
        win[mm[ok], s] = a[ok].sum(1)
        if s == 0 and nt == 0:
            rows0[mm[ok]] = a[ok, :kk]
    return (acc.reshape(b, ho, wo, samples, cout),
            win.reshape(b, ho, wo, samples), rows0)


# (B, H, cin, cout, k, stride, S): the ResNet-50's kinds of conv at small
# sizes: 1x1 at 64 and 128 channels, a strided shortcut, 3x3 at both
# strides, K % 128 == 64 (the last stage half full), K > 520, pixels
# past the last tile and groups of samples
WIDE_CASES = [(2, 6, 64, 64, 1, 1, 3), (2, 5, 32, 128, 1, 1, 2),
              (2, 7, 64, 128, 1, 2, 2), (1, 5, 64, 64, 3, 1, 2),
              (2, 7, 32, 128, 3, 2, 3), (1, 3, 576, 64, 1, 1, 2),
              (2, 6, 16, 192, 3, 1, 2)]


@pytest.mark.parametrize("case", WIDE_CASES, ids=str)
def test_wide_body_emulation_matches_plain(case, monkeypatch):
    """The emulated sums equal the library convs' (int_conv_sums_plain);
    its sample-0 A rows are F.unfold's columns; the plain epilogue on the
    emulated sums gives bitwise int_conv_merged_plain's codes. Run with
    the plan's sample groups and with groups of 2."""
    b, h, cin, cout, k, stride, s = case
    pad = k // 2
    rng = np.random.default_rng(sum(case))
    x = rng.integers(-127, 128, (b, h, h, s * cin), dtype=np.int8)
    w = rng.integers(-128, 128, (s, k, k, cin, cout), dtype=np.int8)
    strides = (h * h * s * cin, h * s * cin, s * cin, cin)
    plan = ic.plan_conv(h, h, cin, cout, k, k, stride, pad, False,
                        ic._align(0, strides), 16)
    assert plan.design == "wide", plan.reason
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    st, pads = (stride, stride), [(pad, pad)] * 2
    p_acc, p_win = ic.int_conv_sums_plain(xt, wt, st, pads)
    group = ic.wide_sample_group
    for sg in (None, 2):
        if sg:
            monkeypatch.setattr(ic, "wide_sample_group",
                                lambda _p, samples, _c: min(sg, samples))
        acc, win, rows0 = _wide_emulate(x, w, stride, pad, plan, s)
        assert np.array_equal(acc, p_acc.numpy()), sg
        assert np.array_equal(win, p_win.numpy()), sg
        monkeypatch.setattr(ic, "wide_sample_group", group)
    ho = (h + 2 * pad - k) // stride + 1
    m = b * ho * ho
    cols = F.unfold(torch.from_numpy(x[..., :cin]).permute(0, 3, 1, 2)
                    .double(), k, padding=pad, stride=stride)
    cols = cols.reshape(b, cin, k * k, -1).permute(0, 3, 2, 1).reshape(
        m, k * k * cin).to(torch.int64).numpy()
    assert np.array_equal(rows0, cols)
    # the plain epilogue on the emulated sums: centered below K = 520,
    # the two float32 terms above, as the kernel's epi_code
    f32 = torch.float32
    x_scale, w_scale = torch.tensor(0.0794982761), torch.tensor(0.00115220679)
    w_zp, out_zp = torch.tensor(-6, dtype=torch.int32), torch.tensor(
        63, dtype=torch.int32)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    a_t, w_t = torch.from_numpy(acc), torch.from_numpy(win)[..., None]
    if k * k * cin <= 520:
        y = (a_t - int(w_zp) * w_t).to(f32) * (x_scale * w_scale)
    else:
        y = (a_t.to(f32) - w_zp.to(f32) * w_t.to(f32)) * (x_scale * w_scale)
    out_scale = (y + bias).std() / 64
    got = ic.requant_out(y, bias, out_scale, out_zp, True, 0, 127)
    want = ic.int_conv_merged_plain(
        xt, x_scale, wt, w_scale, w_zp, bias, out_scale, out_zp, st, pads,
        0, 127, True)
    assert np.array_equal(got.reshape(want.shape).numpy(), want.numpy())
    assert len(torch.unique(want)) > 20

