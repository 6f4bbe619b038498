"""The int8 conv kernel's tile plan (qbn_tpu_torch/ops/int_conv.py
plan_conv), on the CPU: which body each conv shape takes, that the halo
body's tiles cover every output pixel once within 227 KB of shared memory,
and that its k -> offset and pixel -> offset tables, which the kernel reads
as they are, gather from a zero-padded halo tile exactly the im2col columns
of F.unfold; and for the pixel body (the stem and the 1x1 convs), a numpy
emulation of its gathers, sample groups and window sums, which gives the
im2col columns of F.unfold and, through the plain epilogue, bitwise the
codes of int_conv_merged_plain."""

import dataclasses

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import CONV_SHAPES
from qbn_tpu_torch.ops import int_conv as ic

B, S = 256, 100          # the flagship's eval batch and samples


def _plan(shape):
    """The plan int_conv_merged takes at a flagship shape: merged layout
    (B, H, W, S*cin), so the element strides are multiples of cin."""
    _name, cin, cout, k, stride, hw, shared, _n = shape
    c = cin if shared else S * cin
    strides = (hw * hw * c, hw * c, c, 0 if shared else cin)
    return ic.plan_conv(hw, hw, cin, cout, k, k, stride, k // 2, shared,
                        ic._align(0, strides), 16)


HALO_SHAPES = [s for s in CONV_SHAPES if s[3] == 3 and not s[6]]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=[s[0] for s in
                                                    CONV_SHAPES])
def test_design_by_shape(shape):
    """The 3x3 block convs take the halo body; the stem (shared x, cin 3)
    and the 1x1/2 shortcuts the pixel body."""
    plan = _plan(shape)
    want = "halo" if shape in HALO_SHAPES else "pixel"
    assert plan.design == want, plan.reason
    if want == "pixel":
        assert plan.bm == 128 and not plan.koff and not plan.pixoff
        assert plan.sg >= 1


def test_sixteen_halo_convs_per_batch():
    assert sum(s[-1] for s in HALO_SHAPES) == 16
    assert sum(s[-1] for s in CONV_SHAPES) - 16 == 4


def _geometry(shape):
    _name, cin, cout, k, stride, hw, _sh, _n = shape
    ho = (hw + 2 * (k // 2) - k) // stride + 1
    return cin, cout, k, stride, hw, ho


@pytest.mark.parametrize("shape", HALO_SHAPES, ids=[s[0] for s in
                                                    HALO_SHAPES])
def test_tiles_cover_every_pixel_once(shape):
    """The kernel's tiles: tile t owns pixels t*bm .. t*bm + bm - 1 of the
    (b, ho, wo) order, written through out_off; its halo tile starts at
    image b0 = m0 // (Ho*Wo), output row ho0. The pixel a pixoff entry
    addresses must be the pixel out_off writes, and every output pixel of
    the batch is written once."""
    cin, cout, k, stride, hw, ho = _geometry(shape)
    plan = _plan(shape)
    m = B * ho * ho
    hits = np.zeros(m, dtype=np.int64)
    r = np.arange(plan.bm)
    img, rem = np.divmod(r, plan.rows * ho)
    ho_l, wo = np.divmod(rem, ho)
    # pixoff is the window origin of (img, ho_l, wo) in the halo tile
    want = ((img * plan.h_in + ho_l * stride) * plan.w_in + wo * stride) \
        * plan.pitch
    assert np.array_equal(np.asarray(plan.pixoff), want)
    for t in range(math.ceil(m / plan.bm)):
        m0 = t * plan.bm
        b0, ho0 = m0 // (ho * ho), (m0 % (ho * ho)) // ho
        mm = m0 + r
        ok = mm < m
        b, rest = np.divmod(mm, ho * ho)
        assert np.array_equal(b[ok], b0 + img[ok])
        assert np.array_equal(rest[ok] // ho, ho0 + ho_l[ok])
        assert np.array_equal(rest[ok] % ho, wo[ok])
        hits[mm[ok]] += 1
    assert np.all(hits == 1)
    # a tile is output rows of one image, or whole images
    assert plan.bm == plan.n_img * plan.rows * ho
    assert plan.n_img == 1 or plan.rows == ho
    assert ho % plan.rows == 0


@pytest.mark.parametrize("shape", HALO_SHAPES, ids=[s[0] for s in
                                                    HALO_SHAPES])
def test_shared_memory_fits(shape):
    """At most 227 KB per CTA (two CTAs per SM where the plan can), the
    halo tile inside its region, the region large enough for the output
    codes the epilogue stages there, and every window read inside it."""
    cin, cout, k, stride, hw, ho = _geometry(shape)
    plan = _plan(shape)
    assert plan.smem_bytes <= ic.SMEM_LIMIT
    assert plan.smem_bytes <= ic.SMEM_TWO_CTAS
    region = -(-max(plan.halo_bytes, plan.bm * plan.bn) // 16) * 16
    assert plan.smem_bytes == (region + plan.ring * plan.kc * plan.bn
                               + plan.bn * (plan.kc + 16) + 12 * plan.bm
                               + 4 * len(plan.koff))
    assert plan.kc % 32 == 0 and plan.ring in (1, 2)
    assert plan.ring > 1 or plan.kc >= k * k * cin
    assert plan.halo_bytes == plan.n_img * plan.h_in * plan.w_in * plan.pitch
    kk = k * k * cin
    assert len(plan.koff) == -(-kk // 32) * 8
    last = max(plan.pixoff) + max(plan.koff) + 4
    assert last <= plan.halo_bytes
    # the copies: pieces of vx bytes at 16/8/4-byte aligned addresses
    assert plan.pitch % plan.vx == 0 and cin % plan.vx == 0
    assert plan.pitch % 4 == 0 and cin % 4 == 0
    assert cout % plan.bn == 0 and plan.bn // 8 in (3, 6, 12)
    assert plan.bm == 8 // plan.wn * 16 * plan.mt and plan.nt % plan.wn == 0


def _halo_tile(x, plan, stride, b0, ho0):
    """The kernel's halo tile, as load_halo fills it: (n_img, h_in, w_in)
    pixels of `pitch` bytes, the input's cin codes first, zero outside the
    image and past the last image."""
    b, h, w, cin = x.shape
    tile = np.zeros((plan.n_img, plan.h_in, plan.w_in, plan.pitch),
                    dtype=np.int8)
    for img in range(plan.n_img):
        for row in range(plan.h_in):
            for col in range(plan.w_in):
                bi, hi, wi = b0 + img, ho0 * stride - 1 + row, col - 1
                if bi < b and 0 <= hi < h and 0 <= wi < w:
                    tile[img, row, col, :cin] = x[bi, hi, wi]
    return tile.reshape(-1)


def _gather(tile, plan, k):
    """A[r, k] = the byte at pixoff[r] + koff[k // 4] + k % 4."""
    ks = np.arange(k)
    off = (np.asarray(plan.pixoff)[:, None]
           + np.asarray(plan.koff)[ks // 4][None, :] + (ks % 4)[None, :])
    return tile[off]


# (B, H, cin, cout, stride): the flagship's 3x3 shapes at a small batch, and
# narrow shapes with row tiles and with whole-image tiles at both strides
UNFOLD_CASES = [(2, s[5], s[1], s[2], s[4]) for s in HALO_SHAPES] + [
    (2, 32, 8, 24, 1),      # row tiles (8 rows of 32)
    (2, 64, 8, 24, 2),      # row tiles at stride 2
    (5, 8, 8, 48, 1),       # whole images, the last tile past the batch
    (3, 8, 4, 24, 2),       # whole images at stride 2, cin 4
    (3, 16, 12, 24, 1),     # one whole image per tile
]


@pytest.mark.parametrize("case", UNFOLD_CASES, ids=str)
def test_tables_gather_the_unfold_columns(case):
    b, h, cin, cout, stride = case
    plan = ic.plan_conv(h, h, cin, cout, 3, 3, stride, 1, False, 4, 16)
    assert plan.design == "halo", plan.reason
    rng = np.random.default_rng(sum(case))
    x = rng.integers(-128, 128, (b, h, h, cin), dtype=np.int8)
    k = 9 * cin
    # F.unfold columns, reordered from (c, dh, dw) to (dh, dw, c): the
    # weights' (kh, kw, cin) order, which koff follows
    cols = F.unfold(torch.from_numpy(x).permute(0, 3, 1, 2).double(), 3,
                    padding=1, stride=stride)            # (B, cin*9, L)
    cols = cols.reshape(b, cin, 9, -1).permute(0, 3, 2, 1).reshape(
        b * cols.shape[-1], k).to(torch.int64).numpy()
    ho = (h - 1) // stride + 1
    m = b * ho * ho
    for t in range(math.ceil(m / plan.bm)):
        m0 = t * plan.bm
        b0, ho0 = m0 // (ho * ho), (m0 % (ho * ho)) // ho
        a = _gather(_halo_tile(x, plan, stride, b0, ho0), plan, k)
        n = min(plan.bm, m - m0)
        assert np.array_equal(a[:n].astype(np.int64), cols[m0:m0 + n]), t


@pytest.mark.parametrize("args,why", [
    ((32, 32, 8, 24, 3, 3, 1, 1, True), "shared input with K > 32"),
    ((32, 32, 6, 48, 1, 1, 2, 0, False), "1x1 with cin 6"),
    ((16, 16, 6, 24, 3, 3, 1, 1, False), "4-byte"),
    ((16, 16, 8, 40, 3, 3, 1, 1, False), "output channels"),
    ((16, 16, 8, 24, 5, 5, 1, 2, False), "not a 3x3"),
    ((16, 16, 8, 24, 3, 3, 3, 1, False), "not a 3x3"),
    ((7, 7, 8, 24, 3, 3, 1, 1, False), "no tile"),
    ((32, 32, 24, 40, 1, 1, 2, 0, False), "40 output channels"),
    ((32, 32, 3, 40, 3, 3, 1, 1, True), "40 output channels"),
    ((32, 32, 24, 48, 1, 1, 2, 1, False), "not a 3x3"),
])
def test_other_shapes_keep_the_im2col_body(args, why):
    plan = ic.plan_conv(*args)
    assert plan.design == "im2col" and why in plan.reason
    assert plan.bn == 8 * ic._im2col_nt(args[3])


def test_unaligned_rows_keep_the_im2col_body():
    assert ic.plan_conv(16, 16, 8, 24, 3, 3, 1, 1, False, 2).design == \
        "im2col"
    assert ic.plan_conv(16, 16, 8, 24, 3, 3, 1, 1, False, 4, 8).design == \
        "im2col"


def test_pitch_spreads_the_fragment_loads():
    """At every flagship 3x3 shape the chosen pixel pitch costs no more
    shared-memory wavefronts than the dense pitch cin."""
    for shape in HALO_SHAPES:
        cin, cout, k, stride, hw, ho = _geometry(shape)
        plan = _plan(shape)
        dense_k = ic._koff(9 * cin, cin, 3, plan.w_in, cin)
        dense_p = ic._pixoff(plan.bm, plan.rows, ho, stride, plan.h_in,
                             plan.w_in, cin)
        assert ic._conflicts(plan.pixoff, plan.koff) <= \
            ic._conflicts(dense_p, dense_k)


# -- the pixel body -------------------------------------------------------

PIXEL_SHAPES = [s for s in CONV_SHAPES if s not in HALO_SHAPES]


@pytest.mark.parametrize("shape", PIXEL_SHAPES, ids=[s[0] for s in
                                                     PIXEL_SHAPES])
def test_pixel_plan_fits(shape):
    """Three or four CTAs per SM; A rows long enough for a group's runs
    and the last run's reads up to kc, at a pitch of 16 (mod 32) bytes, so
    that the 8 rows of a fragment load fall in distinct banks; the copy
    width divides the runs."""
    cin, cout, k, stride, hw, ho = _geometry(shape)
    plan = _plan(shape)
    shared = shape[6]
    kk = k * k * cin
    assert plan.kc == -(-kk // 32) * 32
    assert plan.smem_bytes == ic.pixel_smem(plan.bm, plan.bn, plan.kc,
                                            plan.sg, plan.pitch)
    assert plan.smem_bytes <= ic._PIXEL_SMEM[plan.nt]
    ctas = ic.PIXEL_CTAS[plan.nt]
    assert ctas * (plan.smem_bytes + 1024) <= ic.SMEM_LIMIT
    assert plan.pitch % 32 == 16
    if shared:
        assert kk <= 32 and plan.pitch == plan.kc + 16 and plan.vx == 0
    else:
        assert plan.pitch >= plan.sg * cin + plan.kc - cin
        assert cin % plan.vx == 0 and plan.vx in (8, 16)
    words = (np.arange(8)[:, None] * plan.pitch // 4 + np.arange(4)) % 32
    assert len(np.unique(words)) == 32
    assert cout % plan.bn == 0 and plan.bn // 8 in (3, 6, 12)


@pytest.mark.parametrize("samples,tiles", [(100, 2048), (100, 512),
                                           (100, 128), (100, 64), (3, 1),
                                           (1, 5), (7, 300)])
def test_sample_groups_cover_every_sample_once(samples, tiles):
    for shape in PIXEL_SHAPES:
        plan = _plan(shape)
        sg, s_cta = ic.sample_groups(plan, samples, tiles, 132)
        assert 1 <= sg <= plan.sg and s_cta % sg == 0
        hits = np.zeros(samples, dtype=np.int64)
        for z in range(-(-samples // s_cta)):
            for s0 in range(z * s_cta, min(samples, (z + 1) * s_cta), sg):
                hits[s0:min(s0 + sg, (z + 1) * s_cta, samples)] += 1
        assert (hits == 1).all()
        # split over CTAs only as far as two CTAs per SM need
        splits = -(-samples // s_cta)
        assert splits == 1 or tiles * (splits - 1) < 2 * 132


def _pixel_emulate(x, w, stride, pad, shared, plan, samples_split):
    """The pixel body's sums, CTA by CTA, in numpy: the A tile as the
    kernel fills it (the stem's im2col rows; a 1x1 conv's runs of a
    group's samples at j * cin in each pixel's row, the rest of the row
    left as garbage), A words read at r * pitch + j * cin + k for
    k < kc, the weights zero past K, window sums over k < K. Returns acc
    (B, Ho, Wo, S, cout) and win (B, Ho, Wo, S) as int64, and the A rows
    of sample 0 (M, K)."""
    rng = np.random.default_rng(0)
    s, kh, kw, cin, cout = w.shape
    b, h, wd = x.shape[:3]
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (wd + 2 * pad - kw) // stride + 1
    m_all, kk, kc, bm, bn = b * ho * wo, kh * kw * cin, plan.kc, plan.bm, \
        plan.bn
    sg, s_cta = samples_split
    wk = np.zeros((s, kc, cout), np.int64)
    wk[:, :kk] = w.reshape(s, kk, cout)
    xp = np.pad(x.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    acc = np.zeros((m_all, s, cout), np.int64)
    win = np.zeros((m_all, s), np.int64)
    rows0 = np.zeros((m_all, kk), np.int64)
    for m0 in range(0, m_all, bm):
        mm = np.arange(m0, min(m0 + bm, m_all))
        bi, rem = np.divmod(mm, ho * wo)
        hi, wi = np.divmod(rem, wo)
        for z0 in range(0, s, s_cta):
            for s0 in range(z0, min(s, z0 + s_cta), sg):
                ng = min(sg, min(s, z0 + s_cta) - s0)
                a = rng.integers(-128, 128, (bm, plan.pitch)).astype(np.int64)
                for r, (bb, y, xx) in enumerate(zip(bi, hi, wi)):
                    y0, x0 = y * stride, xx * stride
                    if shared:
                        patch = xp[bb, y0:y0 + kh, x0:x0 + kw, :]
                        a[r, :kc] = 0
                        a[r, :kk] = patch.reshape(-1)
                    else:
                        run = x[bb, y0, x0].astype(np.int64)   # S*cin
                        a[r, :ng * cin] = run[s0 * cin:(s0 + ng) * cin]
                for j in range(ng):
                    off = 0 if shared else j * cin
                    rows = a[:len(mm), off:off + kc]
                    acc[mm, s0 + j] = rows @ wk[s0 + j]
                    win[mm, s0 + j] = rows[:, :kk].sum(1)
                    if s0 + j == 0:
                        rows0[mm] = rows[:, :kk]
    return (acc.reshape(b, ho, wo, s, cout), win.reshape(b, ho, wo, s),
            rows0)


# (B, H, cin, cout, k, stride, shared, S): the flagship's stem and
# shortcuts at a small batch and sample count, and narrow shapes
PIXEL_CASES = [(2, 8, 3, 24, 3, 1, True, 3), (2, 16, 24, 48, 1, 2, False, 3),
               (2, 8, 48, 96, 1, 2, False, 2), (3, 4, 96, 192, 1, 2, False, 2),
               (3, 9, 8, 24, 1, 2, False, 5), (2, 6, 12, 96, 1, 1, False, 3),
               (1, 12, 2, 48, 3, 2, True, 4)]


@pytest.mark.parametrize("case", PIXEL_CASES, ids=str)
def test_pixel_body_emulation_matches_plain(case):
    """The emulated sums equal the library convs' (int_conv_sums_plain);
    its sample-0 A rows are F.unfold's columns; and the plain epilogue on
    the emulated sums gives bitwise int_conv_merged_plain's codes. Groups
    of 2 samples (and the plan's own) and sample splits are both run."""
    b, h, cin, cout, k, stride, shared, s = case
    pad = k // 2
    rng = np.random.default_rng(sum(case[:6]))
    xc = cin if shared else s * cin
    x = rng.integers(-127, 128, (b, h, h, xc), dtype=np.int8)
    w = rng.integers(-128, 128, (s, k, k, cin, cout), dtype=np.int8)
    strides = (h * h * xc, h * xc, xc, 0 if shared else cin)
    plan = ic.plan_conv(h, h, cin, cout, k, k, stride, pad, shared,
                        ic._align(0, strides), 16)
    assert plan.design == "pixel", plan.reason
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    p_acc, p_win = ic.int_conv_sums_plain(xt, wt, (stride, stride),
                                          [(pad, pad)] * 2, shared)
    ho = (h + 2 * pad - k) // stride + 1
    m = b * ho * ho
    for sg, s_cta in {ic.sample_groups(plan, s, -(-m // plan.bm), 132),
                      (2, 2), (2, 4)}:
        pitch = plan.pitch if shared or sg <= plan.sg else \
            ic._pixel_pitch(sg, cin, plan.kc)
        small = dataclasses.replace(plan, sg=sg, pitch=pitch)
        acc, win, rows0 = _pixel_emulate(x, w, stride, pad, shared, small,
                                         (sg, s_cta))
        assert np.array_equal(acc, p_acc.numpy()), (sg, s_cta)
        assert np.array_equal(win, p_win.numpy()), (sg, s_cta)
    xs = x if shared else x[..., :cin]
    cols = F.unfold(torch.from_numpy(xs).permute(0, 3, 1, 2).double(), k,
                    padding=pad, stride=stride)
    cols = cols.reshape(b, cin, k * k, -1).permute(0, 3, 2, 1).reshape(
        m, k * k * cin).to(torch.int64).numpy()
    assert np.array_equal(rows0, cols)
    # the epilogue of the emulated sums (K <= 520: centered, exact
    # integers) against the plain version's codes
    f32 = torch.float32
    x_scale, w_scale = torch.tensor(0.0794982761), torch.tensor(0.00115220679)
    w_zp, out_zp = torch.tensor(-6, dtype=torch.int32), torch.tensor(
        63, dtype=torch.int32)
    bias = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    y = ((torch.from_numpy(acc) - int(w_zp) * torch.from_numpy(win)[..., None])
         .to(f32) * (x_scale * w_scale))
    out_scale = (y + bias).std() / 64
    got = ic.requant_out(y, bias, out_scale, out_zp, True, 0, 127)
    want = ic.int_conv_merged_plain(
        xt, x_scale, wt, w_scale, w_zp, bias, out_scale, out_zp,
        (stride, stride), [(pad, pad)] * 2, 0, 127, True, shared)
    assert np.array_equal(got.reshape(want.shape).numpy(), want.numpy())
    assert len(torch.unique(want)) > 20
