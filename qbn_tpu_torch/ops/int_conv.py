"""All-samples int8 convolution with the requant epilogue (port of
qbn_tpu/ops/pallas/conv_gemm.py and qbn_tpu/ops/pallas/bconv.py, computing
the function of qbn_tpu/ops/integer.py int_conv_merged).

Activations travel as codes u = q - zp (int8), so dequant(u) = u * scale
and conv zero padding is padding with the zero point. Only the weight zero
point zw needs a correction:
    conv:  u * (w - zw) = conv(u, w) - zw * winsum(u)
qbn_tpu picks one of two formulations by contraction depth K, and the
port keeps both, with the same float32 epilogue, so that the int8 codes
are bitwise equal:
  * K <= 520: the weights are centered, (w - zw), and the correction
    vanishes; acc_f = acc * (sx * sw);
  * K > 520: acc and the window sum are taken apart and
    acc_f = (f32(acc) - zw * f32(winsum)) * (sx * sw).
Requantisation then runs in qbn_tpu's order: + bias, / out_scale, round
half to even, + out_zp, clip to 0..255, quantised ReLU (max with out_zp),
the sub-8-bit clip, - out_zp.

Each of `int_conv_merged`, `int_conv`, `mc_group_conv` and `int_conv_sums`
calls its operator (`qbn_tpu_torch::<name>`, ops/library.py). On a CUDA
tensor the operator launches the hand-written kernel of `csrc/int_conv.cu`
(an int8 implicit GEMM on the tensor cores with exact int32 sums) or
raises; there is no fallback. The kernel addresses activations and outputs by
(batch, row, column, sample) strides and weights by a sample stride: K *
cout for per-sample weights (Bayes-by-backprop), 0 for one set shared by
every sample (`int_conv`: MC-Dropout, pointwise, an ensemble member; or
4-D weights given to `int_conv_merged`). The kernel has four bodies,
chosen by shape in `plan_conv`, never on failure: "halo" for the 3x3
convs with cin % 4 == 0 (the
activations of a tile of output pixels staged once in shared memory with
their halo, the weights streamed through an async-copy ring), "pixel" for
the shared-input stem with K <= 32 and the 1x1 convs with padding 0 (a CTA
owns a tile of output pixels and walks over the samples in groups: the
stem's im2col tile gathered once, a 1x1 conv's input runs copied once per
group, the group's weights transposed into shared memory, the codes
staged so that each pixel's run is written in long pieces), "wide" for
the 1x1 and 3x3 convs that those two decline whose input channels are a
multiple of 16 and output channels of 64 (a pipelined implicit GEMM on
wgmma, 128 pixels x 128 channels a CTA, K through a ring of cp.async
stages) and "im2col" for the rest (an
im2col tile gathered per K step, one sample per CTA). The plan, with the
halo body's k -> offset and pixel -> offset tables and the wide body's
table of taps, is computed here and passed to the kernel, so the CPU tests
check what the kernel reads. On a
CPU tensor they run the plain versions beside them, whose integer sums
come from library convolutions in float64, which holds them
exactly (for some float32 3x3 shapes cuDNN picks an algorithm that is not
exact on integers: the stage-1 48->48 conv at B=256, S=100 came out 0.125
off on an H100).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from qbn_tpu_torch.ops import _build, library
from qbn_tpu_torch.profiling import span

_CENTERED_K = (1 << 24) // (254 * 127)           # 520
_MAX_K = (1 << 31) // (128 * 128) - 1            # int32 sums stay exact

# Kernel launches since the count was last set to 0, in all and by design;
# chip_smoke.py reads them to show that the main path went through the
# kernel.
launches = 0
launches_by_design = {"halo": 0, "pixel": 0, "im2col": 0, "wide": 0}
# of those, the launches with one set of weights shared by every sample
# (MC-Dropout, pointwise and ensemble members), by design
launches_shared_w = {"halo": 0, "pixel": 0, "im2col": 0, "wide": 0}
# of those, the launches that ran the residual epilogue (a residual add in
# the conv's launch)
launches_residual = 0


# -- the plain versions ---------------------------------------------------

def conv_sum(x, w, stride, padding: int, groups: int):
    """Exact integer conv sums in NHWC, in float64.

    x: (B, H, W, C) integer-valued codes; w: (O, C/groups, kh, kw)
    integer-valued weights. Returns (B, H', W', O) float64."""
    xn = x.to(torch.float64).permute(0, 3, 1, 2)          # NCHW view
    y = F.conv2d(xn, w.to(torch.float64), stride=stride, padding=padding,
                 groups=groups)
    return y.permute(0, 2, 3, 1)


def requant_out(acc_f, bias, out_scale, out_zp, relu, a_lo, a_hi):
    """Float-requantise an accumulator to zero-point-removed int8 codes.

    out_scale / out_zp are 0-d tensors on the accumulator's device: a CPU
    scalar divisor would make PyTorch multiply by its reciprocal."""
    y = acc_f
    if bias is not None:
        y = y + bias
    zp = out_zp.to(torch.float32)
    q = torch.round(y / out_scale) + zp
    q = torch.clamp(q, 0, 255)
    if relu:
        q = torch.maximum(q, zp)            # quantised ReLU: max(code, zp)
    q = torch.clamp(q, a_lo, a_hi)
    return (q - zp).to(torch.int8)


def _padding(padding) -> int:
    (p0, p1), (p2, p3) = padding
    if not p0 == p1 == p2 == p3:
        raise ValueError(f"only symmetric padding is supported: {padding}")
    return int(p0)


def _weights_oihw(w_codes):
    """(S, kh, kw, cin, cout) -> (S*cout, cin, kh, kw) float32: group g =
    sample g."""
    s, kh, kw, cin, cout = w_codes.shape
    return w_codes.to(torch.float32).permute(0, 4, 3, 1, 2).reshape(
        s * cout, cin, kh, kw)


def int_conv_sums_plain(x_codes, w_codes, strides, padding,
                        shared_x: bool = False):
    """The raw sums of `int_conv_sums`, from float64 library convs."""
    s, kh, kw, cin, cout = w_codes.shape
    pad, groups = _padding(padding), 1 if shared_x else s
    acc = conv_sum(x_codes, _weights_oihw(w_codes), strides, pad, groups)
    ones = torch.ones((1 if shared_x else s, cin, kh, kw),
                      device=x_codes.device)
    win = conv_sum(x_codes, ones, strides, pad, groups)
    b, ho, wo = acc.shape[:3]
    acc = acc.reshape(b, ho, wo, s, cout).to(torch.int32)
    win = win.to(torch.int32).expand(b, ho, wo, s) if shared_x else \
        win.to(torch.int32)
    return acc, win.contiguous()


def int_conv_merged_plain(x_codes, x_scale, w_codes, w_scale, w_zp, bias,
                          out_scale, out_zp, strides, padding,
                          a_lo: int, a_hi: int, relu: bool = False,
                          shared_x: bool = False, residual=None,
                          res_scale=None, res_out_scale=None,
                          res_out_zp=None, res_relu: bool = False):
    """`int_conv_merged` in plain PyTorch: float64 library convs for the
    sums, the float32 epilogue as elementwise passes."""
    s, kh, kw, cin, cout = w_codes.shape
    k = kh * kw * cin
    groups = 1 if shared_x else s
    pad = _padding(padding)
    f32 = torch.float32
    w = _weights_oihw(w_codes)
    scale = x_scale * w_scale
    if k <= _CENTERED_K:
        acc = conv_sum(x_codes, w - w_zp.to(f32), strides, pad, groups)
        acc_f = acc.to(f32) * scale
    else:
        acc = conv_sum(x_codes, w, strides, pad, groups)
        n_ws = 1 if shared_x else s
        ones = torch.ones((n_ws, cin, kh, kw), dtype=f32,
                          device=x_codes.device)
        winsum = conv_sum(x_codes, ones, strides, pad, groups)
        b, ho, wo = acc.shape[:3]
        corr = w_zp.to(f32) * winsum.to(f32)                # (B,H',W',n_ws)
        acc_f = (acc.to(f32).reshape(b, ho, wo, s, cout) - corr[..., None]
                 ) * scale
    b, ho, wo = acc_f.shape[:3]
    acc_f = acc_f.reshape(b, ho, wo, s, cout)
    out = requant_out(acc_f, bias, out_scale, out_zp, relu, a_lo, a_hi)
    if residual is not None:
        res = residual.reshape(b, ho, wo, s, cout)
        y = out.to(f32) * out_scale + res.to(f32) * res_scale
        out = requant_out(y, None, res_out_scale, res_out_zp, res_relu,
                          a_lo, a_hi)
    return out.reshape(b, ho, wo, s * cout)


# -- qparams and checks ---------------------------------------------------

def _scale(v, dev, name):
    t = torch.as_tensor(v, device=dev)
    if t.numel() != 1:
        raise ValueError(f"{name} must be a scalar: {tuple(t.shape)}")
    if t.dtype != torch.float32:
        if isinstance(v, torch.Tensor):
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
        t = t.to(torch.float32)
    return t.reshape(())


def _zero_point(v, dev, name):
    """A zero point as a 0-d int32 tensor. The kernel's centered branch
    subtracts zw * winsum in integers, so zw must be integer-valued."""
    t = torch.as_tensor(v, device=dev)
    if t.numel() != 1:
        raise ValueError(f"{name} must be a scalar: {tuple(t.shape)}")
    if t.dtype.is_floating_point:
        if not bool(t == torch.round(t)):
            raise ValueError(f"{name} = {float(t)} is not integer-valued")
    return t.to(torch.int32).reshape(())


def _qparams(dev, x_scale, w_scale, w_zp, out_scale, out_zp, res_scale=None,
             res_out_scale=None, res_out_zp=None):
    q = dict(x_scale=_scale(x_scale, dev, "x_scale"),
             w_scale=_scale(w_scale, dev, "w_scale"),
             w_zp=_zero_point(w_zp, dev, "w_zp"),
             out_scale=_scale(out_scale, dev, "out_scale"),
             out_zp=_zero_point(out_zp, dev, "out_zp"))
    if res_scale is not None:
        q.update(res_scale=_scale(res_scale, dev, "res_scale"),
                 res_out_scale=_scale(res_out_scale, dev, "res_out_scale"),
                 res_out_zp=_zero_point(res_out_zp, dev, "res_out_zp"))
    return q


def _check(t: torch.Tensor, dtype, name: str, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _out_hw(h, w, kh, kw, stride, pad):
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError("the convolution has no output pixel")
    return ho, wo


def _strides(strides) -> int:
    sh, sw = strides
    if sh != sw:
        raise ValueError(f"only equal strides are supported: {strides}")
    return int(sh)


# -- the tile plan --------------------------------------------------------

SMEM_LIMIT = 232_448          # shared memory one CTA may use on an H100
SMEM_TWO_CTAS = 113 * 1024    # at most this for two CTAs per SM
_KSTEP = 32                   # contraction step: one m16n8k32
# the warp layout (m16 tiles a warp, warps along n) the halo body is built
# for, by n8 tiles per CTA: 256 pixels x 8 warps at 3 and 6 n8 tiles; at 12
# the warps are 4 x 2, 128 pixels, so that the B fragments a warp loads
# feed two m16 tiles (the accumulators of 256 pixels x 12 n8 tiles a warp
# take 150 registers, one CTA per SM, and measured slower on the H100)
_LAYOUTS = {3: (2, 1), 6: (2, 1), 12: (2, 2)}
_IM2COL_BM = 128
_PIXEL_BM = 128
_WIDE_BM = 128
_WIDE_BK = 128                # K bytes of a ring stage of the wide body
# its ring stages by channels a CTA (csrc/int_conv.cu wide_ring): two CTAs
# fit on an SM either way
_WIDE_RING = {128: 3, 64: 4}
_MAX_GROUP = 32               # samples per group of the pixel body
# the pixel body's CTAs per SM, by n8 tiles: four at 3 and 6, three at 12
# (as many as its registers allow; csrc/int_conv.cu pixel_min_blocks gives
# __launch_bounds__ the same numbers); more CTAs with smaller sample groups
# measured faster on the H100 than two CTAs with large ones
PIXEL_CTAS = {3: 4, 6: 4, 12: 3}
# its shared memory per CTA: a share of SMEM_LIMIT, less the 1 KB the
# card reserves per CTA, in whole KB
_PIXEL_SMEM = {nt: (SMEM_LIMIT // c - 1024) // 1024 * 1024
               for nt, c in PIXEL_CTAS.items()}


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How one conv shape runs on the kernel.

    design "halo": a CTA owns one sample, bm consecutive output pixels
    (`rows` output rows of one image, or `n_img` whole images) and bn
    output channels; its input rows and columns plus a one-pixel halo,
    (n_img, h_in, w_in) pixels of `pitch` bytes, are copied into shared
    memory once, in pieces of vx bytes, zero-filled outside the image. The
    A fragment of output pixel r at contraction index k (a multiple of 4)
    is the word at pixoff[r] + koff[k // 4] of that tile. The weights
    stream in chunks of kc k rows through a ring of `ring` slots (1: one
    chunk, all of K, where it is small; else 2). The 8 warps are
    (8 / wn) x wn: each owns 16 * mt pixels and bn / wn of the bn = 8 * nt
    channels.
    design "pixel": a CTA owns bm = 128 output pixels and bn channels and
    walks over the samples in groups of at most sg. Its A tile holds each
    pixel's row at pitch bytes: the stem's im2col row (kc = 32 bytes,
    gathered once), or a 1x1 conv's input codes of the group's samples,
    sample after sample (cin bytes each, copied by cp.async in pieces of
    vx bytes); the A word of pixel r, group sample j, contraction index k
    is at r * pitch + j * cin + k (the stem: r * pitch + k). The group's
    weights go to shared memory transposed, [sample][n][kc + 16], zero
    past K (kc = K rounded up to 32), and its codes to a staging buffer
    [pixel][sample][bn] before the CTA writes them.
    design "wide": a CTA owns one sample, bm = 128 output pixels and bn =
    128 channels (64 where cout is 64); K runs in stages of kc = 128 bytes
    through a ring of `ring` stages. The A piece of output pixel r at
    contraction bytes 16q .. 16q + 15 is 16 bytes of the input at tap (dh,
    dw), channel ci of the pixel's window, with koff[q] = dh << 24 | dw <<
    20 | ci (-1 past K, read as zeros); a piece never crosses a tap since
    cin % 16 == 0.
    design "im2col": the first body, 128 pixels x 8 * nt channels per CTA,
    an im2col tile gathered from global memory per K step."""
    design: str
    reason: str
    bm: int
    nt: int
    mt: int = 1
    wn: int = 1
    n_img: int = 0
    rows: int = 0
    h_in: int = 0
    w_in: int = 0
    pitch: int = 0
    vx: int = 0
    kc: int = 0
    ring: int = 0
    halo_bytes: int = 0
    smem_bytes: int = 0
    koff: tuple = ()
    pixoff: tuple = ()
    sg: int = 0

    @property
    def bn(self) -> int:
        return 8 * self.nt


def _im2col_nt(cout: int) -> int:
    nt = -(-cout // 8)
    return 1 if nt <= 1 else 3 if nt <= 3 else 6 if nt <= 6 else 12


def _koff(k, cin, kw, w_in, pitch):
    """Byte offset in a halo tile of contraction index 4q (tap-major, then
    channel, as the weights are laid out) for q < ceil(k / 32) * 8; 0 for
    the zero-padded k >= K, whose weights are zero."""
    kp = -(-k // _KSTEP) * _KSTEP
    out = []
    for kk in range(0, kp, 4):
        if kk < k:
            tap, ci = divmod(kk, cin)
            dh, dw = divmod(tap, kw)
            out.append((dh * w_in + dw) * pitch + ci)
        else:
            out.append(0)
    return out


def _pixoff(bm, rows, wo, stride, h_in, w_in, pitch):
    """Byte offset in a halo tile of the window origin of each of a CTA's
    bm output pixels (image, row, column in (b, ho, wo) order)."""
    out = []
    for r in range(bm):
        img, rem = divmod(r, rows * wo)
        ho, wc = divmod(rem, wo)
        out.append(((img * h_in + ho * stride) * w_in + wc * stride) * pitch)
    return out


def _conflicts(pixoff, koff):
    """Shared-memory wavefronts of all the A fragment loads of one CTA: for
    each load (a warp's 8 rows g x 4 k-quads t), the most distinct 4-byte
    words that fall in one of the 32 banks, summed."""
    pix = np.asarray(pixoff, dtype=np.int64).reshape(-1, 8)     # row groups
    ko = np.asarray(koff, dtype=np.int64).reshape(-1, 4)        # k-quads t
    words = (pix[:, None, :, None] + ko[None, :, None, :]) // 4
    words = np.sort(words.reshape(-1, 32), axis=1)
    first = np.ones_like(words, dtype=bool)
    first[:, 1:] = words[:, 1:] != words[:, :-1]
    counts = np.zeros((words.shape[0], 32), dtype=np.int64)
    rows = np.nonzero(first)[0]
    np.add.at(counts, (rows, words[first] % 32), 1)
    return int(counts.max(axis=1).sum())


def halo_smem(halo_bytes, bm, bn, kc, ring, k):
    """Shared memory of the halo body: the halo tile (which later holds the
    bm x bn output codes), the weight ring (ring x kc x bn), the transposed
    chunk (bn rows of kc + 16 bytes), the row sums and output offsets, and
    the k -> offset table."""
    region = -(-max(halo_bytes, bm * bn) // 16) * 16
    return (region + ring * kc * bn + bn * (kc + 16) + 12 * bm
            + 4 * len(range(0, k, _KSTEP)) * 8)


def _rings(k, bn):
    """(kc, ring) in order of preference: all of K in one chunk where the
    slice is small (up to 24 KB), else chunks of 128 k rows in a
    double-buffered ring (on the H100 a third slot or shorter chunks
    measured no faster), then shorter chunks where shared memory is
    short."""
    kp = -(-k // _KSTEP) * _KSTEP
    return ([(kp, 1)] if kp * bn <= 24 * 1024 else []) + [
        (128, 2), (64, 2), (32, 2)]


def pixel_smem(bm, bn, kc, sg, pitch, w_slices=None):
    """Shared memory of the pixel body: the A tile (bm rows of pitch), the
    transposed weights (w_slices x bn rows of kc + 16: the group's sg
    samples, or 1 where every sample shares the weights), the staged codes
    (bm rows of sg * bn + 16), the rows' window sums and their output and
    input offsets."""
    w_slices = sg if w_slices is None else w_slices
    return (bm * pitch + w_slices * bn * (kc + 16) + bm * (sg * bn + 16)
            + 20 * bm)


def _pixel_pitch(sg, cin, kc):
    """The A row pitch of a 1x1 conv's group: its sg runs of cin bytes and
    room for the last one's reads up to kc, rounded up to 16 (mod 32), so
    that the 8 rows of a fragment load fall in distinct banks."""
    p = -(-(sg * cin + kc - cin) // 16) * 16
    return p if p % 32 == 16 else p + 16


def _pixel_plan(cin, cout, k, shared_x, shared_w, x_align, w_align,
                reason):
    """The pixel body's plan, or None where it cannot run the shape. With
    shared weights one transposed slice serves every group."""
    bn = min(cout, 96)
    if cout % bn or bn % 8 or bn // 8 not in _LAYOUTS or w_align < 4:
        return None
    kc = -(-k // _KSTEP) * _KSTEP
    vx = 0
    if not shared_x:
        if cin % 4 or x_align < 4:
            return None
        vx = max(v for v in (16, 8, 4) if cin % v == 0 and v <= x_align)
    for sg in range(_MAX_GROUP, 0, -1):
        pitch = kc + 16 if shared_x else _pixel_pitch(sg, cin, kc)
        smem = pixel_smem(_PIXEL_BM, bn, kc, sg, pitch,
                          1 if shared_w else sg)
        if smem <= _PIXEL_SMEM[bn // 8]:
            return ConvPlan("pixel", reason, bm=_PIXEL_BM, nt=bn // 8,
                            pitch=pitch, vx=vx, kc=kc, sg=sg,
                            smem_bytes=smem)
    return None


def _wide_taps(k, cin, kw):
    """The wide body's table: for each 16-byte piece q of K (tap-major,
    then channel, as the weights are laid out), padded to whole stages,
    dh << 24 | dw << 20 | ci of its first byte; -1 past K."""
    out = []
    for q in range(-(-k // _WIDE_BK) * _WIDE_BK // 16):
        if 16 * q < k:
            tap, ci = divmod(16 * q, cin)
            dh, dw = divmod(tap, kw)
            out.append(dh << 24 | dw << 20 | ci)
        else:
            out.append(-1)
    return out


def wide_smem(bn, ring, k):
    """Shared memory of the wide body: the ring (ring stages of 128 pixels
    and bn channels x 128 K bytes; the staged codes reuse it), the rows'
    window sums and output offsets, and the table of taps."""
    return (ring * (_WIDE_BM + bn) * _WIDE_BK + 12 * _WIDE_BM
            + 4 * 8 * -(-k // _WIDE_BK))


# the weights a group of the wide body's samples keeps in L2 (of 50 MB)
_WIDE_GROUP_BYTES = 16 << 20


def wide_sample_group(plan: ConvPlan, samples: int, cout: int) -> int:
    """Samples a group of the wide body runs together: as many as keep
    their weight slices (K x cout each, K rounded up to a stage) within
    _WIDE_GROUP_BYTES, in groups of balanced size. More samples a group
    lengthen the runs of each pixel's codes read together; fewer keep the
    weights in L2."""
    most = max(1, min(samples, _WIDE_GROUP_BYTES // (16 * len(plan.koff)
                                                      * cout)))
    groups = -(-samples // most)
    return -(-samples // groups)


def _wide_plan(cin, cout, kh, kw, stride, pad, shared_x, x_align, w_align):
    """(the wide body's plan, "") or (None, why it cannot run the shape)."""
    if shared_x:
        return None, "the input is shared by every sample"
    if (kh, kw, pad) not in ((1, 1, 0), (3, 3, 1)) or stride not in (1, 2):
        return None, (f"a {kh}x{kw} kernel, padding {pad}, stride {stride} "
                      "is not 1x1 or 3x3 at stride 1 or 2")
    if cin % 16:
        return None, f"cin {cin} is not a multiple of 16"
    if cout % 64:
        return None, f"{cout} output channels are not a multiple of 64"
    if x_align < 16 or w_align < 16:
        return None, "the input or weights are not in 16-byte pieces"
    k = kh * kw * cin
    bn = 128 if cout % 128 == 0 else 64
    ring = _WIDE_RING[bn]
    return ConvPlan(
        "wide", f"{kh}x{kw}/{stride}, cin % 16 == 0, cout % 64 == 0",
        bm=_WIDE_BM, nt=bn // 8, kc=_WIDE_BK, ring=ring,
        smem_bytes=wide_smem(bn, ring, k),
        koff=tuple(_wide_taps(k, cin, kw))), ""


@functools.lru_cache(maxsize=None)
def plan_conv(h, w, cin, cout, kh, kw, stride, pad, shared_x=False,
              x_align=16, w_align=16, shared_w=False):
    """The ConvPlan of one conv shape (per-sample input (h, w, cin), output
    channels cout, a kh x kw kernel). x_align / w_align: the largest of 16,
    8, 4, 2, 1 dividing the activations' base address and every element
    stride, and the weights' base address. shared_x / shared_w: one input,
    or one set of weights, for every sample (a sample stride of 0).
    Where the halo and pixel bodies decline a shape, the wide body takes
    it if it can, else the im2col body; the reason names why both
    declined."""
    ho = (h + 2 * pad - kh) // stride + 1
    wo = (w + 2 * pad - kw) // stride + 1
    k = kh * kw * cin
    bn = min(cout, 96)

    def declined(reason):   # the halo and pixel bodies cannot run it
        wide, why = _wide_plan(cin, cout, kh, kw, stride, pad, shared_x,
                               x_align, w_align)
        if wide is not None:
            return dataclasses.replace(wide,
                                       reason=f"{reason}; {wide.reason}")
        return ConvPlan("im2col", f"{reason}; wide: {why}", bm=_IM2COL_BM,
                        nt=_im2col_nt(cout))

    if shared_x:
        if k > _KSTEP:
            return declined("shared input with K > 32")
        return _pixel_plan(cin, cout, k, True, shared_w, x_align, w_align,
                           "shared input, K <= 32 (the stem)") or declined(
            f"shared input, {cout} output channels")
    if (kh, kw, pad) == (1, 1, 0):
        return _pixel_plan(cin, cout, k, False, shared_w, x_align, w_align,
                           "1x1, padding 0") or declined(
            f"1x1 with cin {cin}, {cout} output channels")
    if (kh, kw, pad) != (3, 3, 1) or stride not in (1, 2):
        return declined("not a 3x3 conv with padding 1")
    if cin % 4 or x_align < 4:
        return declined("input rows not in 4-byte words")
    if cout % bn or bn % 8 or bn // 8 not in _LAYOUTS:
        return declined(f"{cout} output channels")
    if (k * cout) % 16 or w_align < 16 or (bn < cout and cout % 16):
        return declined("weight rows not in 16-byte pieces")
    mt, wn = _LAYOUTS[bn // 8]
    bm = 8 // wn * 16 * mt
    if ho * wo >= bm and bm % wo == 0 and ho % (bm // wo) == 0:
        n_img, rows = 1, bm // wo          # output rows of one image
    elif ho * wo < bm and bm % (ho * wo) == 0:
        n_img, rows = bm // (ho * wo), ho  # whole images
    else:
        return declined(f"no tile of whole rows or images of {bm}")
    h_in, w_in = (rows - 1) * stride + 3, (wo - 1) * stride + 3
    best = None
    for pitch in range(cin, cin + 32, 4):
        vx = max(v for v in (16, 8, 4)
                 if pitch % v == 0 and cin % v == 0 and v <= x_align)
        koff = _koff(k, cin, kw, w_in, pitch)
        pixoff = _pixoff(bm, rows, wo, stride, h_in, w_in, pitch)
        score = (_conflicts(pixoff, koff), -vx, pitch)
        if best is None or score < best[0]:
            best = (score, pitch, vx, koff, pixoff)
    _score, pitch, vx, koff, pixoff = best
    halo = n_img * h_in * w_in * pitch
    for limit in (SMEM_TWO_CTAS, SMEM_LIMIT):
        for kc, ring in _rings(k, bn):
            smem = halo_smem(halo, bm, bn, kc, ring, k)
            if smem <= limit:
                return ConvPlan(
                    "halo", f"3x3/{stride}, cin % 4 == 0", bm=bm,
                    nt=bn // 8, mt=mt, wn=wn, n_img=n_img, rows=rows,
                    h_in=h_in, w_in=w_in, pitch=pitch, vx=vx, kc=kc,
                    ring=ring, halo_bytes=halo, smem_bytes=smem,
                    koff=tuple(koff), pixoff=tuple(pixoff))
    return declined("no tile fits in shared memory")


def sample_groups(plan: ConvPlan, samples: int, tiles: int, sms: int):
    """(sg, s_cta) of a pixel-body launch: the fewest groups of at most
    plan.sg samples, balanced; and the samples of one CTA, a whole number
    of groups, so that the pixel and channel tiles times the sample splits
    give at least two CTAs per SM where the samples allow."""
    groups = -(-samples // plan.sg)
    sg = -(-samples // groups)
    groups = -(-samples // sg)
    splits = min(groups, max(1, -(-2 * sms // tiles)))
    return sg, -(-groups // splits) * sg


# CUDA's grid limits: x up to 2^31 - 1, y and z up to 65535
_GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


def launch_grid(plan: ConvPlan, m: int, samples: int, cout: int,
                sms: int = 132):
    """The grid (x, y, z) a launch of `plan` takes for m output pixels per
    sample (B * H' * W') and `samples` samples, as csrc/int_conv.cu
    computes it: (samples, pixel tiles, channel tiles) on the halo and
    im2col bodies, (pixel tiles, channel tiles, sample splits) on the pixel
    body, (pixel tiles x channel tiles x group samples, sample groups, 1)
    on the wide body. Raises ValueError where a dimension passes CUDA's
    limits: the samples ride the grid's x (or a loop of the pixel body, or
    the wide body's y), so that S samples of B images never need more
    pixel tiles than B images do."""
    m_tiles, n_tiles = -(-m // plan.bm), -(-cout // plan.bn)
    if plan.design == "pixel":
        _sg, s_cta = sample_groups(plan, samples, m_tiles * n_tiles, sms)
        grid = (m_tiles, n_tiles, -(-samples // s_cta))
    elif plan.design == "wide":   # sample groups slowest
        sg = wide_sample_group(plan, samples, cout)
        grid = (m_tiles * n_tiles * sg, -(-samples // sg), 1)
    else:
        grid = (samples, m_tiles, n_tiles)
    for n, limit, what in zip(grid, _GRID_LIMITS, "xyz"):
        if n > limit:
            raise ValueError(
                f"{m} output pixels per sample x {samples} samples need a "
                f"grid {grid} past the kernel's limit in {what} ({limit})")
    return grid


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _align(ptr: int, strides) -> int:
    for v in (16, 8, 4, 2):
        if ptr % v == 0 and all(st % v == 0 for st in strides):
            return v
    return 1


_TABLES: dict = {}


def _tables(plan: ConvPlan, device):
    """The plan's koff and pixoff tables, one int32 tensor on the device."""
    key = (plan, str(device))
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(plan.koff + plan.pixoff,
                                    dtype=torch.int32, device=device)
    return _TABLES[key]


# -- the kernel -----------------------------------------------------------

_FIELDS = (
    "x", "x_sb", "x_sh", "x_sw", "x_ss", "B", "H", "W", "cin",
    "w", "w_ss", "S", "kh", "kw", "cout", "stride", "pad", "Ho", "Wo",
    "out", "o_sb", "o_sh", "o_sw", "o_ss", "res", "bias",
    "x_scale", "w_scale", "w_zp", "out_scale", "out_zp",
    "res_scale", "res_out_scale", "res_out_zp",
    "relu", "res_relu", "a_lo", "a_hi", "raw_acc", "raw_win",
    "vec_x", "vec_out", "koff", "pixoff", "halo", "bm", "nt", "mt", "wn",
    "n_img", "rows", "h_in", "w_in", "pitch", "vx", "kc", "ring", "smem",
    "pixel", "sg", "s_cta", "vo", "wide", "wt")
_PTRS = frozenset((
    "x", "w", "out", "res", "bias", "x_scale", "w_scale", "w_zp",
    "out_scale", "out_zp", "res_scale", "res_out_scale", "res_out_zp",
    "raw_acc", "raw_win", "koff", "pixoff", "wt"))


class _Args(ctypes.Structure):
    """QbnConvArgs of csrc/int_conv.cu, field for field: every field 64
    bits wide, so the two layouts agree without padding."""
    _fields_ = [(n, ctypes.c_void_p if n in _PTRS else ctypes.c_longlong)
                for n in _FIELDS]


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("int_conv")
    size = lib.qbn_int_conv_args_size
    size.argtypes, size.restype = [], ctypes.c_int
    if size() != ctypes.sizeof(_Args):
        raise RuntimeError("csrc/int_conv.cu's QbnConvArgs and _Args differ")
    fn = lib.qbn_int_conv
    fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def conv_args(x, x_strides, x_shape, w, samples, stride, pad, out_shape,
              out, out_strides, q=None, bias=None, residual=None,
              relu=False, res_relu=False, a_lo=0, a_hi=127, raw=None,
              design=None, sms=132):
    """(QbnConvArgs, ConvPlan) of one launch of the kernel on `sms` SMs, as
    the kernel reads them. x_strides / out_strides: element strides of
    (b, h, w, sample); x_shape (B, H, W, cin); w: (S, kh, kw, cin, cout)
    per-sample weights (weight sample stride K * cout), or (kh, kw, cin,
    cout) shared by all `samples` (weight sample stride 0); out_shape
    (Ho, Wo); raw: (acc, winsum) int32 buffers for the debug entry.
    design: None takes the plan's; "im2col" forces the im2col body on any
    shape (for comparing the designs; nothing on the main path passes
    it). The wide body's transposed weights (`wt`) are the caller's to
    allocate."""
    b, h, wd, cin = x_shape
    kh, kw, _cin, cout = w.shape[-4:]
    ho, wo = out_shape
    k = kh * kw * cin
    if k > _MAX_K:
        raise ValueError(f"K = {k} would overflow the int32 sums")
    shared_w = w.ndim == 4
    plan = plan_conv(h, wd, cin, cout, kh, kw, stride, pad,
                     x_strides[3] == 0, _align(x.data_ptr(), x_strides),
                     _align(w.data_ptr(), ()), shared_w)
    if design == "im2col" and plan.design != "im2col":
        plan = ConvPlan("im2col", "forced", bm=_IM2COL_BM,
                        nt=_im2col_nt(cout))
    elif design not in (None, plan.design):
        raise ValueError(f"design {design!r} cannot run this shape: "
                         f"{plan.reason}")
    launch_grid(plan, b * ho * wo, samples, cout, sms)
    # 4-byte loads and stores where every run starts on a 4-byte boundary
    vec_x = (cin % 4 == 0 and all(v % 4 == 0 for v in x_strides)
             and x.data_ptr() % 4 == 0)
    vec_out = (raw is None and cout % 4 == 0
               and all(v % 4 == 0 for v in out_strides)
               and all(t is None or t.data_ptr() % 4 == 0
                       for t in (out, residual)))
    q = q or {}
    args = _Args(
        x=x.data_ptr(), x_sb=x_strides[0], x_sh=x_strides[1],
        x_sw=x_strides[2], x_ss=x_strides[3], B=b, H=h, W=wd, cin=cin,
        w=w.data_ptr(), w_ss=0 if shared_w else k * cout, S=samples, kh=kh,
        kw=kw, cout=cout, stride=stride, pad=pad,
        Ho=ho, Wo=wo, out=_ptr(out), o_sb=out_strides[0],
        o_sh=out_strides[1], o_sw=out_strides[2], o_ss=out_strides[3],
        res=_ptr(residual), bias=_ptr(bias),
        **{n: _ptr(q.get(n)) for n in (
            "x_scale", "w_scale", "w_zp", "out_scale", "out_zp", "res_scale",
            "res_out_scale", "res_out_zp")},
        relu=int(relu), res_relu=int(res_relu), a_lo=int(a_lo),
        a_hi=int(a_hi), raw_acc=_ptr(raw[0]) if raw else None,
        raw_win=_ptr(raw[1]) if raw else None, vec_x=int(vec_x),
        vec_out=int(vec_out), halo=int(plan.design == "halo"), bm=plan.bm,
        wide=int(plan.design == "wide"),
        nt=plan.nt, mt=plan.mt, wn=plan.wn, n_img=plan.n_img, rows=plan.rows,
        h_in=plan.h_in, w_in=plan.w_in, pitch=plan.pitch, vx=plan.vx,
        kc=plan.kc, ring=plan.ring, smem=plan.smem_bytes,
        pixel=int(plan.design == "pixel"))
    if plan.design == "pixel":
        args.sg, args.s_cta = sample_groups(
            plan, samples, -(-b * ho * wo // plan.bm) * (cout // plan.bn),
            sms)
        # the residual is read a byte at a time: only the output's
        # address and strides set the width of the stores
        args.vo = _align(out.data_ptr() if out is not None else 0,
                         (*out_strides, plan.bn))
    if plan.design in ("halo", "wide"):
        table = _tables(plan, x.device)
        args.koff = table.data_ptr()
        args.pixoff = table.data_ptr() + 4 * len(plan.koff)
    if plan.design == "wide":   # 16-byte stores where every address allows
        args.vo = min(_align(_ptr(out) or 0, out_strides),
                      _align(_ptr(residual) or 0, ()))
        args.sg = wide_sample_group(plan, samples, cout)
    return args, plan


def _launch(x, *shape_args, **kwargs):
    """One launch of the kernel (`conv_args`'s arguments) on the current
    stream; raises if the launch fails."""
    global launches, launches_residual
    args, plan = conv_args(x, *shape_args, sms=_sm_count(x.device),
                           **kwargs)
    if plan.design == "wide":   # the weights' K-major copy, written first
        wt = torch.empty(shape_args[2].numel(), dtype=torch.int8,
                         device=x.device)
        args.wt = wt.data_ptr()
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"qbn_int_conv launch failed: cudaError {err}")
    launches += 1
    launches_by_design[plan.design] += 1
    if args.w_ss == 0:
        launches_shared_w[plan.design] += 1
    if args.res:
        launches_residual += 1


def _merged_geometry(x_codes, w_codes, strides, padding, shared_x):
    """Checks the merged-layout operands of a CUDA call; returns
    (stride, pad, S, (B, H, W, cin), x element strides, (Ho, Wo))."""
    dev = x_codes.device
    if w_codes.ndim not in (4, 5):
        raise ValueError("w_codes must be (S, kh, kw, cin, cout), or "
                         "(kh, kw, cin, cout) shared by every sample")
    kh, kw, cin, cout = w_codes.shape[-4:]
    _check(w_codes, torch.int8, "w_codes", w_codes.shape, dev)
    if x_codes.ndim != 4:
        raise ValueError("x_codes must be (B, H, W, C)")
    b, h, wd, c = x_codes.shape
    if w_codes.ndim == 5:
        s = w_codes.shape[0]
    elif shared_x:
        raise ValueError("a shared input needs per-sample weights")
    else:
        s = c // cin
    _check(x_codes, torch.int8, "x_codes",
           (b, h, wd, cin if shared_x else s * cin), dev)
    stride, pad = _strides(strides), _padding(padding)
    ho, wo = _out_hw(h, wd, kh, kw, stride, pad)
    x_strides = (h * wd * c, wd * c, c, 0 if shared_x else cin)
    return stride, pad, s, (b, h, wd, cin), x_strides, (ho, wo)


def _per_sample(w_codes, x_codes, shared_x):
    """Weights (kh, kw, cin, cout) shared by every sample of a merged input,
    broadcast to (S, kh, kw, cin, cout) for the plain versions."""
    if w_codes.ndim == 5 or shared_x:
        return w_codes
    return w_codes.expand(x_codes.shape[3] // w_codes.shape[2],
                          *w_codes.shape)


# -- the operators ----------------------------------------------------------
#
# Each entry below converts its Python qparams to tensors and its strides
# and padding to ints, and calls its operator; the operator's CPU
# implementation runs the plain version, its CUDA implementation checks the
# operands, plans and launches the kernel (`_launch`: the pointers, the
# alignments and the SM count are read there, on real tensors), inside the
# span `op.int_conv` (profiling.span).

def _as_scale(v, dev):
    return v if isinstance(v, torch.Tensor) else \
        torch.as_tensor(v, device=dev).to(torch.float32)


def _as_zp(v, dev):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=dev)


def _as_qparams(dev, x_scale, w_scale, w_zp, out_scale, out_zp):
    return (_as_scale(x_scale, dev), _as_scale(w_scale, dev),
            _as_zp(w_zp, dev), _as_scale(out_scale, dev), _as_zp(out_zp, dev))


def _pair(stride, pad):
    return (stride, stride), ((pad, pad), (pad, pad))


def _merged_out_shape(x_codes, w_codes, stride, pad, shared_x):
    kh, kw, cin, cout = w_codes.shape[-4:]
    b, h, wd, c = x_codes.shape
    s = w_codes.shape[0] if w_codes.ndim == 5 else c // cin
    return (b, *_out_hw(h, wd, kh, kw, stride, pad), s, cout)


def _merged_cpu(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                out_zp, stride, pad, a_lo, a_hi, relu, shared_x, residual,
                res_scale, res_out_scale, res_out_zp, res_relu, design):
    q = _qparams(x_codes.device, x_scale, w_scale, w_zp, out_scale, out_zp,
                 *((res_scale, res_out_scale, res_out_zp)
                   if residual is not None else ()))
    return int_conv_merged_plain(
        x_codes, q["x_scale"], _per_sample(w_codes, x_codes, shared_x),
        q["w_scale"], q["w_zp"], bias, q["out_scale"], q["out_zp"],
        *_pair(stride, pad), a_lo, a_hi, relu, shared_x, residual,
        q.get("res_scale"), q.get("res_out_scale"), q.get("res_out_zp"),
        res_relu)


def _merged_cuda(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                 out_zp, stride, pad, a_lo, a_hi, relu, shared_x, residual,
                 res_scale, res_out_scale, res_out_zp, res_relu, design):
    with span("op.int_conv"):
        dev = x_codes.device
        q = _qparams(dev, x_scale, w_scale, w_zp, out_scale, out_zp,
                     *((res_scale, res_out_scale, res_out_zp)
                       if residual is not None else ()))
        _stride, _pad, s, x_shape, x_strides, (ho, wo) = _merged_geometry(
            x_codes, w_codes, *_pair(stride, pad), shared_x)
        cout = w_codes.shape[-1]
        b = x_shape[0]
        if bias is not None:
            _check(bias, torch.float32, "bias", (cout,), dev)
        if residual is not None:
            _check(residual, torch.int8, "residual", (b, ho, wo, s * cout),
                   dev)
        out = torch.empty((b, ho, wo, s * cout), dtype=torch.int8, device=dev)
        _launch(x_codes, x_strides, x_shape, w_codes, s, stride, pad, (ho, wo),
                out, (ho * wo * s * cout, wo * s * cout, s * cout, cout), q,
                bias, residual, relu, res_relu, a_lo, a_hi, design=design)
        return out


def _merged_fake(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                 out_zp, stride, pad, a_lo, a_hi, relu, shared_x, residual,
                 res_scale, res_out_scale, res_out_zp, res_relu, design):
    b, ho, wo, s, cout = _merged_out_shape(x_codes, w_codes, stride, pad,
                                           shared_x)
    return x_codes.new_empty((b, ho, wo, s * cout))


_QP_SCHEMA = ("Tensor x_scale, Tensor w, Tensor w_scale, Tensor w_zp, "
              "Tensor? bias, Tensor out_scale, Tensor out_zp, int stride, "
              "int pad, int a_lo, int a_hi, bool relu")

int_conv_merged_op = library.define(
    "int_conv_merged",
    f"(Tensor x, {_QP_SCHEMA}, bool shared_x, Tensor? residual, "
    "Tensor? res_scale, Tensor? res_out_scale, Tensor? res_out_zp, "
    "bool res_relu, str? design) -> Tensor",
    _merged_cpu, _merged_cuda, _merged_fake)


def int_conv_merged(x_codes, x_scale, w_codes, w_scale, w_zp, bias,
                    out_scale, out_zp, strides, padding,
                    a_lo: int, a_hi: int, relu: bool = False,
                    shared_x: bool = False, residual=None,
                    res_scale=None, res_out_scale=None, res_out_zp=None,
                    res_relu: bool = False, _design=None):
    """All-samples quantised conv in the MERGED channel layout.

    x_codes: (B, H, W, S*cin) int8 codes, sample-major channel groups, or
      (B, H, W, cin) when shared_x (the stem: one image, S weights).
    w_codes: (S, kh, kw, cin, cout) int8 per-sample weight codes, or
      (kh, kw, cin, cout) shared by every sample (a deterministic conv in
      the merged layout; not with shared_x).
    strides: (sh, sw); padding: ((p, p), (p, p)).
    residual (optional): (B, H', W', S*cout) int8 codes at scale
      res_scale; the quantised add (dequant both, add, requant to
      res_out_scale/zp, optional ReLU) then follows the conv's requant.
    _design: private, for comparing the kernel's two bodies (see
      `_launch`); the main path never passes it.
    Returns (B, H', W', S*cout) int8 codes, from the operator
    `qbn_tpu_torch::int_conv_merged`.
    """
    dev = x_codes.device
    res = ((_as_scale(res_scale, dev), _as_scale(res_out_scale, dev),
            _as_zp(res_out_zp, dev)) if residual is not None
           else (None, None, None))
    xs, ws, wz, os_, oz = _as_qparams(dev, x_scale, w_scale, w_zp, out_scale,
                                      out_zp)
    return int_conv_merged_op(
        x_codes, xs, w_codes, ws, wz, bias, os_, oz, _strides(strides),
        _padding(padding), int(a_lo), int(a_hi), bool(relu), bool(shared_x),
        residual, *res, bool(res_relu), _design)


def int_conv_plain(x_codes, x_scale, w_codes, w_scale, w_zp, bias,
                   out_scale, out_zp, strides, padding, a_lo: int, a_hi: int,
                   relu: bool = False):
    """`int_conv` in plain PyTorch: the samples folded into the batch and
    one group of weights (qbn_tpu's rule for per-sample x and shared w),
    through int_conv_merged_plain's float64 library convs and epilogue."""
    lead = x_codes.shape[:-3]
    out = int_conv_merged_plain(
        x_codes.reshape(-1, *x_codes.shape[-3:]), x_scale, w_codes[None],
        w_scale, w_zp, bias, out_scale, out_zp, strides, padding, a_lo, a_hi,
        relu)
    return out.reshape(*lead, *out.shape[1:])


def _shared_cpu(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                out_zp, stride, pad, a_lo, a_hi, relu, design):
    q = _qparams(x_codes.device, x_scale, w_scale, w_zp, out_scale, out_zp)
    return int_conv_plain(x_codes, q["x_scale"], w_codes, q["w_scale"],
                          q["w_zp"], bias, q["out_scale"], q["out_zp"],
                          *_pair(stride, pad), a_lo, a_hi, relu)


def _shared_cuda(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                 out_zp, stride, pad, a_lo, a_hi, relu, design):
    with span("op.int_conv"):
        dev = x_codes.device
        q = _qparams(dev, x_scale, w_scale, w_zp, out_scale, out_zp)
        kh, kw, cin, cout = w_codes.shape
        _check(w_codes, torch.int8, "w_codes", w_codes.shape, dev)
        lead = tuple(x_codes.shape[:-3])
        b, h, wd = x_codes.shape[-4:-1]
        _check(x_codes, torch.int8, "x_codes", (*lead, h, wd, cin), dev)
        if bias is not None:
            _check(bias, torch.float32, "bias", (cout,), dev)
        ho, wo = _out_hw(h, wd, kh, kw, stride, pad)
        s = lead[0] if x_codes.ndim == 5 else 1
        out = torch.empty((*lead, ho, wo, cout), dtype=torch.int8, device=dev)
        _launch(x_codes, _sample_strides(b, h, wd, cin), (b, h, wd, cin),
                w_codes, s, stride, pad, (ho, wo), out,
                (ho * wo * cout, wo * cout, cout, b * ho * wo * cout), q, bias,
                None, relu, False, a_lo, a_hi, design=design)
        return out


def _shared_fake(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                 out_zp, stride, pad, a_lo, a_hi, relu, design):
    kh, kw, _cin, cout = w_codes.shape
    h, wd = x_codes.shape[-3:-1]
    return x_codes.new_empty((*x_codes.shape[:-3],
                              *_out_hw(h, wd, kh, kw, stride, pad), cout))


int_conv_op = library.define(
    "int_conv", f"(Tensor x, {_QP_SCHEMA}, str? design) -> Tensor",
    _shared_cpu, _shared_cuda, _shared_fake)


def int_conv(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
             out_zp, strides, padding, a_lo: int, a_hi: int,
             relu: bool = False, _design=None):
    """Quantised conv with ONE set of weights for every sample (port of
    qbn_tpu/ops/integer.py int_conv, with _conv_core's rules for a shared
    input and for per-sample activations with shared weights): MC-Dropout,
    pointwise and each member of an ensemble; the operator
    `qbn_tpu_torch::int_conv`.

    x_codes: (S, B, H, W, cin) int8 codes of S samples (masked
      activations), or (B, H, W, cin) of one (computed once, as qbn_tpu's
      vmap computes an unbatched conv).
    w_codes: (kh, kw, cin, cout) int8 weight codes.
    Returns (S, B, H', W', cout) or (B, H', W', cout) int8 codes.

    On the card the samples ride the kernel's sample axis (stride
    B*H*W*cin) and the weights have a sample stride of 0, so that S
    samples of B images never fold into S*B images, which would pass the
    grid's 65535 pixel tiles at B=256, S=100 (`launch_grid`). Input
    without a sample axis is one sample (S=1), so that it takes the
    per-sample plans (the halo body for the 3x3 convs)."""
    if x_codes.ndim not in (4, 5) or w_codes.ndim != 4:
        raise ValueError("x_codes must be (S, B, H, W, cin) or (B, H, W, "
                         "cin), w_codes (kh, kw, cin, cout)")
    xs, ws, wz, os_, oz = _as_qparams(x_codes.device, x_scale, w_scale, w_zp,
                                      out_scale, out_zp)
    return int_conv_op(x_codes, xs, w_codes, ws, wz, bias, os_, oz,
                       _strides(strides), _padding(padding), int(a_lo),
                       int(a_hi), bool(relu), _design)


def _group_cpu(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
               out_zp, stride, pad, a_lo, a_hi, relu, design):
    s, b, h, wd, _c = x_codes.shape
    cout = w_codes.shape[-1]
    xm = x_codes.permute(1, 2, 3, 0, 4).reshape(b, h, wd, s * x_codes.shape[4])
    out = _merged_cpu(xm, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                      out_zp, stride, pad, a_lo, a_hi, relu, False, None,
                      None, None, None, False, design)
    ho, wo = out.shape[1:3]
    return out.reshape(b, ho, wo, s, cout).permute(3, 0, 1, 2, 4).contiguous()


def _group_cuda(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                out_zp, stride, pad, a_lo, a_hi, relu, design):
    with span("op.int_conv"):
        dev = x_codes.device
        s, kh, kw, cin, cout = w_codes.shape
        _s, b, h, wd, _c = x_codes.shape
        q = _qparams(dev, x_scale, w_scale, w_zp, out_scale, out_zp)
        _check(w_codes, torch.int8, "w_codes", w_codes.shape, dev)
        _check(x_codes, torch.int8, "x_codes", (s, b, h, wd, cin), dev)
        if bias is not None:
            _check(bias, torch.float32, "bias", (cout,), dev)
        ho, wo = _out_hw(h, wd, kh, kw, stride, pad)
        out = torch.empty((s, b, ho, wo, cout), dtype=torch.int8, device=dev)
        _launch(x_codes, (h * wd * cin, wd * cin, cin, b * h * wd * cin),
                (b, h, wd, cin), w_codes, s, stride, pad, (ho, wo), out,
                (ho * wo * cout, wo * cout, cout, b * ho * wo * cout), q, bias,
                None, relu, False, a_lo, a_hi, design=design)
        return out


def _group_fake(x_codes, x_scale, w_codes, w_scale, w_zp, bias, out_scale,
                out_zp, stride, pad, a_lo, a_hi, relu, design):
    s, kh, kw, _cin, cout = w_codes.shape
    _s, b, h, wd, _c = x_codes.shape
    return x_codes.new_empty((s, b, *_out_hw(h, wd, kh, kw, stride, pad),
                              cout))


mc_group_conv_op = library.define(
    "mc_group_conv", f"(Tensor x, {_QP_SCHEMA}, str? design) -> Tensor",
    _group_cpu, _group_cuda, _group_fake)


def mc_group_conv(x_codes, x_scale, w_codes, w_scale, w_zp, bias,
                  out_scale, out_zp, a_lo: int, a_hi: int,
                  relu: bool = False, strides=(1, 1), padding=None,
                  _design=None):
    """Per-sample int8 conv in K3's layout: (S, B, H, W, cin) x
    (S, kh, kw, cin, cout) -> (S, B, H', W', cout) int8 codes, with
    int_conv_merged's epilogue (the operator
    `qbn_tpu_torch::mc_group_conv`). padding defaults to kh // 2 on each
    side (qbn_tpu's mc_group_conv is the 3x3, stride-1, pad-1 case)."""
    s, kh = w_codes.shape[:2]
    if padding is None:
        padding = ((kh // 2, kh // 2), (kh // 2, kh // 2))
    if x_codes.ndim != 5 or x_codes.shape[0] != s:
        raise ValueError("x_codes must be (S, B, H, W, cin)")
    xs, ws, wz, os_, oz = _as_qparams(x_codes.device, x_scale, w_scale, w_zp,
                                      out_scale, out_zp)
    return mc_group_conv_op(x_codes, xs, w_codes, ws, wz, bias, os_, oz,
                            _strides(strides), _padding(padding), int(a_lo),
                            int(a_hi), bool(relu), _design)


def _sums_cpu(x_codes, w_codes, stride, pad, shared_x, design):
    return int_conv_sums_plain(
        x_codes, _per_sample(w_codes, x_codes, shared_x), *_pair(stride, pad),
        shared_x)


def _sums_cuda(x_codes, w_codes, stride, pad, shared_x, design):
    with span("op.int_conv"):
        _stride, _pad, s, x_shape, x_strides, (ho, wo) = _merged_geometry(
            x_codes, w_codes, *_pair(stride, pad), shared_x)
        b, cout = x_shape[0], w_codes.shape[-1]
        dev = x_codes.device
        acc = torch.empty((b, ho, wo, s, cout), dtype=torch.int32, device=dev)
        win = torch.empty((b, ho, wo, s), dtype=torch.int32, device=dev)
        _launch(x_codes, x_strides, x_shape, w_codes, s, stride, pad, (ho, wo),
                None, (0, 0, 0, 0), raw=(acc, win), design=design)
        return acc, win


def _sums_fake(x_codes, w_codes, stride, pad, shared_x, design):
    b, ho, wo, s, cout = _merged_out_shape(x_codes, w_codes, stride, pad,
                                           shared_x)
    return (x_codes.new_empty((b, ho, wo, s, cout), dtype=torch.int32),
            x_codes.new_empty((b, ho, wo, s), dtype=torch.int32))


int_conv_sums_op = library.define(
    "int_conv_sums",
    "(Tensor x, Tensor w, int stride, int pad, bool shared_x, str? design) "
    "-> (Tensor, Tensor)",
    _sums_cpu, _sums_cuda, _sums_fake)


def int_conv_sums(x_codes, w_codes, strides, padding, shared_x: bool = False,
                  _design=None):
    """The raw sums that int_conv_merged's epilogue starts from, for
    checking: (acc (B, H', W', S, cout), winsum (B, H', W', S)) int32, acc
    the conv of the codes with the weight codes (no zero point), winsum the
    window sum of each sample's activations (the operator
    `qbn_tpu_torch::int_conv_sums`)."""
    return int_conv_sums_op(x_codes, w_codes, _strides(strides),
                            _padding(padding), bool(shared_x), _design)


def merged_plan(x_codes, w_codes, strides, padding, shared_x: bool = False):
    """The ConvPlan that `int_conv_merged` runs these operands with."""
    stride, pad, _s, (_b, h, wd, cin), x_strides, _hw = _merged_geometry(
        x_codes, w_codes, strides, padding, shared_x)
    kh, kw, _cin, cout = w_codes.shape[-4:]
    return plan_conv(h, wd, cin, cout, kh, kw, stride, pad, shared_x,
                     _align(x_codes.data_ptr(), x_strides),
                     _align(w_codes.data_ptr(), ()), w_codes.ndim == 4)


def _sample_strides(b, h, w, cin):
    """Element strides of (b, h, w, sample) of (S, B, H, W, cin) codes."""
    return (h * w * cin, w * cin, cin, b * h * w * cin)


def conv_plan(x_codes, w_codes, strides, padding):
    """The ConvPlan that `int_conv` runs these operands with."""
    kh, kw, cin, cout = w_codes.shape
    b, h, wd = x_codes.shape[-4:-1]
    return plan_conv(h, wd, cin, cout, kh, kw, _strides(strides),
                     _padding(padding), False,
                     _align(x_codes.data_ptr(),
                            _sample_strides(b, h, wd, cin)),
                     _align(w_codes.data_ptr(), ()), True)
