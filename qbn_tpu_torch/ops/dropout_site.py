"""One MC-Dropout site of INT8 evaluation: the keep mask applied to int8
codes on the multiply's grid (models/layers.py BernoulliDropout in int
mode).

qbn_tpu has no kernel for it: its INT branch runs inside XLA fusions. The
operator `qbn_tpu_torch::dropout_site` (ops/library.py), which
`dropout_site` calls, runs `dropout_site_plain` on CPU tensors and on CUDA
tensors launches the hand-written kernel of `csrc/dropout_site.cu` or
raises: there is no fallback. The kernel looks each code up in a 2 x 256
table of output codes that every CTA builds from the site's scalars with
the plain version's float32 arithmetic, so its codes are bitwise the plain
version's for a binary keep mask, which every mask source of
ops/stochastic.py gives. `site_plan` is the launch's plan: vector width,
threads, chunks and work items, by shape alone. The host's checks and
launch are the span `op.dropout_site`.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from qbn_tpu_torch.ops import _build, library
from qbn_tpu_torch.profiling import span

_ITEMS = 4             # vectors a thread keeps in flight (kItems)
_MAX_THREADS = 1024
_THREADS_PER_SM = 2048

# Kernel launches since the count was last set to 0; chip_smoke.py reads
# it to show that the MC-Dropout paths went through the kernel.
launches = 0


def dropout_site_plain(codes, mask, x_scale, mul_scale, mul_zp, a_lo: int,
                       a_hi: int, multiplier: float):
    """The site in plain PyTorch: (codes, scale) of the output.

    codes: int8, (B, ..., C) shared by every sample or (S, B, ..., C) per
      sample; mask: (S, B, 1, .., 1, C) float32 (or (S, B, F) for a dense
      site), broadcast against codes. The mask is quantised on the
    multiply's output grid and dequantised, the codes dequantised,
    multiplied and requantised to that grid; the output scale is
    mul_scale * float32(multiplier)."""
    mz_f = mul_zp.to(torch.float32)
    mask_q = torch.clamp(torch.round(mask / mul_scale) + mz_f, 0, 255)
    mask_deq = (mask_q.to(torch.int32).to(torch.float32) - mz_f) * mul_scale
    prod = codes.to(torch.float32) * x_scale * mask_deq
    q = torch.clamp(torch.round(prod / mul_scale) + mz_f, a_lo, a_hi)
    out = (q.to(torch.int32) - mul_zp).to(torch.int8)
    mult = torch.tensor(multiplier, dtype=torch.float32,
                        device=mul_scale.device)
    return out, mul_scale * mult


@dataclass(frozen=True)
class SitePlan:
    """One launch: codes in vectors of `vec` bytes, `vpp` a pixel; rows of
    x (B, or S * B per sample) of `nvr` vectors, cut in `chunks` chunks of
    `chunk_len`; `items` = rows x chunks, walked by `blocks` CTAs of
    `threads` (a multiple of vpp, so that a thread keeps one channel
    group)."""
    batch: int
    samples: int
    shared: bool
    pixels: int
    channels: int
    vec: int
    vpp: int
    threads: int
    nvr: int
    chunk_len: int
    chunks: int
    items: int
    blocks: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align(ptr: int) -> int:
    """The largest power of two up to 16 that divides ptr."""
    return min(16, ptr & -ptr) if ptr else 16


def site_geometry(x_shape, mask_shape):
    """(samples, batch, shared, pixels, channels) of a site's codes and
    mask; raises on shapes the site does not take."""
    x_shape, mask_shape = tuple(x_shape), tuple(mask_shape)
    if len(mask_shape) < 3:
        raise ValueError(f"mask {mask_shape} is not (S, B, ..., C)")
    s, b, c = mask_shape[0], mask_shape[1], mask_shape[-1]
    shared = len(x_shape) == len(mask_shape) - 1
    lead = (b,) if shared else (s, b)
    feat = x_shape[len(lead):]
    if (len(x_shape) not in (len(mask_shape) - 1, len(mask_shape))
            or x_shape[:len(lead)] != lead or len(feat) != len(mask_shape) - 2
            or feat[-1] != c or any(d != 1 for d in mask_shape[2:-1])):
        raise ValueError(f"codes {x_shape} and mask {mask_shape} do not "
                         "make a site")
    return s, b, shared, math.prod(feat[:-1]), c


def site_plan(x_shape, mask_shape, x_align: int = 16, mask_align: int = 16,
              sms: int = 132) -> SitePlan:
    """The plan of one launch on `sms` SMs, for codes and mask of these
    shapes whose pointers are aligned to x_align and mask_align bytes."""
    s, b, shared, p, c = site_geometry(x_shape, mask_shape)
    vec = next(v for v in (16, 8, 4, 2, 1) if c % v == 0 and x_align % v == 0
               and mask_align % (4 * min(v, 4)) == 0)
    vpp = c // vec
    if vpp > _MAX_THREADS:
        raise ValueError(f"{c} channels in vectors of {vec}: more than "
                         f"{_MAX_THREADS} vectors a pixel")
    threads = vpp * max(1, 256 // vpp)
    nvr = p * vpp
    chunks = max(1, _cdiv(nvr, threads * _ITEMS))
    chunk_len = _cdiv(_cdiv(nvr, chunks), vpp) * vpp
    items = (b if shared else s * b) * chunks
    if items >= 1 << 31:
        raise ValueError(f"{items} work items exceed 2^31")
    blocks = max(1, min(items, sms * (_THREADS_PER_SM // threads)))
    return SitePlan(b, s, shared, p, c, vec, vpp, threads, nvr, chunk_len,
                    chunks, items, blocks)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("dropout_site")
    fn = lib.qbn_dropout_site
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, ctypes.c_float, vp, vp, ll,
                   i, i, ll, i, i, i, i, i, i, i, vp]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(t: torch.Tensor, dtypes, name: str, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _out_shape(x, mask):
    return tuple(x.shape) if x.ndim == mask.ndim else (mask.shape[0],
                                                        *x.shape)


def _site_cpu(x, mask, x_scale, mul_scale, mul_zp, a_lo, a_hi, multiplier):
    site_geometry(x.shape, mask.shape)
    return dropout_site_plain(x, mask, x_scale, mul_scale, mul_zp, a_lo,
                              a_hi, multiplier)


def _site_cuda(x, mask, x_scale, mul_scale, mul_zp, a_lo, a_hi, multiplier):
    """One launch of the site kernel (the span `op.dropout_site`); raises
    if it fails."""
    global launches
    with span("op.dropout_site"):
        dev = x.device
        _check(x, (torch.int8,), "codes", dev)
        _check(mask, (torch.float32,), "mask", dev)
        for t, name, dtypes in (
                (x_scale, "x_scale", (torch.float32,)),
                (mul_scale, "mul_scale", (torch.float32,)),
                (mul_zp, "mul_zp", (torch.int32, torch.float32))):
            _check(t, dtypes, name, dev)
            if t.numel() != 1:
                raise ValueError(f"{name} must be a scalar: "
                                 f"{tuple(t.shape)}")
        plan = site_plan(x.shape, mask.shape, _align(x.data_ptr()),
                         _align(mask.data_ptr()), _sms(dev.index or 0))
        out = torch.empty(_out_shape(x, mask), dtype=torch.int8, device=dev)
        scale = torch.empty((), dtype=torch.float32, device=dev)
        fn = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x.data_ptr(), mask.data_ptr(), x_scale.data_ptr(),
                     mul_scale.data_ptr(), mul_zp.data_ptr(),
                     int(mul_zp.dtype == torch.float32), a_lo, a_hi,
                     multiplier, out.data_ptr(), scale.data_ptr(),
                     plan.batch, plan.samples, int(plan.shared), plan.nvr,
                     plan.vec, plan.vpp, plan.threads, plan.chunk_len,
                     plan.chunks, plan.items, plan.blocks, stream)
        if err != 0:
            raise RuntimeError(
                f"qbn_dropout_site launch failed: cudaError {err}")
        launches += 1
        return out, scale


def _site_fake(x, mask, x_scale, mul_scale, mul_zp, a_lo, a_hi, multiplier):
    return (x.new_empty(_out_shape(x, mask)),
            mul_scale.new_empty((), dtype=torch.float32))


dropout_site_op = library.define(
    "dropout_site",
    "(Tensor x, Tensor mask, Tensor x_scale, Tensor mul_scale, "
    "Tensor mul_zp, int a_lo, int a_hi, float multiplier) -> "
    "(Tensor, Tensor)",
    _site_cpu, _site_cuda, _site_fake)


def dropout_site(codes, mask, x_scale, mul_scale, mul_zp, a_lo: int,
                 a_hi: int, multiplier: float):
    """The site's (codes, scale): codes (S, B, ..., C) int8 from codes (B,
    ..., C) shared by every sample or (S, B, ..., C) per sample and the
    (S, B, 1, .., 1, C) keep mask (a dense site's (S, B, F)), from the
    operator `qbn_tpu_torch::dropout_site`."""
    return dropout_site_op(codes, mask, x_scale, mul_scale, mul_zp,
                           int(a_lo), int(a_hi), float(multiplier))
