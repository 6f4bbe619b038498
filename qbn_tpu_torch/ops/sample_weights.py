"""Bulk int8 posterior weight draw (port of qbn_tpu/ops/pallas/sample_weights.py).

`draw_layers` draws S int8 samples of every layer of a pack in ONE launch
of the CUDA kernel in `csrc/sample_weights.cu`, which computes the
function of qbn_tpu's `sample_weights_int8` (one layer) and
`draw_all_layers` (many layers, any size). The normals come from a Philox
generator inside the kernel, keyed by a seed and offset taken from the
caller's `torch.Generator`, or from explicit noise, in which case the
codes are bitwise those of `sample_weights_plain`, the line-for-line port
of qbn_tpu's `sample_weights_oracle`.

On a CPU tensor the wrapper runs the plain version (fed `torch.randn` from
the generator when no noise is given). On a CUDA tensor it launches the
kernel or raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from qbn_tpu_torch.ops import _build
from qbn_tpu_torch.quant.bounds import NOISE_SCALE

QPARAM_KEYS = ("w_scale", "w_zp", "std_scale", "std_zp", "mul_scale",
               "mul_zp", "add_scale", "add_zp")
_PER_THREAD = 16      # outputs per kernel thread; layer blocks align to it

# Kernel launches since the count was last set to 0; chip_smoke.py reads
# it to show that the main path went through the kernel.
launches = 0


def sample_weights_plain(w_codes, std_codes, qparams, noise, w_lo: int,
                         w_hi: int):
    """Plain PyTorch draw given explicit noise: qbn_tpu's
    sample_weights_oracle, operation for operation in float32
    (multiply by the reciprocal, not divide; round half to even).

    w_codes / std_codes: (M, N) int8; noise: (S, M, N) float32;
    qparams: dict of the eight QPARAM_KEYS scalars. Returns (S, M, N) int8.
    """
    f32 = torch.float32
    dev = noise.device

    def qp(k):
        return torch.as_tensor(qparams[k], device=dev).to(f32)

    inv_noise = torch.tensor(1.0 / NOISE_SCALE, dtype=f32, device=dev)
    noise_scale = torch.tensor(NOISE_SCALE, dtype=f32, device=dev)
    eps_q = torch.clamp(torch.round(noise.to(f32) * inv_noise), -128, 127)
    std_f = (std_codes.to(f32) - qp("std_zp")) * qp("std_scale")
    prod = torch.clamp(torch.round(std_f * (eps_q * noise_scale)
                                   * torch.reciprocal(qp("mul_scale")))
                       + qp("mul_zp"), -128, 127)
    w_f = (w_codes.to(f32) - qp("w_zp")) * qp("w_scale")
    prod_f = (prod - qp("mul_zp")) * qp("mul_scale")
    ws = torch.clamp(torch.round((w_f + prod_f)
                                 * torch.reciprocal(qp("add_scale")))
                     + qp("add_zp"), -128, 127)
    return torch.clamp(ws, w_lo, w_hi).to(torch.int8)


@dataclass
class LayerPack:
    """Every layer of one draw, packed for a single launch.

    w / std: all layers' codes, flattened and concatenated (int8).
    qtab: (L, 10) float32 — the eight qparams, then w_lo, w_hi.
    meta: (L, 4) int64 — first kernel thread, first output element, first
      code, elements per sample (n = M*N).
    Layer l's samples fill out[dst_l : dst_l + S*n_l], a contiguous
    (S, *shape_l) block; dst_l is a multiple of 16.
    """
    w: torch.Tensor
    std: torch.Tensor
    qtab: torch.Tensor
    meta: torch.Tensor
    shapes: List[Tuple[int, ...]]
    dst: List[int]
    samples: int
    total: int          # output elements, padding included
    chunks: int         # kernel threads
    layers: list        # the (w, std, qparams, w_lo, w_hi) given


def pack_layers(layers: Sequence, samples: int) -> LayerPack:
    """layers: [(w_codes, std_codes, qparams, w_lo, w_hi)], codes of any
    shape (the draw is elementwise), all on one device."""
    if samples < 1:
        raise ValueError("samples must be >= 1")
    dev = layers[0][0].device
    rows, shapes, dst_offs = [], [], []
    chunk = dst = src = 0
    for (w, std, qparams, w_lo, w_hi) in layers:
        if w.shape != std.shape:
            raise ValueError("w_codes and std_codes differ in shape")
        n = w.numel()
        rows.append((chunk, dst, src, n))
        shapes.append(tuple(w.shape))
        dst_offs.append(dst)
        block = samples * n
        chunk += -(-block // _PER_THREAD)
        dst += -(-block // _PER_THREAD) * _PER_THREAD
        src += n
    qtab = torch.stack([
        torch.stack([torch.as_tensor(qp[k], device=dev).to(torch.float32)
                     for k in QPARAM_KEYS]
                    + [torch.tensor(float(lo), device=dev),
                       torch.tensor(float(hi), device=dev)])
        for (_w, _s, qp, lo, hi) in layers])
    return LayerPack(
        w=torch.cat([l[0].reshape(-1).to(torch.int8) for l in layers]),
        std=torch.cat([l[1].reshape(-1).to(torch.int8) for l in layers]),
        qtab=qtab.contiguous(),
        meta=torch.tensor(rows, dtype=torch.int64, device=dev),
        shapes=shapes, dst=dst_offs, samples=samples, total=dst,
        chunks=chunk, layers=list(layers))


def _lib():
    lib = _build.load("sample_weights")
    fn = lib.qbn_draw_int8
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, vp, ctypes.c_ulonglong, ctypes.c_ulonglong,
                   vp, vp]
    fn.restype = ctypes.c_int
    return fn


def _unpack(pack: LayerPack, flat: torch.Tensor) -> List[torch.Tensor]:
    s = pack.samples
    return [flat[d:d + s * math.prod(sh)].view((s,) + sh)
            for d, sh in zip(pack.dst, pack.shapes)]


def _check(t: torch.Tensor, dtype, name: str, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def draw_layers(pack: LayerPack, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
    """S int8 samples of every layer of `pack`: a list of (S, *shape_l)
    tensors, in layer order.

    noise (testing): one (S, *shape_l) float32 tensor per layer; otherwise
    the normals are drawn from `generator` (the default generator of the
    CPU when None)."""
    global launches
    s = pack.samples
    if noise is not None and len(noise) != len(pack.shapes):
        raise ValueError("noise needs one tensor per layer")
    if pack.w.device.type == "cpu":
        out = []
        for i, (w, std, qp, lo, hi) in enumerate(pack.layers):
            eps = (noise[i] if noise is not None else
                   torch.randn((s,) + tuple(w.shape), generator=generator))
            out.append(sample_weights_plain(w, std, qp, eps, lo, hi))
        return out

    dev = pack.w.device
    for t, dt, name in ((pack.w, torch.int8, "w"),
                        (pack.std, torch.int8, "std"),
                        (pack.qtab, torch.float32, "qtab"),
                        (pack.meta, torch.int64, "meta")):
        _check(t, dt, name, dev)
    noise_ptr, noise_buf = None, None
    if noise is not None:
        noise_buf = torch.zeros(pack.total, dtype=torch.float32, device=dev)
        for t, d, sh in zip(noise, pack.dst, pack.shapes):
            if tuple(t.shape) != (s,) + sh:
                raise ValueError(f"noise shape {tuple(t.shape)} != "
                                 f"{(s,) + sh}")
            _check(t, torch.float32, "noise", dev)
            noise_buf[d:d + t.numel()] = t.reshape(-1)
        noise_ptr = noise_buf.data_ptr()
        seed = offset = 0
    else:
        gen_dev = generator.device if generator is not None else "cpu"
        seed, offset = torch.randint(0, 2 ** 62, (2,), generator=generator,
                                     device=gen_dev).tolist()
    flat = torch.empty(pack.total, dtype=torch.int8, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pack.w.data_ptr(), pack.std.data_ptr(), pack.qtab.data_ptr(),
                 pack.meta.data_ptr(), len(pack.shapes), pack.chunks, s,
                 noise_ptr, seed, offset, flat.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"qbn_draw_int8 launch failed: cudaError {err}")
    launches += 1
    return _unpack(pack, flat)


def sample_weights_int8(w_codes, std_codes, qparams, samples: int,
                        w_lo: int, w_hi: int,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None):
    """Draw `samples` int8 weight samples of one layer: (S, *w.shape)."""
    pack = pack_layers([(w_codes, std_codes, qparams, w_lo, w_hi)], samples)
    return draw_layers(pack, generator,
                       None if noise is None else [noise])[0]
