"""Bulk int8 posterior weight draw (port of qbn_tpu/ops/pallas/sample_weights.py).

`draw_layers` draws S int8 samples of every layer of a pack in ONE launch
of the CUDA kernel in `csrc/sample_weights.cu`, which computes the
function of qbn_tpu's `sample_weights_int8` (one layer) and
`draw_all_layers` (many layers, any size). With explicit noise the codes
are bitwise those of `sample_weights_plain`, the line-for-line port of
qbn_tpu's `sample_weights_oracle`. Without it the normals are qbn_tpu's
default seeded draw: one inverse-CDF normal (`icdf_normals`, qbn_tpu's
`_fast_ndtri` of a 23-bit uniform) per output element, its 32 random bits
from Philox-4x32-10 (`philox4x32`) keyed by a seed and offset taken from
the caller's `torch.Generator`. The bits are a function of (seed, offset,
layer index in the pack, element index in the layer's (S, *shape)
block), so the CPU and the card draw the same codes.

The draw is the operator `qbn_tpu_torch::draw_int8` (ops/library.py),
which `draw_layers` calls: on CPU tensors it runs the plain version, on
CUDA tensors it launches the kernel or raises: there is no fallback. Its
seed and offset come in an int64 tensor, read inside the operator, so
that a traced forward's draw follows the tensor.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from qbn_tpu_torch.ops import _build, library
from qbn_tpu_torch.profiling import span
from qbn_tpu_torch.quant.bounds import NOISE_SCALE

QPARAM_KEYS = ("w_scale", "w_zp", "std_scale", "std_zp", "mul_scale",
               "mul_zp", "add_scale", "add_zp")
_VEC = 16             # outputs per 16-byte store; layer blocks align to it
_TILE = 256           # kernel threads per CTA: one work item each per tile
_SAMPLES_PER_ITEM = 4  # samples a thread draws of its 16 elements

# Kernel launches since the count was last set to 0; chip_smoke.py reads
# it to show that the main path went through the kernel.
launches = 0


# -- the seeded normals ---------------------------------------------------

_MASK = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit halves of a * m for uint32 values a (int64 tensor)
    and a uint32 constant m, through 16-bit halves of m: a signed int64
    cannot hold a full 64-bit product."""
    p_lo = a * (m & 0xFFFF)                          # < 2^48
    p_hi = a * (m >> 16)
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK
    return hi, lo


def philox4x32(ctr, key):
    """Philox-4x32-10 (Salmon et al., SC'11) on int64 tensors holding
    uint32 words: ctr a 4-tuple, key a 2-tuple (tensors or ints, broadcast
    together). Returns the four output words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _MASK
        k1 = (k1 + _PHILOX_W[1]) & _MASK
    return c0, c1, c2, c3


def philox_bits(seed: int, offset: int, layer: int, count: int,
                device="cpu"):
    """The 32 random bits of elements 0 .. count-1 of one layer's block:
    element e is lane e % 4 of Philox call e // 4, whose counter is
    (e // 4, layer, offset low, offset high) and key (seed low, seed
    high). int64 tensor of uint32 values."""
    calls = -(-count // 4)
    if calls > 1 << 32:
        raise ValueError(f"{count} elements exceed 2^34 per layer")
    c = torch.arange(calls, dtype=torch.int64, device=device)
    out = philox4x32((c, layer & _MASK, offset & _MASK,
                      (offset >> 32) & _MASK),
                     (seed & _MASK, (seed >> 32) & _MASK))
    words = [w if torch.is_tensor(w) else torch.full_like(c, w)
             for w in out]
    return torch.stack(words, dim=1).reshape(-1)[:count]


# qbn_tpu/ops/pallas/sample_weights.py:142-151, copied (the port imports
# nothing of qbn_tpu): np.polyfit(w, ndtri(u)/t, 6) on w = -log1p(-t^2) in
# [0, 16], and np.polyfit(z, log1p(z), 4) on z in [0, 1]
_NDTRI_P = (3.8635427531285984e-07, -2.2181696909391053e-05,
            4.998516805939583e-04, -5.330584717241403e-03,
            1.871923104980722e-02, 3.274856508869327e-01,
            1.253253317085791e+00)
_LN1P_P = (-0.054862281195485675, 0.21640848062706985,
           -0.4640705966769647, 0.995426624186825,
           0.00014158395336088888)
_LN2 = 0.6931471805599453


def _f32(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def cheap_neg_log(v):
    """-ln(v) for positive normal float32 v: qbn_tpu's _cheap_neg_log,
    operation for operation (exponent by bitcast, mantissa through a
    degree-4 ln(1+z) polynomial), each multiply and add rounded alone."""
    dev = v.device
    bits = v.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32)
    m = ((bits & 0x7FFFFF) | 0x3F800000).view(torch.float32)   # [1, 2)
    z = m - _f32(1.0, dev)
    p = _f32(_LN1P_P[0], dev)
    for k in _LN1P_P[1:]:
        p = p * z + _f32(k, dev)
    return -(e * _f32(_LN2, dev) + p)


def fast_ndtri(u):
    """Phi^-1(u) for float32 u in (0, 1]: qbn_tpu's _fast_ndtri,
    x = t p(w), t = 2u - 1, w = min(-ln((1 - t)(1 + t)), 16)."""
    dev = u.device
    one = _f32(1.0, dev)
    t = _f32(2.0, dev) * u - one
    v = (one - t) * (one + t)
    w = torch.minimum(cheap_neg_log(v), _f32(16.0, dev))
    p = _f32(_NDTRI_P[0], dev)
    for k in _NDTRI_P[1:]:
        p = p * w + _f32(k, dev)
    return t * p


def icdf_normals(bits):
    """qbn_tpu's default seeded normal of 32 random bits: the top 23 bits
    as a uniform f in [1, 2) (_uniform12), u = 2 - f in (0, 1], then
    fast_ndtri(u). bits: int64 tensor of uint32 values; float32 out."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return fast_ndtri(_f32(2.0, f.device) - f)


def eps_q_of(x):
    """The quantised noise code of a normal: clip(round(x * 127/3))."""
    inv = _f32(1.0 / NOISE_SCALE, x.device)
    return torch.clamp(torch.round(x * inv), -128, 127)


_BUCKET_BITS = 9      # a bucket holds 512 consecutive 23-bit uniforms


@functools.lru_cache(maxsize=None)
def _icdf_table(device: str) -> torch.Tensor:
    """The kernel's eps_q lookup, from the plain transform over all 2^23
    uniforms k, computed on `device`: eps_q(k) = 127 - c(k), with c
    non-decreasing in k (the transform is monotone; checked here, and the
    build raises if not). Entry b of 2^14 (one per bucket of 512 k) is
    c(512 b) | off << 8, where off (1..511, or 512 for none) is the offset
    in the bucket of its one step of c, so that
    c(k) = (entry & 255) + (k % 512 >= off)."""
    dev = torch.device(device)
    n_buckets = 1 << (23 - _BUCKET_BITS)
    width = 1 << _BUCKET_BITS
    table = torch.empty(n_buckets, dtype=torch.int32, device=dev)
    chunk = 1 << 20
    prev = None
    for k0 in range(0, 1 << 23, chunk):
        k = torch.arange(k0, k0 + chunk, dtype=torch.int64, device=dev)
        c = (127 - eps_q_of(icdf_normals(k << 9))).to(torch.int64)
        steps = torch.diff(c, prepend=c[:1] if prev is None else prev)
        if bool((steps < 0).any()) or bool((steps > 1).any()):
            raise RuntimeError("the inverse-CDF eps_q is not monotone in "
                               "the uniform: no threshold table")
        prev = c[-1:]
        c = c.reshape(-1, width)
        rel = c - c[:, :1]
        if bool((rel > 1).any()):
            raise RuntimeError("two eps_q steps in one bucket")
        off = torch.where(rel[:, -1] > 0, (rel == 0).sum(1),
                          torch.full_like(rel[:, 0], width))
        b0 = k0 // width
        table[b0:b0 + c.shape[0]] = (c[:, 0] | (off << 8)).to(torch.int32)
    return table


def icdf_table(device) -> torch.Tensor:
    """The eps_q lookup table, built on `device` once per process (the
    first seeded draw there builds it)."""
    return _icdf_table(str(torch.device(device)))


def eps_q_law() -> torch.Tensor:
    """P(eps_q = v) of the seeded draw for v = -128..127 (float64, index
    v + 128): the share of the 2^23 uniforms on each step of the table,
    exactly."""
    table = icdf_table("cpu").to(torch.int64)
    width = 1 << _BUCKET_BITS
    c0, off = table & 255, table >> 8
    counts = torch.zeros(256, dtype=torch.float64)
    counts.index_add_(0, c0, off.double())
    step = off < width
    counts.index_add_(0, c0[step] + 1, (width - off[step]).double())
    return counts.flip(0) / 2 ** 23


def lookup_eps_q(bits, table):
    """eps_q of random bits through the table, as the kernel computes it
    (for checking the table against the plain transform)."""
    entry = table.to(torch.int64)[bits >> (9 + _BUCKET_BITS)]
    k_low = (bits >> 9) & ((1 << _BUCKET_BITS) - 1)
    c = (entry & 255) + (k_low >= (entry >> 8)).to(torch.int64)
    return (127 - c).to(torch.float32)


# -- the plain draw -------------------------------------------------------

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

    noise_scale = torch.tensor(NOISE_SCALE, dtype=f32, device=dev)
    eps_q = eps_q_of(noise.to(f32))
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


def seeded_noise(seed: int, offset: int, layer: int, shape, device="cpu"):
    """The normals of the seeded draw of one layer (S, *shape): what the
    kernel computes from its Philox bits, as float32."""
    bits = philox_bits(seed, offset, layer, math.prod(shape), device)
    return icdf_normals(bits).reshape(shape)


# -- the pack -------------------------------------------------------------

@dataclass
class LayerPack:
    """Every layer of one draw, packed for a single launch.

    w / std: all layers' codes, flattened and concatenated (int8), each
      layer starting at a multiple of 16 bytes.
    qtab: (L, 8) float32 — w_scale, w_zp, std_scale, std_zp, mul_scale,
      mul_zp, add_scale, add_zp.
    meta: (L, 8) int64 — first tile, work items, first output element,
      first code, elements per sample n, samples, then the clip bounds
      max(w_lo, -128) and min(w_hi, 127).
    tile_layer: (tiles,) int32 — the layer of each tile of _TILE items.
    A layer with n % 16 == 0 has one work item per 16 elements and
    _SAMPLES_PER_ITEM samples; any other layer one per 16 consecutive
    outputs of its (S, n) block. Layer l's samples fill
    out[dst_l : dst_l + S*n_l], a contiguous (S, *shape_l) block; dst_l is
    a multiple of 16.
    """
    w: torch.Tensor
    std: torch.Tensor
    qtab: torch.Tensor
    meta: torch.Tensor
    tile_layer: torch.Tensor
    shapes: List[Tuple[int, ...]]
    dst: List[int]
    samples: int
    total: int          # output elements, padding included
    tiles: int


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pack_layers(layers: Sequence, samples: int) -> LayerPack:
    """layers: [(w_codes, std_codes, qparams, w_lo, w_hi)], codes of any
    shape (the draw is elementwise), all on one device."""
    if samples < 1:
        raise ValueError("samples must be >= 1")
    dev = layers[0][0].device
    rows, shapes, dst_offs, tile_layer = [], [], [], []
    dst = src = 0
    w_parts, s_parts = [], []
    for li, (w, std, qparams, w_lo, w_hi) in enumerate(layers):
        if w.shape != std.shape:
            raise ValueError("w_codes and std_codes differ in shape")
        lo, hi = max(int(w_lo), -128), min(int(w_hi), 127)
        if lo > hi:
            raise ValueError(f"weight range [{w_lo}, {w_hi}] is empty in "
                             "int8")
        n = w.numel()
        if samples * n > 1 << 34:
            raise ValueError(f"{samples} x {n} outputs exceed 2^34 per "
                             "layer (the Philox call index is 32 bits)")
        items = (-(-samples // _SAMPLES_PER_ITEM) * (n // _VEC)
                 if n % _VEC == 0 else -(-samples * n // _VEC))
        tiles = -(-items // _TILE)
        rows.append((len(tile_layer), items, dst, src, n, samples, lo, hi))
        tile_layer += [li] * tiles
        shapes.append(tuple(w.shape))
        dst_offs.append(dst)
        dst += _round_up(samples * n, _VEC)
        pad = _round_up(n, _VEC) - n
        for parts, t in ((w_parts, w), (s_parts, std)):
            parts.append(t.reshape(-1).to(torch.int8))
            if pad:
                parts.append(torch.zeros(pad, dtype=torch.int8, device=dev))
        src += n + pad
    qtab = torch.stack([
        torch.stack([torch.as_tensor(qp[k], device=dev).to(torch.float32)
                     for k in QPARAM_KEYS])
        for (_w, _s, qp, _lo, _hi) in layers])
    return LayerPack(
        w=torch.cat(w_parts), std=torch.cat(s_parts),
        qtab=qtab.contiguous(),
        meta=torch.tensor(rows, dtype=torch.int64, device=dev),
        tile_layer=torch.tensor(tile_layer, dtype=torch.int32, device=dev),
        shapes=shapes, dst=dst_offs, samples=samples, total=dst,
        tiles=len(tile_layer))


# -- the kernel -----------------------------------------------------------

def _lib():
    lib = _build.load("sample_weights")
    fn = lib.qbn_draw_int8
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int, vp, vp,
                   ctypes.c_ulonglong, ctypes.c_ulonglong, vp, vp]
    fn.restype = ctypes.c_int
    return fn


def unpack(pack: LayerPack, flat: torch.Tensor) -> List[torch.Tensor]:
    """The (S, *shape_l) views of each layer of a pack's flat output."""
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


def key_from_generator(generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """The (seed, offset) of one seeded draw as an int64 tensor of 2,
    drawn from `generator` (the default generator of the CPU when None),
    on the generator's device."""
    gen_dev = generator.device if generator is not None else "cpu"
    return torch.randint(0, 2 ** 62, (2,), generator=generator,
                         device=gen_dev)


def _draw_cpu(w, std, qtab, meta, tile_layer, key, noise, total):
    """The plain draw of every layer of a pack: layer by layer from its
    rows of `meta` and `qtab`, the seeded normals from (seed, offset) =
    `key`, or the layer's slice of the flat `noise`."""
    seed, offset = (int(v) for v in key.tolist())
    flat = torch.zeros(total, dtype=torch.int8)
    for li, row in enumerate(meta.tolist()):
        _tile, _items, dst, src, n, s, lo, hi = row
        qp = dict(zip(QPARAM_KEYS, qtab[li]))
        eps = (noise[dst:dst + s * n].reshape(s, n) if noise is not None
               else seeded_noise(seed, offset, li, (s, n)))
        flat[dst:dst + s * n] = sample_weights_plain(
            w[src:src + n], std[src:src + n], qp, eps, lo, hi).reshape(-1)
    return flat


def _draw_cuda(w, std, qtab, meta, tile_layer, key, noise, total):
    """One launch of the draw kernel over the pack (the span `op.draw`);
    raises if it fails."""
    global launches
    with span("op.draw"):
        dev = w.device
        for t, dt, name in ((w, torch.int8, "w"), (std, torch.int8, "std"),
                            (qtab, torch.float32, "qtab"),
                            (meta, torch.int64, "meta"),
                            (tile_layer, torch.int32, "tile_layer")):
            _check(t, dt, name, dev)
        seed = offset = 0
        noise_ptr = table_ptr = None
        if noise is not None:
            _check(noise, torch.float32, "noise", dev)
            noise_ptr = noise.data_ptr()
        else:
            seed, offset = (int(v) for v in key.tolist())
            table_ptr = icdf_table(dev).data_ptr()
        flat = torch.empty(total, dtype=torch.int8, device=dev)
        fn = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(w.data_ptr(), std.data_ptr(), qtab.data_ptr(),
                     meta.data_ptr(), tile_layer.data_ptr(),
                     tile_layer.numel(), noise_ptr, table_ptr, seed, offset,
                     flat.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(
                f"qbn_draw_int8 launch failed: cudaError {err}")
        launches += 1
        return flat


def _draw_fake(w, std, qtab, meta, tile_layer, key, noise, total):
    return w.new_empty((total,), dtype=torch.int8)


# the draw of a whole pack: the flat int8 output (layer l's (S, *shape_l)
# block at dst_l), from the pack's tensors and the (seed, offset) in `key`
# (int64, 2), or from `noise` (float32, laid out as the output)
draw_int8 = library.define(
    "draw_int8",
    "(Tensor w, Tensor std, Tensor qtab, Tensor meta, Tensor tile_layer, "
    "Tensor key, Tensor? noise, SymInt total) -> Tensor",
    _draw_cpu, _draw_cuda, _draw_fake)


def draw_layers(pack: LayerPack, generator: Optional[torch.Generator] = None,
                noise: Optional[Sequence[torch.Tensor]] = None,
                key: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """S int8 samples of every layer of `pack`: a list of (S, *shape_l)
    tensors, in layer order, from ONE call of the `draw_int8` operator.
    pack: a LayerPack or a module with its fields (evaluation.mc's owner).

    noise (testing): one (S, *shape_l) float32 tensor per layer; otherwise
    the seeded inverse-CDF normals, their seed and offset the int64 pair
    `key`, or drawn from `generator` (the default generator of the CPU
    when None)."""
    s = pack.samples
    dev = pack.w.device
    noise_buf = None
    if noise is not None:
        if len(noise) != len(pack.shapes):
            raise ValueError("noise needs one tensor per layer")
        noise_buf = torch.zeros(pack.total, dtype=torch.float32, device=dev)
        for t, d, sh in zip(noise, pack.dst, pack.shapes):
            if tuple(t.shape) != (s,) + sh:
                raise ValueError(f"noise shape {tuple(t.shape)} != "
                                 f"{(s,) + sh}")
            if dev.type != "cpu":
                _check(t, torch.float32, "noise", dev)
            noise_buf[d:d + t.numel()] = t.reshape(-1)
        key = torch.zeros(2, dtype=torch.int64)
    elif key is None:
        key = key_from_generator(generator)
    flat = draw_int8(pack.w, pack.std, pack.qtab, pack.meta, pack.tile_layer,
                     key, noise_buf, pack.total)
    return unpack(pack, flat)


def sample_weights_int8(w_codes, std_codes, qparams, samples: int,
                        w_lo: int, w_hi: int,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[torch.Tensor] = None):
    """Draw `samples` int8 weight samples of one layer: (S, *w.shape)."""
    pack = pack_layers([(w_codes, std_codes, qparams, w_lo, w_hi)], samples)
    return draw_layers(pack, generator,
                       None if noise is None else [noise])[0]
