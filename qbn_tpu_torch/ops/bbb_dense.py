"""Fused local-reparametrisation dense forward (port of
qbn_tpu/ops/pallas/bbb_dense.py).

    out = x @ w + sqrt(1e-8 + (x*x) @ (sp*sp)) * eps

in float32, for Bayes-by-backprop training: x (B, K) activations, w (K, N)
posterior mean, sp (K, N) softplus'd posterior std, eps (B, N) standard
normals. On a CUDA tensor `bbb_dense` launches the hand-written kernel of
`csrc/bbb_dense.cu` (3xTF32 products on the tensor cores, fed by a
cp.async ring; it shares the x tile between the two products and splits K
across CTAs so that the grid fills the card; the host's checks and launch
are the span `op.bbb_dense`) or raises; there is no fallback. On a CPU
tensor it runs `bbb_dense_plain`. eps comes from `noise`, or, without it,
from a Philox stream inside the kernel keyed by a seed and offset taken
from the caller's torch.Generator (on the CPU, `torch.randn` from that
generator).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from qbn_tpu_torch.ops import _build
from qbn_tpu_torch.profiling import span

VAR_EPS = 1e-8

# Kernel launches since the count was last set to 0, in all and by
# (K, N); chip_smoke.py reads them to show that the training paths went
# through the kernel.
launches = 0
launches_by_kn: "collections.Counter" = collections.Counter()


def bbb_dense_plain(x, w, sp, noise):
    """The same function in plain PyTorch (qbn_tpu's `_compute`)."""
    mean = torch.matmul(x, w)
    var = torch.matmul(x * x, torch.square(sp))
    return mean + torch.sqrt(VAR_EPS + var) * noise


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("bbb_dense")
    fn = lib.qbn_bbb_dense
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, ctypes.c_ulonglong, ctypes.c_ulonglong,
                   vp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, vp, vp, vp]
    fn.restype = ctypes.c_int
    tiles = (ctypes.c_int * 4)()
    lib.qbn_bbb_dense_tiles(tiles)
    return fn, tuple(tiles)


def split_k(b: int, k: int, n: int, sms: int, bm: int = 64, bn: int = 64,
            bk: int = 32):
    """(splits, k_chunk): how many CTAs share each output tile and how much
    of K each takes. Split only as far as one CTA per SM needs (one CTA's
    3xTF32 products keep an SM's tensor cores busy: two per SM measured no
    faster on the H100), each split with at least two K-steps; k_chunk is
    a multiple of bk and every split is non-empty."""
    tiles = math.ceil(b / bm) * math.ceil(n / bn)
    steps = max(1, math.ceil(k / bk))
    splits = max(1, min(sms // tiles, steps // 2))
    k_chunk = math.ceil(steps / splits) * bk
    return max(1, math.ceil(k / k_chunk)), k_chunk


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def bbb_dense(x, w, sp, noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
    """x @ w + sqrt(1e-8 + x^2 @ sp^2) * eps: (B, N) float32.

    noise: (B, N) eps; when None, eps is drawn from `generator` (the
    default CPU generator when None) - inside the kernel on the card,
    keyed by a seed and offset that the generator draws (on the host for
    a CPU generator; a CUDA generator costs a device synchronise)."""
    global launches
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError("bbb_dense takes x (B, K) and w (K, N)")
    b, k = x.shape
    n = w.shape[1]
    if x.device.type == "cpu":
        if noise is None:
            noise = torch.randn((b, n), generator=generator)
        return bbb_dense_plain(x, w, sp, noise)

    with span("op.bbb_dense"):
        dev = x.device
        for t, name, shape in ((x, "x", (b, k)), (w, "w", (k, n)),
                               (sp, "sp", (k, n))):
            _check(t, name, shape, dev)
        seed = offset = 0
        if noise is not None:
            _check(noise, "noise", (b, n), dev)
        else:
            gen_dev = generator.device if generator is not None else "cpu"
            seed, offset = torch.randint(0, 2 ** 62, (2,), generator=generator,
                                         device=gen_dev).tolist()
        fn, (bm, bn, bk, part) = _lib()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits, k_chunk = split_k(b, k, n, sms, bm, bn, bk)
        out = torch.empty((b, n), dtype=torch.float32, device=dev)
        tiles = math.ceil(b / bm) * math.ceil(n / bn)
        workspace = counters = None
        if splits > 1:
            workspace = torch.empty(tiles * splits * part, dtype=torch.float32,
                                    device=dev)
            counters = torch.zeros(tiles, dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(x.data_ptr(), w.data_ptr(), sp.data_ptr(),
                     None if noise is None else noise.data_ptr(), seed, offset,
                     out.data_ptr(), b, k, n, splits, k_chunk,
                     None if workspace is None else workspace.data_ptr(),
                     None if counters is None else counters.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"qbn_bbb_dense launch failed: cudaError {err}")
        launches += 1
        launches_by_kn[(k, n)] += 1
        return out
