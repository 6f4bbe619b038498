"""Stochastic layer math of Bayes-by-backprop (port of
qbn_tpu/ops/stochastic.py): local reparametrisation for training, weight
sampling for evaluation, the closed-form KL.

Conventions as in qbn_tpu: NHWC activations, HWIO conv kernels, dense
kernels (in, out), float32. Where qbn_tpu takes a PRNG key, the port takes
a noise source: a callable `noise(shape, device)` returning standard
normals, drawn at the same points and in the same shapes as qbn_tpu draws
them. `GeneratorNoise` wraps a torch.Generator (the main path);
`QueueNoise` hands out given arrays in call order (tests feed it the
normals that a qbn_tpu run receives). MC-Dropout's masks come from a
mask source in the same way: `BernoulliMasks` (a torch.Generator) or
`QueueMasks` (given masks, in call order). `SeedNoise` and `SeedMasks`
draw from a key tensor (seed, offset) through the operator
`qbn_tpu_torch::seeded_draw`, so that an exported predictor's draws follow
its `seed` input.

A draw is one of two kinds, and the layer says which: a whole draw (a
weight sample, `noise(shape, device)`) or a per-row draw, one row per
example of the batch (the local-reparametrisation noise,
`noise_rows(noise, shape, device)`; every dropout mask is per row).
In a data-parallel step each rank sees its rows of the global batch
through `RowNoise` and `RowMasks`: they draw the global batch's rows from
the replicated source and keep the rank's, and take whole draws whole, so
that the sharded step sees the draws of the one-process step.
`SampleMasks` keeps a rank's samples of (S, *shape) masks (the
sample-sharded MC evaluation). `DrawLog` records the calls of a forward
(for replaying them at another batch size).
"""

from __future__ import annotations

import hashlib
from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from qbn_tpu_torch.ops import library
from qbn_tpu_torch.ops.bbb_dense import VAR_EPS, bbb_dense


class GeneratorNoise:
    """Standard normals from a torch.Generator, on the generator's device
    (then moved to the caller's device; None: torch's default generator
    of the caller's device)."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def __call__(self, shape, device) -> torch.Tensor:
        g = self.generator
        eps = torch.randn(tuple(shape), generator=g,
                          device=device if g is None else g.device)
        return eps.to(device)


class QueueNoise:
    """The given arrays (numpy or torch), one per draw, in call order;
    raises on a shape that does not match or when the queue runs dry."""

    def __init__(self, arrays: Iterable):
        self.queue = list(arrays)

    def __call__(self, shape, device) -> torch.Tensor:
        if not self.queue:
            raise RuntimeError(f"noise queue is empty (asked for {shape})")
        eps = self.queue.pop(0)
        if not isinstance(eps, torch.Tensor):
            eps = torch.from_numpy(np.array(eps))
        eps = eps.to(torch.float32)
        if tuple(eps.shape) != tuple(shape):
            raise ValueError(f"queued noise has shape {tuple(eps.shape)}, "
                             f"the draw asks for {tuple(shape)}")
        return eps.to(device)


class BernoulliMasks:
    """MC-Dropout keep masks from a torch.Generator, drawn on the
    generator's device (then moved to the caller's; None: torch's default
    generator of the caller's device): `masks(shape, keep, device)` gives
    (samples, *shape) float32 ones with probability keep, else zeros, as
    jax.random.bernoulli draws uniform < keep."""

    def __init__(self, generator: Optional[torch.Generator], samples: int):
        self.generator, self.samples = generator, samples

    def __call__(self, shape, keep: float, device) -> torch.Tensor:
        g = self.generator
        u = torch.rand((self.samples, *shape), generator=g,
                       device=device if g is None else g.device)
        return (u < keep).to(torch.float32).to(device)


class QueueMasks:
    """The given masks (numpy or torch, (S, *shape) each), one per dropout
    site, in call order; raises on a shape that does not match or when the
    queue runs dry (tests feed it the masks of a qbn_tpu run)."""

    def __init__(self, arrays: Iterable):
        self.queue = list(arrays)

    def __call__(self, shape, keep: float, device) -> torch.Tensor:
        if not self.queue:
            raise RuntimeError(f"mask queue is empty (asked for {shape})")
        mask = self.queue.pop(0)
        if not isinstance(mask, torch.Tensor):
            mask = torch.from_numpy(np.array(mask))
        if tuple(mask.shape[1:]) != tuple(shape):
            raise ValueError(f"queued mask has shape {tuple(mask.shape)}, "
                             f"the site asks for (S, *{tuple(shape)})")
        return mask.to(device=device, dtype=torch.float32)


def noise_rows(noise, shape, device) -> torch.Tensor:
    """A per-row draw of standard normals: axis 0 of `shape` is the
    batch. A row view (`RowNoise`) draws the global batch and keeps its
    rows; any other source draws `shape`."""
    rows = getattr(noise, "rows", None)
    return noise(shape, device) if rows is None else rows(shape, device)


class RowNoise:
    """A rank's view of a noise source in a data-parallel step: rows
    `rows` (a slice) of a global batch of `total`. A whole draw is the
    source's; a per-row draw is drawn for `total` rows and sliced."""

    def __init__(self, source, rows: slice, total: int):
        self.source, self.slice, self.total = source, rows, total

    def __call__(self, shape, device) -> torch.Tensor:
        return self.source(shape, device)

    def rows(self, shape, device) -> torch.Tensor:
        full = noise_rows(self.source, (self.total, *shape[1:]), device)
        return full[self.slice]


class RowMasks:
    """A rank's view of a mask source in a data-parallel step: each
    site's (S, total, ...) masks drawn for the global batch, the rows
    `rows` of axis 1 kept."""

    def __init__(self, source, rows: slice, total: int):
        self.source, self.slice, self.total = source, rows, total

    def __call__(self, shape, keep: float, device) -> torch.Tensor:
        full = self.source((self.total, *shape[1:]), keep, device)
        return full[:, self.slice]


class SampleMasks:
    """Samples `samples` (a slice) of a mask source's (S, *shape) masks:
    a rank's share of the sample axis."""

    def __init__(self, source, samples: slice):
        self.source, self.slice = source, samples

    def __call__(self, shape, keep: float, device) -> torch.Tensor:
        return self.source(shape, keep, device)[self.slice]


class DrawLog:
    """Stands in for a noise source (itself) and a mask source (`masks`,
    of `samples` samples) and records their calls in order: ("noise",
    shape), ("rows", shape) or ("masks", shape, keep). Noise comes back
    as zeros, masks as ones. `replay` makes the same draws from real
    sources, the per-row ones at another batch size."""

    def __init__(self, samples: int = 1):
        self.calls: list = []
        self.samples = samples

    def __call__(self, shape, device) -> torch.Tensor:
        self.calls.append(("noise", tuple(shape)))
        return torch.zeros(tuple(shape), device=device)

    def rows(self, shape, device) -> torch.Tensor:
        self.calls.append(("rows", tuple(shape)))
        return torch.zeros(tuple(shape), device=device)

    def masks(self, shape, keep: float, device) -> torch.Tensor:
        self.calls.append(("masks", tuple(shape), keep))
        return torch.ones((self.samples, *shape), device=device)

    def replay(self, noise, masks, batch: int, device):
        """The recorded draws from `noise` and `masks`, per-row ones at
        `batch` rows, in call order (a list of tensors)."""
        out = []
        for call in self.calls:
            kind, shape = call[0], (batch, *call[1][1:])
            if kind == "noise":
                out.append(noise(call[1], device))
            elif kind == "rows":
                out.append(noise_rows(noise, shape, device))
            else:
                out.append(masks(shape, call[2], device))
        return out


def _seeded_draw(key, stream, shape, normal):
    """Standard normals (or uniforms in [0, 1)) of `shape` from a
    torch.Generator on the key's device seeded with a 64-bit digest of
    (seed, offset, stream); the generator lives only here."""
    seed, offset = key.tolist()
    digest = hashlib.blake2b(f"{seed}/{offset}/{stream}".encode(),
                             digest_size=8).digest()
    g = torch.Generator(device=key.device).manual_seed(
        int.from_bytes(digest, "little"))
    draw = torch.randn if normal else torch.rand
    return draw(tuple(shape), generator=g, device=key.device)


def _seeded_draw_fake(key, stream, shape, normal):
    return key.new_empty(tuple(shape), dtype=torch.float32)


# a draw from the key tensor (seed, offset): the random source of an
# exported predictor's dropout masks and float weight noise, whose key
# follows the predictor's `seed` input
seeded_draw = library.define(
    "seeded_draw", "(Tensor key, int stream, SymInt[] shape, bool normal) "
    "-> Tensor", _seeded_draw, _seeded_draw, _seeded_draw_fake)


class _Seeded:
    """Draws from the int64 pair key = (seed, offset), one
    `qbn_tpu_torch::seeded_draw` stream per draw in call order: the values
    depend on the key, the draw's place in call order and the device.
    The key is a tensor, read on the host only inside the operator, so
    that an exported forward keeps it as an input."""

    def __init__(self, key: torch.Tensor):
        self.key, self.calls = key, 0

    def _draw(self, shape, device, normal):
        out = seeded_draw(self.key.to(device), self.calls, list(shape),
                          normal)
        self.calls += 1
        return out


class SeedNoise(_Seeded):
    """Standard normals from a key, one stream per draw."""

    def __call__(self, shape, device) -> torch.Tensor:
        return self._draw(tuple(shape), device, True)


class SeedMasks(_Seeded):
    """MC-Dropout keep masks from a key, one stream per dropout site:
    (samples, *shape) float32, 1 where the uniform is below keep."""

    def __init__(self, key: torch.Tensor, samples: int):
        super().__init__(key)
        self.samples = samples

    def __call__(self, shape, keep: float, device) -> torch.Tensor:
        u = self._draw((self.samples, *shape), device, False)
        return (u < keep).to(torch.float32)


def softplus(x):
    """log(1 + e^x) as jnp.logaddexp(x, 0) computes it. F.softplus returns
    x itself above its threshold of 20, which logaddexp does not."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def kl_divergence(mu, sigma, mu_prior, sigma_prior):
    """Closed-form KL(N(mu, sigma) || N(mu_prior, sigma_prior)), summed."""
    return 0.5 * torch.sum(
        2.0 * torch.log(sigma_prior / sigma)
        - 1.0
        + (sigma / sigma_prior) ** 2
        + ((mu_prior - mu) / sigma_prior) ** 2
    )


def local_reparam_dense(x, w, sp_std, noise, bias=None):
    """Training-mode BBB dense layer, plain PyTorch:
    x @ w + sqrt(1e-8 + x^2 @ sp_std^2) * eps (+ bias), eps of (B, out)."""
    mean = torch.matmul(x, w)
    var = torch.matmul(torch.square(x), torch.square(sp_std))
    std = torch.sqrt(VAR_EPS + var)
    out = mean + std * noise_rows(noise, mean.shape, mean.device)
    if bias is not None:
        out = out + bias
    return out


class LocalReparamDenseFused(torch.autograd.Function):
    """The fused local-reparametrisation dense with its hand-written
    gradient (port of qbn_tpu's _lrd_fused / _lrd_fused_bwd). Forward:
    `ops.bbb_dense.bbb_dense` (the CUDA kernel for CUDA tensors, the plain
    version for CPU ones). Backward: the closed form of _lrd_fused_bwd in
    torch.matmul; it needs the forward's noise."""

    @staticmethod
    def forward(ctx, x, w, sp, noise):
        x, w, sp, noise = (t.contiguous() for t in (x, w, sp, noise))
        ctx.save_for_backward(x, w, sp, noise)
        return bbb_dense(x, w, sp, noise)

    @staticmethod
    def backward(ctx, g):
        # out = x@w + sqrt(VAR_EPS + x^2 @ sp^2) * eps
        x, w, sp, noise = ctx.saved_tensors
        sp2 = torch.square(sp)
        var = torch.matmul(torch.square(x), sp2)
        sigma = torch.sqrt(VAR_EPS + var)
        dvar = g * noise / (2.0 * sigma)
        dx = torch.matmul(g, w.T) + 2.0 * x * torch.matmul(dvar, sp2.T)
        dw = torch.matmul(x.T, g)
        dsp = 2.0 * sp * torch.matmul(torch.square(x).T, dvar)
        return dx, dw, dsp, g * sigma


def local_reparam_dense_auto(x, w, sp_std, noise, bias=None,
                             fused: bool = False):
    """local_reparam_dense, or with `fused` (and a 2-D x) the fused form:
    the noise is drawn outside the kernel, in the same (B, out) shape as
    the plain path draws it, so the two agree given the same source."""
    if fused and x.ndim == 2:
        eps = noise_rows(noise, (x.shape[0], w.shape[1]), x.device)
        out = LocalReparamDenseFused.apply(x, w, sp_std, eps)
        return out + bias if bias is not None else out
    return local_reparam_dense(x, w, sp_std, noise, bias)


def conv_nhwc(x, w, strides, padding: int):
    """NHWC x HWIO -> NHWC convolution. The NHWC tensor viewed as NCHW is
    channels_last, which cuDNN takes as it is. A strided 1x1 conv without
    padding (the ResNet's shortcuts) reads the strided pixels and runs at
    stride 1: the same sums, and the CPU's channels_last kernel for the
    strided 1x1 case crashes in its backward."""
    if w.shape[:2] == (1, 1) and padding == 0 and tuple(strides) != (1, 1):
        x = x[:, ::strides[0], ::strides[1], :]
        strides = (1, 1)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=tuple(strides), padding=padding)
    return y.permute(0, 2, 3, 1)


def local_reparam_conv(x, w, sp_std, noise, strides, padding: int,
                       bias=None):
    """Training-mode BBB conv via local reparametrisation: x (B, H, W,
    Cin), w / sp_std (kh, kw, Cin, Cout), eps of the output's shape."""
    mean = conv_nhwc(x, w, strides, padding)
    var = conv_nhwc(torch.square(x), torch.square(sp_std), strides, padding)
    std = torch.sqrt(VAR_EPS + var)
    out = mean + std * noise_rows(noise, mean.shape, mean.device)
    if bias is not None:
        out = out + bias
    return out


def sample_weights(w, sp_std, noise):
    """Evaluation-mode BBB weight sample w + sp_std * eps, one draw shared
    across the batch."""
    return w + sp_std * noise(w.shape, w.device)
