"""Distortion-shifted test sets: rotation, horizontal shift and
brightness at 5 levels each (port of qbn_tpu/data/distortions.py).

Every cell is one gather formulation (`gather_spec`, on the host): a
nearest-neighbour index map with a zero-fill mask for rotation and
shift, the identity map with a brightness factor for brightness.
`apply_spec` applies it to a tensor of [0, 1] NHWC images on any device:
the gather, PIL's truncating uint8 brighten, the mask. On uint8-derived
images it gives qbn_tpu's `rotate`, `horizontal_shift` and `brighten`
bit for bit, so the harness uploads the clean test set once and makes
each of the 15 distorted sets on the card (qbn_tpu's device sweep).
"""

from __future__ import annotations

import numpy as np
import torch

BRIGHTNESS_LEVELS = [1.5, 2.0, 2.5, 3.0, 3.5]
ROTATION_LEVELS = [15, 30, 45, 60, 75]
SHIFT_LEVELS = [0.1, 0.2, 0.3, 0.4, 0.5]

DISTORTIONS = ["rotation", "shift", "brightness"]
LEVELS = 5


def gather_spec(distortion, level: int, h: int, w: int):
    """(syi, sxi, valid, factor) of one cell: (h, w) int32 source rows and
    columns, an (h, w) float32 mask and a float32 brightness factor (1:
    none). Rotation maps each output pixel to the nearest source pixel of
    the image turned counter-clockwise about its centre; shift moves the
    image right by round(level * w) pixels; outside pixels are masked."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    ones = np.ones((h, w), np.float32)
    if distortion is None:
        return yy.astype(np.int32), xx.astype(np.int32), ones, np.float32(1)
    if distortion == "rotation":
        theta = np.deg2rad(ROTATION_LEVELS[level])
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        cos_t, sin_t = np.cos(theta), np.sin(theta)
        sx = cos_t * (xx - cx) + sin_t * (yy - cy) + cx
        sy = -sin_t * (xx - cx) + cos_t * (yy - cy) + cy
        sxi = np.round(sx).astype(np.int64)
        syi = np.round(sy).astype(np.int64)
        valid = (sxi >= 0) & (sxi < w) & (syi >= 0) & (syi < h)
        return (np.clip(syi, 0, h - 1).astype(np.int32),
                np.clip(sxi, 0, w - 1).astype(np.int32),
                valid.astype(np.float32), np.float32(1))
    if distortion == "shift":
        tx = int(round(SHIFT_LEVELS[level] * w))
        return (yy.astype(np.int32),
                np.clip(xx - tx, 0, w - 1).astype(np.int32),
                (xx >= tx).astype(np.float32), np.float32(1))
    if distortion == "brightness":
        return (yy.astype(np.int32), xx.astype(np.int32), ones,
                np.float32(BRIGHTNESS_LEVELS[level]))
    raise NotImplementedError(f"Unknown distortion '{distortion}'")


def brighten(images: torch.Tensor, factor: float) -> torch.Tensor:
    """PIL's ImageEnhance.Brightness on uint8-derived [0, 1] images: the
    uint8 value times the factor in float32, truncated and clipped to
    [0, 255], over 255 (a true division: the divisor is a tensor on the
    images' device, since CUDA divides by a host scalar through its
    reciprocal)."""
    v = torch.round(images * 255.0)
    out = torch.clamp(torch.trunc(v * float(factor)), 0.0, 255.0)
    return out / torch.tensor(255.0, dtype=torch.float32,
                              device=images.device)


def apply_spec(images: torch.Tensor, spec) -> torch.Tensor:
    """One cell (gather_spec's tuple) applied to (N, H, W, C) images on
    their device."""
    syi, sxi, valid, factor = spec
    dev = images.device
    g = images[:, torch.from_numpy(syi).to(dev).long(),
               torch.from_numpy(sxi).to(dev).long(), :]
    if factor != 1.0:
        g = brighten(g, factor)
    # contiguous NHWC, as the INT path's kernels take it
    return (g * torch.from_numpy(valid).to(dev)[None, :, :, None]
            ).contiguous()


def apply_distortion(images: np.ndarray, distortion, level: int
                     ) -> np.ndarray:
    """One named distortion (None: none) at a level in 0..4 applied to
    [0, 1] NHWC numpy images, on the host."""
    if distortion is None:
        return images
    n, h, w, c = images.shape
    return apply_spec(torch.from_numpy(images),
                      gather_spec(distortion, level, h, w)).numpy()
