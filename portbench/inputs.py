"""The general generator of the traffic mixes' inputs, from `--seed`.

Images are made as the port's CIFAR reader returns them: NHWC float32 in
[0, 1], whole multiples of 1/255 (uint8 pixels / 255), with int64 labels.
Every seed gives the same sizes; only the values change. Each stream of
one run (`salt`) has its own generator, so adding a stream moves no other.
"""

from __future__ import annotations

import numpy as np


def rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), salt]))


def images(n: int, shape, classes: int, seed: int, salt: int = 0):
    """(x, y): n images (n, H, W, C) float32 in [0, 1] and their labels."""
    r = rng(seed, salt)
    pixels = r.integers(0, 256, size=(n, *shape), dtype=np.uint8)
    x = pixels.astype(np.float32) / 255.0
    y = r.integers(0, classes, size=n).astype(np.int64)
    return x, y


def sample(count: int, among: int, seed: int, salt: int):
    """`count` distinct indices of range(among), sorted, from the seed."""
    k = min(count, among)
    return sorted(int(i) for i in rng(seed, salt).choice(among, size=k,
                                                         replace=False))

