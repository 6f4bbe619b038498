"""Learnable synthetic image datasets (port of qbn_tpu/data/synth.py,
the same arrays for the same seeds, bit for bit).

Smoothed random prototype fields, one per class, each example translated
(wrap-around), scaled in intensity and corrupted with Gaussian pixel
noise; written to disk in the real formats by `data/writers.py`, so that
every reader, augmentation, distortion and OOD path runs as it would on
the real files (campaign/make_campaign_data.py makes the campaign's
data with qbn_tpu's copy of these functions).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth(field: np.ndarray, sigma: float) -> np.ndarray:
    from scipy.ndimage import gaussian_filter
    return gaussian_filter(field, sigma=sigma, mode="wrap")


def make_synth_images(n: int, shape: Tuple[int, int, int], classes: int,
                      seed: int, max_shift: int = 3,
                      noise_sigma: float = 25.0, proto_seed: int = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic learnable dataset: (uint8 images NHWC, int64 labels).

    Every class is a smoothed random prototype in [0, 255]; each example is
    the prototype randomly translated (wrap-around), scaled in intensity,
    and corrupted with Gaussian pixel noise. The prototypes depend ONLY on
    `proto_seed` (default: seed), so train/test splits built with different
    `seed` but the same `proto_seed` share classes — essential for a
    learnable generalisation task.
    """
    h, w, c = shape
    if proto_seed is None:
        proto_seed = seed
    prng = np.random.RandomState(proto_seed)
    rng = np.random.RandomState(seed)
    protos = np.stack([
        _smooth(prng.rand(h, w, c).astype(np.float32), sigma=3.0)
        for _ in range(classes)
    ])
    # normalise each prototype to full [0, 255] range
    lo = protos.min(axis=(1, 2, 3), keepdims=True)
    hi = protos.max(axis=(1, 2, 3), keepdims=True)
    protos = 255.0 * (protos - lo) / np.maximum(hi - lo, 1e-6)

    y = rng.randint(0, classes, n).astype(np.int64)
    x = protos[y]
    # per-example wrap-around translation
    dx = rng.randint(-max_shift, max_shift + 1, n)
    dy = rng.randint(-max_shift, max_shift + 1, n)
    for i in range(n):
        if dy[i]:
            x[i] = np.roll(x[i], dy[i], axis=0)
        if dx[i]:
            x[i] = np.roll(x[i], dx[i], axis=1)
    # intensity jitter + pixel noise
    gain = rng.uniform(0.7, 1.0, (n, 1, 1, 1)).astype(np.float32)
    x = x * gain + rng.randn(n, h, w, c).astype(np.float32) * noise_sigma
    return np.clip(x, 0, 255).astype(np.uint8), y


def make_synth_mnist(n_train: int = 10000, n_test: int = 2000,
                     seed: int = 0, max_shift: int = 3,
                     noise_sigma: float = 25.0):
    """(x_train, y_train, x_test, y_test) uint8 28x28x1, 10 classes; train
    and test share prototypes (same classes) but draw independent
    translations/noise. max_shift/noise_sigma control task difficulty."""
    proto = 1000 + seed
    x_tr, y_tr = make_synth_images(n_train, (28, 28, 1), 10,
                                   seed * 2 + 1, proto_seed=proto,
                                   max_shift=max_shift,
                                   noise_sigma=noise_sigma)
    x_te, y_te = make_synth_images(n_test, (28, 28, 1), 10,
                                   seed * 2 + 2, proto_seed=proto,
                                   max_shift=max_shift,
                                   noise_sigma=noise_sigma)
    return x_tr, y_tr, x_te, y_te


def make_synth_cifar(n_train: int = 10000, n_test: int = 2000,
                     seed: int = 0):
    """(x_train, y_train, x_test, y_test) uint8 32x32x3, 10 classes."""
    proto = 2000 + seed
    x_tr, y_tr = make_synth_images(n_train, (32, 32, 3), 10,
                                   seed * 2 + 101, proto_seed=proto)
    x_te, y_te = make_synth_images(n_test, (32, 32, 3), 10,
                                   seed * 2 + 102, proto_seed=proto)
    return x_tr, y_tr, x_te, y_te
