"""Dataset readers (port of qbn_tpu/data/datasets.py): MNIST, CIFAR-10,
FashionMNIST and SVHN from local files in their standard formats (idx
ubyte, CIFAR python pickles, SVHN .mat) under cfg.data, the synthetic
regression task, and qbn_tpu's deterministic synthetic stand-ins where a
file is missing, bit for bit: the same seeds give the same arrays.

Images are NHWC float32 in [0, 1] before normalisation (numpy, on the
host; the loaders upload them).
"""

from __future__ import annotations

import gzip
import logging
import os
import pickle
import struct
from typing import Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_STD = np.array([0.2023, 0.1994, 0.2010], np.float32)
CIFAR_INV_STD = (np.float32(1.0) / CIFAR_STD).astype(np.float32)


# ---------------------------------------------------------------------------
# Synthetic 1-D regression: y = 2x + 8 (+ unit Gaussian noise)
# ---------------------------------------------------------------------------

def regression_function(x: np.ndarray, noise: bool = True,
                        rng: Optional[np.random.RandomState] = None):
    w, sigma, b = 2.0, 1.0, 8.0
    y = x.dot(np.array([[w]])) if x.ndim == 2 else x * w
    y = y + b
    if noise:
        rng = rng or np.random
        y = y + np.reshape(sigma * rng.normal(0.0, 1.0, len(x)),
                           (len(x), 1) if y.ndim == 2 else (len(x),))
    return y


def regression_data_generator(n_points: int = 100, x: Optional[np.ndarray]
                              = None, noise: bool = True, seed: int = 0):
    rng = np.random.RandomState(seed)
    if x is None:
        x = rng.randn(n_points, 1).astype(np.float64)
    y = regression_function(x, noise, rng)
    return x.astype(np.float32), np.asarray(y, np.float32).reshape(-1, 1)


# ---------------------------------------------------------------------------
# Local-file readers
# ---------------------------------------------------------------------------

def _open_maybe_gz(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")


def _find(data_dir: str, candidates):
    for rel in candidates:
        p = os.path.join(data_dir, rel)
        if os.path.exists(p):
            return p
        if os.path.exists(p + ".gz"):
            return p + ".gz"
    return None


def _read_idx_images(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as fh:
        magic, n, rows, cols = struct.unpack(">IIII", fh.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx image magic {magic}")
        data = np.frombuffer(fh.read(n * rows * cols), np.uint8)
    return data.reshape(n, rows, cols, 1)


def _read_idx_labels(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as fh:
        magic, n = struct.unpack(">II", fh.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx label magic {magic}")
        return np.frombuffer(fh.read(n), np.uint8).astype(np.int64)


def _load_idx_dataset(data_dir: str, prefix: str, train: bool):
    split = "train" if train else "t10k"
    img = _find(data_dir, [
        f"{prefix}/raw/{split}-images-idx3-ubyte",
        f"{prefix}/{split}-images-idx3-ubyte",
        f"{split}-images-idx3-ubyte",
    ])
    lab = _find(data_dir, [
        f"{prefix}/raw/{split}-labels-idx1-ubyte",
        f"{prefix}/{split}-labels-idx1-ubyte",
        f"{split}-labels-idx1-ubyte",
    ])
    if img is None or lab is None:
        return None
    x = _read_idx_images(img).astype(np.float32) / 255.0
    return x, _read_idx_labels(lab)


def _load_cifar10(data_dir: str, train: bool):
    base = None
    for rel in ["cifar-10-batches-py", "CIFAR10/cifar-10-batches-py"]:
        p = os.path.join(data_dir, rel)
        if os.path.isdir(p):
            base = p
            break
    if base is None:
        return None
    names = ([f"data_batch_{i}" for i in range(1, 6)] if train
             else ["test_batch"])
    xs, ys = [], []
    for n in names:
        # the pickles are the dataset's own files, or the ones that
        # data/writers.py wrote
        with open(os.path.join(base, n), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x.astype(np.float32) / 255.0, np.concatenate(ys)


def _load_svhn(data_dir: str, split: str = "test"):
    p = _find(data_dir, [f"{split}_32x32.mat", f"SVHN/{split}_32x32.mat"])
    if p is None:
        return None
    import scipy.io
    d = scipy.io.loadmat(p)
    x = d["X"].transpose(3, 0, 1, 2).astype(np.float32) / 255.0  # NHWC
    y = d["y"].reshape(-1).astype(np.int64)
    y[y == 10] = 0
    return x, y


# ---------------------------------------------------------------------------
# Deterministic synthetic image stand-ins
# ---------------------------------------------------------------------------

def _synthetic_images(n: int, shape: Tuple[int, int, int], classes: int,
                      seed: int, proto_seed: int):
    """Class templates (from proto_seed, shared by train and test) plus
    noise (from seed), clipped to [0, 1]."""
    templates = np.random.RandomState(proto_seed).rand(
        classes, *shape).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, classes, n).astype(np.int64)
    noise = rng.rand(n, *shape).astype(np.float32)
    x = 0.65 * templates[y] + 0.35 * noise
    return np.clip(x, 0.0, 1.0), y


_SYNTH_WARNED = set()


def _fallback(name: str, n_train: int, n_test: int, shape, classes: int,
              seed: int, train: bool):
    if name not in _SYNTH_WARNED:
        log.warning("dataset '%s' not found on disk: using the "
                    "deterministic synthetic stand-in", name)
        _SYNTH_WARNED.add(name)
    n = n_train if train else n_test
    # per-dataset prototype seed (an OOD pair such as cifar/svhn keeps
    # disjoint prototypes); per-split example seed
    return _synthetic_images(n, shape, classes,
                             seed * 1000 + (0 if train else 1), seed)


def load_images(name: str, data_dir: str, train: bool):
    """A named image dataset: its files if present, else the synthetic
    stand-in. Returns (x in [0, 1], NHWC float32; y int64)."""
    if name == "mnist":
        out = _load_idx_dataset(data_dir, "MNIST", train)
        return out if out is not None else _fallback(
            "mnist", 60000, 10000, (28, 28, 1), 10, 11, train)
    if name == "fashion_mnist":
        out = _load_idx_dataset(data_dir, "FashionMNIST", train)
        return out if out is not None else _fallback(
            "fashion_mnist", 60000, 10000, (28, 28, 1), 10, 22, train)
    if name == "cifar":
        out = _load_cifar10(data_dir, train)
        return out if out is not None else _fallback(
            "cifar", 50000, 10000, (32, 32, 3), 10, 33, train)
    if name == "svhn":
        out = _load_svhn(data_dir, "test" if not train else "train")
        return out if out is not None else _fallback(
            "svhn", 73257, 26032, (32, 32, 3), 10, 44, train)
    raise NotImplementedError(f"Unknown image dataset '{name}'")


def normalize(x: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """CIFAR and SVHN: (x - mean) times the float32 reciprocal of the std,
    on x's device, as qbn_tpu computes it (a multiply, not a divide, so
    that its host and device pipelines agree bit for bit); MNIST and
    FashionMNIST (name None or another): x as it is."""
    if name not in ("cifar", "svhn"):
        return x
    mean = torch.from_numpy(CIFAR_MEAN).to(x.device)
    inv_std = torch.from_numpy(CIFAR_INV_STD).to(x.device)
    return (x - mean) * inv_std
