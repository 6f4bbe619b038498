"""Batch loaders and the train/valid/test loader API (port of
qbn_tpu/data/loaders.py).

The dataset stays in host memory as numpy; `ArrayLoader` draws each
epoch's permutation and each batch's crop and flip from its own
`np.random.RandomState`, in qbn_tpu's order, and yields (x, y) tensors on
its device: the batch is uploaded, then cropped, flipped and normalised
there with tensor ops (pure copies and float32 elementwise arithmetic,
so the batches equal qbn_tpu's bit for bit). Like torch's DataLoader, and
qbn_tpu's, the ragged last batch is kept, and `dataset_size` is the size
of the dataset before the valid split (the n_points of 'whole' loss
scaling). Each batch up to its yield is a span `loader.batch`, its
uploads a span `loader.upload` (profiling.span).
"""

from __future__ import annotations

import logging
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from qbn_tpu_torch.data import datasets as D
from qbn_tpu_torch.data.distortions import apply_distortion
from qbn_tpu_torch.profiling import span
from qbn_tpu_torch.utils import resolve_device

log = logging.getLogger(__name__)


def cifar_augment_params(rng: np.random.RandomState, n: int):
    """The draws of one n-image batch's crop and flip, as qbn_tpu makes
    them: the crop's row and column offsets into the 4-padded image, then
    the flips."""
    ys = rng.randint(0, 9, n)
    xs = rng.randint(0, 9, n)
    flip = (rng.rand(n) < 0.5).astype(np.uint8)
    return ys, xs, flip


def augment_cifar(x: torch.Tensor, ys, xs, flip) -> torch.Tensor:
    """Random crop (zero padding 4) after a horizontal flip, of (N, H, W,
    C) images on their device, from cifar_augment_params' draws."""
    n, h, w, _c = x.shape
    dev = x.device
    flip = torch.from_numpy(flip.astype(bool)).to(dev)
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    pad = F.pad(x, (0, 0, 4, 4, 4, 4))
    rows = torch.from_numpy(ys).to(dev)[:, None] + torch.arange(h, device=dev)
    cols = torch.from_numpy(xs).to(dev)[:, None] + torch.arange(w, device=dev)
    return pad[torch.arange(n, device=dev)[:, None, None],
               rows[:, :, None], cols[:, None, :]]


class ArrayLoader:
    """Shuffling mini-batch iterator over in-memory arrays.

    Yields (x, y) tensors on `device`. len() is the number of batches,
    `num_examples` the examples it holds, `dataset_size` the n_points of
    'whole' loss scaling. Each iteration is one epoch: a new permutation
    (shuffle) and new crop and flip draws (augment), made lazily, batch by
    batch, as qbn_tpu's loader makes them. normalize: the dataset name
    that datasets.normalize takes ('cifar'), or None. device: the card
    unless the caller asks for the CPU (raises when there is no card)."""

    def __init__(self, x: np.ndarray, y: np.ndarray, batch_size: int,
                 shuffle: bool = False, seed: int = 0,
                 augment: bool = False, normalize: Optional[str] = None,
                 device="cuda"):
        self.x = x
        self.y = y
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.augment = augment
        self.normalize = normalize
        self.device = resolve_device(device)
        self.rng = np.random.RandomState(seed)
        self.dataset_size = len(x)
        self._len = max(1, math.ceil(len(x) / batch_size))

    @property
    def num_examples(self) -> int:
        return len(self.x)

    def __len__(self) -> int:
        return self._len

    def __iter__(self):
        n = len(self.x)
        idx = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(self._len):
            with span("loader.batch"):
                sel = idx[b * self.batch_size: (b + 1) * self.batch_size]
                # C order: the CIFAR and SVHN readers' arrays are
                # transposed views, and the INT path's kernels take
                # contiguous NHWC codes
                xh, yh = np.ascontiguousarray(self.x[sel]), self.y[sel]
                with span("loader.upload"):
                    xb = torch.from_numpy(xh).to(self.device)
                    yb = torch.from_numpy(yh).to(self.device)
                if self.augment:
                    xb = augment_cifar(xb, *cifar_augment_params(self.rng,
                                                                 len(sel)))
                xb = D.normalize(xb, self.normalize)
            yield xb, yb


def _train_valid_split(x, y, valid_portion: float, seed: int):
    """The first valid_portion of a random permutation is the validation
    set."""
    n = len(x)
    idx = np.random.RandomState(seed).permutation(n)
    n_valid = int(np.floor(valid_portion * n))
    v_idx, t_idx = idx[:n_valid], idx[n_valid:]
    return (x[t_idx], y[t_idx]), (x[v_idx], y[v_idx])


def _regression(cfg, split: int, train: bool):
    if cfg.dataset == "regression_synthetic":
        if train:
            return D.regression_data_generator(n_points=1000, seed=cfg.seed)
        return D.regression_data_generator(n_points=1000, noise=False,
                                           seed=cfg.seed + 1)
    from qbn_tpu_torch.data.uci import UCIDatasets
    name = cfg.dataset.split("_")[-1]
    return UCIDatasets(name, cfg.data).get_split(split, train=train)


def get_train_loaders(cfg, split: int = -1, device="cuda"
                      ) -> Tuple[ArrayLoader, Optional[ArrayLoader]]:
    """Train and validation loaders of cfg.dataset ('mnist', 'cifar' with
    crop, flip and normalisation, 'regression_synthetic' or
    'regression_<uci name>' at fold `split`), their batches on `device`.
    The validation set is cfg.valid_portion of the data (None at 0)."""
    if not 0 <= cfg.valid_portion < 1.0:
        raise ValueError(f"valid_portion {cfg.valid_portion}")
    device = resolve_device(device)
    augment, normalize = False, None
    if cfg.dataset == "mnist":
        x, y = D.load_images("mnist", cfg.data, train=True)
    elif cfg.dataset == "cifar":
        x, y = D.load_images("cifar", cfg.data, train=True)
        augment, normalize = True, "cifar"
    elif "regression" in cfg.dataset:
        x, y = _regression(cfg, split, train=True)
    else:
        raise NotImplementedError(f"no loader for '{cfg.dataset}'")

    (xt, yt), (xv, yv) = _train_valid_split(x, y, cfg.valid_portion,
                                            cfg.seed)
    train = ArrayLoader(xt, yt, cfg.batch_size, shuffle=True, seed=cfg.seed,
                        augment=augment, normalize=normalize, device=device)
    # n_points is the size before the valid split, as in qbn_tpu
    train.dataset_size = len(x)
    valid = None
    if cfg.valid_portion > 0:
        valid = ArrayLoader(xv, yv, cfg.batch_size, normalize=normalize,
                            device=device)
        valid.dataset_size = len(x)
    log.info("train size %d, valid size %d", len(xt), len(xv))
    return train, valid


def get_test_loader(cfg, distortion: Optional[str] = None, level: int = -1,
                    split: int = -1, device="cuda") -> ArrayLoader:
    """The test loader of cfg.dataset, optionally distorted (mnist and
    cifar), and of the OOD sets 'random_mnist' (FashionMNIST) and
    'random_cifar' (SVHN)."""
    device = resolve_device(device)
    normalize = None
    if cfg.dataset in ("mnist", "cifar"):
        x, y = D.load_images(cfg.dataset, cfg.data, train=False)
        x = apply_distortion(x, distortion, level)
        if cfg.dataset == "cifar":
            normalize = "cifar"
    elif cfg.dataset == "random_mnist":
        x, y = D.load_images("fashion_mnist", cfg.data, train=False)
    elif cfg.dataset == "random_cifar":
        x, y = D.load_images("svhn", cfg.data, train=False)
        normalize = "cifar"
    elif "regression" in cfg.dataset:
        x, y = _regression(cfg, split, train=False)
    else:
        raise NotImplementedError(f"no loader for '{cfg.dataset}'")
    log.info("test size %d", len(x))
    return ArrayLoader(x, y, cfg.batch_size, normalize=normalize,
                       device=device)
