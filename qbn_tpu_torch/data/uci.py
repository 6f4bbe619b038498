"""UCI regression datasets (port of qbn_tpu/data/uci.py): local files,
contiguous 10-fold split, per-fold standardisation in float64.

The six tables are read from <data_dir>/UCI/ when present, with numpy
(the card's machine has no pandas), consuming the same header rows as
qbn_tpu's pandas readers. An .xls or .xlsx file cannot be read without
an Excel engine: the reader warns and the dataset falls back to its
stand-in, as qbn_tpu's does when its engine is missing. The stand-in is
a linear-plus-noise table with the dataset's (rows, features), seeded
from a digest of the name, so that every process makes the same table.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Tuple

import numpy as np

log = logging.getLogger(__name__)

# name -> (file names, reader kind, (rows, features) of the stand-in)
_SPECS = {
    "housing": (["housing.data"], "whitespace", (506, 13)),
    "concrete": (["Concrete_Data.xls", "concrete.csv"], "excel", (1030, 8)),
    "energy": (["ENB2012_data.xlsx", "energy.csv"], "excel", (768, 8)),
    "power": (["CCPP/Folds5x2_pp.xlsx", "power.csv"], "excel", (9568, 4)),
    "wine": (["winequality-red.csv"], "semicolon", (1599, 11)),
    "yacht": (["yacht_hydrodynamics.data"], "whitespace", (308, 6)),
}

UCI_NAMES = list(_SPECS)


def _kfold_indices(n: int, n_splits: int):
    """Contiguous unshuffled K-fold (sklearn KFold's default): the first
    n % n_splits folds take one row more."""
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    splits = []
    start = 0
    idx = np.arange(n)
    for s in sizes:
        test = idx[start:start + s]
        train = np.concatenate([idx[:start], idx[start + s:]])
        splits.append((train, test))
        start += s
    return splits


def _load_file(data_dir: str, name: str):
    files, kind, _ = _SPECS[name]
    for f in files:
        path = os.path.join(data_dir, "UCI", f)
        if not os.path.exists(path):
            continue
        if kind == "whitespace":
            # qbn_tpu reads housing with one header row consumed and
            # yacht with two
            skip = 2 if name == "yacht" else 1
            return np.loadtxt(path, skiprows=skip, ndmin=2)
        if kind == "semicolon":
            # pandas' header=1: the second line is the header
            return np.loadtxt(path, delimiter=";", skiprows=2, ndmin=2)
        if path.endswith(".csv"):
            return np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
        log.warning("cannot read %s without an Excel engine: using the "
                    "stand-in", path)
        return None
    return None


_SYNTH_WARNED = set()


def _synthetic_table(name: str):
    n, d = _SPECS[name][2]
    # seeded from a process-stable digest of the name (str hash() is
    # salted per interpreter: a QAT run in its own process would
    # otherwise fine-tune on another table than the float run's)
    digest = hashlib.sha256(name.encode()).digest()
    rng = np.random.RandomState(int.from_bytes(digest[:4], "little"))
    x = rng.randn(n, d)
    w = rng.randn(d, 1)
    y = x @ w + 0.3 * rng.randn(n, 1)
    if name not in _SYNTH_WARNED:
        log.warning("UCI dataset '%s' not found on disk: using the "
                    "synthetic stand-in (%d rows, %d features)", name, n, d)
        _SYNTH_WARNED.add(name)
    return np.concatenate([x, y], axis=1)


class UCIDatasets:
    """K-fold UCI regression dataset with per-fold standardisation."""

    def __init__(self, name: str, data_path: str = "", n_splits: int = 10):
        if name not in _SPECS:
            raise ValueError(f"unknown UCI dataset '{name}'")
        self.name = name
        self.n_splits = n_splits
        data = _load_file(data_path, name)
        if data is None:
            data = _synthetic_table(name)
        self.data = np.asarray(data, np.float64)
        self.in_dim = self.data.shape[1] - 1
        self.out_dim = 1
        self.data_splits = _kfold_indices(len(self.data), n_splits)

    def get_split(self, split: int = -1, train: bool = True
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Standardised float32 (x, y) of one fold's train or test rows,
        by the train rows' mean and std (a zero std taken as 1); split -1
        is fold 0."""
        if split == -1:
            split = 0
        if not 0 <= split < self.n_splits:
            raise ValueError(f"fold {split} of {self.n_splits}")
        tr_idx, te_idx = self.data_splits[split]
        x_tr = self.data[tr_idx, : self.in_dim]
        y_tr = self.data[tr_idx, self.in_dim:]
        x_te = self.data[te_idx, : self.in_dim]
        y_te = self.data[te_idx, self.in_dim:]
        x_m, x_s = x_tr.mean(0), x_tr.var(0) ** 0.5
        y_m, y_s = y_tr.mean(0), y_tr.var(0) ** 0.5
        x_s = np.where(x_s == 0, 1.0, x_s)
        y_s = np.where(y_s == 0, 1.0, y_s)
        if train:
            x, y = (x_tr - x_m) / x_s, (y_tr - y_m) / y_s
        else:
            x, y = (x_te - x_m) / x_s, (y_te - y_m) / y_s
        return x.astype(np.float32), y.astype(np.float32)
