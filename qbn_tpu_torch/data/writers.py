"""On-disk dataset format writers (port of qbn_tpu/data/writers.py):
idx ubyte, CIFAR-10 python pickles, SVHN .mat, UCI tables.

Byte-exact standard formats, so that the readers of `data/datasets.py`
and `data/uci.py` (and qbn_tpu's, and any torchvision-compatible reader)
can be exercised without a download.
"""

from __future__ import annotations

import os
import pickle
import struct

import numpy as np


def write_idx_images(path: str, images: np.ndarray) -> None:
    """Write (N, H, W) or (N, H, W, 1) uint8 images as idx3-ubyte
    (magic 2051, the MNIST raw format)."""
    x = np.asarray(images, np.uint8)
    if x.ndim == 4:
        assert x.shape[-1] == 1, "idx images are single-channel"
        x = x[..., 0]
    n, rows, cols = x.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(struct.pack(">IIII", 2051, n, rows, cols))
        fh.write(x.tobytes())


def write_idx_labels(path: str, labels: np.ndarray) -> None:
    """Write (N,) integer labels as idx1-ubyte (magic 2049)."""
    y = np.asarray(labels, np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(struct.pack(">II", 2049, len(y)))
        fh.write(y.tobytes())


def write_mnist_dir(data_dir: str, x_train, y_train, x_test, y_test,
                    prefix: str = "MNIST") -> str:
    """Lay out <data_dir>/<prefix>/raw/{train,t10k}-{images,labels}-idx*
    exactly as torchvision's raw MNIST download does."""
    raw = os.path.join(data_dir, prefix, "raw")
    os.makedirs(raw, exist_ok=True)
    write_idx_images(os.path.join(raw, "train-images-idx3-ubyte"), x_train)
    write_idx_labels(os.path.join(raw, "train-labels-idx1-ubyte"), y_train)
    write_idx_images(os.path.join(raw, "t10k-images-idx3-ubyte"), x_test)
    write_idx_labels(os.path.join(raw, "t10k-labels-idx1-ubyte"), y_test)
    return raw


def write_cifar10_dir(data_dir: str, x_train, y_train, x_test, y_test
                      ) -> str:
    """Write (N, 32, 32, 3) uint8 NHWC images as the standard
    cifar-10-batches-py pickles (b'data' rows are CHW-flattened)."""
    base = os.path.join(data_dir, "cifar-10-batches-py")
    os.makedirs(base, exist_ok=True)

    def _dump(name, x, y):
        rows = np.asarray(x, np.uint8).transpose(0, 3, 1, 2).reshape(
            len(x), -1)
        with open(os.path.join(base, name), "wb") as fh:
            pickle.dump({b"data": rows,
                         b"labels": [int(v) for v in y]}, fh)

    xs = np.array_split(np.asarray(x_train), 5)
    ys = np.array_split(np.asarray(y_train), 5)
    for i in range(5):
        _dump(f"data_batch_{i + 1}", xs[i], ys[i])
    _dump("test_batch", x_test, y_test)
    return base


def write_svhn_mat(data_dir: str, x, y, split: str = "test") -> str:
    """Write (N, 32, 32, 3) uint8 images as SVHN's <split>_32x32.mat
    (X is HWCN; label 0 is stored as 10, as in the real dataset)."""
    import scipy.io
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, f"{split}_32x32.mat")
    xm = np.asarray(x, np.uint8).transpose(1, 2, 3, 0)
    ym = np.asarray(y, np.int64).reshape(-1, 1).copy()
    ym[ym == 0] = 10
    scipy.io.savemat(path, {"X": xm, "y": ym})
    return path


def write_uci_table(data_dir: str, name: str, table: np.ndarray) -> str:
    """Write a (n, d+1) table in the on-disk format the named UCI dataset
    ships in (reference download targets: src/data.py:22-28)."""
    uci = os.path.join(data_dir, "UCI")
    os.makedirs(uci, exist_ok=True)
    t = np.asarray(table, np.float64)
    if name == "housing":
        path = os.path.join(uci, "housing.data")
        header = " ".join(f"c{i}" for i in range(t.shape[1]))
        np.savetxt(path, t, header=header, comments="")
    elif name == "yacht":
        path = os.path.join(uci, "yacht_hydrodynamics.data")
        # reference reads with header=1: two leading non-data rows
        header = ("description line\n"
                  + " ".join(f"c{i}" for i in range(t.shape[1])))
        np.savetxt(path, t, header=header, comments="")
    elif name == "wine":
        path = os.path.join(uci, "winequality-red.csv")
        # reference reads with header=1 and ';' delimiter
        lines = ["description line",
                 ";".join(f"c{i}" for i in range(t.shape[1]))]
        lines += [";".join(f"{float(v):.12g}" for v in row) for row in t]
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    else:  # excel-based datasets: write the csv fallback the reader accepts
        path = os.path.join(uci, f"{name}.csv")
        np.savetxt(path, t, delimiter=",",
                   header=",".join(f"c{i}" for i in range(t.shape[1])),
                   comments="")
    return path
