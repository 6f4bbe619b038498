"""The port's data pipeline (qbn_tpu_torch/data) against qbn_tpu's, bit
for bit, on the CPU at small sizes, inputs from seeds:

- the learnable synthetic images (synth.py);
- the writers' files read back by both packages' readers (idx, the
  CIFAR pickles, SVHN's .mat; the UCI tables, which the port reads with
  numpy and qbn_tpu with pandas);
- the synthetic stand-ins of the four image datasets, with the arguments
  each package's `load_images` gives them;
- every UCI dataset's stand-in table, its folds 0 and 9, standardised;
- the 15 distortion cells: `gather_spec`, and the port's tensor
  `apply_spec` against qbn_tpu's numpy rotate, horizontal_shift and
  brighten;
- the loaders: len, dataset_size, and two epochs of batches (after the
  one batch that `fit` reads first, as qbn_tpu's `_fit` does), with
  CIFAR's crop, flip and normalisation and the ragged last batch, and
  the test, OOD and distorted test loaders.

qbn_tpu's loaders and distortions take its threaded native library when
it is built; its own tests hold that bitwise against its numpy path,
which these tests use (native.available patched to False), so that no
compiler runs here.
"""

import os

import numpy as np
import pytest
import torch

import qbn_tpu.data.native as j_native
from qbn_tpu.data import datasets as JD
from qbn_tpu.data import distortions as JX
from qbn_tpu.data import loaders as JL
from qbn_tpu.data import synth as JS
from qbn_tpu.data import uci as JU
from qbn_tpu.data import writers as JW
from qbn_tpu.presets import preset as j_preset

from qbn_tpu_torch.data import datasets as D
from qbn_tpu_torch.data import distortions as X
from qbn_tpu_torch.data import loaders as L
from qbn_tpu_torch.data import synth as S
from qbn_tpu_torch.data import uci as U
from qbn_tpu_torch.data import writers as W
from qbn_tpu_torch.presets import preset


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    monkeypatch.setattr(j_native, "available", lambda: False)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


SYNTH = {
    "mnist": lambda m: m.make_synth_mnist(30, 12, seed=2, max_shift=8,
                                          noise_sigma=160.0),
    "cifar": lambda m: m.make_synth_cifar(24, 8, seed=0),
    "images": lambda m: m.make_synth_images(20, (32, 32, 3), 10, 8899,
                                            proto_seed=31337),
}


@pytest.mark.parametrize("kind", sorted(SYNTH))
def test_synth_images(kind):
    for a, b in zip(SYNTH[kind](S), SYNTH[kind](JS)):
        _same(a, b)


def _tiny_data(root, n_train=60, n_test=24):
    """MNIST, FashionMNIST, CIFAR-10 and SVHN files written by the port's
    writers: (dir, {name: (x_train, y_train, x_test, y_test) uint8})."""
    out = {}
    out["mnist"] = S.make_synth_mnist(n_train, n_test, seed=1)
    W.write_mnist_dir(root, *out["mnist"], prefix="MNIST")
    fx, fy = S.make_synth_images(n_train + n_test, (28, 28, 1), 10, 7,
                                 proto_seed=9)
    out["fashion_mnist"] = (fx[:n_train], fy[:n_train], fx[n_train:],
                            fy[n_train:])
    W.write_mnist_dir(root, *out["fashion_mnist"], prefix="FashionMNIST")
    out["cifar"] = S.make_synth_cifar(n_train, n_test, seed=3)
    W.write_cifar10_dir(root, *out["cifar"])
    sx, sy = S.make_synth_images(n_test, (32, 32, 3), 10, 8899,
                                 proto_seed=31337)
    out["svhn"] = (None, None, sx, sy)
    W.write_svhn_mat(root, sx, sy, split="test")
    return out


@pytest.mark.parametrize("name", ["mnist", "cifar", "svhn"])
def test_writers_round_trip(tmp_path, name):
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "qbn")
    made = _tiny_data(mine)[name]
    if name == "mnist":
        JW.write_mnist_dir(theirs, *made, prefix="MNIST")
        files = [os.path.join("MNIST", "raw", f) for f in sorted(
            os.listdir(os.path.join(mine, "MNIST", "raw")))]
    elif name == "cifar":
        JW.write_cifar10_dir(theirs, *made)
        files = [os.path.join("cifar-10-batches-py", f) for f in sorted(
            os.listdir(os.path.join(mine, "cifar-10-batches-py")))]
    else:
        files = []              # a .mat header carries its write time
    for f in files:
        with open(os.path.join(mine, f), "rb") as a, \
                open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f
    for train in ([True, False] if name != "svhn" else [False]):
        got = D.load_images(name, mine, train)
        want = JD.load_images(name, mine, train)
        for a, b in zip(got, want):
            _same(a, b)
        x, y = made[:2] if train else made[2:]
        _same(got[1], y)
        _same(got[0], x.astype(np.float32) / 255.0)


UCI_SKIP = {"housing": 1, "yacht": 2, "wine": 2}     # header lines


@pytest.mark.parametrize("name", U.UCI_NAMES)
def test_uci_files_read_as_qbn_tpu_reads_them(tmp_path, name):
    """The port reads each number of a table file exactly (its decimal
    text correctly rounded, as Python's float() reads it); qbn_tpu reads
    it with pandas' default parser, which is not correctly rounded: within
    2 float64 ulps (measured: 2 at most), and the standardised float32
    splits within 1 float32 ulp."""
    rng = np.random.RandomState(5)
    n, d = U._SPECS[name][2]
    table = rng.randn(min(n, 40), d + 1) * 10.0 ** rng.randint(-3, 4, d + 1)
    path = W.write_uci_table(str(tmp_path), name, table)
    with open(path) as fh:
        lines = fh.read().splitlines()[UCI_SKIP.get(name, 1):]
    exact = np.array([[float(v) for v in ln.replace(";", " ").replace(
        ",", " ").split()] for ln in lines])
    got = U.UCIDatasets(name, str(tmp_path))
    want = JU.UCIDatasets(name, str(tmp_path))
    _same(got.data, exact)
    np.testing.assert_array_max_ulp(got.data, want.data, maxulp=2)
    for fold in (0, 9):
        for train in (True, False):
            for a, b in zip(got.get_split(fold, train),
                            want.get_split(fold, train)):
                np.testing.assert_array_max_ulp(a, b, maxulp=1)


@pytest.mark.parametrize("name", U.UCI_NAMES)
def test_uci_stand_in_folds(tmp_path, name):
    got = U.UCIDatasets(name, str(tmp_path))
    want = JU.UCIDatasets(name, str(tmp_path))
    _same(got.data, want.data)
    assert got.data.shape == (U._SPECS[name][2][0], U._SPECS[name][2][1] + 1)
    for (gt, ge), (wt, we) in zip(got.data_splits, want.data_splits):
        _same(gt, wt)
        _same(ge, we)
    for fold in (0, 9):
        for train in (True, False):
            for a, b in zip(got.get_split(fold, train),
                            want.get_split(fold, train)):
                _same(a, b)


@pytest.mark.parametrize("name", ["mnist", "fashion_mnist", "cifar",
                                  "svhn"])
def test_stand_ins(tmp_path, monkeypatch, name):
    """Each package's load_images on a directory without the files calls
    its stand-in with the same arguments; the stand-ins (at a fiftieth of
    the size) give the same arrays."""
    calls = {}
    for key, mod in (("port", D), ("qbn", JD)):
        real = mod._fallback
        monkeypatch.setattr(mod, "_fallback", lambda *a, _k=key: (
            calls.setdefault(_k, []).append(a) or (None, None)))
        for train in (True, False):
            mod.load_images(name, str(tmp_path), train)
        monkeypatch.setattr(mod, "_fallback", real)
    assert calls["port"] == calls["qbn"]
    for (nm, n_tr, n_te, shape, classes, seed, train) in calls["port"]:
        small = (nm, n_tr // 50, n_te // 50, shape, classes, seed, train)
        for a, b in zip(D._fallback(*small), JD._fallback(*small)):
            _same(a, b)


CELLS = [(d, lv) for d in X.DISTORTIONS for lv in range(X.LEVELS)]


@pytest.mark.parametrize("distortion,level", CELLS)
def test_distortion_cell(distortion, level):
    x, _y = S.make_synth_cifar(6, 1, seed=4)[:2]
    images = x.astype(np.float32) / 255.0
    spec = X.gather_spec(distortion, level, 32, 32)
    for a, b in zip(spec, JX.gather_spec(distortion, level, 32, 32)):
        _same(a, b)
    if distortion == "rotation":
        want = JX.rotate(images, JX.ROTATION_LEVELS[level])
    elif distortion == "shift":
        want = JX.horizontal_shift(images, JX.SHIFT_LEVELS[level])
    else:
        want = JX.brighten(images, JX.BRIGHTNESS_LEVELS[level])
    got = X.apply_spec(torch.from_numpy(images), spec)
    assert got.is_contiguous()
    _same(got.numpy(), want)
    _same(X.apply_distortion(images, distortion, level),
          JX.apply_distortion(images, distortion, level))


def _loader_batches(loader, epochs=2):
    """The batch fit reads first, then `epochs` epochs, as numpy (the
    port's batches contiguous, as the INT path's kernels take them)."""
    batches = [next(iter(loader))]
    for _ in range(epochs):
        batches += list(loader)
    for b in batches:
        assert not isinstance(b[0], torch.Tensor) or all(
            t.is_contiguous() for t in b)
    return [tuple(np.asarray(t) for t in b) for b in batches]


TIERS = {"mnist": ("bbb", "mnist", {}),
         "cifar": ("pointwise", "cifar", {}),
         "regression_synthetic": ("mcdropout", "regression", {}),
         "regression_housing": ("sgld", "regression",
                                dict(dataset="regression_housing"))}


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_train_loaders_two_epochs(tmp_path, tier):
    _tiny_data(str(tmp_path))
    method, t, over = TIERS[tier]
    over = dict(over, data=str(tmp_path), seed=3,
                batch_size=16 if t != "regression" else 96)
    train, valid = L.get_train_loaders(preset(method, t, **over), split=9,
                                       device="cpu")
    j_train, j_valid = JL.get_train_loaders(j_preset(method, t, **over),
                                            split=9)
    for got, want in ((train, j_train), (valid, j_valid)):
        assert (len(got), got.dataset_size, got.num_examples) == \
            (len(want), want.dataset_size, want.num_examples)
    assert len(train.x) % train.batch_size, "no ragged last batch"
    for got, want in ((train, j_train), (valid, j_valid)):
        a, b = _loader_batches(got), _loader_batches(want)
        assert len(a) == len(b)
        for (xa, ya), (xb, yb) in zip(a, b):
            _same(xa, xb)
            _same(ya, yb)


TEST_SETS = [("cifar", None, -1), ("cifar", "rotation", 2),
             ("random_cifar", None, -1), ("mnist", "brightness", 4),
             ("random_mnist", None, -1), ("regression_yacht", None, 9)]


@pytest.mark.parametrize("dataset,distortion,level", TEST_SETS)
def test_test_loaders(tmp_path, dataset, distortion, level):
    _tiny_data(str(tmp_path))
    tier = ("regression" if "regression" in dataset else
            dataset.split("_")[-1])
    over = dict(dataset=dataset, data=str(tmp_path), batch_size=10)
    split = level if tier == "regression" else -1
    lv = -1 if tier == "regression" else level
    got = L.get_test_loader(preset("bbb", tier, **over), distortion, lv,
                            split=split, device="cpu")
    want = JL.get_test_loader(j_preset("bbb", tier, **over), distortion, lv,
                              split=split)
    a, b = _loader_batches(got, 1), _loader_batches(want, 1)
    assert len(a) == len(b) == len(want) + 1
    for (xa, ya), (xb, yb) in zip(a, b):
        _same(xa, xb)
        _same(ya, yb)
