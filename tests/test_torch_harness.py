"""The port's uncertainty harness (qbn_tpu_torch/evaluation/harness.py and
mc.evaluate_with_loader, evaluate_distortion_sweep) against qbn_tpu's,
on the CPU, weights carried across from qbn_tpu:

- `evaluate_with_loader` of a pointwise LeNet and a pointwise MLP from
  qbn_tpu's inits, on loaders over the same data: the four metrics, the
  outputs and the targets;
- `evaluate_classification_uncertainty` of that LeNet on a tiny MNIST and
  FashionMNIST that the port's writers put on disk: the whole results
  dict (train, valid, test, the OOD set 'random', the 15 distortion
  cells, model_size), latency aside, the key sets identical;
- `evaluate_regression_uncertainty` on a copy of the committed
  examples/campaign/pointwise-regression-seed1 cut to the synthetic task
  and housing's first two folds, each package reading the fold
  checkpoints itself;
- `model_size_mb` of the committed CIFAR states, equal to qbn_tpu's and
  to the committed results.json's;
- the results store's schema;
- the port's distortion sweep against its own loader path, bitwise, for
  a BBB LeNet (a posterior draw per sample and batch), the port alone.

Tolerance 1e-5 (relative, 1e-6 absolute): float32 products summed in
another order. Pointwise models are deterministic, so the posterior
generator's stream plays no part.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import qbn_tpu.data.native as j_native
from qbn_tpu.config import Config as JConfig
from qbn_tpu.data import loaders as JL
from qbn_tpu.evaluation import harness as JH
from qbn_tpu.evaluation import mc as JMC
from qbn_tpu.evaluation import results as JR
from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training.checkpoint import model_size_mb as j_model_size
from qbn_tpu.utils import init_variables as j_init

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.data import loaders as L
from qbn_tpu_torch.data import synth as S
from qbn_tpu_torch.data import writers as W
from qbn_tpu_torch.evaluation import harness as H
from qbn_tpu_torch.evaluation import mc as MC
from qbn_tpu_torch.evaluation import results as R
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training.checkpoint import (
    checkpoint_path, model_size_mb, read_checkpoint)
from qbn_tpu_torch.utils import init_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = os.path.join(ROOT, "examples", "campaign")
TOL = dict(rel=1e-5, abs=1e-6)


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    monkeypatch.setattr(j_native, "available", lambda: False)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share the CPU,
    and at these sizes torch's thread pool spends more waiting at its
    barriers there than it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mnist(root, n_train=72, n_test=40):
    W.write_mnist_dir(root, *S.make_synth_mnist(n_train, n_test, seed=5),
                      prefix="MNIST")
    fx, fy = S.make_synth_images(2 * n_test, (28, 28, 1), 10, 7,
                                 proto_seed=9)
    W.write_mnist_dir(root, fx[:n_test], fy[:n_test], fx[n_test:],
                      fy[n_test:], prefix="FashionMNIST")


def _pointwise(tier, **over):
    """qbn_tpu's and the port's cfg, model and state of a pointwise model
    of the tier, the state qbn_tpu's init carried across."""
    jcfg, cfg = j_preset("pointwise", tier, **over), preset("pointwise",
                                                            tier, **over)
    jm = j_build(jcfg)
    jstate = jax.tree.map(np.asarray, j_init(
        jm, jax.random.PRNGKey(3), jnp.zeros((1,) + tuple(cfg.input_size))))
    return jcfg, cfg, jm, build_model(cfg), jstate, from_jax_state(jstate)


@pytest.mark.parametrize("tier", ["mnist", "regression"])
def test_evaluate_with_loader(tmp_path, tier):
    _mnist(str(tmp_path))
    over = dict(data=str(tmp_path), batch_size=32)
    if tier == "regression":
        over.update(dataset="regression_housing", input_size=(13,),
                    batch_size=64)
    jcfg, cfg, jm, tm, jstate, tstate = _pointwise(tier, **over)
    jl, _ = JL.get_train_loaders(jcfg, split=4)
    tl, _ = L.get_train_loaders(cfg, split=4, device="cpu")
    want = JMC.evaluate_with_loader(jl, jm, jax.tree.map(jnp.asarray,
                                                         jstate),
                                    jcfg, "float", salt="train")
    got = MC.evaluate_with_loader(tl, tm, tstate, cfg, "float",
                                  salt="train", device="cpu")
    for g, w in zip(got[:4], want[:4]):
        assert g == pytest.approx(w, **TOL)
    for g, w in zip(got[4] if tier == "regression" else (got[4],),
                    want[4] if tier == "regression" else (want[4],)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[5], want[5])
    assert got[6] > 0


def _compare(got, want, path=""):
    """Equal key sets all the way down; numbers within TOL; the latency
    slot's keys only."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if not isinstance(want, dict):
        if isinstance(want, str):
            assert got == want, path
        elif "latency" not in path:
            assert got == pytest.approx(want, **TOL), path
        return
    assert set(got) == set(want), path
    for k in want:
        _compare(got[k], want[k], f"{path}/{k}")


def test_classification_protocol(tmp_path):
    data = str(tmp_path / "data")
    _mnist(data)
    over = dict(data=data, batch_size=32)
    jcfg, cfg, jm, tm, jstate, tstate = _pointwise("mnist", **over)
    for who in ("qbn", "port"):
        (tmp_path / who).mkdir()
    want = JH.evaluate_classification_uncertainty(
        jm, jax.tree.map(jnp.asarray, jstate),
        jcfg.replace(save=str(tmp_path / "qbn")), "float")
    got = H.evaluate_classification_uncertainty(
        tm, tstate, cfg.replace(save=str(tmp_path / "port")), "float",
        device="cpu")
    _compare(got, want)
    assert len(got["error"]) == 4 + 3 and len(got["latency"]) == 4
    assert got["model_size"] == want["model_size"]
    with open(tmp_path / "port" / "results.json") as fh:
        _compare(json.load(fh), got)


FOLDS = [("synthetic", 1), ("housing", 2)]


def test_regression_protocol_on_committed_folds(tmp_path):
    src = os.path.join(CAMPAIGN, "pointwise-regression-seed1")
    runs = {}
    for who in ("port", "qbn"):
        d = tmp_path / who
        d.mkdir()
        for f in ["config.json", "results.json"] + [
                f"weights_{n}_{k}.msgpack" for n, folds in FOLDS
                for k in range(folds)]:
            shutil.copy(os.path.join(src, f), d / f)
        runs[who] = str(d)
    with open(os.path.join(src, "config.json")) as fh:
        raw = json.load(fh)
    over = dict(data=str(tmp_path / "no_data"))
    jraw = {k: v for k, v in raw.items()
            if k in JConfig.__dataclass_fields__}
    jraw["input_size"] = tuple(jraw["input_size"])
    jcfg = JConfig(**jraw).replace(save=runs["qbn"], **over)
    cfg = Config.from_json(os.path.join(src, "config.json")).replace(
        save=runs["port"], **over)
    want = JH.evaluate_regression_uncertainty(jcfg, "float", datasets=FOLDS)
    got = H.evaluate_regression_uncertainty(cfg, "float", datasets=FOLDS,
                                            device="cpu")
    _compare(got, want)
    assert got["model_size"] == want["model_size"]
    for name, _n in FOLDS:
        assert set(got["error"][f"regression_{name}"]) == {
            "train", "valid", "test"}
    assert os.path.exists(os.path.join(runs["port"], "results.json"))


@pytest.mark.parametrize("run", ["bbb-cifar-a_7_w_8-seed1",
                                 "pointwise-cifar-seed1"])
def test_model_size(run):
    path = checkpoint_path(os.path.join(CAMPAIGN, run))
    with open(path, "rb") as fh:
        want = j_model_size(serialization.msgpack_restore(fh.read()))
    got = model_size_mb(from_jax_state(read_checkpoint(path)))
    with open(os.path.join(CAMPAIGN, run, "results.json")) as fh:
        committed = json.load(fh)["model_size"]
    assert got == want == committed == os.path.getsize(path) / 1e6


def test_results_schema(tmp_path):
    cfg = preset("bbb", "cifar")
    got = R.init_results(cfg)
    assert got == JR.init_results(j_preset("bbb", "cifar"))
    got["error"]["test"] = 0.25
    R.save_results(got, str(tmp_path))
    assert JR.load_results(str(tmp_path)) == R.load_results(str(tmp_path)) \
        == got


@pytest.fixture(scope="module")
def bbb_sweep(tmp_path_factory):
    """A BBB LeNet from the port's init on a tiny MNIST, and its 3 x 5
    sweep in float (a posterior draw per sample and batch)."""
    data = str(tmp_path_factory.mktemp("sweep"))
    _mnist(data, n_test=40)
    cfg = preset("bbb", "mnist", data=data, batch_size=16, samples=2)
    model = build_model(cfg)
    state = init_variables(model, torch.Generator().manual_seed(4),
                           cfg.input_size, "cpu")
    # one thread, as the tests that hold it against the loader path run
    # (the CPU's reductions follow the thread count)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sweep = MC.evaluate_distortion_sweep(model, state, cfg, "float",
                                             device="cpu")
    finally:
        torch.set_num_threads(n)
    return cfg, model, state, sweep


@pytest.mark.parametrize("distortion", ["rotation", "shift", "brightness"])
def test_sweep_equals_the_loader_path(bbb_sweep, distortion):
    """The sweep (each cell made from one upload of the clean test set)
    against evaluate_with_loader of get_test_loader(cfg, distortion,
    level) (the cell made on the host, batch by batch) under the cell's
    generator: the four metrics bitwise equal at every level."""
    cfg, model, state, sweep = bbb_sweep
    cells = [c for c in sweep if c[0] == distortion]
    assert [c[1] for c in cells] == list(range(5))
    for _d, level, *have in cells:
        want = MC.evaluate_with_loader(
            L.get_test_loader(cfg, distortion, level, device="cpu"), model,
            state, cfg, "float", collect_outputs=False,
            salt=f"{distortion}{level}", device="cpu")[:4]
        assert tuple(have) == tuple(want), level
