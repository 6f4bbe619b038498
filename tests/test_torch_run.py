"""The port's experiment runner, `python -m qbn_tpu_torch.run`, on the CPU
(`--device cpu`), and the flows' loaders:

- float then qat runs with --debug and one epoch (pointwise regression
  over the synthetic task and the six UCI stand-ins; BBB and SGHMC on a
  tiny MNIST and FashionMNIST written to disk): each run directory holds
  qbn_tpu's files, the qat run read the float run's checkpoints, and
  results.json has the key set of the committed campaign run of the
  same cell (a --debug run stops each loop after one batch, evaluates
  one distortion cell and fold 0 of each dataset: those keys only);
- without --device the runner needs the card, and raises on a host
  without one;
- the pointwise regression tier, float then qat with --debug and one
  epoch, through the port's runner and through qbn_tpu's
  experiments/run.py on the same data, each model starting from qbn_tpu's
  init: the two results.json files agree value by value within 1e-5
  (relative; 1e-6 absolute), latency aside;
- `flows.fit` over a port loader trains, epoch after epoch, on the
  batches that qbn_tpu's loader gives for the same seed, and takes its
  n_points from the loader's dataset_size.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import qbn_tpu.data.native as j_native
from qbn_tpu import flows as JF
from qbn_tpu.data import loaders as JL
from qbn_tpu.evaluation import harness as JH
from qbn_tpu.presets import preset as j_preset

from qbn_tpu_torch import flows as F
from qbn_tpu_torch import run
from qbn_tpu_torch.convert import from_jax_state, to_device
from qbn_tpu_torch.data import get_train_loaders
from qbn_tpu_torch.data import synth as S
from qbn_tpu_torch.data import writers as W
from qbn_tpu_torch.evaluation import harness as H
from qbn_tpu_torch.flows import fit
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training import trainer as T
from qbn_tpu_torch.training.checkpoint import read_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = os.path.join(ROOT, "examples", "campaign")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's parallel workers share the CPU,
    and at these sizes torch's thread pool spends more waiting at its
    barriers there than it computes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_images(root, n_train=48, n_test=24):
    W.write_mnist_dir(root, *S.make_synth_mnist(n_train, n_test, seed=2),
                      prefix="MNIST")
    fx, fy = S.make_synth_images(2 * n_test, (28, 28, 1), 10, 7,
                                 proto_seed=9)
    W.write_mnist_dir(root, fx[:n_test], fy[:n_test], fx[n_test:],
                      fy[n_test:], prefix="FashionMNIST")
    W.write_cifar10_dir(root, *S.make_synth_cifar(n_train, n_test, seed=1))


def _keys(tree, debug_cut):
    """The nested key set of a results dict; with debug_cut, a distortion
    keeps only level "0" and rotation only (a --debug run's sweep)."""
    if not isinstance(tree, dict):
        return None
    out = {}
    for k, v in tree.items():
        if debug_cut and k in ("shift", "brightness"):
            continue
        if debug_cut and k == "rotation":
            v = {"0": v["0"]}
        out[k] = _keys(v, debug_cut)
    return out


RUNS = {
    "pointwise-regression": ("pointwise", "regression", []),
    "bbb-mnist": ("bbb", "mnist", ["--batch_size", "16", "--samples", "2",
                                   "--tpu_fused"]),
    "sgld-mnist": ("sgld", "mnist", ["--batch_size", "16", "--samples", "2",
                                     "--burnin_epochs", "0"]),
}


@pytest.mark.parametrize("cell", sorted(RUNS))
def test_float_then_qat_on_the_cpu(tmp_path, cell):
    method, tier, extra = RUNS[cell]
    data = str(tmp_path / "data")
    if tier != "regression":
        _tiny_images(data)
    common = ["--method", method, "--tier", tier, "--debug", "--device",
              "cpu", "--data", data] + extra
    f_epochs = ["--epochs", "3"] if method == "sgld" else ["--epochs", "1"]
    f_dir = run.main(common + ["--phase", "float", "--save",
                               str(tmp_path / "f")] + f_epochs)
    q_dir = run.main(common + ["--phase", "qat", "--save",
                               str(tmp_path / "q"), "--load", f_dir,
                               "--epochs", "1"])
    with open(os.path.join(CAMPAIGN, f"{cell}-seed1", "results.json")) as fh:
        committed = json.load(fh)
    if tier == "regression":
        weights = [f"weights_{n}_0.msgpack" for n in (
            "synthetic", "housing", "concrete", "energy", "power", "wine",
            "yacht")]
    elif method == "sgld":
        # 3 epochs, samples 2: snapshots at epochs 0 and 2
        weights = ["weights_0.msgpack", "weights_2.msgpack"]
    else:
        weights = ["weights.msgpack"]
    for d in (f_dir, q_dir):
        names = set(os.listdir(d))
        assert {"config.json", "log.log", "results.json", "scalars.jsonl",
                "DONE", "GIT_REVISION"} | set(weights) <= names, names
        with open(os.path.join(d, "results.json")) as fh:
            res = json.load(fh)
        assert _keys(res, tier != "regression") == \
            _keys(committed, tier != "regression")
        for metric in ("error", "nll"):
            for split, v in res[metric].items():
                for x in (v.values() if isinstance(v, dict) else [v]):
                    assert np.isfinite(x), (d, metric, split)
    with open(os.path.join(q_dir, "config.json")) as fh:
        qcfg = json.load(fh)
    assert (qcfg["q"], qcfg["at"], qcfg["load"]) == (True, True, f_dir)
    # the qat run fine-tuned the float run's weights (one step at lr
    # 1e-5), not a fresh init
    for w in weights:
        fp = read_checkpoint(os.path.join(f_dir, w))["params"]
        qp = read_checkpoint(os.path.join(q_dir, w))["params"]
        for a, b in zip(_leaves(fp), _leaves(qp)):
            np.testing.assert_allclose(b, a, atol=1e-3, err_msg=w)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _j_runner():
    """qbn_tpu's experiments/run.py, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        "qbn_tpu_experiments_run", os.path.join(ROOT, "experiments",
                                                "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _close(got, want, path=""):
    """Equal key sets all the way down; numbers within 1e-5 relative
    (1e-6 absolute); the latency slot's keys only."""
    assert isinstance(got, dict) == isinstance(want, dict), path
    if not isinstance(want, dict):
        if isinstance(want, str):
            assert got == want, path
        elif "latency" not in path:
            assert got == pytest.approx(want, rel=1e-5, abs=1e-6), path
        return
    assert set(got) == set(want), path
    for k in want:
        _close(got[k], want[k], f"{path}/{k}")


RUN_DATASETS = [("synthetic", 1), ("housing", 10), ("power", 10)]


def test_regression_runs_match_qbn_tpu(tmp_path, monkeypatch):
    """Float then qat, through both runners: the folds, their seeds and
    loaders, the checkpoints the qat run reads and the evaluation. Each
    of the port's models starts from the init that qbn_tpu's flow drew
    for the same shape (the two draw from different generators)."""
    inits = {}
    j_init = JF.init_variables

    def recording(model, key, x, quantized=False):
        v = j_init(model, key, x, quantized=quantized)
        inits[(tuple(x.shape[1:]), quantized)] = jax.tree.map(np.asarray, v)
        return v

    def carried(model, generator, input_size, device="cuda",
                quantized=False):
        return to_device(from_jax_state(inits[(tuple(input_size),
                                               quantized)]), device)

    monkeypatch.setattr(JF, "init_variables", recording)
    monkeypatch.setattr(F, "init_variables", carried)
    # three of the seven datasets: the synthetic task, housing, and power,
    # the one whose train split is more than one batch
    for mod in (JF, JH, F, H):
        monkeypatch.setattr(mod, "REGRESSION_DATASETS", RUN_DATASETS)
    common = ["--method", "pointwise", "--tier", "regression", "--debug",
              "--epochs", "1", "--data", str(tmp_path / "no_data")]
    runners = {"qbn": (_j_runner().main, []),
               "port": (run.main, ["--device", "cpu"])}
    for phase in ("float", "qat"):
        res = {}
        for who, (main, extra) in runners.items():
            load = (["--load", str(tmp_path / f"{who}-float")]
                    if phase == "qat" else [])
            save = tmp_path / f"{who}-{phase}"
            main(common + extra + load + ["--phase", phase, "--save",
                                          str(save)])
            with open(save / "results.json") as fh:
                res[who] = json.load(fh)
        _close(res["port"], res["qbn"], phase)
        assert len(res["port"]["error"]) == len(RUN_DATASETS), phase


def test_the_runner_needs_the_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--method", "pointwise", "--tier", "regression",
                  "--debug", "--save", str(tmp_path / "r")])
    assert not os.path.exists(tmp_path / "r")


def test_fit_iterates_a_loader_afresh_each_epoch(tmp_path, monkeypatch):
    monkeypatch.setattr(j_native, "available", lambda: False)
    _tiny_images(str(tmp_path), n_train=20)
    over = dict(data=str(tmp_path), batch_size=8, epochs=2, seed=6)
    seen, sizes = [], []
    make = T.make_train_step

    def recording(model, cfg, tx, mode, n_batches, n_points):
        sizes.append((n_batches, n_points))
        step = make(model, cfg, tx, mode, n_batches, n_points)

        def wrapped(state, metric_state, x, y, *a):
            seen.append((x.numpy().copy(), y.numpy().copy()))
            return step(state, metric_state, x, y, *a)
        return wrapped

    monkeypatch.setattr(T, "make_train_step", recording)
    cfg = preset("pointwise", "cifar", **over)
    train, valid = get_train_loaders(cfg, device="cpu")
    fit(cfg, train, valid, device="cpu")

    j_train, _ = JL.get_train_loaders(j_preset("pointwise", "cifar", **over))
    next(iter(j_train))          # qbn_tpu's _fit reads one batch first
    want = [b for _ in range(2) for b in j_train]
    assert sizes == [(3, 20)]
    assert len(seen) == len(want) == 6
    for (x, y), (jx, jy) in zip(seen, want):
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
    assert not np.array_equal(seen[0][0], seen[3][0])


def _runner_entry_points():
    from qbn_tpu_torch import flows
    from qbn_tpu_torch.data import loaders
    from qbn_tpu_torch.evaluation import harness, mc
    return {
        "ArrayLoader": loaders.ArrayLoader,
        "get_train_loaders": loaders.get_train_loaders,
        "get_test_loader": loaders.get_test_loader,
        "evaluate_with_loader": mc.evaluate_with_loader,
        "evaluate_distortion_sweep": mc.evaluate_distortion_sweep,
        "evaluate_classification_uncertainty":
            harness.evaluate_classification_uncertainty,
        "evaluate_regression_uncertainty":
            harness.evaluate_regression_uncertainty,
        "run_float_classification": flows.run_float_classification,
        "run_float_regression": flows.run_float_regression,
        "run_qat_classification": flows.run_qat_classification,
        "run_qat_regression": flows.run_qat_regression,
    }


@pytest.mark.parametrize("name", sorted(_runner_entry_points()))
def test_runner_entry_points_default_to_the_card(name, monkeypatch):
    """Each entry point of the runner's path takes `device`, "cuda" by
    default, and raises on a host without a card rather than running on
    the CPU."""
    import inspect
    fn = _runner_entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = preset("pointwise", "regression", data="no_data")
    args = {"ArrayLoader": (np.zeros((2, 1)), np.zeros(2), 1),
            "get_train_loaders": (cfg,), "get_test_loader": (cfg,),
            "evaluate_with_loader": ([], None, {}, cfg, "float"),
            "evaluate_distortion_sweep": (None, {}, cfg, "float"),
            "evaluate_classification_uncertainty": (None, {}, cfg, "float"),
            "evaluate_regression_uncertainty": (cfg, "float"),
            "run_float_classification": (cfg,),
            "run_float_regression": (cfg,),
            "run_qat_classification": (cfg, "no_run"),
            "run_qat_regression": (cfg, "no_run")}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)
