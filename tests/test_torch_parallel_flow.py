"""The port's runner over a mesh of 2 gloo ranks on the CPU against its
one-process run, qbn_tpu's test_mesh_flow_matches_single_device for the
port: the float BBB and pointwise MNIST runs (2 epochs of --debug, batch
16, 8 samples, seed 3, on a small MNIST written to disk) give the same
results.json, every split and metric within rtol 1e-5, atol 1e-6
(qbn_tpu's tolerance): the batch and the samples divide over the mesh,
so every step is sharded and every evaluation sample-sharded. Also the
runner's --mesh_shape, and a launch whose rank fails.

The mesh runs take one launch (tests/test_torch_parallel_ranks.py's
run_flows calls the runner's rank body for each); the failing rank a
second, small one.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from qbn_tpu_torch import run
from qbn_tpu_torch.data import synth as S
from qbn_tpu_torch.data import writers as W
from qbn_tpu_torch.flows import setup_experiment
from qbn_tpu_torch.parallel import launch
from qbn_tpu_torch.presets import preset

import test_torch_parallel_ranks as R

METHODS = ["bbb", "pointwise"]
ARGS = ["--tier", "mnist", "--epochs", "2", "--batch_size", "16",
        "--samples", "8", "--debug", "--seed", "3", "--valid_portion",
        "0.1", "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("flows")
    data = root / "data"
    W.write_mnist_dir(str(data), *S.make_synth_mnist(48, 32, seed=2),
                      prefix="MNIST")
    fx, fy = S.make_synth_images(64, (28, 28, 1), 10, 7, proto_seed=9)
    W.write_mnist_dir(str(data), fx[:32], fy[:32], fx[32:], fy[32:],
                      prefix="FashionMNIST")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = {}
        for m in METHODS:
            d = run.main(["--method", m, *ARGS, "--data", str(data),
                          "--save", str(root / f"single-{m}")])
            single[m] = json.load(open(os.path.join(d, "results.json")))
        cfgs = [setup_experiment(preset(
            m, "mnist", epochs=2, batch_size=16, samples=8, debug=True,
            seed=3, valid_portion=0.1, data=str(data), mesh_shape=(2,),
            save=str(root / f"mesh-{m}"))) for m in METHODS]
        t0 = time.monotonic()
        mesh = launch(R.run_flows, (2,), cfgs, device="cpu",
                      init_method=f"file://{root / 'store'}", timeout=120,
                      deadline=600)
        seconds = time.monotonic() - t0
    finally:
        torch.set_num_threads(threads)
    return dict(single=single, mesh=dict(zip(METHODS, mesh)), cfgs=cfgs,
                seconds=seconds)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("method", METHODS)
def test_mesh_flow_matches_one_process(runs, method):
    single, mesh = runs["single"][method], runs["mesh"][method]
    n = 0
    for metric in ("error", "nll", "ece", "entropy"):
        a, b = dict(_flat(single[metric])), dict(_flat(mesh[metric]))
        assert a.keys() == b.keys() and ("test",) in a and ("valid",) in a
        for k in a:
            assert np.isclose(a[k], b[k], rtol=1e-5, atol=1e-6), (
                metric, k, a[k], b[k])
            n += 1
    assert n >= 4 * 5            # train, valid, test, random, a distortion
    cfg = runs["cfgs"][METHODS.index(method)]
    files = set(os.listdir(cfg.save))
    assert {"DONE", "results.json", "config.json", "log.log",
            "weights.msgpack", "scalars.jsonl"} <= files
    with open(os.path.join(cfg.save, "log.log")) as fh:
        assert "## test error=" in fh.read()


@pytest.mark.parametrize("flag,want", [("2", (2,)), ("2,2", (2, 2)),
                                       (None, None)])
def test_mesh_shape_flag(flag, want):
    """--mesh_shape '2' and '2,2' become tuples of ints (qbn_tpu's
    experiments/run.py leaves them strings); without it, None."""
    argv = ["--method", "bbb", "--tier", "mnist"]
    if flag is not None:
        argv += ["--mesh_shape", flag]
    over = run._overrides(run.build_parser().parse_args(argv))
    assert over.get("mesh_shape") == want
    assert preset("bbb", "mnist", **over).mesh_shape == want


def test_runner_launches_the_mesh(monkeypatch, tmp_path):
    """With --mesh_shape the runner makes the run directory once and
    launches prod(mesh_shape) ranks of its rank body (recorded here, not
    started); without it, nothing is launched."""
    from qbn_tpu_torch.parallel import mesh as PM
    calls = []
    monkeypatch.setattr(PM, "launch", lambda fn, shape, *a, **k:
                        calls.append((fn, shape, a, k)))
    d = run.main(["--method", "bbb", "--tier", "mnist", "--mesh_shape",
                  "2,2", "--device", "cpu", "--save", str(tmp_path / "r")])
    (fn, shape, args, kw), = calls
    assert fn.__module__ == "qbn_tpu_torch.run" and fn.__name__ == "_rank"
    assert shape == (2, 2) and kw["device"].type == "cpu"
    assert args[0].save == d and args[0].mesh_shape == (2, 2)
    assert json.load(open(os.path.join(d, "config.json")))[
        "mesh_shape"] == [2, 2]


def test_failing_rank_fails_the_launch(tmp_path):
    """Rank 1 raises while rank 0 waits in a barrier: the launch raises
    rank 1's error well within the group's timeout."""
    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(R.failing, (2,), device="cpu",
               init_method=f"file://{tmp_path / 'store'}", timeout=60,
               deadline=120)
    assert time.monotonic() - t0 < 60
