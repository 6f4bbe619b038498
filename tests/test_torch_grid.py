"""The port's experiment grid (qbn_tpu_torch.sweep) and seed averaging
(qbn_tpu_torch.average_results) against qbn_tpu's experiments/sweep.py and
average_results.py: the grid's cases of tests/test_sweep_driver.py with
the runs monkeypatched out, the same run invocations as qbn_tpu's driver
makes, the same aggregates of the same results trees (NaN and string
leaves included), and one real float grid of two seeds on the CPU."""

import json
import math
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from experiments import average_results as j_average  # noqa: E402
from experiments import sweep as j_sweep  # noqa: E402

from qbn_tpu_torch import average_results, cli, sweep  # noqa: E402


def _record(monkeypatch, module):
    calls, averaged = [], []
    monkeypatch.setattr(module, "run_main", lambda argv: calls.append(argv))
    monkeypatch.setattr(module.average_results, "main",
                        lambda argv: averaged.append(argv))
    return calls, averaged


def test_quant_grid_cells(monkeypatch, tmp_path):
    calls, averaged = _record(monkeypatch, sweep)
    sweep.main(["quant", "--methods", "bbb", "--tiers", "cifar",
                "--load", "floatdir-{seed}", "--seeds", "1",
                "--out", str(tmp_path)])
    # w in {8..3} at a=7, then a in {6..3} at w=8 - 10 cells x 1 seed
    assert len(calls) == 10
    pairs = []
    for argv in calls:
        a = argv[argv.index("--activation_precision") + 1]
        w = argv[argv.index("--weight_precision") + 1]
        pairs.append((int(a), int(w)))
        assert argv[argv.index("--load") + 1] == "floatdir-1"
    assert pairs == [(7, 8), (7, 7), (7, 6), (7, 5), (7, 4), (7, 3),
                     (6, 8), (5, 8), (4, 8), (3, 8)]
    assert len(averaged) == 10  # one aggregation per cell


def test_quant_grid_seeds_cells_and_default_load(monkeypatch, tmp_path):
    calls, averaged = _record(monkeypatch, sweep)
    sweep.main(["quant", "--methods", "bbb", "--tiers", "mnist",
                "--seeds", "1", "2", "--cells", "a_7_w_8", "a_7_w_4",
                "--out", str(tmp_path)])
    assert len(calls) == 4  # 2 cells x 2 seeds
    loads = [argv[argv.index("--load") + 1] for argv in calls]
    assert loads[0].endswith("bbb-mnist-seed1")
    assert loads[1].endswith("bbb-mnist-seed2")
    seeds = [argv[argv.index("--seed") + 1] for argv in calls]
    assert seeds == ["1", "2", "1", "2"]
    assert len(averaged) == 2


def test_float_grid_seeds_and_average(monkeypatch, tmp_path):
    calls, averaged = _record(monkeypatch, sweep)
    sweep.main(["float", "--methods", "pointwise", "--tiers", "mnist",
                "--seeds", "1", "2", "3", "--out", str(tmp_path)])
    assert len(calls) == 3
    seeds = [argv[argv.index("--seed") + 1] for argv in calls]
    assert seeds == ["1", "2", "3"]
    assert len(averaged) == 1 and "--save" in averaged[0]


@pytest.mark.parametrize("argv", [
    ["float", "--methods", "pointwise", "bbb", "--tiers", "regression",
     "mnist", "--seeds", "1", "2"],
    ["quant", "--methods", "sgld", "--tiers", "cifar", "--seeds", "3",
     "--load", "f/{seed}"],
    ["quant", "--methods", "mcdropout", "--tiers", "regression",
     "--seeds", "1", "2", "--cells", "a_5_w_8", "--extra", "--debug",
     "--epochs", "1"],
], ids=["float", "quant-load", "quant-cells-extra"])
def test_same_runs_and_averages_as_qbn_tpu(monkeypatch, tmp_path, argv):
    """The port's driver makes qbn_tpu's run invocations and averages, in
    the same order, argument for argument."""
    want = _record(monkeypatch, j_sweep)
    got = _record(monkeypatch, sweep)
    out = ["--out", str(tmp_path)]
    extra = argv.index("--extra") if "--extra" in argv else len(argv)
    full = argv[:extra] + out + argv[extra:]
    j_sweep.main(full)
    sweep.main(full)
    assert got == want and got[0]


def test_done_cells_are_skipped_and_partial_ones_cleared(monkeypatch,
                                                         tmp_path):
    calls, _averaged = _record(monkeypatch, sweep)
    done = tmp_path / "pointwise-mnist-seed1"
    done.mkdir()
    (done / "DONE").write_text("ok\n")
    partial = tmp_path / "pointwise-mnist-seed2"
    partial.mkdir()
    (partial / "results.json").write_text("{}")
    sweep.main(["float", "--methods", "pointwise", "--tiers", "mnist",
                "--seeds", "1", "2", "--out", str(tmp_path)])
    assert [a[a.index("--seed") + 1] for a in calls] == ["2"]
    assert done.exists() and not partial.exists()


def test_transient_failure_retries_once(monkeypatch, tmp_path):
    """A relay/device transient clears the half-written dir and retries;
    the retry succeeds."""
    calls = []

    def flaky(argv):
        calls.append(list(argv))
        if len(calls) == 1:
            os.makedirs(argv[argv.index("--save") + 1])
            raise RuntimeError("UNAVAILABLE: the worker restarted")

    monkeypatch.setattr(sweep, "run_main", flaky)
    monkeypatch.setattr(sweep.time, "sleep", lambda s: None)
    monkeypatch.setattr(sweep.average_results, "main", lambda argv: None)
    sweep.main(["float", "--methods", "bbb", "--tiers", "mnist",
                "--seeds", "1", "--out", str(tmp_path)])
    assert len(calls) == 2
    assert not (tmp_path / "bbb-mnist-seed1").exists()


def test_non_transient_failure_raises_immediately(monkeypatch, tmp_path):
    calls = []

    def broken(argv):
        calls.append(argv)
        raise ValueError("bad config")

    monkeypatch.setattr(sweep, "run_main", broken)
    monkeypatch.setattr(sweep.average_results, "main", lambda argv: None)
    with pytest.raises(ValueError):
        sweep.main(["float", "--methods", "bbb", "--tiers", "mnist",
                    "--seeds", "1", "--out", str(tmp_path)])
    assert len(calls) == 1


def test_transient_failure_reraises_on_final_attempt(monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(sweep, "run_main", lambda argv: (_ for _ in ()
                        ).throw(RuntimeError("UNAVAILABLE: worker")))
    monkeypatch.setattr(sweep.time, "sleep", lambda s: None)
    monkeypatch.setattr(sweep.average_results, "main", lambda argv: None)
    with pytest.raises(RuntimeError):
        sweep.main(["float", "--methods", "bbb", "--tiers", "mnist",
                    "--seeds", "1", "--out", str(tmp_path)])


def test_transient_markers_are_qbn_tpus():
    assert sweep.TRANSIENT == j_sweep.TRANSIENT
    assert sweep.WEIGHT_SWEEP == j_sweep.WEIGHT_SWEEP
    assert sweep.ACTIVATION_SWEEP == j_sweep.ACTIVATION_SWEEP


def _trees(rng):
    """Three seed runs' results trees: nested metrics, a NaN, a leaf only
    some runs have, string labels, ints."""
    trees = []
    for i in range(3):
        trees.append({
            "dataset": "cifar", "model": "conv_resnet_bbb",
            "error": {"test": float(rng.random()),
                      "rotation": {str(l): float(rng.random())
                                   for l in range(5)}},
            "nll": {"test": float("nan") if i == 1 else float(rng.random())},
            "latency": {"test": int(rng.integers(1, 100))},
            "model_size": 15.773,
        })
    trees[2]["error"]["valid"] = 0.25
    return trees


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_aggregate_equals_qbn_tpus(seed):
    trees = _trees(np.random.default_rng(seed))
    got = average_results.aggregate(trees)
    want = j_average.aggregate(trees)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["dataset"] == "cifar"
    nll = [t["nll"]["test"] for t in trees]
    assert got["nll"]["test"] == [float(np.nanmean(nll)),
                                  float(np.nanstd(nll))]


def test_average_main_writes_the_summary(tmp_path):
    trees = _trees(np.random.default_rng(7))
    dirs = []
    for i, t in enumerate(trees):
        d = tmp_path / f"run{i}"
        d.mkdir()
        (d / "results.json").write_text(json.dumps(t))
        dirs.append(str(d))
    average_results.main(dirs + ["--save", str(tmp_path / "ours")])
    j_average.main(dirs + ["--save", str(tmp_path / "theirs")])
    ours = json.loads((tmp_path / "ours" / "results.json").read_text())
    theirs = json.loads((tmp_path / "theirs" / "results.json").read_text())
    assert ours["n_runs"] == 3
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)


def test_cli_entry_points(monkeypatch):
    seen = []
    import qbn_tpu_torch.run as run_mod
    monkeypatch.setattr(run_mod, "main", lambda argv: seen.append(("run",
                                                                   argv)))
    monkeypatch.setattr(sweep, "main", lambda argv: seen.append(("sweep",
                                                                 argv)))
    cli.run_main(["--method", "bbb"])
    cli.sweep_main(["float"])
    assert seen == [("run", ["--method", "bbb"]), ("sweep", ["float"])]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_a_real_float_grid_of_two_seeds(tmp_path):
    """The pointwise regression tier through `qbn_tpu_torch.run` on the
    CPU (--debug, 1 epoch), two seeds: each -avg leaf is numpy's nanmean
    and nanstd over the two runs' results.json; a rerun skips both."""
    argv = ["float", "--methods", "pointwise", "--tiers", "regression",
            "--seeds", "1", "2", "--out", str(tmp_path), "--extra",
            "--device", "cpu", "--debug", "--epochs", "1"]
    sweep.main(argv)
    runs = [json.loads((tmp_path / f"pointwise-regression-seed{s}"
                        / "results.json").read_text()) for s in (1, 2)]
    avg = json.loads((tmp_path / "pointwise-regression-avg"
                      / "results.json").read_text())
    assert avg["n_runs"] == 2
    n = 0
    for path, v in _leaves(runs[0]):
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            vals = [v]
            node = runs[1]
            for k in path:
                node = node[k]
            vals.append(node)
            got = avg
            for k in path:
                got = got[k]
            want = [float(np.nanmean(vals)), float(np.nanstd(vals))]
            assert all((math.isnan(a) and math.isnan(b)) or a == b
                       for a, b in zip(got, want)), path
            n += 1
    assert n > 5
    stamp = os.path.getmtime(tmp_path / "pointwise-regression-seed1"
                             / "results.json")
    sweep.main(argv)
    assert os.path.getmtime(tmp_path / "pointwise-regression-seed1"
                            / "results.json") == stamp
