"""The port's (data, sample) mesh of shape (2, 2) over a gloo group of 4
ranks on the CPU, in one launch (tests/test_torch_parallel_ranks.py):
rank r at (r // 2, r % 2), one group per axis; the train step sharded
over 'data' (the ranks along 'sample' compute the same rows) against the
one-process step; the MC evaluation sharded over 'sample' (the last
axis) against the one-process evaluation, bitwise. Tolerances as in
tests/test_torch_parallel.py (the sharded step against the one-process
step on the same draws)."""

import numpy as np
import pytest
import torch

from qbn_tpu_torch.convert import to_numpy_state
from qbn_tpu_torch.parallel import launch
from qbn_tpu_torch.utils import init_variables

import test_torch_parallel_ranks as R

B = 8


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(21)
    x = rng.random((B, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, B)
    model, _cfg = R._model("bbb", "lenet", "float")
    v = to_numpy_state(init_variables(
        model, torch.Generator().manual_seed(21), (28, 28, 1), "cpu"))
    normals = [rng.standard_normal(s).astype(np.float32) for s in
               [(B, 28, 28, 20), (B, 14, 14, 50), (B, 500), (B, 10)]]
    xr = rng.standard_normal((B, 1)).astype(np.float32)
    scen = {
        "mesh": ("mesh_info", {}),
        "train": ("train_step", dict(
            method="bbb", arch="lenet", phase="float", variables=v, x=x,
            y=y, normals=normals, masks=[], n_batches=2, n_points=2 * B)),
        "mc-mcdropout": ("mc_eval", dict(case="mcdropout", samples=4, x=x,
                                         y=y, given_seed=5)),
        "mc-bbb-mlp": ("mc_eval", dict(case="bbb-mlp", samples=4, x=xr,
                                       y=2 * xr + 8)),
    }
    store = tmp_path_factory.mktemp("store4") / "store"
    return launch(R.run_scenarios, (2, 2), scen, device="cpu",
                  init_method=f"file://{store}", timeout=120, deadline=600)


def test_mesh_layout(run):
    out = run["mesh"]
    assert out["shape"] == (2, 2) and out["axis_names"] == ("data",
                                                             "sample")
    assert out["size"] == 4
    for r, info in enumerate(out["ranks"]):
        assert info["index"] == {"data": r // 2, "sample": r % 2}
        assert info["groups"]["data"] == [r % 2, r % 2 + 2]
        assert info["groups"]["sample"] == [r // 2 * 2, r // 2 * 2 + 1]
        # shard_batch splits along 'data': ranks along 'sample' share rows
        assert info["rows"] == list(range(4 * (r // 2), 4 * (r // 2) + 4))
    assert out["from_config"] == ((2, 2), ("data", "sample"))
    assert out["too_many"] == ("ValueError: mesh_shape (8,) needs 8 "
                               "devices, have 4")


def test_train_step_over_the_data_axis(run):
    out = run["train"]
    t, s = out["sharded"], out["single"]
    assert out["rows"] == B // 2
    assert len(set(out["digests"])) == 1       # replicated on all 4 ranks
    for k in ("obj", "main_obj", "kl"):
        assert abs(t["logs"][k] - s["logs"][k]) <= 1e-6 * abs(s["logs"][k])
    for (p, a), (_q, b) in zip(_leaves(t["opt_state"]["mu"]),
                               _leaves(s["opt_state"]["mu"])):
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), p
    for k in ("errors", "count", "nll_sum"):
        np.testing.assert_allclose(t["metrics"][k], s["metrics"][k],
                                   rtol=1e-6)


@pytest.mark.parametrize("case", ["mcdropout", "bbb-mlp"])
def test_mc_eval_over_the_sample_axis(run, case):
    out = run["mc-" + case]
    assert out["share"] == [0, 1, 0, 1]
    a, b = out["single"], out["sharded"]
    for k in a["metrics"]:
        np.testing.assert_array_equal(b["metrics"][k], a["metrics"][k])
    if "given_single" in out:
        np.testing.assert_array_equal(out["given_sharded"],
                                      out["given_single"])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree, np.float64)
