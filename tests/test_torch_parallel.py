"""The port's mesh over a gloo process group of 2 ranks on the CPU
(qbn_tpu_torch.parallel): the mesh, data-parallel training against
qbn_tpu's sharded step, and the sample-sharded MC evaluation against the
port's one-process evaluation.

One launch serves the file: a module fixture computes qbn_tpu's side in
this process (its sharded train step on make_mesh(2) of conftest.py's
8-device CPU mesh, recording the normals and masks that qbn_tpu draws,
as tests/test_torch_resnet_train.py does), then starts the 2 ranks once
(tests/test_torch_parallel_ranks.py, which imports neither JAX nor
qbn_tpu) with every scenario's inputs, and each test reads its
scenario's result. The ranks see the recorded global draws through
QueueNoise and QueueMasks and keep their rows (RowNoise, RowMasks), as
the sharded step does with a generator.

Tolerances and why:
- the sharded step against qbn_tpu's sharded step: the tolerances of the
  one-process comparisons (tests/test_torch_lenet_train.py,
  test_torch_resnet_train.py): the loss 1e-5 relative (the LeNet's obj
  and KL 1e-4: its KL is a float32 sum of 1.2 M terms, XLA's 5.8e-5 off
  float64; the QAT step's 1e-4: fake-quant codes on the other side of
  a rounding edge between the two stacks, tests/
  test_torch_resnet_train.py::test_one_qat_step); the params after the
  first update (Adam's, of about lr * sign(g)) within 2 * lr and at most
  1e-3 of them beyond 1e-6 (a gradient at rounding level may take the
  other sign); batch norm's running statistics and the observers 1e-5
  relative (atol 1e-6);
- the sharded step against the port's one-process step on the same
  draws: the same math summed in another order: the loss 1e-6
  relative, every gradient leaf (Adam's first moment, or SGD's momentum
  trace, which is the gradient) within GRAD_RTOL = 1e-5 relative in
  norm (readings up to 3.4e-6), params as above, the running
  statistics and observers 1e-6 relative, and every rank's state
  bitwise the same;
- each gradient leaf against qbn_tpu's: no further from it than the
  port's one-process step is, plus GRAD_RTOL. At this init and batch
  the narrow BBB ResNet's one-process gradients of the two stacks
  already differ by up to 1.1% on some leaves (the NLL's alone, too;
  qbn_tpu's sharded, jitted and eager steps agree within 1e-5 among
  themselves): ReLU inputs sit within rounding of zero (2.7e-7 at the
  stem, 4.0e-6 at stage 3; at the init of tests/
  test_torch_resnet_train.py, where the stacks agree within 1e-5, none
  is nearer than 1.7e-5), and batch norm over B*H*W values spreads one
  flipped element's gradient to every channel's; a property of the
  float32 step, not of the sharding;
- the MC evaluation, one process against the sample-sharded: bitwise,
  seeded and with the draws given.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qbn_tpu.models.architectures import ResNet as JResNet
from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.models.layers import QuantConfig as JQuant
from qbn_tpu.parallel.mesh import make_mesh as j_make_mesh
from qbn_tpu.parallel.mesh import shard_batch as j_shard_batch
from qbn_tpu.parallel.sharded import make_sharded_train_step as j_sharded
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training import metrics as JM
from qbn_tpu.training.optim import build_optimizer as j_optimizer
from qbn_tpu.training.trainer import TrainState as JState
from qbn_tpu.utils import apply_model as j_apply
from qbn_tpu.utils import init_variables as j_init

from qbn_tpu_torch.parallel import launch

import test_torch_parallel_ranks as R

N_BATCHES = 2
LR_BOUND_SHARE = 1e-3
GRAD_RTOL = 1e-5
TRAIN = {                    # name: (method, arch, phase, global batch)
    "lenet-bbb": ("bbb", "lenet", "float", 8),
    "resnet-bbb": ("bbb", "resnet", "float", 4),
    "resnet-mcdropout": ("mcdropout", "resnet", "float", 4),
    "lenet-bbb-qat": ("bbb", "lenet", "qat", 8),
}
MC_CASES = ["bbb", "mcdropout", "pointwise", "sgld", "bbb-mlp",
            "bbb-float"]
GIVEN = {"bbb", "mcdropout", "bbb-float"}
SAMPLES = 4


class Recorder:
    """Stands in for jax.random.normal and jax.random.bernoulli: draws
    from a numpy generator, in call order, and keeps what it drew (masks
    as (1, *shape) float32)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.normals, self.masks = [], []

    def normal(self, key, shape=(), dtype=jnp.float32, *a, **k):
        arr = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        self.normals.append(arr)
        return jnp.asarray(arr, dtype)

    def bernoulli(self, key, p=0.5, shape=None, *a, **k):
        arr = self.rng.random(tuple(shape)) < float(p)
        self.masks.append(arr[None].astype(np.float32))
        return jnp.asarray(arr)


def _j_model(method, arch, phase):
    over = dict(tpu_fused=True, epochs=2)
    if arch == "lenet":
        cfg = j_preset(method, "mnist", phase, **over)
        return j_build(cfg), cfg, (28, 28, 1)
    cfg = j_preset(method, "cifar", phase, **over)
    model = JResNet(quant=JQuant(enabled=phase == "qat", tpu_fused=True),
                    widths=R.WIDTHS, stochastic=method == "bbb",
                    dropout_p=0.15 if method == "mcdropout" else 0.0,
                    sigma_prior=0.05)
    return model, cfg, (32, 32, 3)


def _j_step(name, monkeypatch, seed):
    """qbn_tpu's sharded train step on make_mesh(2), from its own init
    (for QAT, after one QAT forward with updates, so that the observers
    hold real ranges): the numpy start, the batch, the recorded draws and
    the stepped state."""
    method, arch, phase, b = TRAIN[name]
    jm, jcfg, hw = _j_model(method, arch, phase)
    rng = np.random.default_rng(seed)
    x = rng.random((b, *hw), dtype=np.float32)
    y = rng.integers(0, 10, b)
    jv = j_init(jm, jax.random.PRNGKey(seed), jnp.zeros((1, *hw)),
                quantized=phase == "qat")
    if phase == "qat":
        _o, _kl, jv = j_apply(jm, jv, jnp.asarray(x), jax.random.PRNGKey(4),
                              train=True, mode="qat", update_stats=True)
    v0 = jax.tree.map(np.asarray, jv)
    rec = Recorder(seed)
    monkeypatch.setattr(jax.random, "normal", rec.normal)
    monkeypatch.setattr(jax.random, "bernoulli", rec.bernoulli)
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    mesh = j_make_mesh(2)
    step = j_sharded(jm, jcfg, jtx, "qat" if phase == "qat" else "float",
                     N_BATCHES, N_BATCHES * b, mesh)
    jv = jax.tree.map(jnp.asarray, v0)
    params = jv.pop("params")
    j0 = JState(params=params, model_state=jv, opt_state=jtx.init(params),
                step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(1))
    xb, yb = j_shard_batch((jnp.asarray(x), jnp.asarray(y)), mesh)
    j1, jms, jlogs = step(j0, JM.cls_metrics_init(), xb, yb)
    monkeypatch.undo()
    return dict(variables=v0, x=x, y=y, normals=rec.normals,
                masks=rec.masks), dict(
        params=jax.tree.map(np.asarray, j1.params),
        model_state=jax.tree.map(np.asarray, j1.model_state),
        grads=_j_grads(j1.opt_state, phase),
        logs={k: float(v) for k, v in jlogs.items()}, lr=jcfg.learning_rate,
        metrics={k: np.asarray(v) for k, v in jms.items()})


def _j_grads(opt_state, phase):
    """The step's gradients from optax's state: SGD's momentum trace, or
    Adam's first moment ((1 - b1) times the gradient)."""
    for s in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda n: hasattr(n, "trace")
            or hasattr(n, "mu")):
        if phase == "qat" and hasattr(s, "trace"):
            return jax.tree.map(np.asarray, s.trace)
        if phase != "qat" and hasattr(s, "mu"):
            return jax.tree.map(np.asarray, s.mu)
    raise AssertionError("no gradient in the optimiser state")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """qbn_tpu's side, then the one launch of every scenario."""
    mp = pytest.MonkeyPatch()
    scen, jax_side = {}, {}
    for i, name in enumerate(TRAIN):
        method, arch, phase, _b = TRAIN[name]
        inputs, jax_side[name] = _j_step(name, mp, 10 + i)
        scen[name] = ("train_step", dict(
            method=method, arch=arch, phase=phase, n_batches=N_BATCHES,
            n_points=N_BATCHES * len(inputs["y"]), **inputs))
    mp.undo()
    lenet = scen["lenet-bbb"][1]
    x, y = lenet["x"], lenet["y"]
    x_nan = x.copy()
    x_nan[-1, 3, 3, 0] = np.nan            # in rank 1's rows
    scen["mesh"] = ("mesh_info", {})
    scen["partial"] = ("partial_batch", dict(
        variables=lenet["variables"], x=x[:5], y=y[:5]))
    scen["nonfinite"] = ("nonfinite", dict(
        variables=lenet["variables"], x=x_nan, y=y,
        normals=lenet["normals"]))
    qat = scen["lenet-bbb-qat"][1]
    scen["eval_step"] = ("eval_step", dict(
        variables=_mcdropout_qat_vars(), x=qat["x"], y=qat["y"]))
    scen["writes"] = ("writes", dict(
        save_dir=str(tmp_path_factory.mktemp("writes")), x=x, y=y))
    rng = np.random.default_rng(3)
    for case in MC_CASES:
        if case == "bbb-mlp":
            xx = rng.standard_normal((8, 1)).astype(np.float32)
            yy = (2 * xx + 8).astype(np.float32)
        else:
            xx, yy = x, y
        scen["mc-" + case] = ("mc_eval", dict(
            case=case, samples=8 if case == "bbb-float" else SAMPLES,
            x=xx, y=yy, given_seed=4 if case in GIVEN else None))
    store = tmp_path_factory.mktemp("store") / "store"
    out = launch(R.run_scenarios, (2,), scen, device="cpu",
                 init_method=f"file://{store}", timeout=120, deadline=600)
    return out, jax_side


def _mcdropout_qat_vars():
    """The port's quantised init of the MC-Dropout LeNet, as numpy."""
    from qbn_tpu_torch.convert import to_numpy_state
    from qbn_tpu_torch.utils import init_variables
    model, _cfg = R._model("mcdropout", "lenet", "qat")
    return to_numpy_state(init_variables(
        model, torch.Generator().manual_seed(2), (28, 28, 1), "cpu",
        quantized=True))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


def _close_params(got, want, lr, tol=1e-6):
    """Every entry within 2 * lr, at most LR_BOUND_SHARE beyond tol."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    d = np.concatenate([np.abs(g[p] - w[p]).ravel() for p in g])
    beyond = int((d > tol).sum())
    assert d.max() <= 2 * lr and beyond <= LR_BOUND_SHARE * d.size, (
        d.max(), beyond, d.size)
    return d.max(), beyond


def _close_tree(got, want, rtol=1e-5, atol=1e-6):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys() and g
    for p in g:
        np.testing.assert_allclose(g[p], w[p], rtol=rtol, atol=atol,
                                   err_msg=str(p))


def test_mesh_and_shard_batch(run):
    out = run[0]["mesh"]
    assert out["shape"] == (2,) and out["axis_names"] == ("data",)
    assert out["size"] == 2 and out["backend"] == "gloo"
    r0, r1 = out["ranks"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["index"] == {"data": 0} and r1["index"] == {"data": 1}
    assert r0["groups"] == r1["groups"] == {"data": [0, 1]}
    assert r0["rows"] == [0, 1, 2, 3] and r1["rows"] == [4, 5, 6, 7]
    assert r1["pair"] == [[4, 5, 6, 7], [8, 10, 12, 14]]
    assert r0["device"] == r1["device"] == "cpu"


@pytest.mark.parametrize("what", ["none", "from_config", "too_many",
                                  "other"])
def test_mesh_from_config(run, what):
    """None for mesh_shape None; the configured mesh at world 2; a
    ValueError, with qbn_tpu's message, for a shape whose product differs
    from the world size."""
    got = run[0]["mesh"][what]
    if what == "none":
        assert got is True
    elif what == "from_config":
        assert got == ((2,), ("data",))
    elif what == "too_many":
        assert got == "ValueError: mesh_shape (4,) needs 4 devices, have 2"
    else:
        assert got == ("ValueError: mesh_shape (2, 2) needs 4 devices, "
                       "have 2")


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_sharded_train_step_matches_qbn_tpu(run, name):
    """The port's sharded step against qbn_tpu's sharded step, and
    against the port's one-process step on the same draws."""
    out, jside = run[0][name], run[1][name]
    phase = TRAIN[name][2]
    t, s, j = out["sharded"], out["single"], jside
    assert out["rows"] == TRAIN[name][3] // 2
    assert out["digests"][0] == out["digests"][1]
    lr = j["lr"]
    loss_rtol = 1e-4 if (name == "lenet-bbb" or phase == "qat") else 1e-5
    for k in ("obj", "main_obj", "kl"):
        rtol = 1e-5 if k == "main_obj" and phase != "qat" else loss_rtol
        assert abs(t["logs"][k] - j["logs"][k]) <= rtol * abs(
            j["logs"][k]) + 1e-12, (k, t["logs"][k], j["logs"][k])
        assert abs(t["logs"][k] - s["logs"][k]) <= 1e-6 * abs(
            s["logs"][k]) + 1e-12, (k, t["logs"][k], s["logs"][k])
    # every gradient leaf (all-reduced), relative in norm
    key = "trace" if phase == "qat" else "mu"
    tg = dict(_leaves(t["opt_state"][key]))
    sg = dict(_leaves(s["opt_state"][key]))
    jg = dict(_leaves(j["grads"]))
    assert tg.keys() == jg.keys() == sg.keys()
    for p in jg:
        norm = np.linalg.norm(jg[p].astype(np.float64))
        to_single = np.linalg.norm(tg[p].astype(np.float64) - sg[p])
        to_j = np.linalg.norm(tg[p].astype(np.float64) - jg[p])
        single_to_j = np.linalg.norm(sg[p].astype(np.float64) - jg[p])
        assert to_single <= GRAD_RTOL * norm + 1e-12, (p, to_single, norm)
        assert to_j <= single_to_j + GRAD_RTOL * norm + 1e-12, (
            p, to_j, single_to_j, norm)
    d_j = _close_params(t["params"], j["params"], lr)
    d_s = _close_params(t["params"], s["params"], lr)
    print(f"{name}: params max |diff| vs qbn_tpu {d_j[0]:.3g} "
          f"({d_j[1]} beyond 1e-6), vs one process {d_s[0]:.3g} "
          f"({d_s[1]} beyond 1e-6)")
    ts = {k: v for k, v in t["model_state"].items()
          if k in ("batch_stats", "quant")}
    js = {k: v for k, v in j["model_state"].items() if k in ts}
    ss = {k: v for k, v in s["model_state"].items() if k in ts}
    if name.startswith("resnet"):
        assert "batch_stats" in ts
    if phase == "qat":
        assert "quant" in ts
    if ts:
        _close_tree(ts, js)
        _close_tree(ts, ss, rtol=1e-6)
    for k in ("errors", "count", "nll_sum"):
        np.testing.assert_allclose(t["metrics"][k], j["metrics"][k],
                                   rtol=1e-5)


def test_partial_batch_falls_back(run):
    """5 rows on 2 ranks: the Trainer runs the one-process step on every
    rank, bitwise the mesh-less Trainer's."""
    out = run[0]["partial"]
    assert out["mesh"]["sharded"] is False and out["mesh"]["rows"] == 5
    assert out["mesh"]["digest"] == out["single"]["digest"]
    assert out["mesh"]["metrics"] == out["single"]["metrics"]


def test_nonfinite_rows_skip_every_rank(run):
    """A NaN pixel in rank 1's rows only: the global loss is NaN on both
    ranks, and both keep their params and optimiser state."""
    r0, r1 = run[0]["nonfinite"]
    assert not r0["nan_in_rows"] and r1["nan_in_rows"]
    assert np.isnan(r0["obj"]) and np.isnan(r1["obj"])
    assert r0["kept"] and r1["kept"]


def test_sharded_validation_step(run):
    """The QAT MC-Dropout LeNet's validation step (observers updated):
    the observers are the global batch's extrema, bitwise; the metrics
    those of the one-process step."""
    out = run[0]["eval_step"]
    s, t = out["single"], out["sharded"]
    for (p, a), (_q, b) in zip(_leaves(t["quant"]), _leaves(s["quant"])):
        np.testing.assert_array_equal(a, b, err_msg=str(p))
    for k in s["metrics"]:
        np.testing.assert_allclose(t["metrics"][k], s["metrics"][k],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert float(s["metrics"]["count"]) == 8


def test_rank_zero_writes(run):
    """flows.fit on a mesh: rank 0 writes the checkpoint (and the config
    and scalars); rank 1 nothing."""
    out = run[0]["writes"]
    assert out["calls"] == [["weights.msgpack"], []]
    assert out["files"] == ["config.json", "scalars.jsonl",
                            "weights.msgpack"]


@pytest.mark.parametrize("case", MC_CASES)
def test_sample_sharded_mc_eval_is_bitwise(run, case):
    """Each rank evaluates its share of the samples; the gathered,
    aggregated result is the one-process evaluation's, bitwise."""
    out = run[0]["mc-" + case]
    assert out["share"] == [0, 1]
    a, b = out["single"], out["sharded"]
    assert a["metrics"].keys() == b["metrics"].keys()
    for k in a["metrics"]:
        np.testing.assert_array_equal(b["metrics"][k], a["metrics"][k],
                                      err_msg=k)
    for p, q in zip(a["outs"], b["outs"]):
        np.testing.assert_array_equal(np.asarray(q), np.asarray(p))
    assert float(a["metrics"]["count"]) == 8


@pytest.mark.parametrize("case", sorted(GIVEN))
def test_sample_sharded_mc_eval_given_draws(run, case):
    """With the draws given for all samples (presampled codes, masks,
    noise), the sharded per-sample outputs are the one-process ones."""
    out = run[0]["mc-" + case]
    n = 8 if case == "bbb-float" else SAMPLES
    assert out["given_single"].shape[0] == n
    np.testing.assert_array_equal(out["given_sharded"],
                                  out["given_single"])


def test_sharded_mc_eval_over_sample_axis(run):
    """qbn_tpu's test_sharded_mc_eval_over_sample_axis: the float BBB
    LeNet, 8 samples over the mesh, B=8: a finite NLL, (8, 10)
    probabilities summing to 1."""
    step = run[0]["mc-bbb-float"]["step"]
    assert np.isfinite(step["metrics"]["nll"])
    assert step["agg"].shape == (8, 10)
    np.testing.assert_allclose(step["agg"].sum(-1), 1.0, rtol=1e-5)
