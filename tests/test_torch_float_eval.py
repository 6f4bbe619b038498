"""Float Monte-Carlo evaluation (`mc_predict(mode="float")` and
`evaluate(mode="float")`) of the four methods: the port against
qbn_tpu's `mc_predict(mode="float")`, on the CPU, for the regression MLP
(13 features) and the LeNet (28x28x1), B=4, from qbn_tpu's float inits
carried across (an SGHMC ensemble: MEMBERS inits stacked on a member
axis).

The draws are fixed on both sides: the test replaces `jax.random.normal`
and `jax.random.bernoulli` (which qbn_tpu's weight sample and dropout
masks call) with functions that hand out a table made with numpy, one
entry per call site and sample, and gives the port the same table,
sample by sample, through QueueNoise and QueueMasks; the sample a draw
goes to is found from the key qbn_tpu's `mc_predict` gives that sample
(its `_one_sample` is wrapped for this). qbn_tpu's own `mc_predict` runs:
its vmap over keys or members. For `evaluate`, the port's sources are
those queues too (the module's GeneratorNoise and BernoulliMasks are
replaced), and qbn_tpu's side is its `aggregate` and metric update of
its `mc_predict`.

Tolerances: outputs (probabilities, or mu and var) 1e-5 relative (atol
1e-6): float32 products and softmax summed in another order; the
aggregated predictive and the metric state 1e-5 relative.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbn_tpu.evaluation.mc as JMC
from qbn_tpu.evaluation.ensemble import stack_variables as j_stack
from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training import metrics as JM
from qbn_tpu.utils import init_variables as j_init
from qbn_tpu.utils import split_rngs

import qbn_tpu_torch.evaluation.mc as TMC
from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.evaluation import ensemble as TE
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import QueueMasks, QueueNoise
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training.trainer import metrics_compute

B, S, MEMBERS = 4, 3, 3
METHODS = ["pointwise", "mcdropout", "bbb", "sgld"]
TIERS = {"regression": (13,), "mnist": (28, 28, 1)}


@contextlib.contextmanager
def fixed_draws(monkeypatch, keys, seed):
    """Within: qbn_tpu's normals and masks come from `table` (one (S,
    *shape) array per call site, made on first use, in call order), each
    sample taking its row. Yields the table: [(kind, array)]."""
    rng = np.random.default_rng(seed)
    table, state = [], {}
    keys = jnp.asarray(keys)

    def entry(kind, make):
        i = state["calls"]
        state["calls"] += 1
        if i == len(table):
            table.append((kind, make()))
        assert table[i][0] == kind
        return jnp.asarray(table[i][1])[state["idx"]]

    def normal(_key, shape=(), dtype=jnp.float32, *a, **k):
        return entry("normal", lambda: rng.standard_normal(
            (len(keys),) + tuple(shape)).astype(np.float32))

    def bernoulli(_key, p=0.5, shape=None, *a, **k):
        return entry("mask", lambda: rng.random(
            (len(keys),) + tuple(shape)) < float(p))

    def one_sample(model, mode, variables, x, key):
        state["idx"] = jnp.argmax(jnp.all(key[None] == keys, axis=-1))
        state["calls"] = 0
        out, _ = model.apply(variables, x, train=False, mode=mode,
                             update_stats=False, rngs=split_rngs(key),
                             mutable=["kl"])
        return out

    monkeypatch.setattr(jax.random, "normal", normal)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(JMC, "_one_sample", one_sample)
    yield table


def port_sources(table, samples):
    """The table as the port draws it: sample by sample, each sample's
    sites in call order."""
    normals, masks = [], []
    for s in range(samples):
        for kind, arr in table:
            if kind == "normal":
                normals.append(arr[s])
            else:
                masks.append(arr[s][None].astype(np.float32))
    return QueueNoise(normals), QueueMasks(masks)


def _setup(tier, method, seed=0):
    jcfg = j_preset(method, tier, input_size=TIERS[tier])
    cfg = preset(method, tier, input_size=TIERS[tier])
    jm, tm = j_build(jcfg), build_model(cfg)
    x0 = jnp.zeros((1,) + TIERS[tier])
    if method == "sgld":
        members = [jax.tree.map(np.asarray, j_init(
            jm, jax.random.PRNGKey(seed + i), x0)) for i in range(MEMBERS)]
        jstate = j_stack(members)
        tstate = TE.stack_variables([from_jax_state(m) for m in members])
        samples = MEMBERS
    else:
        jstate = jax.tree.map(np.asarray, j_init(jm, jax.random.PRNGKey(seed),
                                                 x0))
        tstate, samples = from_jax_state(jstate), S
    rng = np.random.default_rng(seed + 7)
    x = rng.random((B,) + TIERS[tier], dtype=np.float32)
    y = (rng.standard_normal((B, 1)).astype(np.float32) if tier ==
         "regression" else rng.integers(0, 10, B))
    return jm, tm, jstate, tstate, samples, x, y


def j_predict(jm, jstate, x, samples, monkeypatch, ensemble):
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, samples)
    with fixed_draws(monkeypatch, keys, 3) as table:
        out = JMC.mc_predict(jm, jax.tree.map(jnp.asarray, jstate),
                             jnp.asarray(x), key, samples=samples,
                             mode="float", ensemble=ensemble)
    return out, table


def _assert_outs(t, j, what):
    t = t if isinstance(t, tuple) else (t,)
    j = j if isinstance(j, tuple) else (j,)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert tuple(a.shape) == tuple(np.shape(b)), what
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6, err_msg=what)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_mc_predict_float_matches(monkeypatch, tier, method):
    jm, tm, jstate, tstate, samples, x, _y = _setup(tier, method)
    ensemble = method == "sgld"
    jout, table = j_predict(jm, jstate, x, samples, monkeypatch, ensemble)
    want_sites = {"pointwise": 0, "sgld": 0,
                  "mcdropout": 4 if tier == "regression" else 3,
                  "bbb": 5 if tier == "regression" else 4}[method]
    assert len(table) == want_sites
    noise, masks = port_sources(table, samples)
    with torch.no_grad():
        tout = TMC.mc_predict(tm, tstate, torch.from_numpy(x),
                              samples=samples, mode="float",
                              ensemble=ensemble, noise=noise, masks=masks)
    assert not noise.queue and not masks.queue
    _assert_outs(tout, jout, f"{tier} {method}")


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_evaluate_float_matches(monkeypatch, tier, method):
    jm, tm, jstate, tstate, samples, x, y = _setup(tier, method, seed=5)
    jout, table = j_predict(jm, jstate, x, samples, monkeypatch,
                            method == "sgld")
    task = "regression" if tier == "regression" else "classification"
    jagg = JMC.aggregate(task, jout, samples)
    if task == "regression":
        jms = JM.reg_metrics_compute(JM.reg_metrics_update(
            JM.reg_metrics_init(), *jagg, jnp.asarray(y)))
    else:
        jms = JM.cls_metrics_compute(JM.cls_metrics_update(
            JM.cls_metrics_init(), jagg, jnp.asarray(y)))
    noise, masks = port_sources(table, samples)
    monkeypatch.setattr(TMC, "GeneratorNoise", lambda _g: noise)
    monkeypatch.setattr(TMC, "BernoulliMasks", lambda _g, _s: masks)
    tms, touts, secs = TMC.evaluate(tm, tstate, [(x, y)], samples,
                                    device="cpu", mode="float")
    assert not noise.queue and not masks.queue and len(secs) == 1
    _assert_outs(touts[0], jagg, f"{tier} {method} predictive")
    got = metrics_compute(task, tms)
    assert got.keys() == jms.keys()
    for k in jms:
        np.testing.assert_allclose(float(got[k]), float(jms[k]), rtol=1e-5,
                                   err_msg=k)


def test_float_evaluate_defaults_to_the_card():
    """evaluate keeps its INT default and its device default."""
    import inspect
    sig = inspect.signature(TMC.evaluate).parameters
    assert sig["mode"].default == "int" and sig["device"].default == "cuda"
