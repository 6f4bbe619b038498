"""INT MC evaluation of the regression MLP (in -> 100 -> 100 -> 100 ->
{mu, log_var}, B=16, 5 features) for MC-Dropout, pointwise and an SGHMC
ensemble: the port's against qbn_tpu's on the CPU, both built by their
`build_model`, with the dropout masks fixed on both sides and every
module's output captured as in tests/test_torch_int_methods.py (whose
helpers this file uses); then the regression predictive (`aggregate`:
E[mu], Var[mu] with ddof=1 + E[var]) and metric state.

Tolerances: int8 codes at every module bitwise; mu and var (a float32
exp) within 1e-6 absolute; the predictive and the metric state (float32
means, variances and logs whose summation orders differ) within 1e-6
relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbn_tpu.evaluation.mc as JMC
from qbn_tpu.config import Config as JConfig
from qbn_tpu.evaluation.ensemble import stack_variables as j_stack
from qbn_tpu.models.factory import build_model as j_build_model
from qbn_tpu.training import metrics as JM

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.evaluation import ensemble as TE
from qbn_tpu_torch.evaluation.mc import aggregate, evaluate
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.training import metrics as TM

from test_torch_int_methods import (assert_close, assert_layers_equal,
                                    convert, j_run, t_run)

B, F, S, MEMBERS, P = 16, 5, 6, 3, 0.2


def _models(model):
    jm = j_build_model(JConfig(model=model, at=True, q=True, p=P,
                               task="regression", input_size=(F,)))
    tm = build_model(Config(model=model, q=True, p=P, task="regression",
                            input_size=(F,)))
    return jm, tm


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (B, F)).astype(np.float32)
    y = (x @ rng.normal(0, 1, F) + rng.normal(0, 0.3, B)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        jm, tm = _models("linear_mc")
        st = convert(jm, jnp.asarray(x), jax.random.PRNGKey(0))
        jo, jl, masks = j_run(jm, st, x, S, mp)
        out["mcdropout"] = (jo, jl) + t_run(tm, from_jax_state(st), x, S,
                                            masks) + (S, tm, st)
        jm, tm = _models("linear")
        members = [convert(jm, jnp.asarray(x), jax.random.PRNGKey(5 + i))
                   for i in range(MEMBERS)]
        jo, jl, _ = j_run(jm, members[0], x, 1, mp)
        out["pointwise"] = (jo, jl) + t_run(
            tm, from_jax_state(members[0]), x, 1) + (1, tm, members[0])
        jm, tm = _models("linear_sgld")
        jo, jl, _ = j_run(jm, j_stack(members), x, MEMBERS, mp,
                          ensemble=True)
        state = TE.stack_variables([from_jax_state(m) for m in members])
        out["sgld"] = (jo, jl) + t_run(tm, state, x, MEMBERS,
                                       ensemble=True) + (MEMBERS, tm, state)
    finally:
        mp.undo()
    out["xy"] = (x, y)
    return out


METHODS = ["mcdropout", "pointwise", "sgld"]


def _rel(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=0, err_msg=what)


@pytest.mark.parametrize("method", METHODS)
def test_mlp_codes_bitwise_at_every_module(runs, method):
    jo, jl, to, tl, samples, _tm, _st = runs[method]
    # input quant, three hidden layers, two heads (and four dropout sites)
    assert_layers_equal(jl, tl, samples, 10 if method == "mcdropout" else 6)


@pytest.mark.parametrize("method", METHODS)
def test_mlp_mean_and_variance(runs, method):
    jo, _jl, to, _tl, samples, _tm, _st = runs[method]
    assert isinstance(to, tuple) and to[0].shape == (samples, B, 1)
    assert_close(to, jo)


@pytest.mark.parametrize("method", METHODS)
def test_mlp_regression_predictive_and_metrics(runs, method):
    """aggregate's regression branch (ddof=1 over the samples, the variance
    term dropped at one sample) and the regression metric state, against
    qbn_tpu's, within 1e-6 relative."""
    jo, _jl, to, _tl, samples, _tm, _st = runs[method]
    x, y = runs["xy"]
    mean, var = aggregate(to, "regression")
    jmean, jvar = JMC.aggregate("regression", jo, samples)
    _rel(mean, jmean, "mean")
    _rel(var, jvar, "var")
    if samples > 1:       # the epistemic term is there
        assert bool((var > torch.mean(to[1], dim=0)).any())
    ts = TM.reg_metrics_update(TM.reg_metrics_init(), mean, var,
                               torch.from_numpy(y))
    js = JM.reg_metrics_update(JM.reg_metrics_init(), jmean, jvar,
                               jnp.asarray(y))
    for k in js:
        _rel(ts[k], js[k], k)
    tc, jc = TM.reg_metrics_compute(ts), JM.reg_metrics_compute(js)
    for k in jc:
        _rel(tc[k], jc[k], k)


@pytest.mark.parametrize("method", METHODS)
def test_mlp_evaluate_entry_point(runs, method):
    _jo, _jl, _to, _tl, samples, tm, st = runs[method]
    x, y = runs["xy"]
    assert (tm.method, tm.task) == (method, "regression")
    state = st if method == "sgld" else from_jax_state(st)
    ms, outs, _secs = evaluate(tm, state, [(x, y)] * 2, samples=samples,
                               generator=torch.Generator().manual_seed(1),
                               device="cpu")
    assert float(ms["count"]) == 2 * B
    mean, var = outs[0]
    assert mean.shape == var.shape == (B, 1)
    assert torch.isfinite(mean).all() and bool((var > 0).all())
    metrics = TM.reg_metrics_compute(ms)
    assert all(torch.isfinite(v) for v in metrics.values())
