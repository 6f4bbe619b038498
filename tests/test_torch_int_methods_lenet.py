"""INT MC evaluation of the MNIST LeNet (full widths, B=2) for MC-Dropout,
pointwise and an SGHMC ensemble: the port's against qbn_tpu's on the CPU,
both built by their `build_model`, with the dropout masks fixed on both
sides and every module's output captured as in
tests/test_torch_int_methods.py (whose helpers this file uses). Covers
`max_pool` on codes, the 5x5 convs (K = 25 and 500), the deep dense head
(K = 2450) and the dropout after each layer, and the 4-bit collapse that
qbn_tpu and the reference show (tests/test_mc_int_dropout.py): on the
coarse grids every code after the last dropout goes to the zero point and
the net predicts exactly uniform.

Tolerances: int8 codes at every module bitwise, probabilities within
1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbn_tpu.evaluation.mc as JMC
from qbn_tpu.config import Config as JConfig
from qbn_tpu.evaluation.ensemble import stack_variables as j_stack
from qbn_tpu.models.factory import build_model as j_build_model

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.evaluation import ensemble as TE
from qbn_tpu_torch.evaluation.mc import aggregate, evaluate
from qbn_tpu_torch.models.factory import build_model

from test_torch_int_methods import (assert_close, assert_layers_equal,
                                    convert, j_run, t_run)

B, S, MEMBERS, P = 2, 4, 3, 0.3


def _models(model, **kw):
    jm = j_build_model(JConfig(model=model, at=True, q=True, output_size=10,
                               p=P, **kw))
    tm = build_model(Config(model=model, q=True, output_size=10, p=P,
                            input_size=(28, 28, 1), **kw))
    return jm, tm


@pytest.fixture(scope="module")
def runs():
    x = np.array(jax.random.uniform(jax.random.PRNGKey(1), (B, 28, 28, 1)))
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        jm, tm = _models("conv_lenet_mc")
        st = convert(jm, jnp.asarray(x), jax.random.PRNGKey(0))
        jo, jl, masks = j_run(jm, st, x, S, mp)
        out["mcdropout"] = (jo, jl) + t_run(tm, from_jax_state(st), x, S,
                                            masks) + (S, tm, st)
        jm, tm = _models("conv_lenet")
        members = [convert(jm, jnp.asarray(x), jax.random.PRNGKey(5 + i))
                   for i in range(MEMBERS)]
        jo, jl, _ = j_run(jm, members[0], x, 1, mp)
        out["pointwise"] = (jo, jl) + t_run(
            tm, from_jax_state(members[0]), x, 1) + (1, tm, members[0])
        jm, tm = _models("conv_lenet_sgld")
        jo, jl, _ = j_run(jm, j_stack(members), x, MEMBERS, mp,
                          ensemble=True)
        state = TE.stack_variables([from_jax_state(m) for m in members])
        out["sgld"] = (jo, jl) + t_run(tm, state, x, MEMBERS,
                                       ensemble=True) + (MEMBERS, tm, state)
    finally:
        mp.undo()
    out["x"] = x
    return out


METHODS = ["mcdropout", "pointwise", "sgld"]


@pytest.mark.parametrize("method", METHODS)
def test_lenet_codes_bitwise_at_every_module(runs, method):
    jo, jl, to, tl, samples, _tm, _st = runs[method]
    # input quant, two convs, two dense (and three dropout sites)
    assert_layers_equal(jl, tl, samples, 8 if method == "mcdropout" else 5)


@pytest.mark.parametrize("method", METHODS)
def test_lenet_probabilities(runs, method):
    jo, _jl, to, _tl, samples, _tm, _st = runs[method]
    assert to.shape == (samples, B, 10)
    assert_close(to, jo)
    assert_close(aggregate(to), JMC.aggregate("classification", jo,
                                              samples))


@pytest.mark.parametrize("method", METHODS)
def test_lenet_evaluate_entry_point(runs, method):
    """`evaluate` on the model from build_model: the method's path (masks
    from the generator, one forward, one per member), finite
    probabilities, a metric state counting the examples."""
    _jo, _jl, _to, _tl, samples, tm, st = runs[method]
    assert tm.method == method
    state = st if method == "sgld" else from_jax_state(st)
    g = torch.Generator().manual_seed(3)
    ms, probs, secs = evaluate(tm, state, [(runs["x"], np.array([0, 9]))],
                               samples=samples, generator=g, device="cpu")
    assert float(ms["count"]) == B and len(secs) == 1
    assert probs[0].shape == (B, 10) and torch.isfinite(probs[0]).all()
    np.testing.assert_allclose(probs[0].sum(-1).numpy(), 1.0, atol=1e-5)


def test_lenet_4bit_mask_collapse_reproduces(monkeypatch):
    """tests/test_mc_int_dropout.py's miniature of the campaign's a4
    finding, through the port: large inputs, coarse 4-bit grids (the last
    dropout's above 2/3), every code after the last dropout at the zero
    point, and the bias-free LeNet predicts exactly uniform, bitwise as
    qbn_tpu at every module."""
    jm, tm = _models("conv_lenet_mc", activation_precision=4)
    x = np.array(50.0 * jax.random.uniform(jax.random.PRNGKey(1),
                                           (B, 28, 28, 1)))
    st = convert(jm, jnp.asarray(x), jax.random.PRNGKey(0))
    assert float(st["qconst"]["drop_2"]["q"]["mul_scale"]) > 2.0 / 3.0
    jo, jl, masks = j_run(jm, st, x, S, monkeypatch)
    to, tl = t_run(tm, from_jax_state(st), x, S, masks)
    assert_layers_equal(jl, tl, S, 8)
    assert not tl["drop_2"][0].codes.any()
    np.testing.assert_allclose(to.numpy(), 0.1, atol=1e-6)
    assert_close(to, jo)
