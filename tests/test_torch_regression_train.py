"""Regression training of the MLP (in -> 100 -> 100 -> 100 -> {mu,
log_var}, full width) for the four methods: the port against qbn_tpu, on
the CPU, with housing's 13 features at B=8.

- The variable tree of the port's own init (float and quantised)
  against qbn_tpu's: names, shapes, dtypes, the constant leaves equal.
- The float forward (train and eval mode) of every method from
  qbn_tpu's init, and of the committed
  examples/campaign/{bbb,mcdropout,pointwise}-regression-seed1/
  weights_housing_0.msgpack in eval mode.
- Three training steps of qbn_tpu's regression presets (pointwise: Adam
  with L2; MC-Dropout: Adam; BBB: Adam, tpu_fused, so the port's five
  dense layers run the fused dense's plain version and hand-written
  backward; sgld: the adaptive clip and SGHMC with 'whole' loss scaling)
  against qbn_tpu's make_train_step(jit_compile=False): the loss, the
  params, the optimiser state and the regression metric state; and the
  step skip on a non-finite loss, which keeps SGHMC's and the clip's
  state too.
- The QAT training forward (observers updated) and convert of the MLP of
  every method, from qbn_tpu's states.

Both packages see the same noise, masks and SGHMC draws: qbn_tpu's
`jax.random.normal`, `bernoulli` and `gamma` are replaced (pytest
monkeypatch) by functions that draw with numpy and record what they
return, in call order; the port gets the records through QueueNoise,
QueueMasks and QueueDraws.

Tolerances and why:
- mu and var of a forward 1e-5 relative (atol 1e-6): float32 products
  summed in another order;
- the loss 1e-5 relative; the metric state 1e-5 relative;
- params after 3 steps: Adam's first update is about lr * sign(g), and
  during burn-in SGHMC's is about lr^2 * sign(g) (its preconditioner
  divides by |g|), so where a gradient is at rounding level its sign
  can differ between the two stacks (ROADMAP section 3) and the next
  steps spread that: every entry within STEPS * lr, and at most
  PARAM_SHARE of the entries beyond 1e-6 (the count printed: 1 of
  21,805 for BBB and 44 for sgld at these inputs, none for the others);
- SGHMC's state after the first step 1e-4 relative, or 1e-5 of the
  leaf's largest entry, the clip's buffer 1e-5 relative: the first
  updates of g and v_hat are 1 + (-1 + d_p) and 1 + (-1 + d_p^2), whose
  cancellation keeps the gradient's absolute error (about ulp(1)), and
  the momentum divides by sqrt(v_hat) (3.5e-5 relative seen); later, the spread params above move the gradients and with them
  the preconditioner (v_hat by up to 5e-4 relative after 3 steps), so
  only the counts are held there;
- the QAT forward: mu and var 1e-5 relative, the observers' extrema 1e-5
  relative (atol 1e-6); qconst as in tests/test_torch_convert.py
  (bitwise but std_codes, at most one code apart on at most 1e-4 of
  them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training import metrics as JM
from qbn_tpu.training.optim import build_optimizer as j_optimizer
from qbn_tpu.training.trainer import TrainState as JState
from qbn_tpu.training.trainer import make_train_step as j_make_step
from qbn_tpu.utils import apply_model as j_apply
from qbn_tpu.utils import init_variables as j_init
from qbn_tpu.utils import split_rngs

from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import QueueMasks, QueueNoise
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training import metrics as TM
from qbn_tpu_torch.training.checkpoint import read_checkpoint
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.sghmc import QueueDraws
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import apply_model, convert_model, init_variables

from test_torch_convert import assert_qconst_match, j_qconst

B, F, STEPS, N_BATCHES = 8, 13, 3, 2
PARAM_SHARE = 5e-3
METHODS = ["pointwise", "mcdropout", "bbb", "sgld"]
COMMITTED = "examples/campaign/{}-regression-seed1/weights_housing_0.msgpack"


class Recorder:
    """Stands in for jax.random.normal, bernoulli and gamma: draws with
    numpy, in call order, and keeps what it drew for the port."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.calls = []

    def normal(self, key, shape=(), dtype=jnp.float32, *a, **k):
        arr = self.rng.standard_normal(tuple(shape)).astype(np.float32)
        self.calls.append(("normal", arr))
        return jnp.asarray(arr, dtype)

    def bernoulli(self, key, p=0.5, shape=None, *a, **k):
        arr = self.rng.random(tuple(shape)) < float(p)
        self.calls.append(("mask", arr[None].astype(np.float32)))
        return jnp.asarray(arr)

    def gamma(self, key, a, shape=None, dtype=jnp.float32, *args, **kw):
        arr = np.float32(self.rng.gamma(float(a)))
        self.calls.append(("gamma", arr))
        return jnp.asarray(arr, dtype)

    def take(self):
        calls, self.calls = self.calls, []
        return calls

    @staticmethod
    def sources(calls):
        return (QueueNoise([a for k, a in calls if k == "normal"]),
                QueueMasks([a for k, a in calls if k == "mask"]))


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder(0)
    monkeypatch.setattr(jax.random, "normal", rec.normal)
    monkeypatch.setattr(jax.random, "bernoulli", rec.bernoulli)
    monkeypatch.setattr(jax.random, "gamma", rec.gamma)
    return rec


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _np(tree):
    return dict(_leaves(to_numpy_state(tree)))


def _data(seed, n=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F)).astype(np.float32)
    y = (x @ rng.standard_normal((F, 1)) + 0.3 * rng.standard_normal(
        (n, 1))).astype(np.float32)
    return x, y


def _cfgs(method, phase="float"):
    over = dict(tpu_fused=True, epochs=2, input_size=(F,))
    return j_preset(method, "regression", phase, **over), \
        preset(method, "regression", phase, **over)


def _assert_out(t, j, what, rtol=1e-5, atol=1e-6):
    for a, b, name in zip(t, j, ("mu", "var")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quant"])
@pytest.mark.parametrize("method", METHODS)
def test_init_tree_matches(method, quantized):
    jcfg, cfg = _cfgs(method, "qat" if quantized else "float")
    jv = _np(j_init(j_build(jcfg), jax.random.PRNGKey(0), jnp.zeros((1, F)),
                    quantized=quantized))
    tv = _np(init_variables(build_model(cfg), torch.Generator().manual_seed(
        0), (F,), "cpu", quantized=quantized))
    assert jv.keys() == tv.keys()
    for p in jv:
        assert jv[p].shape == tv[p].shape and jv[p].dtype == tv[p].dtype, p
        if p[0] in ("quant", "qconst") or p[-1] == "std":
            np.testing.assert_array_equal(tv[p], jv[p], err_msg=str(p))
        elif p[-1] in ("kernel", "bias"):
            fan_in = jv[p[:-1] + ("kernel",)].shape[0]
            bound = 0.01 if method == "bbb" else 1 / np.sqrt(fan_in)
            assert np.abs(tv[p]).max() <= bound, p


def _start(method, recorder, quantized=False):
    jcfg, cfg = _cfgs(method, "qat" if quantized else "float")
    jm, tm = j_build(jcfg), build_model(cfg)
    jv = j_init(jm, jax.random.PRNGKey(3), jnp.zeros((1, F)),
                quantized=quantized)
    recorder.take()
    return jcfg, cfg, jm, tm, jax.tree.map(np.asarray, jv)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("method", METHODS)
def test_float_forward_matches(recorder, method, train):
    _jc, _c, jm, tm, v0 = _start(method, recorder)
    x, _y = _data(1)
    jout = jm.apply(jax.tree.map(jnp.asarray, v0), jnp.asarray(x),
                    train=train, mode="float",
                    rngs=split_rngs(jax.random.PRNGKey(0)),
                    mutable=["kl"])[0]
    calls = recorder.take()
    want = {"pointwise": 0, "sgld": 0, "mcdropout": 4, "bbb": 5}[method]
    assert len(calls) == want
    noise, masks = Recorder.sources(calls)
    kl = {}
    with torch.no_grad():
        out = tm(torch.from_numpy(x), from_jax_state(v0), mode="float",
                 train=train, noise=noise, masks=masks, kl=kl)
    assert not noise.queue and not masks.queue
    assert out[0].shape == (B, 1) and out[1].shape == (B, 1)
    _assert_out(out, jout, f"{method} train={train}")


@pytest.mark.parametrize("method", ["bbb", "mcdropout", "pointwise"])
def test_float_forward_on_committed_checkpoint(recorder, method):
    ckpt = read_checkpoint(COMMITTED.format(method))
    jcfg, cfg = _cfgs(method)
    x, _y = _data(2)
    jout = j_build(jcfg).apply(jax.tree.map(jnp.asarray, ckpt),
                               jnp.asarray(x), train=False, mode="float",
                               rngs=split_rngs(jax.random.PRNGKey(0)),
                               mutable=["kl"])[0]
    noise, masks = Recorder.sources(recorder.take())
    with torch.no_grad():
        out = build_model(cfg)(torch.from_numpy(x), from_jax_state(ckpt),
                               mode="float", noise=noise, masks=masks)
    assert not noise.queue and not masks.queue
    _assert_out(out, jout, method)


def _draw_queue(calls, jparams, tparams):
    """qbn_tpu's SGHMC draws of one step (per tensor in its sorted leaf
    order: gamma, momentum normal, noise normal) as the port's QueueDraws
    entry (per tensor in the port's leaf order)."""
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert len(calls) == 3 * len(paths)
    by_path = {}
    for i, p in enumerate(paths):
        (kg, g), (k1, mom), (k2, noise) = calls[3 * i:3 * i + 3]
        assert (kg, k1, k2) == ("gamma", "normal", "normal")
        by_path[p] = (mom, noise, g)
    return [by_path[p] for p, _ in _leaves(tparams)]


def _steps_both(method, recorder, xs, ys):
    """STEPS training steps of each stack from qbn_tpu's init, the same
    draws: (qbn_tpu's states and logs, the port's)."""
    jcfg, cfg, jm, tm, v0 = _start(method, recorder)
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    jstep = j_make_step(jm, jcfg, jtx, "float", N_BATCHES, N_BATCHES * B,
                        jit_compile=False)
    jv = jax.tree.map(jnp.asarray, v0)
    params = jv.pop("params")
    jstate = JState(params=params, model_state=jv,
                    opt_state=jtx.init(params), step=jnp.zeros((), jnp.int32),
                    rng=jax.random.PRNGKey(1))
    noise, masks, draws = QueueNoise([]), QueueMasks([]), QueueDraws([])
    tx, _ = build_optimizer(cfg, N_BATCHES, sghmc_draws=draws)
    trainer = Trainer(tm, cfg, tx, "float", N_BATCHES, N_BATCHES * B, noise,
                      "cpu", masks=masks)
    tstate = trainer.init_state(from_jax_state(v0))
    jm_state, tm_state = JM.reg_metrics_init(), TM.reg_metrics_init()
    out = []
    for x, y in zip(xs, ys):
        jstate, jm_state, jlogs = jstep(jstate, jm_state, jnp.asarray(x),
                                        jnp.asarray(y))
        calls = recorder.take()
        if method == "sgld":
            draws.queue.append(_draw_queue(calls, jstate.params,
                                           tstate.params))
        else:
            n, m = Recorder.sources(calls)
            noise.queue += n.queue
            masks.queue += m.queue
        tstate, tm_state, tlogs = trainer.train_step(
            tstate, tm_state, torch.from_numpy(x), torch.from_numpy(y),
            noise, masks)
        assert not noise.queue and not masks.queue and not draws.queue
        out.append((jlogs, tlogs, jstate, tstate))
    return (jstate, jm_state), (tstate, tm_state), out


@pytest.mark.parametrize("method", METHODS)
def test_training_steps_match(recorder, method):
    data = [_data(10 + i) for i in range(STEPS)]
    (js, jms), (ts, tms), logs = _steps_both(
        method, recorder, [d[0] for d in data], [d[1] for d in data])
    for i, (jl, tl, _j, _t) in enumerate(logs):
        for k in ("obj", "main_obj", "kl"):
            j, t = float(jl[k]), float(tl[k])
            assert abs(t - j) <= 1e-5 * abs(j) + 1e-7, (i, k, t, j)
    jp = _np(jax.tree.map(np.asarray, js.params))
    tp = _np(ts.params)
    assert jp.keys() == tp.keys()
    d = np.concatenate([np.abs(tp[p] - jp[p]).reshape(-1) for p in jp])
    n_off = int((d > 1e-6).sum())
    print(f"{method}: params after {STEPS} steps max abs diff "
          f"{d.max():.3g}, {n_off} of {d.size} beyond 1e-6")
    lr = _cfgs(method)[1].learning_rate
    assert d.max() <= STEPS * lr and n_off <= PARAM_SHARE * d.size
    for k in jms:
        np.testing.assert_allclose(float(tms[k]), float(jms[k]), rtol=1e-5)
    if method == "sgld":
        clip, sg = js.opt_state
        assert int(ts.opt_state["0"]["count"]) == int(clip.count) == STEPS
        assert int(ts.opt_state["1"]["count"]) == int(sg.count) == STEPS
        # the first step, from the common init: SGHMC's and the clip's
        # state
        _jl, _tl, js1, ts1 = logs[0]
        clip, sg = js1.opt_state
        np.testing.assert_allclose(ts1.opt_state["0"]["buffer"].numpy(),
                                   np.asarray(clip.buffer), rtol=1e-5)
        for name in ("tau", "g", "v_hat", "momentum", "weight_decay"):
            jl = _np(jax.tree.map(np.asarray, getattr(sg, name)))
            tl = _np(ts1.opt_state["1"][name])
            for p in jl:
                np.testing.assert_allclose(
                    tl[p], jl[p], rtol=1e-4,
                    atol=1e-5 * float(np.abs(jl[p]).max()),
                    err_msg=f"{name} {p}")


def test_sghmc_step_skip_keeps_every_state_leaf(recorder):
    """A target of NaN: the loss is NaN, and params, SGHMC's state (count,
    preconditioner, momentum, prior precisions) and the clip's buffer,
    count and threshold stay as they were, in both packages."""
    x, y = _data(20)
    (js0, _), (ts0, _), _ = _steps_both("sgld", recorder, [x], [y])
    y_bad = y.copy()
    y_bad[0, 0] = np.nan
    jcfg, cfg = _cfgs("sgld")
    jm, tm = j_build(jcfg), build_model(cfg)
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    jstep = j_make_step(jm, jcfg, jtx, "float", N_BATCHES, N_BATCHES * B,
                        jit_compile=False)
    js1, _m, jlogs = jstep(js0, JM.reg_metrics_init(), jnp.asarray(x),
                           jnp.asarray(y_bad))
    calls = recorder.take()
    assert not np.isfinite(float(jlogs["obj"]))
    tx, _ = build_optimizer(cfg, N_BATCHES, sghmc_draws=QueueDraws(
        [_draw_queue(calls, js0.params, ts0.params)]))
    trainer = Trainer(tm, cfg, tx, "float", N_BATCHES, N_BATCHES * B,
                      QueueNoise([]), "cpu")
    ts1, _m, tlogs = trainer.train_step(ts0, TM.reg_metrics_init(),
                                        torch.from_numpy(x),
                                        torch.from_numpy(y_bad),
                                        trainer.noise)
    assert not np.isfinite(float(tlogs["obj"]))
    for a, b in zip(jax.tree_util.tree_leaves((js0.params, js0.opt_state)),
                    jax.tree_util.tree_leaves((js1.params, js1.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    before = _np({"p": ts0.params, "o": ts0.opt_state})
    after = _np({"p": ts1.params, "o": ts1.opt_state})
    assert before.keys() == after.keys()
    assert {p[1] for p in before if p[0] == "o"} == {"0", "1"}
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=str(k))


def _observers(tree):
    return {p: v for p, v in _np(tree).items()}


@pytest.mark.parametrize("method", METHODS)
def test_qat_forward_and_convert_match(recorder, method):
    """A QAT training forward with the observers updating, from qbn_tpu's
    quantised init; then a QAT eval pass on qbn_tpu's side (the observers
    that only eval forwards reach) and convert of that state in both."""
    _jc, _c, jm, tm, v0 = _start(method, recorder, quantized=True)
    x, _y = _data(30)
    jout, _kl, jv = j_apply(jm, jax.tree.map(jnp.asarray, v0),
                            jnp.asarray(x), jax.random.PRNGKey(4),
                            train=True, mode="qat", update_stats=True)
    noise, masks = Recorder.sources(recorder.take())
    with torch.no_grad():
        tout, _tkl, tv = apply_model(tm, from_jax_state(v0),
                                     torch.from_numpy(x), train=True,
                                     mode="qat", update_stats=True,
                                     noise=noise, masks=masks)
    assert not noise.queue and not masks.queue
    _assert_out(tout, jout, f"{method} qat forward")
    jq = _observers(jax.tree.map(np.asarray, jv["quant"]))
    tq = _observers(tv["quant"])
    assert jq.keys() == tq.keys()
    for p in jq:
        np.testing.assert_allclose(tq[p], jq[p], rtol=1e-5, atol=1e-6,
                                   err_msg=str(p))
    _o, _kl, jv = j_apply(jm, jv, jnp.asarray(x), jax.random.PRNGKey(5),
                          train=False, mode="qat", update_stats=True)
    state = jax.tree.map(np.asarray, jv)
    want = j_qconst(jm, state, x)["qconst"]
    got = convert_model(tm, from_jax_state(state), torch.from_numpy(x))
    assert_qconst_match(got["qconst"], want)
