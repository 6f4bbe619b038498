"""Float and QAT training of the CIFAR ResNet-18 with batch norm: the
port against qbn_tpu, on the CPU.

- The float forward in eval mode on the committed float checkpoints
  (examples/campaign/pointwise-cifar-seed1 and mcdropout-cifar-seed1:
  'params' and 'batch_stats') at full width, B=2.
- The variable tree of the port's own init (float and quantised) against
  qbn_tpu's: names, shapes and dtypes of every collection.
- One float training step (Adam) and one QAT step (SGD with momentum) of
  the narrow ResNet (widths 8/16/16/16, 32x32 inputs, B=4) for pointwise,
  MC-Dropout and Bayes-by-backprop (tpu_fused, so the port's head runs
  the fused dense), from the same carried-across state: the loss, the
  gradients (QAT), the params, the running statistics and the observers;
  and the QAT training forward module by module, each module fed
  qbn_tpu's input.
- The step skip: a non-finite loss leaves params, optimiser state,
  running statistics and observers as they were.

Both packages see the same noise and masks: qbn_tpu's
`jax.random.normal` and `jax.random.bernoulli` are replaced (pytest
monkeypatch) by functions that draw from a numpy generator and record
what they return, in call order; the port gets the records through
QueueNoise and QueueMasks. qbn_tpu's step runs eagerly
(jit_compile=False).

Tolerances and why:
- probabilities 1e-5 absolute (float32 convs summed in another order);
- the loss 1e-5 relative; the running statistics 1e-5 relative (atol
  1e-6): batch means and variances of the same activations;
- the QAT step, every port module's output pinned to qbn_tpu's: the
  loss 1e-5 relative, each leaf's gradient 2e-5 and its update 1e-3
  relative in norm (see test_one_qat_step for why it is pinned and for
  the readings); its forward module by module: codes on their grid, at
  most 2e-3 of them one step apart;
- params after a float step (Adam): the first update is
  lr * g / (|g| + eps), about lr * sign(g): where a gradient is at the
  level of rounding noise its sign can differ between the two stacks
  (ROADMAP section 3), so every entry within 2 * lr and at most 1e-3 of
  the entries beyond 1e-6, the count printed;
- the observers (module by module) 1e-5 relative (atol 1e-6): extrema
  of the same tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.models.architectures import ResNet as JResNet
from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.models.layers import QuantConfig as JQuant
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training import metrics as JM
from qbn_tpu.training.optim import build_optimizer as j_optimizer
from qbn_tpu.training.trainer import TrainState as JState
from qbn_tpu.training.trainer import make_train_step as j_make_step
from qbn_tpu.utils import apply_model as j_apply
from qbn_tpu.utils import init_variables as j_init
from qbn_tpu.utils import split_rngs

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.models.architectures import ResNet
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import QueueMasks, QueueNoise
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training import metrics as TM
from qbn_tpu_torch.training.checkpoint import read_checkpoint
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import init_variables
from qbn_tpu_torch.utils import prune as prune_tree
from qbn_tpu_torch.utils import tree_update

WIDTHS = (8, 16, 16, 16)
B, N_BATCHES = 4, 2
METHODS = ["pointwise", "mcdropout", "bbb"]
CAPTURE_SEED = 7
GRAD_RTOL, UPDATE_RTOL = 2e-5, 1e-3     # test_one_qat_step
FLOAT_CKPTS = {"pointwise": "examples/campaign/pointwise-cifar-seed1",
               "mcdropout": "examples/campaign/mcdropout-cifar-seed1"}


class Recorder:
    """Stands in for jax.random.normal and jax.random.bernoulli: draws
    from a numpy generator, in call order, and keeps what it drew for the
    port (normals as they are, masks as (1, *shape) float32)."""

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

    def sources(self):
        return QueueNoise(self.normals), QueueMasks(self.masks)


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder(0)
    monkeypatch.setattr(jax.random, "normal", rec.normal)
    monkeypatch.setattr(jax.random, "bernoulli", rec.bernoulli)
    return rec


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _np(tree):
    return dict(_leaves(to_numpy_state(tree)))


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, n))


@pytest.mark.parametrize("method", sorted(FLOAT_CKPTS))
def test_float_forward_on_committed_checkpoint(recorder, method):
    """Full width, eval mode (running statistics; MC-Dropout's sites
    drawing one mask each), B=2: probabilities within 1e-5."""
    ckpt = read_checkpoint(FLOAT_CKPTS[method] + "/weights.msgpack")
    assert set(ckpt) == {"params", "batch_stats"}
    jm = j_build(j_preset(method, "cifar"))
    model = build_model(preset(method, "cifar"))
    x, _y = _images(1, 2)
    jout = jm.apply(jax.tree.map(jnp.asarray, ckpt), jnp.asarray(x),
                    train=False, mode="float",
                    rngs=split_rngs(jax.random.PRNGKey(0)))
    noise, masks = recorder.sources()
    assert len(masks.queue) == (20 if method == "mcdropout" else 0)
    with torch.no_grad():
        out = model(torch.from_numpy(x), from_jax_state(ckpt), mode="float",
                    noise=noise, masks=masks)
    assert not masks.queue and out.shape == (2, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0,
                               atol=1e-5)


def _models(method, quantized):
    kw = dict(widths=WIDTHS, stochastic=method == "bbb",
              dropout_p=0.15 if method == "mcdropout" else 0.0,
              sigma_prior=0.05)
    jm = JResNet(quant=JQuant(enabled=quantized, tpu_fused=True), **kw)
    tm = ResNet(quant=QuantConfig(enabled=quantized, tpu_fused=True), **kw)
    tm.method, tm.task = method, "classification"
    return jm, tm


@pytest.mark.parametrize("enabled,quantized", [
    (False, False), (True, True), (True, False)],
    ids=["float", "quant", "float-with-quant"])
@pytest.mark.parametrize("method", METHODS)
def test_init_tree_matches(method, enabled, quantized):
    """Every collection, name, shape and dtype of qbn_tpu's init (float:
    params, batch_stats, kl; quantised: also every observer at its
    sentinel and the qconst placeholders; a float init of a model with
    its quantisation machinery: the observers and placeholders that
    qbn_tpu declares in float mode) in the port's own init."""
    jm, tm = _models(method, enabled)
    jv = _np(j_init(jm, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                    quantized=quantized))
    tv = _np(init_variables(tm, torch.Generator().manual_seed(0),
                            (32, 32, 3), "cpu", quantized=quantized))
    assert jv.keys() == tv.keys()
    for p in jv:
        assert jv[p].shape == tv[p].shape and jv[p].dtype == tv[p].dtype, p
        if p[0] in ("batch_stats", "quant", "qconst") or p[-1] in (
                "std", "bn_scale", "bn_bias"):
            np.testing.assert_array_equal(tv[p], jv[p], err_msg=str(p))


def _cfg(method, phase):
    over = dict(tpu_fused=True, epochs=2)
    return j_preset(method, "cifar", phase, **over), \
        preset(method, "cifar", phase, **over)


def _start(method, phase, recorder):
    """qbn_tpu's init of the narrow net and, for QAT, one QAT forward
    with updates (so that the observers hold real ranges): the state both
    packages start from, as numpy."""
    jm, tm = _models(method, phase == "qat")
    x, _ = _images(2, B)
    jv = j_init(jm, jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)),
                quantized=phase == "qat")
    if phase == "qat":
        _o, _kl, jv = j_apply(jm, jv, jnp.asarray(x), jax.random.PRNGKey(4),
                              train=True, mode="qat", update_stats=True)
    recorder.normals.clear()
    recorder.masks.clear()
    return jm, tm, jax.tree.map(np.asarray, jv)


def _captured(intermediates):
    """{dotted module path: its output} of flax's captured intermediates."""
    out = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                out[".".join(path)] = np.asarray(v[0])
            else:
                walk(v, path + (k,))

    walk(intermediates, ())
    return out


def _capture(jm, v0, x, recorder):
    """qbn_tpu's QAT training forward (train=True, update_stats=True) on
    v0, every module's output captured, and the updated collections. The
    recorder is then set back to the seed it drew from, so that the next
    forward with the same call sequence draws the same noise and masks."""
    recorder.rng = np.random.default_rng(CAPTURE_SEED)
    _out, upd = jm.apply(
        jax.tree.map(jnp.asarray, v0), jnp.asarray(x), train=True,
        mode="qat", update_stats=True, rngs=split_rngs(jax.random.PRNGKey(0)),
        mutable=["batch_stats", "quant", "kl", "intermediates"],
        capture_intermediates=True)
    drawn = list(recorder.normals), list(recorder.masks)
    recorder.rng = np.random.default_rng(CAPTURE_SEED)
    recorder.normals.clear()
    recorder.masks.clear()
    return _captured(upd["intermediates"]), upd, drawn


def _pin(tm, captured):
    """Forward hooks on every port module whose output qbn_tpu's captured
    intermediates name: the output takes qbn_tpu's value exactly
    (captured + (out - out.detach())), the gradient flows through the
    port's own module. Returns the hook handles."""
    def hook(_mod, _args, out, name):
        return torch.from_numpy(captured[name].copy()) + (out - out.detach())

    return [m.register_forward_hook(
        lambda mod, a, o, name=n: hook(mod, a, o, name))
        for n, m in tm.named_modules() if n and n in captured]


def _step_both(method, phase, recorder, x, y, pin=False):
    """One training step of each stack from the same state, noise and
    masks. pin (QAT): every port module's output pinned to qbn_tpu's, from
    a captured forward that draws what the step then draws."""
    jcfg, cfg = _cfg(method, phase)
    jm, tm, v0 = _start(method, phase, recorder)
    hooks = []
    if pin:
        captured, _upd, drawn = _capture(jm, v0, x, recorder)
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    jstep = j_make_step(jm, jcfg, jtx, phase, N_BATCHES, N_BATCHES * B,
                        jit_compile=False)
    jv = jax.tree.map(jnp.asarray, v0)
    params = jv.pop("params")
    j0 = JState(params=params, model_state=jv, opt_state=jtx.init(params),
                step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(1))
    j1, _jm, jlogs = jstep(j0, JM.cls_metrics_init(), jnp.asarray(x),
                           jnp.asarray(y))
    if pin:
        for a, b in zip(drawn, (recorder.normals, recorder.masks)):
            assert len(a) == len(b) and all(
                np.array_equal(u, v) for u, v in zip(a, b))
        hooks = _pin(tm, captured)
    noise, masks = recorder.sources()
    tx, _ = build_optimizer(cfg, N_BATCHES)
    trainer = Trainer(tm, cfg, tx, phase, N_BATCHES, N_BATCHES * B, noise,
                      "cpu", masks=masks)
    t0 = trainer.init_state(from_jax_state(v0))
    try:
        t1, _tm, tlogs = trainer.train_step(
            t0, TM.cls_metrics_init(), torch.from_numpy(x),
            torch.from_numpy(y), noise, masks)
    finally:
        for h in hooks:
            h.remove()
    assert not noise.queue and not masks.queue
    return (j0, j1, jlogs), (t0, t1, tlogs), jcfg


@pytest.mark.parametrize("method", METHODS)
def test_one_float_step_matches(recorder, method):
    x, y = _images(5, B)
    (_j0, j1, jlogs), (t0, t1, tlogs), jcfg = _step_both(
        method, "float", recorder, x, y)
    for k in ("obj", "main_obj"):
        j, t = float(jlogs[k]), float(tlogs[k])
        assert abs(t - j) <= 1e-5 * abs(j), (k, t, j)
    jp, tp = _np(j1.params), _np(t1.params)
    assert jp.keys() == tp.keys()
    d = np.concatenate([np.abs(tp[p] - jp[p]).ravel() for p in jp])
    beyond = int((d > 1e-6).sum())
    print(f"{method} float step: params max |diff| {d.max():.3g}, {beyond} "
          f"of {d.size} beyond 1e-6")
    assert d.max() <= 2 * jcfg.learning_rate and beyond <= 1e-3 * d.size
    js, ts = _np(j1.model_state), _np(t1.model_state)
    assert js.keys() == ts.keys() and "batch_stats" in {p[0] for p in js}
    for p in js:
        np.testing.assert_allclose(ts[p], js[p], rtol=1e-5, atol=1e-6,
                                   err_msg=str(p))
    stem_var = ("batch_stats", "stem", "var")
    assert not np.array_equal(ts[stem_var], _np(t0.model_state)[stem_var])


def _grid_steps(t, j, scale):
    """|t - j| in units of the fake-quant grid `scale` (float64)."""
    return np.abs(t.astype(np.float64) - j) / float(scale)


@pytest.mark.parametrize("method", METHODS)
def test_qat_forward_module_by_module(recorder, method):
    """The QAT training forward (train=True, update_stats=True) with every
    module fed qbn_tpu's input: the port's modules run on the CAPTURED
    outputs of qbn_tpu's previous modules (forward hooks), so that a code
    that lands on the other side of a rounding edge in one module does
    not cascade (through batch norm's batch statistics it would reach
    every later activation). Each module's output: fake-quantised values
    on its own grid, at most 2e-3 of them one grid step apart, the others
    within 1e-5 of a step; every running statistic and observer the
    forward wrote within 1e-5 relative (atol 1e-6)."""
    jm, tm, v0 = _start(method, "qat", recorder)
    x, _y = _images(5, B)
    captured, upd, _drawn = _capture(jm, v0, x, recorder)
    recorder.normals[:], recorder.masks[:] = _drawn
    noise, masks = recorder.sources()
    seen = {}

    def hook(module, _args, out, name):
        seen[name] = out.detach().numpy().copy()
        return torch.from_numpy(captured[name].copy())

    names = [n for n, _m in tm.named_modules() if n and n in captured]
    hooks = [m.register_forward_hook(
        lambda mod, a, o, name=n: hook(mod, a, o, name))
        for n, m in tm.named_modules() if n in names]
    mutable = {"batch_stats": {}, "quant": {}}
    try:
        with torch.no_grad():
            tm(torch.from_numpy(x), from_jax_state(v0), mode="qat",
               train=True, update_stats=True, noise=noise, masks=masks,
               kl={}, mutable=mutable)
    finally:
        for h in hooks:
            h.remove()
    assert not noise.queue and not masks.queue
    quant = upd["quant"]
    n_modules = 0
    for name in names:
        if name.count(".") == 0 and name.startswith("stage"):
            continue                              # a block: its add's output
        node = quant
        for k in name.split("."):
            node = node[k]
        obs = node.get("act", node.get("add_act", node.get("mul_mask")))
        lo, hi = (0, 127)
        from qbn_tpu.quant.observer import calculate_qparams
        scale, _zp = calculate_qparams(obs["min_val"], obs["max_val"], lo, hi)
        if "drop" in name:
            scale = scale / (1 - 0.15)
        steps = _grid_steps(seen[name], captured[name], scale)
        off = steps > 1e-5
        print(f"{name}: {int(off.sum())} of {steps.size} codes off, max "
              f"{steps.max():.3g} steps")
        assert off.mean() <= 2e-3 and steps.max() <= 1 + 1e-5, name
        n_modules += 1
    assert n_modules >= (38 if method == "mcdropout" else 22)
    want = _np({c: upd[c] for c in ("batch_stats", "quant")})
    start = from_jax_state(v0)
    got = _np({c: tree_update(start[c], prune_tree(mutable[c]))
               for c in mutable})
    assert want.keys() == got.keys()
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, atol=1e-6,
                                   err_msg=str(p))


def _trace(opt_state):
    """The momentum trace of optax.sgd's state: after a first step, the
    gradient (the non-finite entries zeroed)."""
    return next(s.trace for s in opt_state if hasattr(s, "trace"))


def _readings(method, recorder, pin):
    """One QAT step in both stacks; the readings: the loss's relative
    difference, and per leaf the gradient's relative error
    ||g_t - g_j|| / ||g_j|| (the momentum traces, in float64), the
    update's ||(t1 - p0) - (j1 - p0)|| / ||j1 - p0|| and whether each
    stack's step moved the leaf."""
    x, y = _images(5, B)
    (j0, j1, jlogs), (_t0, t1, tlogs), _ = _step_both(
        method, "qat", recorder, x, y, pin=pin)
    loss = {k: abs(float(tlogs[k]) - float(jlogs[k])) / abs(float(jlogs[k]))
            for k in ("obj", "main_obj")}
    gj, gt = _np(_trace(j1.opt_state)), _np(t1.opt_state["trace"])
    jp, tp, p0 = _np(j1.params), _np(t1.params), _np(j0.params)
    assert gj.keys() == gt.keys() == jp.keys() == tp.keys()
    rows = {}
    for p in jp:
        g64 = gj[p].astype(np.float64)
        err = float(np.linalg.norm(gt[p] - g64))
        norm = float(np.linalg.norm(g64))
        dj = jp[p].astype(np.float64) - p0[p]
        dt = tp[p].astype(np.float64) - p0[p]
        un = float(np.linalg.norm(dj))
        ue = float(np.linalg.norm(dt - dj))
        rows[p] = dict(grad_rel=err / norm if norm else err,
                       upd_rel=ue / un if un else ue,
                       moved_j=bool((jp[p] != p0[p]).any()),
                       moved_t=bool((tp[p] != p0[p]).any()))
    worst = max(rows, key=lambda p: rows[p]["grad_rel"])
    print(f"{method} qat step (pinned={pin}): loss rel diff {loss}, "
          f"largest gradient rel error {rows[worst]['grad_rel']:.3g} "
          f"({'/'.join(worst)}), largest update rel error "
          f"{max(r['upd_rel'] for r in rows.values()):.3g}")
    return loss, rows, (_np(j1.model_state), _np(t1.model_state))


@pytest.mark.parametrize("method", METHODS)
def test_one_qat_step(recorder, method):
    """One QAT step (SGD with momentum) from the same state, noise and
    masks, with every port module's output pinned to qbn_tpu's captured
    one (the value taken, the gradient flowing through the port's module):
    the backward and the update run at qbn_tpu's forward point. Unpinned,
    a code on the other side of a rounding edge in the port's forward
    (held module by module above) reaches every later activation through
    batch norm's batch statistics: the loss then differs by up to 1.2e-3
    relative and bn_scale's gradient by up to 127% (pointwise and BBB at
    this size), which no limit can tell from a broken backward.

    Held, per leaf of the params: the gradient (the optimiser's momentum
    trace) within GRAD_RTOL in norm (readings up to 5.6e-6, on bn_scale,
    whose gradient sums over B*H*W); the update t1 - p0 within
    UPDATE_RTOL of qbn_tpu's j1 - p0 in norm (readings up to 1.7e-4: at
    lr 1e-5 an update is a few ulps of its param, so the float32
    difference is coarse); moved by the step exactly where qbn_tpu's
    moved. The loss within 1e-5 relative (readings 0), and the running
    statistics and observers the step wrote within 1e-5 relative (atol
    1e-6)."""
    loss, rows, (js, ts) = _readings(method, recorder, pin=True)
    assert max(loss.values()) <= 1e-5, loss
    for p, r in rows.items():
        assert r["grad_rel"] <= GRAD_RTOL, (p, r)
        assert r["upd_rel"] <= UPDATE_RTOL, (p, r)
        assert r["moved_t"] == r["moved_j"], (p, r)
    assert any(r["moved_j"] for r in rows.values())
    assert js.keys() == ts.keys() and {"batch_stats", "quant"} <= {
        p[0] for p in js}
    for p in js:
        np.testing.assert_allclose(ts[p], js[p], rtol=1e-5, atol=1e-6,
                                   err_msg=str(p))


@pytest.mark.parametrize("phase", ["float", "qat"])
def test_nonfinite_loss_skips_the_step(recorder, phase):
    """A NaN pixel: the loss is NaN, and params, optimiser state, running
    statistics and observers stay as they were, in both packages."""
    x, y = _images(6, B)
    x[0, 3, 3, 0] = np.nan
    (j0, j1, jlogs), (t0, t1, tlogs), _ = _step_both(
        "mcdropout", phase, recorder, x, y)
    assert not np.isfinite(float(jlogs["obj"]))
    assert not np.isfinite(float(tlogs["obj"]))
    leaves = jax.tree_util.tree_leaves
    jb = leaves((j0.params, j0.opt_state, j0.model_state))
    ja = leaves((j1.params, j1.opt_state, j1.model_state))
    assert len(jb) == len(ja)
    for a, b in zip(jb, ja):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    before = _np({"p": t0.params, "o": t0.opt_state, "s": t0.model_state})
    after = _np({"p": t1.params, "o": t1.opt_state, "s": t1.model_state})
    assert before.keys() == after.keys()
    assert {k[1] for k in before if k[0] == "s"} >= (
        {"batch_stats"} | ({"quant"} if phase == "qat" else set()))
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=str(k))
