"""Float Bayes-by-backprop LeNet training: qbn_tpu_torch against qbn_tpu.

qbn_tpu's init of conv_lenet_bbb (the mnist preset with tpu_fused=True)
is carried across as numpy. Both packages then see the same normals:
qbn_tpu's `jax.random.normal` is replaced (pytest monkeypatch) by a queue
that returns, in call order, the arrays that the port's QueueNoise also
receives. On the CPU qbn_tpu takes its unfused path, which draws the same
(B, N) shapes as the fused one; the port takes its fused path
(LocalReparamDenseFused: the kernel's plain version and the hand-written
backward). qbn_tpu's step runs eagerly (jit_compile=False), so that each
step draws anew.

Tolerances and why:
- probabilities 1e-5 absolute, the NLL 1e-5 relative, per-layer KL of the
  forward 1e-5 relative: the same float32 formulas, summed in another
  order;
- the KL of the training steps (and the loss, which it dominates) 1e-4
  relative against qbn_tpu, and 1e-6 relative against a float64 sum of
  the port's own parameters. After one Adam step every conv_1 std is the
  same value, and XLA:CPU's float32 sum of those 25,000 equal KL terms
  comes out 5.8e-5 below float64, where the port's sum is within 1e-7;
- first-step gradients rtol 1e-4 (atol 1e-6 for entries near zero), as
  for the custom backward in tests/test_pallas.py;
- parameters after 3 Adam steps within 1e-6 absolute (5e-8 seen). Adam
  divides by sqrt(v) ~ |g|, so a gradient at the level of summation noise
  could amplify ulps up to lr per step (tests/test_lockstep_torch.py saw
  it against torch's Adam); at these inputs no entry does.

The pointwise and MC-Dropout LeNets (their mnist presets, Adam with and
without L2) take one float step each against qbn_tpu's, the dropout
masks drawn by a numpy stand-in for `jax.random.bernoulli` and given to
the port through QueueMasks: the loss within 1e-5 relative; the params, after
Adam's first update of about lr * sign(g), within 2 * lr, and at most
1e-4 of them beyond 1e-6 (a gradient at rounding level may take the
other sign; 26 of 1.2 M entries of fc_0 at these inputs, the count
printed).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training import metrics as JM
from qbn_tpu.training.losses import classification_loss as j_loss
from qbn_tpu.training.optim import build_optimizer as j_optimizer
from qbn_tpu.training.trainer import TrainState as JState
from qbn_tpu.training.trainer import make_train_step as j_make_step
from qbn_tpu.utils import init_variables as j_init
from qbn_tpu.utils import split_rngs, sum_kl as j_sum_kl

from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import QueueMasks, QueueNoise
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training import metrics as TM
from qbn_tpu_torch.training.losses import classification_loss
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import sum_kl

B, STEPS, N_BATCHES = 8, 3, 2
# epochs=2 makes the cosine LR halve at the epoch boundary (after step 2)
CFG = dict(tpu_fused=True, epochs=2)
TRAIN_SHAPES = [(B, 28, 28, 20), (B, 14, 14, 50), (B, 500), (B, 10)]
WEIGHT_SHAPES = [(5, 5, 1, 20), (5, 5, 20, 50), (2450, 500), (500, 10)]


class _JaxNormals:
    """Stands in for jax.random.normal: the queued arrays, in call order."""

    def __init__(self):
        self.queue = []

    def __call__(self, key, shape=(), dtype=jnp.float32, *args, **kwargs):
        arr = self.queue.pop(0)
        assert arr.shape == tuple(shape), (arr.shape, shape)
        return jnp.asarray(arr, dtype)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_preset("bbb", "mnist", **CFG)
    cfg = preset("bbb", "mnist", **CFG)
    jmodel, model = j_build(jcfg), build_model(cfg)
    jvars = j_init(jmodel, jax.random.PRNGKey(0), jnp.zeros((B, 28, 28, 1)))
    rng = np.random.RandomState(0)
    xs = rng.rand(STEPS, B, 28, 28, 1).astype(np.float32)
    ys = rng.randint(0, 10, (STEPS, B))
    return dict(jcfg=jcfg, cfg=cfg, jmodel=jmodel, model=model, jvars=jvars,
                np_vars=jax.tree.map(np.asarray, jvars), xs=xs, ys=ys,
                rng=rng)


@pytest.fixture
def normals(monkeypatch):
    fake = _JaxNormals()
    monkeypatch.setattr(jax.random, "normal", fake)
    return fake


def _draw(rng, shapes):
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_variable_tree_matches(setup):
    """The port's own init has qbn_tpu's tree: names, shapes, init laws."""
    from qbn_tpu_torch.utils import init_variables
    tv = init_variables(setup["model"], torch.Generator().manual_seed(0),
                        (28, 28, 1), device="cpu")
    j = {p: np.asarray(v) for p, v in _leaves(setup["np_vars"])}
    t = {p: v.detach().numpy() for p, v in _leaves(tv)}
    assert j.keys() == t.keys()
    for p in j:
        assert j[p].shape == t[p].shape and j[p].dtype == t[p].dtype, p
        if p[-1] == "std":                   # constant init
            np.testing.assert_array_equal(t[p], j[p])
        elif p[-1] == "kernel":              # U(-0.01, 0.01)
            assert np.abs(t[p]).max() <= 0.01
        else:                                # the KL of its own init
            assert p[0] == "kl" and np.isfinite(t[p]) and t[p] > 0


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches(setup, normals, train):
    noise = _draw(setup["rng"], TRAIN_SHAPES if train else WEIGHT_SHAPES)
    normals.queue = list(noise)
    x = setup["xs"][0]
    jout, upd = setup["jmodel"].apply(
        setup["jvars"], jnp.asarray(x), train=train, mode="float",
        rngs=split_rngs(jax.random.PRNGKey(1)), mutable=["kl"])
    kl = {}
    out = setup["model"](torch.from_numpy(x),
                         from_jax_state(setup["np_vars"]), train=train,
                         noise=QueueNoise(noise), kl=kl)
    assert not normals.queue
    assert out.shape == (B, 10)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    jkl = dict(_leaves(jax.tree.map(np.asarray, upd["kl"])))
    tkl = dict(_leaves(kl))
    assert jkl.keys() == tkl.keys()
    for p in jkl:
        np.testing.assert_allclose(float(tkl[p]), jkl[p], rtol=1e-5)


def test_pointwise_lenet_forward_matches():
    """The deterministic blocks (pointwise LeNet of the mnist preset):
    qbn_tpu's init laws and tree, and the same probabilities; nothing is
    drawn and no KL is sown."""
    from qbn_tpu_torch.utils import init_variables
    jmodel = j_build(j_preset("pointwise", "mnist"))
    model = build_model(preset("pointwise", "mnist"))
    jvars = j_init(jmodel, jax.random.PRNGKey(4), jnp.zeros((B, 28, 28, 1)))
    tv = init_variables(model, torch.Generator().manual_seed(4), (28, 28, 1),
                        device="cpu")
    assert set(tv) == set(jvars) == {"params"}
    j = dict(_leaves(jax.tree.map(np.asarray, jvars["params"])))
    t = dict(_leaves(tv["params"]))
    assert j.keys() == t.keys() and "std" not in {p[-1] for p in t}
    for p in j:                     # U(-1/sqrt(fan_in), +1/sqrt(fan_in))
        fan_in = int(np.prod(j[p].shape[:-1]))
        assert t[p].shape == j[p].shape
        assert float(t[p].abs().max()) <= 1 / np.sqrt(fan_in)
    x = np.random.RandomState(5).rand(B, 28, 28, 1).astype(np.float32)
    jout = jmodel.apply(jvars, jnp.asarray(x), train=True, mode="float",
                        rngs=split_rngs(jax.random.PRNGKey(1)))
    kl = {}
    out = model(torch.from_numpy(x), from_jax_state(jax.tree.map(
        np.asarray, jvars)), train=True, noise=QueueNoise([]), kl=kl)
    assert kl == {"conv_0": {}, "conv_1": {}, "fc_0": {}, "fc_1": {}}
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)


def test_first_step_gradients_match(setup, normals):
    """Gradients of the ELBO (the 'batch' scaled loss of the preset) with
    respect to every parameter, same weights and noise."""
    jcfg, x, y = setup["jcfg"], setup["xs"][0], setup["ys"][0]
    noise = _draw(setup["rng"], TRAIN_SHAPES)

    def objective(params):
        out, upd = setup["jmodel"].apply(
            {**setup["jvars"], "params": params}, jnp.asarray(x),
            train=True, mode="float", rngs=split_rngs(jax.random.PRNGKey(2)),
            mutable=["kl"])
        return j_loss(out, jnp.asarray(y), j_sum_kl(upd["kl"]), jcfg.gamma,
                      N_BATCHES, N_BATCHES * B)[0]

    normals.queue = list(noise)
    jgrads = jax.grad(objective)(setup["jvars"]["params"])

    tvars = from_jax_state(setup["np_vars"], requires_grad=True)
    kl = {}
    out = setup["model"](torch.from_numpy(x), tvars, train=True,
                         noise=QueueNoise(noise), kl=kl)
    loss = classification_loss(out, torch.from_numpy(y), sum_kl(kl),
                               jcfg.gamma, N_BATCHES, N_BATCHES * B)[0]
    paths = [p for p, _ in _leaves(tvars["params"])]
    tgrads = torch.autograd.grad(loss, [v for _, v in
                                        _leaves(tvars["params"])])
    jg = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    for p, g in zip(paths, tgrads):
        np.testing.assert_allclose(g.numpy(), jg[p], rtol=1e-4, atol=1e-6,
                                   err_msg=str(p))


def _kl_float64(params, sigma_prior):
    """The summed KL of a params tree, in float64 with numpy."""
    total = 0.0
    for layer in params.values():
        mu = layer["kernel"].detach().numpy().astype(np.float64)
        sigma = np.logaddexp(layer["std"].detach().numpy()
                             .astype(np.float64), 0.0)
        total += 0.5 * np.sum(2 * np.log(sigma_prior / sigma) - 1
                              + (sigma / sigma_prior) ** 2
                              + (mu / sigma_prior) ** 2)
    return total


def _j_state(setup, jtx):
    params = setup["jvars"]["params"]
    return JState(params=params, model_state={"kl": setup["jvars"]["kl"]},
                  opt_state=jtx.init(params), step=jnp.zeros((), jnp.int32),
                  rng=jax.random.PRNGKey(1))


def _port_trainer(setup, noise):
    cfg = setup["cfg"]
    tx, _ = build_optimizer(cfg, N_BATCHES)
    trainer = Trainer(setup["model"], cfg, tx, "float", N_BATCHES,
                      N_BATCHES * B, QueueNoise(noise), "cpu")
    return trainer, trainer.init_state(
        from_jax_state(setup["np_vars"], requires_grad=True))


def test_three_adam_steps_match(setup, normals):
    jcfg = setup["jcfg"]
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    jstep = j_make_step(setup["jmodel"], jcfg, jtx, "float", N_BATCHES,
                        N_BATCHES * B, jit_compile=False)
    noise = [_draw(setup["rng"], TRAIN_SHAPES) for _ in range(STEPS)]
    trainer, tstate = _port_trainer(setup, [a for n in noise for a in n])
    jstate, jm = _j_state(setup, jtx), JM.cls_metrics_init()
    tm = TM.cls_metrics_init()
    for i in range(STEPS):
        normals.queue = list(noise[i])
        x, y = setup["xs"][i], setup["ys"][i]
        jstate, jm, jlogs = jstep(jstate, jm, jnp.asarray(x), jnp.asarray(y))
        kl64 = _kl_float64(tstate.params, jcfg.sigma_prior)
        tstate, tm, tlogs = trainer.train_step(
            tstate, tm, torch.from_numpy(x), torch.from_numpy(y),
            trainer.noise)
        for k, rtol in (("main_obj", 1e-5), ("obj", 1e-4), ("kl", 1e-4)):
            j, t = float(jlogs[k]), float(tlogs[k])
            assert abs(t - j) <= rtol * abs(j), (i, k, t, j)
        t = float(tlogs["kl"]) * B * N_BATCHES
        assert abs(t - kl64) <= 1e-6 * kl64, (i, t, kl64)
    assert tstate.step == STEPS and int(jstate.step) == STEPS
    assert int(tstate.opt_state["count"]) == STEPS
    jp = dict(_leaves(jax.tree.map(np.asarray, jstate.params)))
    for p, v in _leaves(tstate.params):
        np.testing.assert_allclose(v.detach().numpy(), jp[p], rtol=0,
                                   atol=1e-6, err_msg=str(p))
    for k in ("errors", "count", "nll_sum"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)


def test_nonfinite_loss_skips_the_step(setup, normals):
    """A batch with a NaN pixel: the loss is NaN, and params and optimiser
    state stay as they were, in both packages."""
    jcfg = setup["jcfg"]
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    jstep = j_make_step(setup["jmodel"], jcfg, jtx, "float", N_BATCHES,
                        N_BATCHES * B, jit_compile=False)
    noise = _draw(setup["rng"], TRAIN_SHAPES)
    x = setup["xs"][0].copy()
    x[0, 3, 3, 0] = np.nan
    y = setup["ys"][0]
    normals.queue = list(noise)
    j0 = _j_state(setup, jtx)
    j1, _, jlogs = jstep(j0, JM.cls_metrics_init(), jnp.asarray(x),
                         jnp.asarray(y))
    assert not np.isfinite(float(jlogs["obj"]))
    trainer, t0 = _port_trainer(setup, noise)
    t1, _, tlogs = trainer.train_step(t0, TM.cls_metrics_init(),
                                      torch.from_numpy(x),
                                      torch.from_numpy(y), trainer.noise)
    assert not np.isfinite(float(tlogs["obj"]))
    leaves = jax.tree_util.tree_leaves
    for a, b in zip(leaves((j0.params, j0.opt_state)),
                    leaves((j1.params, j1.opt_state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    before = dict(_leaves(to_numpy_state({"p": t0.params,
                                          "o": t0.opt_state})))
    after = dict(_leaves(to_numpy_state({"p": t1.params,
                                         "o": t1.opt_state})))
    assert before.keys() == after.keys()
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=str(k))


@pytest.mark.parametrize("method", ["pointwise", "mcdropout"])
def test_one_float_step_of_the_deterministic_lenets(monkeypatch, method):
    """One float training step of the mnist preset from qbn_tpu's init:
    MC-Dropout's three sites draw one mask each (per image and channel
    after the convs, per element after fc_0)."""
    rng = np.random.RandomState(6)
    masks = []

    def bernoulli(key, p=0.5, shape=None, *a, **k):
        arr = rng.rand(*shape) < float(p)
        masks.append(arr[None].astype(np.float32))
        return jnp.asarray(arr)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    jcfg, cfg = j_preset(method, "mnist"), preset(method, "mnist")
    jmodel, model = j_build(jcfg), build_model(cfg)
    jvars = j_init(jmodel, jax.random.PRNGKey(8), jnp.zeros((B, 28, 28, 1)))
    np_vars = jax.tree.map(np.asarray, jvars)
    x = rng.rand(B, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, B)
    jtx, _ = j_optimizer(jcfg, N_BATCHES)
    jstep = j_make_step(jmodel, jcfg, jtx, "float", N_BATCHES,
                        N_BATCHES * B, jit_compile=False)
    params = jvars["params"]
    j0 = JState(params=params, model_state={}, opt_state=jtx.init(params),
                step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(1))
    masks.clear()
    j1, _m, jlogs = jstep(j0, JM.cls_metrics_init(), jnp.asarray(x),
                          jnp.asarray(y))
    assert len(masks) == (3 if method == "mcdropout" else 0)
    tx, _ = build_optimizer(cfg, N_BATCHES)
    qmasks = QueueMasks(masks)
    trainer = Trainer(model, cfg, tx, "float", N_BATCHES, N_BATCHES * B,
                      QueueNoise([]), "cpu", masks=qmasks)
    t1, _m, tlogs = trainer.train_step(
        trainer.init_state(from_jax_state(np_vars)), TM.cls_metrics_init(),
        torch.from_numpy(x), torch.from_numpy(y), trainer.noise, qmasks)
    assert not qmasks.queue
    assert abs(float(tlogs["obj"]) - float(jlogs["obj"])) <= \
        1e-5 * abs(float(jlogs["obj"]))
    jp = dict(_leaves(jax.tree.map(np.asarray, j1.params)))
    d = np.concatenate([np.abs(v.detach().numpy() - jp[p]).reshape(-1)
                        for p, v in _leaves(t1.params)])
    n_off = int((d > 1e-6).sum())
    print(f"{method}: params max abs diff {d.max():.3g}, {n_off} of "
          f"{d.size} beyond 1e-6")
    assert d.max() <= 2 * cfg.learning_rate and n_off <= 1e-4 * d.size
