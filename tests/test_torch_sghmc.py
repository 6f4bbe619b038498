"""SGHMC and the adaptive gradient clip (qbn_tpu_torch.training.sghmc and
optim): the port against qbn_tpu's optax transforms, on the CPU.

Both packages see the same draws: qbn_tpu's `jax.random.normal` and
`jax.random.gamma` are replaced (pytest monkeypatch) by functions that
hand out arrays made with numpy, in the order qbn_tpu draws them (per
tensor in its sorted leaf order: the Gamma, the momentum normal, the
noise normal); the port gets the same arrays per tensor through
`QueueDraws`. The params tree's keys are not in sorted order, so that the
two leaf orders differ.

Tolerances and why:
- one step from a common state: every update and state leaf within rtol
  1e-6 (atol 1e-12): the same float32 formulas; the global norm and
  |p|^2 are sums in another order;
- a chain of CHAIN_STEPS steps across the burn-in boundary and several
  resampling periods, each package from its own previous state, and the
  sgld presets' chains (the clip, then SGHMC): the same bound after every
  step, rtol 1e-6 (atol 1e-12). Differences could compound through the
  preconditioner (v_hat enters as 1/sqrt) and the momentum; at these
  inputs the chain's params agree bitwise (the worst relative difference
  is printed);
- the clip: buffer, count and threshold within rtol 1e-6, the clipped
  gradients within rtol 1e-6, the same steps accepted and rejected.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training.optim import build_optimizer as j_build
from qbn_tpu.training.optim import clip_by_adaptive_global_norm as j_clip
from qbn_tpu.training.sghmc import sghmc as j_sghmc

from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training.optim import (
    build_optimizer, clip_by_adaptive_global_norm)
from qbn_tpu_torch.training.sghmc import QueueDraws, sghmc
from qbn_tpu_torch.utils import tree_leaves

# keys out of sorted order on purpose
SHAPES = {"b": {"kernel": (6, 5), "bias": (5,)}, "a": {"kernel": (4, 3)}}
PATHS = [("b", "kernel"), ("b", "bias"), ("a", "kernel")]     # port order
J_PATHS = sorted(PATHS)                                       # jax order
CHAIN_STEPS = 9
KW = dict(learning_rate=1e-2, burnin_steps=4, resample_momentum_every=3,
          resample_prior_every=2, base_c=0.05, gauss_sig=0.1, alpha0=10.0,
          beta0=10.0)


def _tree(rng, scale=1.0):
    return {m: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                for k, s in p.items()} for m, p in SHAPES.items()}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    """Tensor leaves in the port's (SHAPES) key order."""
    return {m: {k: torch.from_numpy(np.array(tree[m][k])) for k in p}
            for m, p in SHAPES.items()}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class JaxDraws:
    """Stands in for jax.random.normal and jax.random.gamma: one step's
    draws per tensor, handed out in qbn_tpu's call order."""

    def __init__(self):
        self.queue = []

    def load(self, step):
        """step: {path: (momentum normal, noise normal, gamma)}."""
        for path in J_PATHS:
            mom, noise, gamma = step[path]
            self.queue += [("gamma", gamma), ("normal", mom),
                           ("normal", noise)]

    def normal(self, key, shape=(), dtype=jnp.float32, *a, **k):
        kind, arr = self.queue.pop(0)
        assert kind == "normal" and arr.shape == tuple(shape)
        return jnp.asarray(arr, dtype)

    def gamma(self, key, a, shape=None, dtype=jnp.float32, *args, **kw):
        kind, arr = self.queue.pop(0)
        assert kind == "gamma"
        return jnp.asarray(arr, dtype)


@pytest.fixture
def draws(monkeypatch):
    fake = JaxDraws()
    monkeypatch.setattr(jax.random, "normal", fake.normal)
    monkeypatch.setattr(jax.random, "gamma", fake.gamma)
    return fake


def _make_draws(rng, alpha0=KW["alpha0"]):
    """One step's draws: {path: (normal, normal, Gamma(alpha0 + n/2))}."""
    out = {}
    for m, p in SHAPES.items():
        for k, s in p.items():
            alpha = alpha0 + np.prod(s) / 2.0
            out[(m, k)] = (rng.standard_normal(s).astype(np.float32),
                           rng.standard_normal(s).astype(np.float32),
                           np.float32(rng.gamma(alpha)))
    return out


def _port_steps(steps):
    return [[step[p] for p in PATHS] for step in steps]


def _assert_state(tstate, jstate, rtol, atol, what):
    """The port's SGHMC state dict against qbn_tpu's SGHMCState."""
    assert int(tstate["count"]) == int(jstate.count), what
    for name in ("tau", "g", "v_hat", "momentum", "weight_decay"):
        for p in PATHS:
            np.testing.assert_allclose(
                _get(tstate[name], p).numpy(),
                np.asarray(_get(getattr(jstate, name), p)), rtol=rtol,
                atol=atol, err_msg=f"{what} {name} {p}")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-9)))


def test_one_step_from_a_common_state(draws):
    """Each step of the chain below, started from qbn_tpu's state before
    it: updates and state within rtol 1e-6."""
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.1)
    jtx = j_sghmc(**KW)
    jstate = jtx.init(_jax(params))
    for step in range(CHAIN_STEPS):
        grads, d = _tree(rng), _make_draws(rng)
        tx = sghmc(**KW, draws=QueueDraws(_port_steps([d])))
        tstate = tx.init(_torch(params))
        # qbn_tpu's state before this step, carried across
        tstate.update(count=torch.tensor(int(jstate.count),
                                         dtype=torch.int32))
        for name in ("tau", "g", "v_hat", "momentum", "weight_decay"):
            tstate[name] = _torch(jax.tree.map(np.asarray,
                                               getattr(jstate, name)))
        draws.load(d)
        jupd, jstate = jtx.update(_jax(grads), jstate, _jax(params))
        tupd, tstate = tx.update(_torch(grads), tstate, _torch(params))
        assert not draws.queue
        for p in PATHS:
            np.testing.assert_allclose(
                _get(tupd, p).numpy(), np.asarray(_get(jupd, p)),
                rtol=1e-6, atol=1e-12, err_msg=f"step {step} update {p}")
        _assert_state(tstate, jstate, 1e-6, 1e-12, f"step {step}")
        params = jax.tree.map(np.asarray,
                              optax.apply_updates(_jax(params), jupd))


def test_chain_across_burn_in_and_resampling(draws):
    """CHAIN_STEPS steps, each package from its own state: burn-in ends
    after step 4, the momentum is resampled at steps 0, 3, 6, the prior
    at 0, 2, 4, 6, 8."""
    rng = np.random.default_rng(1)
    params = _tree(rng, 0.1)
    steps = [(_tree(rng), _make_draws(rng)) for _ in range(CHAIN_STEPS)]
    jtx = j_sghmc(**KW)
    tx = sghmc(**KW, draws=QueueDraws(_port_steps([d for _, d in steps])))
    jp, tp = _jax(params), _torch(params)
    jstate, tstate = jtx.init(jp), tx.init(tp)
    worst = 0.0
    for i, (grads, d) in enumerate(steps):
        draws.load(d)
        jupd, jstate = jtx.update(_jax(grads), jstate, jp)
        tupd, tstate = tx.update(_torch(grads), tstate, tp)
        jp = optax.apply_updates(jp, jupd)
        tp = {m: {k: tp[m][k] + tupd[m][k] for k in tp[m]} for m in tp}
        for p in PATHS:
            worst = max(worst, _rel(_get(tp, p).numpy(), _get(jp, p)))
            np.testing.assert_allclose(_get(tp, p).numpy(),
                                       np.asarray(_get(jp, p)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"step {i} {p}")
        _assert_state(tstate, jstate, 1e-6, 1e-12, f"step {i}")
    print(f"params after {CHAIN_STEPS} chained steps: worst relative "
          f"difference {worst:.3g}")
    assert int(tstate["count"]) == CHAIN_STEPS


def test_generator_draws_are_on_the_params_device_and_seeded():
    """Without a draw source the transform draws from a generator on the
    params' device seeded with `seed`: the same seed gives the same
    chain, another seed another."""
    rng = np.random.default_rng(2)
    params, grads = _torch(_tree(rng, 0.1)), _torch(_tree(rng))
    outs = []
    for seed in (5, 5, 6):
        tx = sghmc(**KW, seed=seed)
        st = tx.init(params)
        upd, st = tx.update(grads, st, params)
        outs.append(torch.cat([u.reshape(-1) for u in tree_leaves(upd)]))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    assert all(torch.isfinite(o).all() for o in outs)


def test_nonfinite_momentum_is_scrubbed():
    """An inf gradient makes the momentum non-finite; it is set to 0, as
    qbn_tpu's scrub does (the trainer zeroes such gradients before)."""
    rng = np.random.default_rng(3)
    params = _torch(_tree(rng, 0.1))
    grads = _torch(_tree(rng))
    grads["a"]["kernel"][0, 0] = float("inf")
    d = _make_draws(rng)
    tx = sghmc(**KW, draws=QueueDraws(_port_steps([d])))
    upd, _st = tx.update(grads, tx.init(params), params)
    assert all(torch.isfinite(u).all() for u in tree_leaves(upd))
    assert float(upd["a"]["kernel"][0, 0]) == 0.0


def _norm_schedule(rng):
    """Gradients whose global norms fill a window of 4, then one far above
    the threshold (clipped, not buffered), then more past the window."""
    scales = [1.0, 1.1, 0.9, 1.05, 1.0, 50.0, 0.95, 1.2, 200.0, 1.0, 0.8]
    return [_tree(rng, s) for s in scales]


def test_adaptive_clip_matches():
    rng = np.random.default_rng(4)
    window = 4
    jtx, tx = j_clip(window=window), clip_by_adaptive_global_norm(
        window=window)
    grads0 = _tree(rng)
    jstate, tstate = jtx.init(_jax(grads0)), tx.init(_torch(grads0))
    rejected = []
    for i, g in enumerate(_norm_schedule(rng)):
        jg, jstate = jtx.update(_jax(g), jstate)
        tg, tstate = tx.update(_torch(g), tstate)
        for p in PATHS:
            np.testing.assert_allclose(_get(tg, p).numpy(),
                                       np.asarray(_get(jg, p)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"step {i} {p}")
        assert int(tstate["count"]) == int(jstate.count), i
        np.testing.assert_allclose(tstate["buffer"].numpy(),
                                   np.asarray(jstate.buffer), rtol=1e-6)
        np.testing.assert_allclose(float(tstate["max_grad"]),
                                   float(jstate.max_grad), rtol=1e-6)
        if not np.array_equal(np.asarray(_get(jg, PATHS[0])),
                              _get(g, PATHS[0])):
            rejected.append(i)
    # the threshold moved once the window filled, and the two large
    # gradients were clipped to it
    assert float(tstate["max_grad"]) < 1e19
    assert rejected == [5, 8]
    assert int(tstate["count"]) == len(_norm_schedule(rng)) - 2


@pytest.mark.parametrize("tier", ["regression", "mnist", "cifar"])
def test_sgld_preset_chain_matches(draws, tier):
    """build_optimizer of each sgld preset (the adaptive clip, then SGHMC
    at a constant LR), 2 steps an epoch and 2 burn-in epochs, 6 steps:
    updates within rtol 1e-6, as the chain above."""
    steps_per_epoch = 2
    over = dict(burnin_epochs=2)
    jtx, _ = j_build(j_preset("sgld", tier, **over), steps_per_epoch)
    rng = np.random.default_rng(5)
    params = _tree(rng, 0.1)
    cfg = preset("sgld", tier, **over)
    steps = [(_tree(rng), _make_draws(rng, cfg.alpha0)) for _ in range(6)]
    tx, sched = build_optimizer(cfg, steps_per_epoch, sghmc_draws=QueueDraws(
        _port_steps([d for _, d in steps])))
    assert sched == cfg.learning_rate                  # constant LR
    jp, tp = _jax(params), _torch(params)
    jstate, tstate = jtx.init(jp), tx.init(tp)
    for i, (grads, d) in enumerate(steps):
        draws.load(d)
        jupd, jstate = jtx.update(_jax(grads), jstate, jp)
        tupd, tstate = tx.update(_torch(grads), tstate, tp)
        for p in PATHS:
            np.testing.assert_allclose(_get(tupd, p).numpy(),
                                       np.asarray(_get(jupd, p)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"step {i} {p}")
        jp = optax.apply_updates(jp, jupd)
        tp = {m: {k: tp[m][k] + tupd[m][k] for k in tp[m]} for m in tp}
    clip, sg = jstate
    assert int(tstate["0"]["count"]) == int(clip.count) == 6
    _assert_state(tstate["1"], sg, 1e-6, 1e-12, f"{tier} after 6 steps")
