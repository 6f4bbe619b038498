"""qbn_tpu_torch.training.optim and losses against qbn_tpu's (optax).

The same gradients (numpy, from a seed) go through qbn_tpu's optax chain
and the port's functional optimiser for several steps across epoch
boundaries of the cosine schedule. Both compute in float32 with the same
order of operations, so updates agree to a few ulps: rtol 1e-6, atol 1e-9.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qbn_tpu.config import Config as JConfig
from qbn_tpu.training.losses import classification_loss as j_cls
from qbn_tpu.training.losses import regression_loss as j_reg
from qbn_tpu.training.optim import build_optimizer as j_build

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.training.losses import classification_loss, regression_loss
from qbn_tpu_torch.training.optim import build_optimizer

SHAPES = {"a": {"kernel": (6, 5), "std": (6, 5)}, "b": {"kernel": (7,)}}


def _tree(rng, scale=1.0):
    return {m: {k: (rng.randn(*s) * scale).astype(np.float32)
                for k, s in p.items()} for m, p in SHAPES.items()}


def _flat(tree):
    return [tree[m][k] for m in SHAPES for k in SHAPES[m]]


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam"),
    dict(optimizer="adam", weight_decay=1e-4),
    dict(optimizer="adam", lr_schedule="constant"),
    dict(optimizer="sgd", momentum=0.9, learning_rate=1e-2),
], ids=["adam", "adam_l2", "adam_constant", "sgd_momentum"])
def test_updates_match_optax(kw):
    rng = np.random.RandomState(0)
    steps_per_epoch, epochs = 2, 3
    jtx, jsched = j_build(JConfig(epochs=epochs, **kw), steps_per_epoch)
    tx, sched = build_optimizer(Config(epochs=epochs, **kw), steps_per_epoch)
    params = _tree(rng, 0.1)
    jp = {m: {k: jnp.asarray(v) for k, v in p.items()}
          for m, p in params.items()}
    tp = {m: {k: torch.from_numpy(v.copy()) for k, v in p.items()}
          for m, p in params.items()}
    jstate, tstate = jtx.init(jp), tx.init(tp)
    for step in range(2 * epochs * steps_per_epoch):
        g = _tree(rng)
        if step == 1:
            g["a"]["kernel"][0, 0] = 1e-9        # Adam's near-zero case
        jg = {m: {k: jnp.asarray(v) for k, v in p.items()}
              for m, p in g.items()}
        tg = {m: {k: torch.from_numpy(v) for k, v in p.items()}
              for m, p in g.items()}
        jupd, jstate = jtx.update(jg, jstate, jp)
        tupd, tstate = tx.update(tg, tstate, tp)
        for a, b in zip(_flat(tupd), _flat(jupd)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9, err_msg=f"step {step}")
        jp = optax.apply_updates(jp, jupd)
        tp = {m: {k: tp[m][k] + tupd[m][k] for k in tp[m]} for m in tp}
    if callable(jsched):
        for count in range(2 * epochs * steps_per_epoch):
            np.testing.assert_allclose(
                float(sched(torch.tensor(count, dtype=torch.int32))),
                float(jsched(jnp.asarray(count, jnp.int32))), rtol=1e-7)


@pytest.mark.parametrize("scaling", ["batch", "whole"])
def test_losses_match(scaling):
    rng = np.random.RandomState(1)
    logits = rng.randn(6, 10).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    probs[0, 3] = 0.0                       # the 1e-8 under the log
    y = rng.randint(0, 10, 6)
    y[0] = 3
    kw = dict(kl=123.5, gamma=0.1, n_batches=4, n_points=24,
              scaling=scaling, loss_multiplier=2.0)
    want = j_cls(jnp.asarray(probs), jnp.asarray(y), **kw)
    got = classification_loss(torch.from_numpy(probs), torch.from_numpy(y),
                              **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
    mu, var = rng.randn(6, 2).astype(np.float32), rng.rand(6, 2).astype(
        np.float32)
    t = rng.randn(6, 2).astype(np.float32)
    want = j_reg((jnp.asarray(mu), jnp.asarray(var)), jnp.asarray(t), **kw)
    got = regression_loss((torch.from_numpy(mu), torch.from_numpy(var)),
                          torch.from_numpy(t), **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-6)

