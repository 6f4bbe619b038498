"""Optimisers and the per-epoch LR schedule (port of
qbn_tpu/training/optim.py: Adam with and without coupled L2 decay, SGD
with momentum, cosine or constant LR).

Written in optax's functional form rather than as torch.optim's in-place
steps: `init(params) -> state` and `update(grads, state, params) ->
(updates, new_state)`, every state leaf a tensor on the params' device, so
that the trainer can keep or drop a whole step with `torch.where` (its
non-finite-loss skip) without a host round trip. The arithmetic follows
optax's: moments (1 - b) * g**k + b * m, bias correction m / (1 - b**t),
eps outside the square root, then the learning rate times -1.

SGHMC and the adaptive gradient clip are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _count(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=like.device)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def cosine_schedule(learning_rate: float, steps_per_epoch: int,
                    epochs: int):
    """torch CosineAnnealingLR stepped once per epoch, as a function of
    the int32 update count (float32 arithmetic, as qbn_tpu's)."""
    def schedule(count):
        epoch = torch.clamp(count // max(steps_per_epoch, 1), max=epochs)
        return learning_rate * 0.5 * (
            1.0 + torch.cos(math.pi * epoch / epochs))
    return schedule


def _lr_scale(schedule):
    """optax.scale_by_learning_rate: updates * -lr(count)."""
    def lr(count):
        if callable(schedule):
            return -1 * schedule(count)
        return torch.tensor(-1 * schedule, dtype=torch.float32,
                            device=count.device)
    return lr


def adam(schedule, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> GradientTransformation:
    """optax.adam(schedule), or with weight_decay the chain
    add_decayed_weights(wd) -> scale_by_adam -> scale_by_learning_rate
    (torch Adam's coupled L2: wd * p enters the moments)."""
    lr = _lr_scale(schedule)

    def init(params):
        like = _first_leaf(params)
        return {"count": _count(like),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "lr_count": _count(like)}

    def update(grads, state, params):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads,
                             params)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * g ** 2 + b2 * v, grads,
                      state["nu"])
        count = state["count"] + 1
        t = count.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
        step = lr(state["lr_count"])
        updates = tree_map(
            lambda m, v: step * ((m / bc1) / (torch.sqrt(v / bc2) + eps)),
            mu, nu)
        return updates, {"count": count, "mu": mu, "nu": nu,
                         "lr_count": state["lr_count"] + 1}

    return GradientTransformation(init, update)


def sgd(schedule, momentum: float) -> GradientTransformation:
    """optax.sgd(schedule, momentum): trace (g + momentum * t), then the
    learning rate."""
    lr = _lr_scale(schedule)

    def init(params):
        return {"lr_count": _count(_first_leaf(params)),
                "trace": tree_map(torch.zeros_like, params)}

    def update(grads, state, params):
        trace = tree_map(lambda g, t: g + momentum * t, grads,
                         state["trace"])
        step = lr(state["lr_count"])
        return tree_map(lambda g: step * g, trace), {
            "lr_count": state["lr_count"] + 1, "trace": trace}

    return GradientTransformation(init, update)


def build_optimizer(cfg, steps_per_epoch: int):
    """(transformation, schedule) for a config: Adam + cosine for float
    training, SGD with momentum for QAT fine-tuning."""
    if cfg.lr_schedule == "cosine":
        schedule = cosine_schedule(cfg.learning_rate, steps_per_epoch,
                                   cfg.epochs)
    else:
        schedule = cfg.learning_rate
    if cfg.optimizer == "adam":
        return adam(schedule, weight_decay=cfg.weight_decay), schedule
    if cfg.optimizer == "sgd":
        return sgd(schedule, momentum=cfg.momentum), schedule
    raise NotImplementedError(f"optimizer '{cfg.optimizer}' is not ported")
