"""Optimisers and the per-epoch LR schedule (port of
qbn_tpu/training/optim.py: Adam with and without coupled L2 decay, SGD
with momentum, SGHMC (training/sghmc.py) behind the adaptive gradient
clip, cosine or constant LR).

Written in optax's functional form rather than as torch.optim's in-place
steps: `init(params) -> state` and `update(grads, state, params) ->
(updates, new_state)`, every state leaf a tensor on the params' device, so
that the trainer can keep or drop a whole step with `torch.where` (its
non-finite-loss skip) without a host round trip. The arithmetic follows
optax's: moments (1 - b) * g**k + b * m, bias correction m / (1 - b**t),
eps outside the square root, then the learning rate times -1.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from qbn_tpu_torch.utils import tree_leaves


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, *trees):
    """fn over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_unflatten(tree, it):
    """`tree`'s structure with its leaves taken from the iterator `it`."""
    if isinstance(tree, dict):
        return {k: tree_unflatten(v, it) for k, v in tree.items()}
    return next(it)


def chain(*transforms) -> GradientTransformation:
    """optax.chain: each transformation's updates feed the next; the
    state is {'0': first's, '1': second's, ...}."""
    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(grads, state, params):
        new = {}
        for i, t in enumerate(transforms):
            grads, new[str(i)] = t.update(grads, state[str(i)], params)
        return grads, new

    return GradientTransformation(init, update)


def clip_by_adaptive_global_norm(window: int = 1000, std_mul: float = 30.0,
                                 init_max: float = 1e20
                                 ) -> GradientTransformation:
    """Clip the gradients to max_grad, the mean + std_mul * std of the
    last `window` accepted global norms (qbn_tpu's transform). A norm at
    or above max_grad is clipped and not written to the buffer; max_grad
    moves only once `window` norms were accepted. As qbn_tpu's, the mean
    divides the buffer's sum by the count of accepted norms (past the
    window, more than the slots it sums), and the std is the population
    std over the filled slots about that mean."""
    def init(params):
        device = _first_leaf(params).device
        return {"buffer": torch.zeros((window,), device=device),
                "count": torch.zeros((), dtype=torch.int32, device=device),
                "max_grad": torch.tensor(init_max, dtype=torch.float32,
                                         device=device)}

    def update(grads, state, params=None):
        leaves = list(tree_leaves(grads))
        total = 0
        for g in leaves:                          # optax.global_norm
            total = total + torch.sum(g * g)
        norm = torch.sqrt(total)
        scale = torch.clamp(state["max_grad"] / (norm + 1e-12), max=1.0)
        clipped = tree_map(lambda g: g * scale, grads)
        accepted = norm < state["max_grad"]
        slots = torch.arange(window, device=norm.device)
        idx = state["count"] % window
        buffer = torch.where(accepted & (slots == idx), norm,
                             state["buffer"])
        count = state["count"] + accepted.to(torch.int32)
        mean = torch.sum(buffer) / torch.clamp(count, min=1)
        filled = (slots < torch.clamp(count, max=window)).to(torch.float32)
        var = (torch.sum(filled * (buffer - mean) ** 2)
               / torch.clamp(torch.sum(filled), min=1.0))
        max_grad = torch.where(count >= window,
                               mean + std_mul * torch.sqrt(var),
                               state["max_grad"])
        return clipped, {"buffer": buffer, "count": count,
                         "max_grad": max_grad}

    return GradientTransformation(init, update)


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


def build_optimizer(cfg, steps_per_epoch: int, sghmc_draws=None):
    """(transformation, schedule) for a config: Adam + cosine for float
    training, SGD with momentum for QAT fine-tuning, the adaptive clip and
    SGHMC for the sgld method (burn-in counted in steps: burnin_epochs x
    steps_per_epoch). sghmc_draws: SGHMC's draw source (training/sghmc.py;
    by default a generator on the params' device seeded with cfg.seed)."""
    if cfg.lr_schedule == "cosine":
        schedule = cosine_schedule(cfg.learning_rate, steps_per_epoch,
                                   cfg.epochs)
    else:
        schedule = cfg.learning_rate
    if cfg.optimizer == "adam":
        return adam(schedule, weight_decay=cfg.weight_decay), schedule
    if cfg.optimizer == "sgd":
        return sgd(schedule, momentum=cfg.momentum), schedule
    if cfg.optimizer == "sghmc":
        from qbn_tpu_torch.training.sghmc import sghmc
        return chain(clip_by_adaptive_global_norm(), sghmc(
            schedule, burnin_steps=cfg.burnin_epochs * steps_per_epoch,
            resample_momentum_every=cfg.resample_momentum_iterations,
            resample_prior_every=cfg.resample_prior_iterations,
            base_c=cfg.base_c, gauss_sig=cfg.gauss_sig, alpha0=cfg.alpha0,
            beta0=cfg.beta0, seed=cfg.seed, draws=sghmc_draws)), schedule
    raise ValueError(f"unknown optimizer '{cfg.optimizer}'")
