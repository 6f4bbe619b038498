"""Training step and a minimal epoch loop (port of make_train_step and the
host loop of qbn_tpu/training/trainer.py, float mode).

One step: forward with train=True drawing from the trainer's noise
source, the KL of every Bayesian layer summed, the ELBO loss,
torch.autograd.grad, non-finite gradients zeroed, the optimiser's
functional update, and the whole update dropped when the loss is not
finite (params and optimiser state keep their old values, chosen with
torch.where on the device), then the metric-state update. As in qbn_tpu
the 'kl' collection of the state keeps its init values; no ported float
module has mutable statistics yet (batch norm's running stats join the
skip when batch-norm float training is ported).

qbn_tpu's device-resident epoch scans, SGHMC snapshots and mesh-sharded
steps are not ported; the loop runs over given (x, y) batches.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.ops.stochastic import GeneratorNoise
from qbn_tpu_torch.training import metrics as M
from qbn_tpu_torch.training.losses import classification_loss
from qbn_tpu_torch.training.optim import tree_map
from qbn_tpu_torch.utils import (
    full_float32, resolve_device, sum_kl, tree_leaves)


@dataclasses.dataclass
class TrainState:
    params: dict          # leaves require grad
    model_state: dict     # the other collections ('kl')
    opt_state: dict
    step: int = 0


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    return next(it)


def make_train_step(model, cfg: Config, tx, mode: str, n_batches: int,
                    n_points: int):
    """The training step: step(state, metric_state, x, y, noise) ->
    (state, metric_state, logs), x (B, H, W, C) float32 and y (B,) int64
    on the params' device, noise a noise source."""
    if cfg.task != "classification":
        raise NotImplementedError("only classification training is ported")

    def step(state: TrainState, metric_state, x, y, noise):
        kl_tree: dict = {}
        with full_float32():
            out = model(x, {"params": state.params, **state.model_state},
                        train=True, mode=mode, noise=noise, kl=kl_tree)
            kl = sum_kl(kl_tree)
            loss, main, kl_t = classification_loss(
                out, y, kl, cfg.gamma, n_batches, n_points,
                scaling=cfg.loss_scaling,
                loss_multiplier=cfg.loss_multiplier)
            grads = torch.autograd.grad(loss, list(tree_leaves(state.params)))
        with torch.no_grad():
            # zero non-finite grads; skip the whole step on a non-finite
            # loss (qbn_tpu/training/trainer.py:98-127)
            grads = _unflatten(state.params, iter(
                torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                for g in grads))
            ok = torch.isfinite(loss)
            params = tree_map(torch.Tensor.detach, state.params)
            upd, new_opt = tx.update(grads, state.opt_state, params)
            new_params = tree_map(
                lambda p, u: torch.where(ok, p + u, p), params, upd)
            new_opt = tree_map(lambda n, o: torch.where(ok, n, o), new_opt,
                               state.opt_state)
            metric_state = M.cls_metrics_update(metric_state, out.detach(),
                                                y)
        new_params = tree_map(lambda p: p.requires_grad_(), new_params)
        logs = {"obj": loss.detach(), "main_obj": main.detach(),
                "kl": kl_t.detach()}
        return (TrainState(new_params, state.model_state, new_opt,
                           state.step + 1), metric_state, logs)

    return step


class Trainer:
    """Epoch loop around the training step, over given (x, y) batches."""

    def __init__(self, model, cfg: Config, tx, mode: str, n_batches: int,
                 n_points: int, noise, device="cuda"):
        self.model, self.cfg, self.tx, self.mode = model, cfg, tx, mode
        self.noise = noise
        self.device = resolve_device(device)
        self.train_step = make_train_step(model, cfg, tx, mode, n_batches,
                                          n_points)
        self.history: list = []

    def init_state(self, variables) -> TrainState:
        """The state of a variable tree on the trainer's device: params as
        leaves that require grad, a fresh optimiser state."""
        params = tree_map(lambda p: p.detach().to(self.device)
                          .requires_grad_(), variables["params"])
        model_state = {k: tree_map(lambda t: t.detach().to(self.device), v)
                       for k, v in variables.items() if k != "params"}
        return TrainState(params=params, model_state=model_state,
                          opt_state=self.tx.init(
                              tree_map(torch.Tensor.detach, params)))

    def variables(self, state: TrainState):
        return {"params": state.params, **state.model_state}

    def _tensors(self, x, y):
        return (torch.as_tensor(x, dtype=torch.float32, device=self.device),
                torch.as_tensor(y, dtype=torch.int64, device=self.device))

    def train_epoch(self, state: TrainState, batches: Iterable):
        """One pass over (x, y) batches; returns (state, train metrics and
        the last step's logs, as floats)."""
        metric_state = M.cls_metrics_init(device=self.device)
        logs = {}
        for x, y in batches:
            x, y = self._tensors(x, y)
            state, metric_state, logs = self.train_step(
                state, metric_state, x, y, self.noise)
        out = {k: float(v) for k, v in M.cls_metrics_compute(
            metric_state).items()}
        out.update({k: float(v) for k, v in logs.items()})
        return state, out

    def eval_epoch(self, state: TrainState, batches: Iterable,
                   seed: int = 0):
        """Validation metrics: eval-mode forwards (one weight sample per
        batch), no gradient. The weight samples come from the pass's own
        generator, seeded from cfg.seed + 17 with `seed` (the epoch)
        folded in, as qbn_tpu keys its eval (PRNGKey(cfg.seed + 17),
        fold_in seed * 100003): never from the training noise, so the
        training trajectory does not depend on whether validation runs."""
        metric_state = M.cls_metrics_init(device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            (self.cfg.seed + 17) * 1_000_003 + seed * 100_003)
        noise = GeneratorNoise(gen)
        with torch.no_grad(), full_float32():
            for x, y in batches:
                x, y = self._tensors(x, y)
                out = self.model(x, self.variables(state), train=False,
                                 mode=self.mode, noise=noise)
                metric_state = M.cls_metrics_update(metric_state, out, y)
        return {k: float(v) for k, v in M.cls_metrics_compute(
            metric_state).items()}

    def fit(self, state: TrainState, train_batches,
            valid_batches: Optional[list] = None):
        """cfg.epochs epochs; the LR follows the schedule of the
        optimiser's update count. Appends one dict per epoch to
        self.history and returns the final state."""
        for epoch in range(self.cfg.epochs):
            state, train_m = self.train_epoch(state, train_batches)
            row = {"epoch": epoch, "train": train_m}
            if valid_batches is not None:
                row["valid"] = self.eval_epoch(state, valid_batches,
                                               seed=epoch)
            self.history.append(row)
        return state
