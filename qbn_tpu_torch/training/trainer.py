"""Training step and a minimal epoch loop (port of make_train_step,
make_eval_step and the host loop of qbn_tpu/training/trainer.py), for
float training and QAT fine-tuning.

One step: forward with train=True and update_stats=True in the trainer's
mode ('float' or 'qat'), drawing from its noise and mask sources, so that
batch norm's running statistics ('batch_stats') and the observers
('quant') are updated; the KL of every Bayesian layer summed, the ELBO
loss, torch.autograd.grad, non-finite gradients zeroed, the optimiser's
functional update, and the whole update dropped when the loss is not
finite: params, optimiser state, running statistics and observers keep
their old values, chosen with torch.where on the device. Then the
metric-state update. As in qbn_tpu the 'kl' and 'qconst' collections keep
their values. Validation runs eval forwards (train=False); in 'qat' mode
they update the observers (never the running statistics), as qbn_tpu's
QAT validation does.

qbn_tpu's device-resident epoch scans, SGHMC snapshots and mesh-sharded
steps are not ported; the loop runs over given (x, y) batches.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.training import metrics as M
from qbn_tpu_torch.training.losses import classification_loss
from qbn_tpu_torch.training.optim import tree_map
from qbn_tpu_torch.utils import (
    apply_model, full_float32, resolve_device, tree_leaves)

# the collections a training forward writes
STATS = ("batch_stats", "quant")


@dataclasses.dataclass
class TrainState:
    params: dict          # leaves require grad
    model_state: dict     # the other collections ('batch_stats', 'quant',
    opt_state: dict       # 'qconst', 'kl')
    step: int = 0


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(v, it) for k, v in tree.items()}
    return next(it)


def make_train_step(model, cfg: Config, tx, mode: str, n_batches: int,
                    n_points: int):
    """The training step: step(state, metric_state, x, y, noise, masks) ->
    (state, metric_state, logs), x (B, H, W, C) float32 and y (B,) int64
    on the params' device, noise a noise source, masks a mask source (for
    MC-Dropout; one mask per site and step)."""
    if cfg.task != "classification":
        raise NotImplementedError("only classification training is ported")

    def step(state: TrainState, metric_state, x, y, noise, masks=None):
        with full_float32():
            out, kl, new_vars = apply_model(
                model, {"params": state.params, **state.model_state}, x,
                train=True, mode=mode, update_stats=True, noise=noise,
                masks=masks)
            loss, main, kl_t = classification_loss(
                out, y, kl, cfg.gamma, n_batches, n_points,
                scaling=cfg.loss_scaling,
                loss_multiplier=cfg.loss_multiplier)
            grads = torch.autograd.grad(loss, list(tree_leaves(state.params)))
        with torch.no_grad():
            # zero non-finite grads; skip the whole step on a non-finite
            # loss (qbn_tpu/training/trainer.py:98-127), the running
            # statistics and observers included: one overflowing batch
            # would otherwise poison them for good
            grads = _unflatten(state.params, iter(
                torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                for g in grads))
            ok = torch.isfinite(loss)

            def keep(new, old):
                return tree_map(lambda n, o: torch.where(ok, n, o), new, old)

            params = tree_map(torch.Tensor.detach, state.params)
            upd, new_opt = tx.update(grads, state.opt_state, params)
            new_params = keep(tree_map(torch.add, params, upd), params)
            new_opt = keep(new_opt, state.opt_state)
            model_state = dict(state.model_state)
            for col in STATS:
                if new_vars.get(col) is not state.model_state.get(col):
                    model_state[col] = keep(new_vars[col],
                                            state.model_state[col])
            metric_state = M.cls_metrics_update(metric_state, out.detach(),
                                                y)
        new_params = tree_map(lambda p: p.requires_grad_(), new_params)
        logs = {"obj": loss.detach(), "main_obj": main.detach(),
                "kl": kl_t.detach()}
        return (TrainState(new_params, model_state, new_opt,
                           state.step + 1), metric_state, logs)

    return step


def make_eval_step(model, cfg: Config, mode: str, update_observers: bool):
    """The validation step: step(state, metric_state, x, y, noise, masks)
    -> (state, metric_state); no gradient, no running-statistics update;
    the observers update iff update_observers (QAT validation)."""
    if cfg.task != "classification":
        raise NotImplementedError("only classification training is ported")

    def step(state: TrainState, metric_state, x, y, noise, masks=None):
        with torch.no_grad(), full_float32():
            out, _kl, new_vars = apply_model(
                model, {"params": state.params, **state.model_state}, x,
                train=False, mode=mode, update_stats=update_observers,
                noise=noise, masks=masks)
            model_state = {k: v for k, v in new_vars.items()
                           if k != "params"}
            metric_state = M.cls_metrics_update(metric_state, out, y)
        return dataclasses.replace(state, model_state=model_state), \
            metric_state

    return step


class Trainer:
    """Epoch loop around the training step, over given (x, y) batches."""

    def __init__(self, model, cfg: Config, tx, mode: str, n_batches: int,
                 n_points: int, noise, device="cuda", masks=None):
        self.model, self.cfg, self.tx, self.mode = model, cfg, tx, mode
        self.noise, self.masks = noise, masks
        self.device = resolve_device(device)
        self.train_step = make_train_step(model, cfg, tx, mode, n_batches,
                                          n_points)
        self.eval_step = make_eval_step(model, cfg, mode,
                                        update_observers=mode == "qat")
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
                state, metric_state, x, y, self.noise, self.masks)
        out = {k: float(v) for k, v in M.cls_metrics_compute(
            metric_state).items()}
        out.update({k: float(v) for k, v in logs.items()})
        return state, out

    def eval_epoch(self, state: TrainState, batches: Iterable,
                   seed: int = 0):
        """Validation: eval-mode forwards (one weight sample and one mask
        per site and batch), no gradient; in 'qat' mode the observers
        update. Returns (state, metrics). The samples come from the pass's
        own generator, seeded from cfg.seed + 17 with `seed` (the epoch)
        folded in, as qbn_tpu keys its eval (PRNGKey(cfg.seed + 17),
        fold_in seed * 100003): never from the training sources, so the
        training draws do not depend on whether validation runs."""
        metric_state = M.cls_metrics_init(device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            (self.cfg.seed + 17) * 1_000_003 + seed * 100_003)
        noise, masks = GeneratorNoise(gen), BernoulliMasks(gen, 1)
        for x, y in batches:
            x, y = self._tensors(x, y)
            state, metric_state = self.eval_step(state, metric_state, x, y,
                                                 noise, masks)
        return state, {k: float(v) for k, v in M.cls_metrics_compute(
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
                state, row["valid"] = self.eval_epoch(state, valid_batches,
                                                      seed=epoch)
            self.history.append(row)
        return state
