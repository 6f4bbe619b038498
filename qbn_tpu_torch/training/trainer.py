"""Training and validation steps and the epoch loop with its checkpoint
policy (port of make_train_step, make_eval_step, key_metric and
train_loop of qbn_tpu/training/trainer.py), for float training and QAT
fine-tuning, classification and regression.

One step: forward with train=True and update_stats=True in the trainer's
mode ('float' or 'qat'), drawing from its noise and mask sources, so that
batch norm's running statistics ('batch_stats') and the observers
('quant') are updated; the KL of every Bayesian layer summed, the ELBO
loss (classification: the NLL of the probabilities; regression: the
heteroscedastic Gaussian NLL of the model's (mu, var) against (B, 1)
float32 targets), torch.autograd.grad, non-finite gradients zeroed, the
optimiser's functional update (Adam, SGD or the adaptive clip and
SGHMC), and the whole update dropped when the loss is not finite: params,
optimiser state (SGHMC's and the clip's included), running statistics and
observers keep their old values, chosen with torch.where on the device.
Then the metric-state update. A step is the span `train.step`
(profiling.span), with `train.forward` (model and loss),
`train.backward` (torch.autograd.grad) and `train.update` (the
optimiser's update and the metric update) inside. As in qbn_tpu the
'kl' and 'qconst' collections keep their values. Validation runs eval
forwards (train=False); in 'qat' mode they update the observers (never
the running statistics), as qbn_tpu's QAT validation does.

With a process group (`group`), the step is one rank's share of a
data-parallel step (parallel/sharded.py): the forward runs under
`ops.collectives.data_parallel` (batch norm and the observers reduce over
the group), the gradients and the loss are summed over the ranks in one
all-reduce and divided by the group's size (the KL term, the same on
every rank, so counts once), the non-finite gradients are zeroed after
it, the skip follows the global loss, so every rank keeps or drops the
update together, and the metric increment is summed over the ranks.

qbn_tpu's device-resident epoch scans are not ported; the loop runs over
(x, y) batches, a loader's afresh each epoch. With cfg.debug every pass
stops after its first batch, as qbn_tpu's does. With a mesh, the
Trainer takes the sharded steps where a batch divides over the mesh's
devices (qbn_tpu's gate) and the one-process steps, on every rank alike,
where it does not; rank 0 alone writes the checkpoints and the scalars.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Iterable, Optional

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.ops.collectives import all_reduce_sum, data_parallel
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.profiling import span
from qbn_tpu_torch.training import metrics as M
from qbn_tpu_torch.training.checkpoint import checkpoint_path, save_variables
from qbn_tpu_torch.training.losses import classification_loss, regression_loss
from qbn_tpu_torch.training.optim import tree_map, tree_unflatten
from qbn_tpu_torch.utils import (
    apply_model, full_float32, resolve_device, tree_leaves)

log = logging.getLogger(__name__)

# the collections a training forward writes
STATS = ("batch_stats", "quant")
# save-last writes its file every this many epochs and after the last
# (qbn_tpu's default QBN_CKPT_FLUSH); the final file is the last state
CKPT_FLUSH_EVERY = 25


@dataclasses.dataclass
class TrainState:
    params: dict          # leaves require grad
    model_state: dict     # the other collections ('batch_stats', 'quant',
    opt_state: dict       # 'qconst', 'kl')
    step: int = 0


def metrics_init(task: str, device="cpu"):
    return (M.cls_metrics_init(device=device) if task == "classification"
            else M.reg_metrics_init(device=device))


def metrics_update(task: str, state, out, target):
    if task == "classification":
        return M.cls_metrics_update(state, out, target)
    mu, var = out
    return M.reg_metrics_update(state, mu, var, target)


def metrics_compute(task: str, state):
    return (M.cls_metrics_compute(state) if task == "classification"
            else M.reg_metrics_compute(state))


def _detached(out):
    return tuple(o.detach() for o in out) if isinstance(out, tuple) \
        else out.detach()


def _update_metrics(task, metric_state, out, y, group):
    """The metric state with one batch added; with a group, the batch's
    increment summed over the ranks first."""
    if group is None:
        return metrics_update(task, metric_state, out, y)
    inc = metrics_update(task, metrics_init(task, y.device), out, y)
    return M.add(metric_state, M.all_reduce(inc, group))


def apply_update(tx, state: TrainState, grads, loss, new_vars):
    """The end of a training step, without autograd: (params, model
    state, optimiser state) after the update of `grads` (a list in the
    order of the params' leaves), or the old ones where the loss is not
    finite."""
    # zero non-finite grads; skip the whole step on a non-finite loss
    # (qbn_tpu/training/trainer.py:98-127), the running statistics and
    # observers included: one overflowing batch would otherwise poison
    # them for good
    grads = tree_unflatten(state.params, iter(
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
            model_state[col] = keep(new_vars[col], state.model_state[col])
    return new_params, model_state, new_opt


def make_train_step(model, cfg: Config, tx, mode: str, n_batches: int,
                    n_points: int, group=None):
    """The training step: step(state, metric_state, x, y, noise, masks) ->
    (state, metric_state, logs), x (B, ...) float32 and y (B,) int64
    labels or (B, 1) float32 targets on the params' device, noise a noise
    source, masks a mask source (for MC-Dropout; one mask per site and
    step). group: the process group of a data-parallel step (see the
    module docstring); x and y are then this rank's rows."""
    task = cfg.task
    loss_fn = (classification_loss if task == "classification"
               else regression_loss)

    def step(state: TrainState, metric_state, x, y, noise, masks=None):
        with span("train.step"):
            return _step(state, metric_state, x, y, noise, masks)

    def _step(state: TrainState, metric_state, x, y, noise, masks):
        with full_float32(), (data_parallel(group) if group is not None
                              else contextlib.nullcontext()):
            with span("train.forward"):
                out, kl, new_vars = apply_model(
                    model, {"params": state.params, **state.model_state}, x,
                    train=True, mode=mode, update_stats=True, noise=noise,
                    masks=masks)
                loss, main, kl_t = loss_fn(
                    out, y, kl, cfg.gamma, n_batches, n_points,
                    scaling=cfg.loss_scaling,
                    loss_multiplier=cfg.loss_multiplier,
                    batch=None if group is None
                    else len(y) * torch.distributed.get_world_size(group))
            with span("train.backward"):
                grads = torch.autograd.grad(
                    loss, list(tree_leaves(state.params)))
        if group is not None:
            # the global batch's mean loss and gradient: each rank's is
            # the mean over its rows (plus the replicated KL term)
            n = torch.distributed.get_world_size(group)
            *grads, loss, main = (t / n for t in all_reduce_sum(
                [*grads, loss.detach(), main.detach()], group))
        with torch.no_grad(), span("train.update"):
            new_params, model_state, new_opt = apply_update(
                tx, state, grads, loss, new_vars)
            metric_state = _update_metrics(task, metric_state,
                                           _detached(out), y, group)
        new_params = tree_map(lambda p: p.requires_grad_(), new_params)
        logs = {"obj": loss.detach(), "main_obj": main.detach(),
                "kl": kl_t.detach()}
        return (TrainState(new_params, model_state, new_opt,
                           state.step + 1), metric_state, logs)

    return step


def make_eval_step(model, cfg: Config, mode: str, update_observers: bool,
                   group=None):
    """The validation step: step(state, metric_state, x, y, noise, masks)
    -> (state, metric_state); no gradient, no running-statistics update;
    the observers update iff update_observers (QAT validation). group: as
    for make_train_step."""
    task = cfg.task

    def step(state: TrainState, metric_state, x, y, noise, masks=None):
        with torch.no_grad(), full_float32(), (
                data_parallel(group) if group is not None
                else contextlib.nullcontext()):
            out, _kl, new_vars = apply_model(
                model, {"params": state.params, **state.model_state}, x,
                train=False, mode=mode, update_stats=update_observers,
                noise=noise, masks=masks)
            model_state = {k: v for k, v in new_vars.items()
                           if k != "params"}
            metric_state = _update_metrics(task, metric_state, out, y,
                                           group)
        return dataclasses.replace(state, model_state=model_state), \
            metric_state

    return step


class Trainer:
    """Epoch loop around the training step, over given (x, y) batches.

    `train_loop` writes its checkpoints to cfg.save (None: nowhere);
    writer: a ScalarWriter (evaluation/writer.py) that receives the
    epoch's train/* and valid/* metrics. mesh: a parallel.mesh.Mesh (the
    device is then the mesh's; every rank runs the same loop over the
    same global batches, and rank 0 alone writes)."""

    mesh = None

    def __init__(self, model, cfg: Config, tx, mode: str, n_batches: int,
                 n_points: int, noise, device="cuda", masks=None,
                 writer=None, mesh=None):
        self.model, self.cfg, self.tx, self.mode = model, cfg, tx, mode
        self.noise, self.masks = noise, masks
        self.device = resolve_device(device)
        self.writer = writer
        self.mesh = mesh
        self.train_step = make_train_step(model, cfg, tx, mode, n_batches,
                                          n_points)
        self.eval_step = make_eval_step(model, cfg, mode,
                                        update_observers=mode == "qat")
        if mesh is not None:
            from qbn_tpu_torch.parallel import (
                make_sharded_eval_step, make_sharded_train_step)
            self.sharded_train_step = make_sharded_train_step(
                model, cfg, tx, mode, n_batches, n_points, mesh)
            self.sharded_eval_step = make_sharded_eval_step(
                model, cfg, mode, mode == "qat", mesh)
        self.history: list = []

    def _pick(self, train: bool, x, y):
        """The step for a batch and its inputs: the sharded step and this
        rank's rows when the batch divides over the mesh's devices
        (qbn_tpu's gate, the total device count on a 2-D mesh); else the
        one-process step on the whole batch, on every rank alike."""
        if self.mesh is not None and len(y) % self.mesh.size == 0:
            from qbn_tpu_torch.parallel import shard_batch
            x, y = shard_batch((x, y), self.mesh)
            return (self.sharded_train_step if train
                    else self.sharded_eval_step), x, y
        return (self.train_step if train else self.eval_step), x, y

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
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if self.cfg.task == "classification":
            return x, torch.as_tensor(y, dtype=torch.int64,
                                      device=self.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        return x, y.reshape(y.shape[0], -1)

    def train_epoch(self, state: TrainState, batches: Iterable):
        """One pass over (x, y) batches; returns (state, train metrics and
        the last step's logs, as floats)."""
        task = self.cfg.task
        metric_state = metrics_init(task, self.device)
        logs = {}
        for i, (x, y) in enumerate(batches):
            step, x, y = self._pick(True, *self._tensors(x, y))
            state, metric_state, logs = step(
                state, metric_state, x, y, self.noise, self.masks)
            if i % self.cfg.report_freq == 0 and i > 0:
                log.info("train step %d obj=%.4f", i, float(logs["obj"]))
            if self.cfg.debug:
                break
        out = {k: float(v) for k, v in metrics_compute(
            task, metric_state).items()}
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
        task = self.cfg.task
        metric_state = metrics_init(task, self.device)
        gen = torch.Generator(device=self.device).manual_seed(
            (self.cfg.seed + 17) * 1_000_003 + seed * 100_003)
        noise, masks = GeneratorNoise(gen), BernoulliMasks(gen, 1)
        for x, y in batches:
            step, x, y = self._pick(False, *self._tensors(x, y))
            state, metric_state = step(state, metric_state, x, y, noise,
                                       masks)
            if self.cfg.debug:
                break
        return state, {k: float(v) for k, v in metrics_compute(
            task, metric_state).items()}

    def key_metric(self, metrics) -> float:
        """The validation metric that the checkpoint policy minimises."""
        return metrics["error" if self.cfg.task == "classification"
                       else "rmse"]

    def _save(self, state: TrainState, special_info: str) -> None:
        if self.mesh is not None and not self.mesh.is_main:
            return
        save_variables(self.variables(state),
                       checkpoint_path(self.cfg.save, special_info))

    def train_loop(self, state: TrainState, train_batches,
                   valid_batches: Optional[list] = None,
                   special_info: str = ""):
        """cfg.epochs epochs with qbn_tpu's checkpoint policy; the LR
        follows the schedule of the optimiser's update count. Appends one
        dict per epoch to self.history, writes the metrics through the
        writer and returns (final state, best validation key metric).

        With cfg.save set: when cfg.save_last or the epoch's key metric is
        at or below the best so far (every epoch without validation
        batches), an SGHMC run (cfg.optimizer 'sghmc') in a snapshot
        epoch (from burnin_epochs on, even, within the last samples * 2)
        writes weights{special_info}_{epoch}.msgpack, unless sghmc_guard
        > 0 and the key metric is above the best + sghmc_guard; any other
        epoch writes weights{special_info}.msgpack, on the best epoch
        (best-only) or, with save_last, every CKPT_FLUSH_EVERY epochs and
        after the last (its final content is the last state)."""
        cfg = self.cfg
        best = math.inf
        dirty = False
        for epoch in range(cfg.epochs):
            state, train_m = self.train_epoch(state, train_batches)
            row = {"epoch": epoch, "train": train_m}
            log.info("epoch %d/%d train %s", epoch, cfg.epochs, train_m)
            self._write("train", train_m, epoch)
            val = best
            if valid_batches is not None:
                state, row["valid"] = self.eval_epoch(state, valid_batches,
                                                      seed=epoch)
                val = self.key_metric(row["valid"])
                log.info("epoch %d valid %s", epoch, row["valid"])
                self._write("valid", row["valid"], epoch)
            self.history.append(row)
            if cfg.save is None or not (cfg.save_last or val <= best):
                best = min(best, val)
                continue
            if (cfg.optimizer == "sghmc" and epoch >= cfg.burnin_epochs
                    and epoch % 2 == 0
                    and epoch >= cfg.epochs - cfg.samples * 2):
                # a posterior snapshot, skipped while the chain sits in a
                # diverged mode (the guard)
                if (cfg.sghmc_guard > 0.0 and valid_batches is not None
                        and val > best + cfg.sghmc_guard):
                    log.info("epoch %d: skipping the SGHMC snapshot (val "
                             "%.4f > best %.4f + guard %.4f)", epoch, val,
                             best, cfg.sghmc_guard)
                else:
                    self._save(state, f"{special_info}_{epoch}")
            elif cfg.save_last:
                dirty = (epoch + 1) % CKPT_FLUSH_EVERY != 0
                if not dirty:
                    self._save(state, special_info)
            else:
                self._save(state, special_info)
            best = min(best, val)
        if dirty:
            self._save(state, special_info)
        return state, best

    def _write(self, split: str, metrics, epoch: int) -> None:
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.scalar(f"{split}/{k}", v, epoch)
