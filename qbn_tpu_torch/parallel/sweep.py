"""Experiment fan-out: vmapped multi-seed training (port of
qbn_tpu/parallel/sweep.py).

The seeds of a small model (the regression MLPs, the LeNet) train at
once: one training step, vmapped (torch.func.vmap) over params,
optimiser state and model state stacked on a leading seed axis, the
batch shared (qbn_tpu's in_axes (0, 0, None, None)). Seed s draws its
init from s and its training noise and masks from a generator seeded
with s + 9999, as qbn_tpu keys them (PRNGKey(s), PRNGKey(s + 9999)).

How it differs from the one-state step (training/trainer.py), which
calls torch.autograd.grad: that does not compose with vmap, so the step
takes torch.func.grad_and_value of the loss as a function of the params
(the model is already functional: it takes its variable tree). A
generator does not draw per seed inside vmap, so each step's draws are
made outside it, from each seed's own generator in the one-state step's
call order (their shapes read once from a forward of one seed with
recording sources, ops.stochastic.DrawLog), stacked, and handed to the
vmapped step through QueueNoise and QueueMasks: seed s's stacked run is
its own one-state run with GeneratorNoise and BernoulliMasks on its
generator. The fused BBB dense (K5's autograd Function) has no vmap
rule: the vmapped step takes the unfused layers (it raises on a model
built with tpu_fused). SGHMC draws inside its update and is not
vmapped either.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.ops.stochastic import (
    BernoulliMasks, DrawLog, GeneratorNoise, QueueMasks, QueueNoise)
from qbn_tpu_torch.training.losses import classification_loss, regression_loss
from qbn_tpu_torch.training.optim import tree_map
from qbn_tpu_torch.training.trainer import (
    TrainState, apply_update, metrics_init, metrics_update)
from qbn_tpu_torch.utils import (
    apply_model, full_float32, init_variables, resolve_device, tree_leaves)


@dataclasses.dataclass
class SeedStates:
    """A TrainState whose leaves are stacked on a leading seed axis, and
    each seed's step generator."""
    state: TrainState
    generators: List[torch.Generator]


def _stack(trees):
    return tree_map(lambda *leaves: torch.stack(leaves), *trees)


def init_seed_states(model, cfg: Config, tx, sample_input,
                     seeds: Sequence[int], device="cuda") -> SeedStates:
    """Each seed's init (init_variables from a CPU generator seeded with
    s) and fresh optimiser state, stacked; each seed's step generator on
    `device`, seeded with s + 9999."""
    device = resolve_device(device)
    states = []
    for s in seeds:
        v = init_variables(model, torch.Generator().manual_seed(s),
                           tuple(sample_input.shape[1:]), device,
                           quantized=bool(cfg.q or cfg.at))
        params = tree_map(torch.Tensor.detach, v["params"])
        states.append(TrainState(
            params=params,
            model_state={k: t for k, t in v.items() if k != "params"},
            opt_state=tx.init(params)))
    stacked = TrainState(
        params=_stack([st.params for st in states]),
        model_state=_stack([st.model_state for st in states]),
        opt_state=_stack([st.opt_state for st in states]))
    return SeedStates(stacked, [
        torch.Generator(device=device).manual_seed(s + 9999) for s in seeds])


def init_stacked_metrics(cfg: Config, n_seeds: int, device="cpu"):
    """A fresh metric state per seed, stacked."""
    return _stack([metrics_init(cfg.task, device)] * n_seeds)


def _unstack(tree, i):
    """Seed i's slice of a stacked tree (a dict, a tuple or a tensor)."""
    if isinstance(tree, tuple):
        return tuple(_unstack(t, i) for t in tree)
    return tree_map(lambda t: t[i].detach(), tree)


def make_vmapped_train_step(model, cfg: Config, tx, mode: str,
                            n_batches: int, n_points: int):
    """step(seed_states, metric_states, x, y) -> (seed_states,
    metric_states, logs): one training step of every seed on the shared
    batch (x, y); logs' entries have a leading seed axis."""
    if any(getattr(getattr(m, "quant", None), "tpu_fused", False)
           for m in model.modules()):
        raise ValueError("the vmapped step runs the unfused BBB dense: "
                         "build the model with tpu_fused=False")
    if cfg.optimizer == "sghmc":
        raise ValueError("SGHMC draws inside its update: not vmapped")
    task = cfg.task
    loss_fn = (classification_loss if task == "classification"
               else regression_loss)

    def one(params, model_state, opt_state, x, y, noise, masks):
        noise, masks = QueueNoise(noise), QueueMasks(masks)

        def objective(params):
            out, kl, new_vars = apply_model(
                model, {"params": params, **model_state}, x, train=True,
                mode=mode, update_stats=True, noise=noise, masks=masks)
            loss, main, kl_t = loss_fn(
                out, y, kl, cfg.gamma, n_batches, n_points,
                scaling=cfg.loss_scaling,
                loss_multiplier=cfg.loss_multiplier)
            return loss, (main, kl_t, out, new_vars)

        grads, (loss, (main, kl_t, out, new_vars)) = \
            torch.func.grad_and_value(objective, has_aux=True)(params)
        state = TrainState(params, model_state, opt_state)
        new_params, new_state, new_opt = apply_update(
            tx, state, list(tree_leaves(grads)), loss, new_vars)
        return (new_params, new_state, new_opt, out,
                {"obj": loss, "main_obj": main, "kl": kl_t})

    vmapped = torch.func.vmap(one, in_dims=(0, 0, 0, None, None, 0, 0))

    def draws(seeds: SeedStates, x):
        """Each seed's draws of this step, in the one-state step's call
        order, stacked: (noise arrays, mask arrays)."""
        first = seeds.state
        log = DrawLog(1)
        with torch.no_grad():
            apply_model(model, {"params": _unstack(first.params, 0),
                                **_unstack(first.model_state, 0)}, x,
                        train=True, mode=mode, update_stats=True,
                        noise=log, masks=log.masks)
        per_seed = [log.replay(GeneratorNoise(g), BernoulliMasks(g, 1),
                               len(x), x.device) for g in seeds.generators]
        kinds = [c[0] for c in log.calls]
        noise = [torch.stack([d[i] for d in per_seed])
                 for i, k in enumerate(kinds) if k != "masks"]
        masks = [torch.stack([d[i] for d in per_seed])
                 for i, k in enumerate(kinds) if k == "masks"]
        return noise, masks

    def step(seeds: SeedStates, metric_states, x, y):
        noise, masks = draws(seeds, x)
        st = seeds.state
        with full_float32():
            params, model_state, opt_state, out, logs = vmapped(
                st.params, st.model_state, st.opt_state, x, y, noise, masks)
        with torch.no_grad():
            metric_states = _stack([metrics_update(
                task, _unstack(metric_states, i), _unstack(out, i), y)
                for i in range(len(seeds.generators))])
        return (SeedStates(TrainState(params, model_state, opt_state,
                                      st.step + 1), seeds.generators),
                metric_states, {k: v.detach() for k, v in logs.items()})

    return step

