"""Training flows (port of qbn_tpu/flows.py's `_fit`, `_qat_one` and the
per-snapshot and per-fold QAT of `run_qat_classification` and
`run_qat_regression`).

`fit` builds the model, draws its init from `cfg.seed`, builds the
optimiser (Adam, SGD, or the adaptive clip and SGHMC) and the trainer,
runs `cfg.epochs` epochs over the batches it is given (`train_loop`) and
returns the model, the trainer (per-epoch metrics in `trainer.history`)
and the final state; with `save_dir` it writes the run's config.json,
its checkpoints under qbn_tpu's names (best-only or save-last,
weights{special_info}.msgpack, and an SGHMC run's posterior snapshots
weights{special_info}_<epoch>.msgpack) and scalars.jsonl. `qat` is the
QAT flow: the model with its quantisation machinery, a float or QAT
checkpoint merged into its quantised init (fresh observers where the
checkpoint has none), `fit` in 'qat' mode, the conversion to int
constants, and the converted state saved where asked; for an SGHMC run
(`cfg.method == 'sgld'`) it does so for each of the last `cfg.samples`
snapshots. The dataset readers are not ported yet, so the caller passes
(x, y) batches: x (B, H, W, C) float32 images and y (B,) integer
labels, or x (B, features) and y (B, 1) float32 regression targets,
numpy or torch; a regression fold's files carry its special_info
'_<dataset>_<fold>', as qbn_tpu's flows name them.

    from qbn_tpu_torch.presets import preset
    from qbn_tpu_torch.flows import fit, qat
    cfg = preset("sgld", "cifar", epochs=16, burnin_epochs=2)
    model, trainer, state = fit(cfg, batches, save_dir="runs/f")
    qcfg = preset("sgld", "cifar", phase="qat")
    model, trainer, ensemble = qat(qcfg, "runs/f", batches,
                                   save_dir="runs/q")

With `tpu_fused=True` every Bayes-by-backprop dense layer's training
forward (the LeNet's fc_0 and fc_1, the ResNet's fc, the MLP's five
layers) runs the CUDA kernel of `ops/bbb_dense.py`.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state, to_device, to_numpy_state
from qbn_tpu_torch.evaluation.ensemble import stack_variables
from qbn_tpu_torch.evaluation.writer import ScalarWriter
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.training.checkpoint import (
    checkpoint_path, list_snapshots, merge, read_checkpoint, save_variables)
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import convert_model, init_variables, resolve_device


def fit(cfg: Config, train_batches, valid_batches=None, device="cuda",
        generator: Optional[torch.Generator] = None,
        dataset_size: Optional[int] = None, init_from=None,
        save_dir: Optional[str] = None, special_info: str = ""):
    """Train one model; returns (model, trainer, state).

    generator: the source of the training noise and dropout masks (by
    default a generator on `device` seeded with cfg.seed + 1; SGHMC draws
    from its own, seeded with cfg.seed). The init always comes from a CPU
    generator seeded with cfg.seed, so a seed gives the same initial
    weights on every device; with cfg.q or cfg.at it is the quantised
    init (observers and int-constant placeholders). cfg.input_size is
    taken from the first batch, as qbn_tpu's _fit does. init_from: a
    variable tree (tensor or numpy leaves) merged into the init, key by
    key. dataset_size: the number of examples before the valid split
    (qbn_tpu's loaders carry it as `dataset_size`), the n_points of
    'whole' loss scaling; without it, the examples in train_batches. A
    config with cfg.at (preset(..., phase='qat')) trains in 'qat' mode,
    the QAT fine-tune; any other in 'float' mode. save_dir and
    special_info: see the module docstring."""
    device = resolve_device(device)
    train_batches = list(train_batches)
    if valid_batches is not None:
        valid_batches = list(valid_batches)
    n_points = (dataset_size if dataset_size is not None
                else sum(len(y) for _x, y in train_batches))
    cfg = cfg.replace(input_size=tuple(train_batches[0][0].shape[1:]))
    cfg = cfg.replace(save=save_dir)
    writer = None
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        cfg.to_json(os.path.join(save_dir, "config.json"))
        writer = ScalarWriter(save_dir)
    model = build_model(cfg)
    variables = init_variables(
        model, torch.Generator().manual_seed(cfg.seed), cfg.input_size,
        device, quantized=bool(cfg.q or cfg.at))
    if init_from is not None:
        variables = to_device(from_jax_state(merge(
            to_numpy_state(variables), to_numpy_state(init_from))), device)
    tx, _ = build_optimizer(cfg, len(train_batches))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    trainer = Trainer(model, cfg, tx, "qat" if cfg.at else "float",
                      len(train_batches), n_points,
                      GeneratorNoise(generator), device,
                      masks=BernoulliMasks(generator, 1), writer=writer)
    state = trainer.init_state(variables)
    try:
        state, _best = trainer.train_loop(state, train_batches,
                                          valid_batches, special_info)
    finally:
        if writer is not None:
            writer.close()
    return model, trainer, state


def _qat_one(cfg: Config, init_from, train_batches, valid_batches, device,
             generator, dataset_size, save_dir, special_info):
    """qbn_tpu's _qat_one: fit in 'qat' mode from init_from; with a
    save_dir, the state that train_loop saved (the best or the last)
    read back; convert on the first training batch, saved over it."""
    if isinstance(init_from, str):
        init_from = read_checkpoint(init_from)
    model, trainer, state = fit(cfg, train_batches, valid_batches, device,
                                generator, dataset_size, init_from,
                                save_dir, special_info)
    variables = trainer.variables(state)
    path = None
    if save_dir is not None:
        path = checkpoint_path(save_dir, special_info)
        variables = to_device(from_jax_state(merge(
            to_numpy_state(variables), read_checkpoint(path))), device)
    x0 = torch.as_tensor(train_batches[0][0], dtype=torch.float32,
                         device=device)
    variables = convert_model(model, variables, x0)
    if path is not None:
        save_variables(variables, path)
    return model, trainer, variables


def qat(cfg: Config, init_from: Union[str, dict], train_batches,
        valid_batches=None, device="cuda",
        generator: Optional[torch.Generator] = None,
        dataset_size: Optional[int] = None,
        save_dir: Optional[str] = None, special_info: str = ""):
    """Fine-tune quantised models and convert them (qbn_tpu's _qat_one,
    and its loop over SGHMC snapshots); returns (model, trainer,
    converted variables).

    cfg: a QAT config (preset(..., phase="qat")). init_from: an
    experiment directory or checkpoint file of a float or QAT run, or its
    variable tree. After `fit` in 'qat' mode, `convert_model` on the
    first training batch computes the int constants ('qconst'). With
    save_dir, the converted variables and the config are written there as
    `models.factory.load_trained` reads them. special_info: a regression
    fold's '_<dataset>_<fold>' (its checkpoint in init_from, and the
    name of what is saved).

    For cfg.method 'sgld', init_from is the float run's directory: each
    of its last cfg.samples snapshots weights{special_info}_<epoch>.msgpack
    is fine-tuned and converted on its own, from the same seed, and saved
    under its own name; the converted members are returned stacked (the
    trainer is the last member's)."""
    device = resolve_device(device)
    if not (cfg.q and cfg.at):
        raise ValueError("qat needs a config with q and at set "
                         "(preset(..., phase='qat'))")
    train_batches = list(train_batches)
    args = (train_batches, valid_batches, device, generator, dataset_size,
            save_dir)
    if cfg.method != "sgld":
        if isinstance(init_from, str) and os.path.isdir(init_from):
            init_from = checkpoint_path(init_from, special_info)
        return _qat_one(cfg, init_from, *args, special_info)
    if not (isinstance(init_from, str) and os.path.isdir(init_from)):
        raise ValueError("the QAT of an SGHMC run reads its snapshots from "
                         "the float run's directory")
    snaps = list_snapshots(init_from, special_info[1:] + "_" if special_info
                           else "")
    if len(snaps) < cfg.samples:
        raise FileNotFoundError(f"{len(snaps)} SGHMC snapshots in "
                                f"{init_from}, {cfg.samples} needed")
    members = []
    for path in snaps[-cfg.samples:]:
        info = "_" + os.path.basename(path).split("weights_")[1].split(
            ".msgpack")[0]
        model, trainer, variables = _qat_one(cfg, path, *args, info)
        members.append(variables)
    return model, trainer, stack_variables(members)
