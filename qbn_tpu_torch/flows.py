"""Training flows (port of qbn_tpu/flows.py's `_fit` and `_qat_one`).

`fit` builds the model, draws its init from `cfg.seed`, builds the
optimiser and the trainer, runs `cfg.epochs` epochs over the batches it is
given, and returns the model, the trainer (per-epoch metrics in
`trainer.history`) and the final state. `qat` is the QAT flow of one
model: the model with its quantisation machinery, a float or QAT
checkpoint merged into its quantised init (fresh observers where the
checkpoint has none), `fit` in 'qat' mode, the conversion to int
constants, and the converted state saved where asked. The dataset readers
are not ported yet, so the caller passes (x, y) batches: x (B, H, W, C)
float32 images, y (B,) integer labels, numpy or torch.

    from qbn_tpu_torch.presets import preset
    from qbn_tpu_torch.flows import fit, qat
    cfg = preset("bbb", "cifar", tpu_fused=True, epochs=2)
    model, trainer, state = fit(cfg, batches)             # on the card
    qcfg = preset("bbb", "cifar", phase="qat", tpu_fused=True)
    model, trainer, converted = qat(qcfg, trainer.variables(state),
                                    batches, save_dir="runs/q")

With `tpu_fused=True` every Bayes-by-backprop dense layer's training
forward (the LeNet's fc_0 and fc_1, the ResNet's fc) runs the CUDA kernel
of `ops/bbb_dense.py`. The SGHMC per-snapshot QAT and the regression
flows are not ported.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state, to_device, to_numpy_state
from qbn_tpu_torch.models.factory import build_model, check_ported
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.training.checkpoint import (
    checkpoint_path, merge, read_checkpoint, save_variables)
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import convert_model, init_variables, resolve_device


def fit(cfg: Config, train_batches, valid_batches=None, device="cuda",
        generator: Optional[torch.Generator] = None,
        dataset_size: Optional[int] = None, init_from=None):
    """Train one model; returns (model, trainer, state).

    generator: the source of the training noise and dropout masks (by
    default a generator on `device` seeded with cfg.seed + 1). The init
    always comes from a CPU generator seeded with cfg.seed, so a seed
    gives the same initial weights on every device; with cfg.q or cfg.at
    it is the quantised init (observers and int-constant placeholders).
    init_from: a variable tree (tensor or numpy leaves) merged into the
    init, key by key. dataset_size: the number of examples before the
    valid split (qbn_tpu's loaders carry it as `dataset_size`), the
    n_points of 'whole' loss scaling; without it, the examples in
    train_batches. A config with cfg.at (preset(..., phase='qat')) trains
    in 'qat' mode, the QAT fine-tune; any other in 'float' mode."""
    device = resolve_device(device)
    train_batches = list(train_batches)
    if valid_batches is not None:
        valid_batches = list(valid_batches)
    n_points = (dataset_size if dataset_size is not None
                else sum(len(y) for _x, y in train_batches))
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
                      masks=BernoulliMasks(generator, 1))
    state = trainer.init_state(variables)
    state = trainer.fit(state, train_batches, valid_batches)
    return model, trainer, state


def qat(cfg: Config, init_from: Union[str, dict], train_batches,
        valid_batches=None, device="cuda",
        generator: Optional[torch.Generator] = None,
        dataset_size: Optional[int] = None,
        save_dir: Optional[str] = None):
    """Fine-tune one quantised model and convert it (qbn_tpu's _qat_one);
    returns (model, trainer, converted variables).

    cfg: a QAT config (preset(..., phase="qat")). init_from: an
    experiment directory or checkpoint file of a float or QAT run, or its
    variable tree. After `fit` in 'qat' mode, `convert_model` on the
    first training batch computes the int constants ('qconst'). With
    save_dir, the converted variables and the config are written there as
    `models.factory.load_trained` reads them."""
    device = resolve_device(device)
    check_ported(cfg, "qat")
    if not (cfg.q and cfg.at):
        raise ValueError("qat needs a config with q and at set "
                         "(preset(..., phase='qat'))")
    if isinstance(init_from, str):
        path = (checkpoint_path(init_from) if os.path.isdir(init_from)
                else init_from)
        init_from = read_checkpoint(path)
    train_batches = list(train_batches)
    model, trainer, state = fit(cfg, train_batches, valid_batches, device,
                                generator, dataset_size, init_from)
    x0 = torch.as_tensor(train_batches[0][0], dtype=torch.float32,
                         device=device)
    variables = convert_model(model, trainer.variables(state), x0)
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        save_variables(variables, checkpoint_path(save_dir))
        cfg.save(os.path.join(save_dir, "config.json"))
    return model, trainer, variables
