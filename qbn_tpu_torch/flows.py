"""Training flow (port of qbn_tpu/flows.py's `_fit`, float phase).

`fit` builds the model, draws its init from `cfg.seed`, builds the
optimiser and the trainer, runs `cfg.epochs` epochs over the batches it is
given, and returns the model, the trainer (per-epoch metrics in
`trainer.history`) and the final state. The dataset readers are not
ported yet, so the caller passes (x, y) batches: x (B, H, W, C) float32
images, y (B,) integer labels, numpy or torch.

    from qbn_tpu_torch.presets import preset
    from qbn_tpu_torch.flows import fit
    cfg = preset("bbb", "mnist", tpu_fused=True, epochs=2)
    model, trainer, state = fit(cfg, batches)       # on the card

With `tpu_fused=True` every Bayes-by-backprop dense layer's training
forward runs the CUDA kernel of `ops/bbb_dense.py`.
"""

from __future__ import annotations

from typing import Optional

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import GeneratorNoise
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import init_variables, resolve_device


def fit(cfg: Config, train_batches, valid_batches=None, device="cuda",
        generator: Optional[torch.Generator] = None,
        dataset_size: Optional[int] = None):
    """Train one model in float mode; returns (model, trainer, state).

    generator: the source of the training noise (by default a generator
    on `device` seeded with cfg.seed + 1). The init always comes from a
    CPU generator seeded with cfg.seed, so a seed gives the same initial
    weights on every device. dataset_size: the number of examples before
    the valid split (qbn_tpu's loaders carry it as `dataset_size`), the
    n_points of 'whole' loss scaling; without it, the examples in
    train_batches."""
    device = resolve_device(device)
    train_batches = list(train_batches)
    if valid_batches is not None:
        valid_batches = list(valid_batches)
    n_points = (dataset_size if dataset_size is not None
                else sum(len(y) for _x, y in train_batches))
    model = build_model(cfg)
    variables = init_variables(
        model, torch.Generator().manual_seed(cfg.seed), cfg.input_size,
        device)
    tx, _ = build_optimizer(cfg, len(train_batches))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    trainer = Trainer(model, cfg, tx, "float", len(train_batches), n_points,
                      GeneratorNoise(generator), device)
    state = trainer.init_state(variables)
    state = trainer.fit(state, train_batches, valid_batches)
    return model, trainer, state
