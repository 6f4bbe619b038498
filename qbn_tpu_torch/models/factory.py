"""Model factory (port of qbn_tpu/models/factory.py): model name ->
architecture, '<arch>[_<method>]' with arch in {linear, conv_lenet,
conv_resnet} and the method suffix '' (pointwise), '_mc' (MC-Dropout),
'_bbb' or '_sgld' (an SGHMC ensemble: the pointwise templates, its members
stacked on a leading axis of the state, evaluation/ensemble.py).

Every architecture and method is ported in every mode (float training
and evaluation, QAT and convert, converted-int evaluation); an unknown
name raises, as qbn_tpu's `_parse` does. As in qbn_tpu, a model whose
config sets `q` or `at` carries the quantisation machinery, and one model
serves its float, qat, convert and int modes. The model carries its
`method` and `task`, on which `evaluation.mc.evaluate` dispatches.
"""

from __future__ import annotations

import os

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_device
from qbn_tpu_torch.evaluation.ensemble import load_ensemble
from qbn_tpu_torch.models.architectures import LeNet, MLPNet, ResNet
from qbn_tpu_torch.training.checkpoint import checkpoint_path, read_checkpoint
from qbn_tpu_torch.utils import resolve_device

_ARCHS = ("linear", "conv_lenet", "conv_resnet")


def build_model(cfg: Config):
    method = cfg.method
    if cfg.arch not in _ARCHS:
        raise ValueError(f"Unknown model '{cfg.model}'")
    quantized = bool(cfg.q or cfg.at)
    quant = QuantConfig(enabled=quantized, a_bits=cfg.activation_precision,
                        w_bits=cfg.weight_precision, tpu_fused=cfg.tpu_fused)
    kw = dict(stochastic=method == "bbb",
              dropout_p=cfg.p if method == "mcdropout" else 0.0,
              sigma_prior=cfg.sigma_prior, quant=quant)
    if cfg.arch == "linear":
        model = MLPNet(output_size=1, **kw)
    elif cfg.arch == "conv_resnet":
        model = ResNet(output_size=cfg.output_size, **kw)
    else:
        model = LeNet(output_size=cfg.output_size, **kw)
    model.method = method
    model.task = "regression" if cfg.arch == "linear" else "classification"
    return model


def load_trained(exp_dir: str, device="cuda", special_info: str = ""):
    """(cfg, model, state) of a trained experiment directory, float or
    converted (its config.json and weights{special_info}.msgpack; for
    SGHMC the last cfg.samples snapshots
    weights{special_info}_<epoch>.msgpack, stacked), the state on
    `device`. special_info: a regression fold's '_<dataset>_<fold>', as
    qbn_tpu's flows name the fold's files."""
    device = resolve_device(device)
    cfg = Config.from_json(os.path.join(exp_dir, "config.json"))
    model = build_model(cfg)
    return cfg, model, to_device(load_state(cfg, exp_dir, special_info),
                                 device)


def load_state(cfg: Config, exp_dir: str, special_info: str = ""):
    """The state that `load_trained` reads for cfg's method, as CPU
    tensors: weights{special_info}.msgpack, or for SGHMC the last
    cfg.samples snapshots stacked."""
    if cfg.method == "sgld":
        return load_ensemble(exp_dir, cfg.samples,
                             special_info[1:] + "_" if special_info else "")
    return from_jax_state(read_checkpoint(
        checkpoint_path(exp_dir, special_info)))
