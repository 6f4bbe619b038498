"""Model factory (port of qbn_tpu/models/factory.py): model name ->
architecture, '<arch>[_<method>]' with arch in {linear, conv_lenet,
conv_resnet} and the method suffix '' (pointwise), '_mc' (MC-Dropout),
'_bbb' or '_sgld' (an SGHMC ensemble: the pointwise templates, its members
stacked on a leading axis of the state, evaluation/ensemble.py).

Ported: float training of the LeNet (pointwise, BBB) and of the
ResNet-18 (pointwise, MC-Dropout, BBB); QAT and convert of the ResNet-18
of those three methods and of the LeNet (pointwise, BBB); converted-int
evaluation of every architecture and method. Any other name or phase
raises. As in qbn_tpu, a model whose config sets `q` or `at` carries the
quantisation machinery, and one model serves its float, qat, convert and
int modes. The model carries its `method` and `task`, on which
`evaluation.mc.evaluate` dispatches.
"""

from __future__ import annotations

import os

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_device
from qbn_tpu_torch.evaluation.ensemble import load_ensemble
from qbn_tpu_torch.models.architectures import LeNet, MLPNet, ResNet
from qbn_tpu_torch.training.checkpoint import checkpoint_path, read_checkpoint
from qbn_tpu_torch.utils import resolve_device

# (arch, method) of the ported models, by phase
_PORTED = {
    "float": {("conv_lenet", "bbb"), ("conv_lenet", "pointwise"),
              ("conv_resnet", "pointwise"), ("conv_resnet", "mcdropout"),
              ("conv_resnet", "bbb")},
    "qat": {("conv_resnet", "pointwise"), ("conv_resnet", "mcdropout"),
            ("conv_resnet", "bbb"), ("conv_lenet", "pointwise"),
            ("conv_lenet", "bbb")},
    "int": {(a, m) for a in ("linear", "conv_lenet", "conv_resnet")
            for m in ("pointwise", "mcdropout", "sgld", "bbb")},
}


def check_ported(cfg: Config, phase: str) -> None:
    """Raise unless the model of `cfg` is ported for `phase` ('float',
    'qat' (QAT and convert) or 'int')."""
    if (cfg.arch, cfg.method) not in _PORTED[phase]:
        names = sorted(a + {"pointwise": "", "mcdropout": "_mc",
                            "bbb": "_bbb", "sgld": "_sgld"}[m]
                       for a, m in _PORTED[phase])
        raise NotImplementedError(
            f"model '{cfg.model}' is not ported for the {phase} phase; "
            f"ported: {', '.join(names)}")


def build_model(cfg: Config):
    method = cfg.method
    quantized = bool(cfg.q or cfg.at)
    check_ported(cfg, "int" if quantized else "float")
    quant = QuantConfig(enabled=quantized, a_bits=cfg.activation_precision,
                        w_bits=cfg.weight_precision, tpu_fused=cfg.tpu_fused)
    kw = dict(stochastic=method == "bbb",
              dropout_p=cfg.p if method == "mcdropout" else 0.0, quant=quant)
    if cfg.arch == "linear":
        model = MLPNet(output_size=1, **kw)
    elif cfg.arch == "conv_resnet":
        model = ResNet(output_size=cfg.output_size,
                       sigma_prior=cfg.sigma_prior, **kw)
    else:
        model = LeNet(output_size=cfg.output_size,
                      sigma_prior=cfg.sigma_prior, **kw)
    model.method = method
    model.task = "regression" if cfg.arch == "linear" else "classification"
    return model


def load_trained(exp_dir: str, device="cuda"):
    """(cfg, model, state) of a trained, converted experiment directory
    (its config.json and weights.msgpack; for SGHMC the last cfg.samples
    snapshots weights_<epoch>.msgpack, stacked), the state on `device`."""
    device = resolve_device(device)
    cfg = Config.from_json(os.path.join(exp_dir, "config.json"))
    model = build_model(cfg)
    if cfg.method == "sgld":
        state = load_ensemble(exp_dir, cfg.samples)
    else:
        state = from_jax_state(read_checkpoint(checkpoint_path(exp_dir)))
    return cfg, model, to_device(state, device)
