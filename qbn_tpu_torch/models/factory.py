"""Model factory (port of qbn_tpu/models/factory.py): model name ->
architecture, '<arch>[_<method>]' with arch in {linear, conv_lenet,
conv_resnet} and the method suffix '' (pointwise), '_mc' (MC-Dropout),
'_bbb' or '_sgld' (an SGHMC ensemble: the pointwise templates, its members
stacked on a leading axis of the state, evaluation/ensemble.py).

Ported: the float LeNet (pointwise, BBB) and converted-int models: the
ResNet-18 of every method, the LeNet and the regression MLP of pointwise,
MC-Dropout and SGHMC. Any other name or mode raises. The model carries its
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

_INT_METHODS = ("pointwise", "mcdropout", "sgld")
# (arch, method, converted int?) of the ported models
_PORTED = ({("conv_lenet", "bbb", False), ("conv_lenet", "pointwise", False),
            ("conv_resnet", "bbb", True)}
           | {(a, m, True) for a in ("linear", "conv_lenet", "conv_resnet")
              for m in _INT_METHODS})


def build_model(cfg: Config):
    method = cfg.method
    if (cfg.arch, method, bool(cfg.q)) not in _PORTED:
        raise NotImplementedError(
            f"model '{cfg.model}' with q={cfg.q} is not ported; ported: "
            "conv_lenet[_bbb] float; conv_resnet[_bbb|_mc|_sgld], "
            "conv_lenet[_mc|_sgld] and linear[_mc|_sgld] int")
    quant = QuantConfig(enabled=bool(cfg.q), a_bits=cfg.activation_precision,
                        w_bits=cfg.weight_precision, tpu_fused=cfg.tpu_fused)
    kw = dict(stochastic=method == "bbb",
              dropout_p=cfg.p if method == "mcdropout" else 0.0, quant=quant)
    if cfg.arch == "linear":
        model = MLPNet(output_size=1, **kw)
    elif cfg.arch == "conv_resnet":
        model = ResNet(output_size=cfg.output_size, **kw)
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
