"""Model factory (port of qbn_tpu/models/factory.py): model name ->
architecture.

Ported: 'conv_lenet_bbb' (and pointwise 'conv_lenet') in float mode, and
'conv_resnet_bbb' in converted-int mode. Any other name or mode raises.
"""

from __future__ import annotations

import os

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_device
from qbn_tpu_torch.models.architectures import LeNet, ResNet
from qbn_tpu_torch.training.checkpoint import checkpoint_path, read_checkpoint
from qbn_tpu_torch.utils import resolve_device

# (arch, method, converted int?) of the ported models
_PORTED = {("conv_lenet", "bbb", False), ("conv_lenet", "pointwise", False),
           ("conv_resnet", "bbb", True)}


def build_model(cfg: Config):
    method = cfg.method
    if (cfg.arch, method, bool(cfg.q)) not in _PORTED:
        raise NotImplementedError(
            f"model '{cfg.model}' with q={cfg.q} is not ported; ported: "
            "conv_lenet[_bbb] float, conv_resnet_bbb int")
    quant = QuantConfig(enabled=bool(cfg.q), a_bits=cfg.activation_precision,
                        w_bits=cfg.weight_precision, tpu_fused=cfg.tpu_fused)
    if cfg.q:
        return ResNet(output_size=cfg.output_size, quant=quant)
    return LeNet(output_size=cfg.output_size, stochastic=method == "bbb",
                 sigma_prior=cfg.sigma_prior, quant=quant)


def load_trained(exp_dir: str, device="cuda"):
    """(cfg, model, state) of a trained, converted experiment directory
    (its config.json and weights.msgpack), the state on `device`."""
    device = resolve_device(device)
    cfg = Config.from_json(os.path.join(exp_dir, "config.json"))
    model = build_model(cfg)
    state = from_jax_state(read_checkpoint(checkpoint_path(exp_dir)))
    return cfg, model, to_device(state, device)
