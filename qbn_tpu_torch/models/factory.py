"""Model factory (port of qbn_tpu/models/factory.py): model name ->
architecture in int mode.

Only 'conv_resnet_bbb' is ported; any other name raises.
"""

from __future__ import annotations

import os

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_device
from qbn_tpu_torch.models.architectures import ResNet
from qbn_tpu_torch.training.checkpoint import checkpoint_path, read_checkpoint
from qbn_tpu_torch.utils import resolve_device

_ARCHS = {"conv_resnet_bbb": ResNet}


def build_model(cfg: Config):
    if cfg.model not in _ARCHS:
        raise NotImplementedError(
            f"model '{cfg.model}' is not ported; ported: {sorted(_ARCHS)}")
    if not cfg.q:
        raise NotImplementedError("only converted-int models are ported")
    quant = QuantConfig(a_bits=cfg.activation_precision,
                        w_bits=cfg.weight_precision)
    return _ARCHS[cfg.model](output_size=cfg.output_size, quant=quant)


def load_trained(exp_dir: str, device="cuda"):
    """(cfg, model, state) of a trained, converted experiment directory
    (its config.json and weights.msgpack), the state on `device`."""
    device = resolve_device(device)
    cfg = Config.from_json(os.path.join(exp_dir, "config.json"))
    model = build_model(cfg)
    state = from_jax_state(read_checkpoint(checkpoint_path(exp_dir)))
    return cfg, model, to_device(state, device)
