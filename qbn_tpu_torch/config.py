"""Experiment configuration (port of qbn_tpu/config.py and the QuantConfig
of qbn_tpu/models/layers.py).

Only the fields that INT evaluation of a trained checkpoint reads are
kept; `Config.from_json` ignores the other keys of an experiment's
config.json.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple

from qbn_tpu_torch.quant.bounds import INT_BOUNDS, UINT_BOUNDS


@dataclasses.dataclass
class Config:
    model: str = "conv_resnet_bbb"        # <arch>[_<method>]
    input_size: Tuple[int, ...] = (32, 32, 3)   # NHWC
    output_size: int = 10
    q: bool = False                       # converted-int inference
    activation_precision: int = 7         # bits, 2..7 (uint)
    weight_precision: int = 8             # bits, 2..8 (int)
    samples: int = 20                     # MC samples at eval
    batch_size: int = 256

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as fh:
            raw = json.load(fh)
        kw = {k: v for k, v in raw.items() if k in cls.__dataclass_fields__}
        if "input_size" in kw:
            kw["input_size"] = tuple(kw["input_size"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantisation configuration (int mode: always enabled)."""
    a_bits: int = 7
    w_bits: int = 8

    @property
    def a_bounds(self) -> Tuple[int, int]:
        return UINT_BOUNDS[self.a_bits]

    @property
    def w_bounds(self) -> Tuple[int, int]:
        return INT_BOUNDS[self.w_bits]
