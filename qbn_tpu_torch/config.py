"""Experiment configuration (port of qbn_tpu/config.py and the QuantConfig
of qbn_tpu/models/layers.py).

Only the fields that the ported paths read are kept (INT and float
evaluation, float training with Adam or SGHMC, QAT, the checkpoint
policy, the data pipeline, the experiment runner, profiling and the
mesh); `Config.from_json` ignores the other keys of an experiment's
config.json, and `to_json` writes the port's fields. `mesh_shape` runs
the experiment over a mesh of processes (parallel/mesh.py): None is one
device, (n,) a 1-D data mesh, (d, s) a (data, sample) mesh. `tpu_fused` keeps
qbn_tpu's name so that a config.json carries across; in the port it routes
the BBB local-reparametrisation dense layers through the hand-written CUDA
kernel of `ops/bbb_dense.py`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

from qbn_tpu_torch.quant.bounds import INT_BOUNDS, UINT_BOUNDS


@dataclasses.dataclass
class Config:
    # task / model selection
    task: str = "classification"          # classification | regression
    model: str = "conv_resnet_bbb"        # <arch>[_<method>]
    dataset: str = "cifar"                # mnist | cifar | regression_*
    # optimisation
    learning_rate: float = 1e-3
    loss_scaling: str = "batch"           # 'whole' | 'batch'
    loss_multiplier: float = 1.0
    weight_decay: float = 0.0
    epochs: int = 300
    batch_size: int = 256
    gamma: float = 0.01                   # KL weight
    optimizer: str = "adam"               # adam | sgd | sghmc
    momentum: float = 0.9                 # for sgd
    lr_schedule: str = "cosine"           # cosine | constant
    # Bayesian knobs
    sigma_prior: float = 0.05             # BBB prior std
    p: float = 0.2                        # MC-Dropout rate
    samples: int = 20                     # MC samples / ensemble size
    # SGHMC (training/sghmc.py)
    burnin_epochs: int = 200
    resample_momentum_iterations: int = 50
    resample_prior_iterations: int = 25
    gauss_sig: float = 0.1
    base_c: float = 0.05
    alpha0: float = 10.0
    beta0: float = 10.0
    # > 0: skip a posterior snapshot while the validation key metric is
    # above the best so far + sghmc_guard (qbn_tpu's guard; 0 is off)
    sghmc_guard: float = 0.0
    # data
    data: str = "./data"                  # dataset files (else stand-ins)
    valid_portion: float = 0.1            # of the train set, for validation
    input_size: Tuple[int, ...] = (32, 32, 3)   # NHWC
    output_size: int = 10
    # quantisation
    q: bool = False                       # converted-int inference
    at: bool = False                      # quantisation-aware training
    activation_precision: int = 7         # bits, 2..7 (uint)
    weight_precision: int = 8             # bits, 2..8 (int)
    # bookkeeping
    seed: int = 1
    debug: bool = False                   # every loop stops after one batch
    save: Optional[str] = None            # the run directory (None: none)
    load: Optional[str] = None            # a QAT run's float run directory
    save_last: bool = True                # else: save on best validation
    report_freq: int = 50
    tpu_fused: bool = False               # BBB dense through the CUDA kernel
    # profiling (profiling.py)
    debug_nans: bool = False              # raise on the first non-finite
    #                                       module output (and backward)
    profile: bool = False                 # torch.profiler trace of training
    # multi-device (parallel/mesh.py)
    mesh_shape: Optional[Tuple[int, ...]] = None   # None: one device

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as fh:
            raw = json.load(fh)
        kw = {k: v for k, v in raw.items() if k in cls.__dataclass_fields__}
        for k in ("input_size", "mesh_shape"):
            if kw.get(k) is not None:
                kw[k] = tuple(kw[k])
        return cls(**kw)

    def to_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh, indent=2)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @property
    def method(self) -> str:
        """Inference method encoded in the model name suffix."""
        for m in ("bbb", "sgld", "mc"):
            if self.model.endswith("_" + m) or m in self.model.split("_"):
                return {"mc": "mcdropout"}.get(m, m)
        return "pointwise"

    @property
    def arch(self) -> str:
        """Architecture family: linear (the regression MLP) | conv_lenet
        (the MNIST LeNet) | conv_resnet (the CIFAR ResNet-18) |
        conv_resnet50 (the ImageNet ResNet-50 v1.5)."""
        name = self.model
        for suffix in ("_bbb", "_sgld", "_mc"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
        return name


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantisation configuration. `enabled` attaches the int
    machinery (int mode); `tpu_fused` routes the BBB training dense through
    the CUDA kernel."""
    enabled: bool = False
    a_bits: int = 7
    w_bits: int = 8
    tpu_fused: bool = False

    @property
    def a_bounds(self) -> Tuple[int, int]:
        return UINT_BOUNDS[self.a_bits]

    @property
    def w_bounds(self) -> Tuple[int, int]:
        return INT_BOUNDS[self.w_bits]
