"""Per-(method x tier x phase) hyperparameter presets (port of
qbn_tpu/presets.py, as data).

Tiers: 'regression' (MLP), 'mnist' (LeNet), 'cifar' (ResNet-18 w24). The
float table is qbn_tpu's, entry for entry, and so is the QAT overlay (10
epochs of SGD with momentum 0.9 at lr 1e-5, 1e-3 for MC-Dropout on CIFAR;
batch 1024 for pointwise and SGHMC on CIFAR; gamma 0 for BBB; 'batch'
loss scaling without a multiplier; `q` and `at` set), with the data
fields: the tier's dataset, `valid_portion` 0.1 (0.2 for regression).
"""

from __future__ import annotations

from typing import Dict

from qbn_tpu_torch.config import Config

_ARCH = {"regression": "linear", "mnist": "conv_lenet",
         "cifar": "conv_resnet"}
_SUFFIX = {"pointwise": "", "mcdropout": "_mc", "bbb": "_bbb",
           "sgld": "_sgld"}
_DATASET = {"regression": "regression_synthetic", "mnist": "mnist",
            "cifar": "cifar"}
_INPUT = {"regression": (1,), "mnist": (28, 28, 1), "cifar": (32, 32, 3)}

FLOAT: Dict[tuple, dict] = {
    ("pointwise", "regression"): dict(learning_rate=1e-3, epochs=300,
                                      batch_size=1000, weight_decay=5e-5,
                                      samples=1),
    ("pointwise", "mnist"): dict(learning_rate=1e-3, epochs=100,
                                 batch_size=256, weight_decay=1e-4,
                                 samples=1),
    ("pointwise", "cifar"): dict(learning_rate=1e-3, epochs=300,
                                 batch_size=256, weight_decay=1e-5,
                                 samples=1),
    ("mcdropout", "regression"): dict(learning_rate=1e-3, epochs=300,
                                      batch_size=1000, p=0.2, samples=20),
    ("mcdropout", "mnist"): dict(learning_rate=1e-3, epochs=100,
                                 batch_size=128, p=0.2, samples=20),
    ("mcdropout", "cifar"): dict(learning_rate=5e-3, epochs=300,
                                 batch_size=256, p=0.15, samples=20),
    ("bbb", "regression"): dict(learning_rate=1e-2, epochs=300,
                                batch_size=1000, gamma=1.0, sigma_prior=1.0,
                                samples=20),
    ("bbb", "mnist"): dict(learning_rate=1e-3, epochs=100, batch_size=256,
                           gamma=0.1, sigma_prior=0.1, samples=20),
    ("bbb", "cifar"): dict(learning_rate=1e-3, epochs=300, batch_size=256,
                           gamma=0.01, sigma_prior=0.05, samples=20),
    # SGLD runs at a CONSTANT lr (qbn_tpu/presets.py explains why)
    ("sgld", "regression"): dict(learning_rate=1e-2, epochs=300,
                                 batch_size=128, optimizer="sghmc",
                                 lr_schedule="constant",
                                 loss_scaling="whole", loss_multiplier=2.0,
                                 burnin_epochs=200,
                                 resample_momentum_iterations=10,
                                 resample_prior_iterations=5, samples=7),
    ("sgld", "mnist"): dict(learning_rate=1e-2, epochs=100, batch_size=256,
                            optimizer="sghmc", lr_schedule="constant",
                            loss_scaling="whole",
                            loss_multiplier=1.0, burnin_epochs=20,
                            resample_momentum_iterations=50,
                            resample_prior_iterations=15, samples=7),
    ("sgld", "cifar"): dict(learning_rate=1e-2, epochs=300, batch_size=256,
                            optimizer="sghmc", lr_schedule="constant",
                            loss_scaling="whole",
                            loss_multiplier=16.0, burnin_epochs=200,
                            resample_momentum_iterations=50,
                            resample_prior_iterations=25, samples=7),
}


QAT_LR_EXCEPTIONS = {("mcdropout", "cifar"): 1e-3}
QAT_BATCH_EXCEPTIONS = {("pointwise", "cifar"): 1024, ("sgld", "cifar"): 1024}


def preset(method: str, tier: str, phase: str = "float",
           **overrides) -> Config:
    """The Config of one experiment cell; phase 'float' (float32
    training) or 'qat' (the QAT fine-tune that precedes convert)."""
    if phase not in ("float", "qat"):
        raise ValueError(f"unknown phase '{phase}'")
    if (method, tier) not in FLOAT:
        raise KeyError(f"no preset for ({method}, {tier})")
    kw = dict(FLOAT[(method, tier)])
    kw.update(
        model=_ARCH[tier] + _SUFFIX[method],
        dataset=_DATASET[tier],
        task="regression" if tier == "regression" else "classification",
        input_size=_INPUT[tier],
        output_size=1 if tier == "regression" else 10,
        valid_portion=0.1 if tier != "regression" else 0.2,
    )
    if phase == "qat":
        # the QAT runner scripts use 'batch' scaling with no multiplier,
        # sgld's included (its float phase uses 'whole')
        kw.update(optimizer="sgd",
                  learning_rate=QAT_LR_EXCEPTIONS.get((method, tier), 1e-5),
                  epochs=10, at=True, q=True, lr_schedule="cosine",
                  loss_scaling="batch", loss_multiplier=1.0)
        if method == "bbb":
            kw["gamma"] = 0.0
        if (method, tier) in QAT_BATCH_EXCEPTIONS:
            kw["batch_size"] = QAT_BATCH_EXCEPTIONS[(method, tier)]
    kw.update(overrides)
    return Config(**kw)
