"""CIFAR-10 normalisation as the reference's data pipeline applies it:
(x - mean) times the float32 reciprocal of the per-channel std."""

from __future__ import annotations

import numpy as np
import torch

CIFAR_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR_INV_STD = (np.float32(1.0)
                 / np.array([0.2023, 0.1994, 0.2010], np.float32)
                 ).astype(np.float32)


def normalize_cifar(x: torch.Tensor) -> torch.Tensor:
    mean = torch.from_numpy(CIFAR_MEAN).to(x.device)
    inv_std = torch.from_numpy(CIFAR_INV_STD).to(x.device)
    return (x - mean) * inv_std
