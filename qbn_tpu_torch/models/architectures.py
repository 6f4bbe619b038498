"""CIFAR ResNet-18 in int mode (port of BasicBlock and ResNet of
qbn_tpu/models/architectures.py).

Widths 24/48/96/192, stages [2, 2, 2, 2], strides 1/2/2/2, avgpool 4, fc,
softmax. Data layout NHWC; the network returns per-sample probabilities
(B, S, classes), or the int8 activations at an `up_to` cut.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.models.layers import (
    ConvBlock, DenseBlock, InputQuant, ResidualAdd, avg_pool, dequant,
    flatten, scope,
)

CUTS = ("stem", "stage0", "stage1", "stage2", "stage3", "pool")


class BasicBlock(nn.Module):
    """ResNet basic block: two 3x3 conv+BN, optional 1x1 shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.conv_bn_relu = ConvBlock(planes, (3, 3), (stride, stride),
                                      padding=1, relu=True, quant=quant)
        self.conv_bn = ConvBlock(planes, (3, 3), (1, 1), padding=1,
                                 quant=quant)
        self.shortcut = None
        if stride != 1 or in_planes != planes:
            self.shortcut = ConvBlock(planes, (1, 1), (stride, stride),
                                      padding=0, quant=quant)
        self.add = ResidualAdd(quant, relu=True)

    def forward(self, x, variables):
        out = self.conv_bn_relu(x, scope(variables, "conv_bn_relu"))
        out = self.conv_bn(out, scope(variables, "conv_bn"))
        shortcut = x
        if self.shortcut is not None:
            shortcut = self.shortcut(x, scope(variables, "shortcut"))
        return self.add(out, shortcut, scope(variables, "add"))


class ResNet(nn.Module):
    """CIFAR ResNet-18 at widths 24/48/96/192."""

    def __init__(self, output_size: int = 10,
                 widths: Sequence[int] = (24, 48, 96, 192),
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.input_quant = InputQuant(quant)
        self.stem = ConvBlock(widths[0], (3, 3), (1, 1), padding=1,
                              relu=True, quant=quant)
        self.stages = []
        in_planes = widths[0]
        for s, (planes, blocks, stride) in enumerate(
                zip(widths, num_blocks, strides)):
            names = []
            for b in range(blocks):
                name = f"stage{s}_block{b}"
                self.add_module(name, BasicBlock(
                    in_planes, planes, stride if b == 0 else 1, quant))
                names.append(name)
                in_planes = planes
            self.stages.append(names)
        self.fc = DenseBlock(output_size, use_bias=False, quant=quant)

    def forward(self, x, variables, up_to: str = None):
        """x: (B, H, W, C) float32 images; variables: {'qconst': ...,
        'sampled': ...} with (S, ...) weight codes per stochastic layer.
        Returns (B, S, classes) probabilities, or the MergedQTensor at
        `up_to` (one of CUTS)."""
        if up_to is not None and up_to not in CUTS:
            raise ValueError(f"up_to must be one of {CUTS}")
        x = self.input_quant(x, scope(variables, "input_quant"))
        x = self.stem(x, scope(variables, "stem"))
        if up_to == "stem":
            return x
        for s, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, scope(variables, name))
            if up_to == f"stage{s}":
                return x
        x = flatten(avg_pool(x, 4))
        if up_to == "pool":
            return x
        x = self.fc(x, scope(variables, "fc"))
        return torch.softmax(dequant(x), dim=-1)
