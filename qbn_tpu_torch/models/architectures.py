"""Architectures (port of qbn_tpu/models/architectures.py).

* LeNet in float mode: conv(20, 5x5, pad 2) -> maxpool 2 -> conv(50) ->
  maxpool 2 -> flatten -> fc 500 + ReLU -> fc out -> softmax (the convs
  have no ReLU or BN). Returns (B, classes) probabilities.
* CIFAR ResNet-18 in int mode: widths 24/48/96/192, stages [2, 2, 2, 2],
  strides 1/2/2/2, avgpool 4, fc, softmax. Returns per-sample
  probabilities (B, S, classes), or the int8 activations at an `up_to`
  cut.

Data layout NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.models.layers import (
    ConvBlock, DenseBlock, InputQuant, ResidualAdd, avg_pool, dequant,
    flatten, max_pool, scope,
)

CUTS = ("stem", "stage0", "stage1", "stage2", "stage3", "pool")


def _child(kl, name):
    """The KL subtree of child `name` (None when KL is not collected)."""
    return None if kl is None else kl.setdefault(name, {})


class LeNet(nn.Module):
    """MNIST LeNet-style conv net, float mode."""

    def __init__(self, output_size: int = 10, stochastic: bool = False,
                 sigma_prior: float = 1.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        kw = dict(stochastic=stochastic, sigma_prior=sigma_prior,
                  quant=quant)
        self.input_quant = InputQuant(quant)
        self.conv_0 = ConvBlock(20, (5, 5), (1, 1), padding=2,
                                use_bias=False, std_init=-10.0, **kw)
        self.conv_1 = ConvBlock(50, (5, 5), (1, 1), padding=2,
                                use_bias=False, std_init=-10.0, **kw)
        self.fc_0 = DenseBlock(500, use_bias=False, relu=True,
                               std_init=-3.0, **kw)
        self.fc_1 = DenseBlock(output_size, use_bias=False, std_init=-3.0,
                               **kw)

    def init(self, generator, input_size: Sequence[int]):
        """The 'params' tree for (H, W, C) inputs."""
        h, w, c = input_size
        params = {"conv_0": self.conv_0.init(generator, c)}
        h, w = (d // 2 for d in self.conv_0.out_hw(h, w))
        params["conv_1"] = self.conv_1.init(generator, 20)
        h, w = (d // 2 for d in self.conv_1.out_hw(h, w))
        params["fc_0"] = self.fc_0.init(generator, h * w * 50)
        params["fc_1"] = self.fc_1.init(generator, 500)
        return params

    def forward(self, x, variables, *, train: bool = False,
                mode: str = "float", noise=None, kl: dict = None):
        """x: (B, H, W, C) float32 images; noise: the noise source of the
        stochastic layers; kl: a dict that receives each layer's KL under
        its name, as qbn_tpu's 'kl' collection. Returns (B, classes)
        probabilities."""
        if mode != "float":
            raise NotImplementedError(f"LeNet mode '{mode}' is not ported")
        kw = dict(train=train, noise=noise)
        x = self.input_quant(x, scope(variables, "input_quant"))
        x = self.conv_0(x, scope(variables, "conv_0"),
                        kl=_child(kl, "conv_0"), **kw)
        x = max_pool(x, 2, 2)
        x = self.conv_1(x, scope(variables, "conv_1"),
                        kl=_child(kl, "conv_1"), **kw)
        x = max_pool(x, 2, 2)
        x = flatten(x)                      # (h, w, c) order, as in NHWC
        x = self.fc_0(x, scope(variables, "fc_0"), kl=_child(kl, "fc_0"),
                      **kw)
        x = self.fc_1(x, scope(variables, "fc_1"), kl=_child(kl, "fc_1"),
                      **kw)
        return torch.softmax(dequant(x), dim=-1)


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
        out = self.conv_bn_relu(x, scope(variables, "conv_bn_relu"),
                                mode="int")
        out = self.conv_bn(out, scope(variables, "conv_bn"), mode="int")
        shortcut = x
        if self.shortcut is not None:
            shortcut = self.shortcut(x, scope(variables, "shortcut"),
                                     mode="int")
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
        x = self.input_quant(x, scope(variables, "input_quant"), mode="int")
        x = self.stem(x, scope(variables, "stem"), mode="int")
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
        x = self.fc(x, scope(variables, "fc"), mode="int")
        return torch.softmax(dequant(x), dim=-1)
