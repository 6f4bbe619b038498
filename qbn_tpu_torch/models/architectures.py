"""Architectures (port of qbn_tpu/models/architectures.py).

* MLPNet, int mode: in -> 100 -> 100 -> 100 (ReLU) -> {mu, log_var}
  heads; returns (mu, exp(log_var)).
* LeNet, float and int mode: conv(20, 5x5, pad 2) -> maxpool 2 ->
  conv(50) -> maxpool 2 -> flatten -> fc 500 + ReLU -> fc out -> softmax
  (the convs have no ReLU or BN). Returns probabilities.
* CIFAR ResNet-18, int mode: widths 24/48/96/192, stages [2, 2, 2, 2],
  strides 1/2/2/2, avgpool 4, fc, softmax. Returns probabilities, or the
  int8 activations at an `up_to` cut.

As in qbn_tpu, one definition serves every method: `stochastic` makes the
blocks Bayes-by-backprop (int mode: the merged layout over drawn weights,
(B, S, classes) out), `dropout_p` adds the always-on MC-Dropout sites
(int mode: S masked samples from `masks`, (S, B, classes) out); pointwise
and an SGHMC ensemble member run the deterministic blocks on one input,
(B, classes) out. Data layout NHWC.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.models.layers import (
    BernoulliDropout, ConvBlock, DenseBlock, InputQuant, ResidualAdd,
    avg_pool, dequant, flatten, max_pool, scope,
)

CUTS = ("stem", "stage0", "stage1", "stage2", "stage3", "pool")


def _child(kl, name):
    """The KL subtree of child `name` (None when KL is not collected)."""
    return None if kl is None else kl.setdefault(name, {})


class _Sites(nn.Module):
    """A module with MC-Dropout sites: `_site(name)` registers one where
    dropout_p > 0, `_drop(name, ...)` applies it (or passes x through)."""

    def _site(self, name, quant):
        if self.dropout_p > 0:
            self.add_module(name, BernoulliDropout(self.dropout_p, quant))

    def _drop(self, name, x, variables, masks):
        if self.dropout_p <= 0:
            return x
        if masks is None:
            raise ValueError("an MC-Dropout model needs a mask source")
        return getattr(self, name)(x, scope(variables, name), masks)


class MLPNet(_Sites):
    """Regression MLP with mean and log-variance heads, int mode."""

    def __init__(self, output_size: int = 1,
                 hidden: Sequence[int] = (100, 100, 100),
                 stochastic: bool = False, dropout_p: float = 0.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.hidden, self.dropout_p = tuple(hidden), dropout_p
        self.stochastic = stochastic
        self.input_quant = InputQuant(quant)
        kw = dict(use_bias=True, stochastic=stochastic, quant=quant)
        for i, h in enumerate(self.hidden):
            self.add_module(f"dense_{i}", DenseBlock(h, relu=True, **kw))
            if i != len(self.hidden) - 1:
                self._site(f"drop_{i}", quant)
        self._site("drop_mu", quant)
        self._site("drop_log_var", quant)
        self.mu = DenseBlock(output_size, **kw)
        self.log_var = DenseBlock(output_size, **kw)

    def forward(self, x, variables, *, mode: str = "int", masks=None):
        """x: (B, features) float32 (or (B, ...), flattened). Returns
        (mu, var), each (B, out), or (S, B, out) under MC-Dropout."""
        if mode != "int":
            raise NotImplementedError(f"MLPNet mode '{mode}' is not ported")
        x = x.reshape(x.shape[0], -1) if x.ndim > 2 else x
        x = self.input_quant(x, scope(variables, "input_quant"), mode="int")
        for i in range(len(self.hidden)):
            x = getattr(self, f"dense_{i}")(x, scope(variables, f"dense_{i}"),
                                            mode="int")
            if i != len(self.hidden) - 1:
                x = self._drop(f"drop_{i}", x, variables, masks)
        mu_in = self._drop("drop_mu", x, variables, masks)
        lv_in = self._drop("drop_log_var", x, variables, masks)
        mu = self.mu(mu_in, scope(variables, "mu"), mode="int")
        log_var = self.log_var(lv_in, scope(variables, "log_var"),
                               mode="int")
        return dequant(mu), torch.exp(dequant(log_var))


class LeNet(_Sites):
    """MNIST LeNet-style conv net: float mode (pointwise, BBB) and int mode
    (pointwise, MC-Dropout, an ensemble member)."""

    def __init__(self, output_size: int = 10, stochastic: bool = False,
                 dropout_p: float = 0.0, sigma_prior: float = 1.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.stochastic, self.dropout_p = stochastic, dropout_p
        kw = dict(stochastic=stochastic, sigma_prior=sigma_prior,
                  quant=quant)
        self.input_quant = InputQuant(quant)
        self.conv_0 = ConvBlock(20, (5, 5), (1, 1), padding=2,
                                use_bias=False, std_init=-10.0, **kw)
        self._site("drop_0", quant)
        self.conv_1 = ConvBlock(50, (5, 5), (1, 1), padding=2,
                                use_bias=False, std_init=-10.0, **kw)
        self._site("drop_1", quant)
        self.fc_0 = DenseBlock(500, use_bias=False, relu=True,
                               std_init=-3.0, **kw)
        self._site("drop_2", quant)
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
                mode: str = "float", noise=None, kl: dict = None,
                masks=None):
        """x: (B, H, W, C) float32 images; noise: the noise source of the
        stochastic layers (float mode); kl: a dict that receives each
        layer's KL under its name, as qbn_tpu's 'kl' collection; masks:
        the MC-Dropout mask source (int mode). Returns (B, classes)
        probabilities, or (S, B, classes) under MC-Dropout."""
        if mode not in ("float", "int"):
            raise NotImplementedError(f"LeNet mode '{mode}' is not ported")
        if mode == "float" and self.dropout_p > 0:
            raise NotImplementedError("float MC-Dropout is not ported")
        kw = dict(train=train, mode=mode, noise=noise)
        x = self.input_quant(x, scope(variables, "input_quant"), mode=mode)
        x = self.conv_0(x, scope(variables, "conv_0"),
                        kl=_child(kl, "conv_0"), **kw)
        x = max_pool(self._drop("drop_0", x, variables, masks), 2, 2)
        x = self.conv_1(x, scope(variables, "conv_1"),
                        kl=_child(kl, "conv_1"), **kw)
        x = max_pool(self._drop("drop_1", x, variables, masks), 2, 2)
        x = flatten(x)                      # (h, w, c) order, as in NHWC
        x = self.fc_0(x, scope(variables, "fc_0"), kl=_child(kl, "fc_0"),
                      **kw)
        x = self._drop("drop_2", x, variables, masks)
        x = self.fc_1(x, scope(variables, "fc_1"), kl=_child(kl, "fc_1"),
                      **kw)
        return torch.softmax(dequant(x), dim=-1)


class BasicBlock(_Sites):
    """ResNet basic block: two 3x3 conv+BN, optional 1x1 shortcut, and
    the MC-Dropout sites after each conv."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 stochastic: bool = False, dropout_p: float = 0.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.dropout_p = dropout_p
        kw = dict(stochastic=stochastic, quant=quant)
        self.conv_bn_relu = ConvBlock(planes, (3, 3), (stride, stride),
                                      padding=1, relu=True, **kw)
        self._site("drop_0", quant)
        self.conv_bn = ConvBlock(planes, (3, 3), (1, 1), padding=1, **kw)
        self._site("drop_1", quant)
        self.shortcut = None
        if stride != 1 or in_planes != planes:
            self.shortcut = ConvBlock(planes, (1, 1), (stride, stride),
                                      padding=0, **kw)
            self._site("drop_sc", quant)
        self.add = ResidualAdd(quant, relu=True)

    def forward(self, x, variables, masks=None):
        out = self.conv_bn_relu(x, scope(variables, "conv_bn_relu"),
                                mode="int")
        out = self._drop("drop_0", out, variables, masks)
        out = self.conv_bn(out, scope(variables, "conv_bn"), mode="int")
        out = self._drop("drop_1", out, variables, masks)
        shortcut = x
        if self.shortcut is not None:
            shortcut = self.shortcut(x, scope(variables, "shortcut"),
                                     mode="int")
            shortcut = self._drop("drop_sc", shortcut, variables, masks)
        return self.add(out, shortcut, scope(variables, "add"))


class ResNet(_Sites):
    """CIFAR ResNet-18 at widths 24/48/96/192, int mode."""

    def __init__(self, output_size: int = 10,
                 widths: Sequence[int] = (24, 48, 96, 192),
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 stochastic: bool = False, dropout_p: float = 0.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.stochastic, self.dropout_p = stochastic, dropout_p
        self.input_quant = InputQuant(quant)
        self.stem = ConvBlock(widths[0], (3, 3), (1, 1), padding=1,
                              relu=True, stochastic=stochastic, quant=quant)
        self._site("drop_stem", quant)
        self.stages = []
        in_planes = widths[0]
        for s, (planes, blocks, stride) in enumerate(
                zip(widths, num_blocks, strides)):
            names = []
            for b in range(blocks):
                name = f"stage{s}_block{b}"
                self.add_module(name, BasicBlock(
                    in_planes, planes, stride if b == 0 else 1, stochastic,
                    dropout_p, quant))
                names.append(name)
                in_planes = planes
            self.stages.append(names)
        self.fc = DenseBlock(output_size, use_bias=False,
                             stochastic=stochastic, quant=quant)

    def forward(self, x, variables, up_to: str = None, masks=None):
        """x: (B, H, W, C) float32 images; variables: {'qconst': ...} and,
        for Bayes-by-backprop, 'sampled' with (S, ...) weight codes per
        stochastic layer; masks: the MC-Dropout mask source. Returns
        (B, S, classes) probabilities (BBB), (S, B, classes) (MC-Dropout)
        or (B, classes), or the codes at `up_to` (one of CUTS)."""
        if up_to is not None and up_to not in CUTS:
            raise ValueError(f"up_to must be one of {CUTS}")
        x = self.input_quant(x, scope(variables, "input_quant"), mode="int")
        x = self.stem(x, scope(variables, "stem"), mode="int")
        x = self._drop("drop_stem", x, variables, masks)
        if up_to == "stem":
            return x
        for s, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, scope(variables, name), masks)
            if up_to == f"stage{s}":
                return x
        x = flatten(avg_pool(x, 4))
        if up_to == "pool":
            return x
        x = self.fc(x, scope(variables, "fc"), mode="int")
        return torch.softmax(dequant(x), dim=-1)
