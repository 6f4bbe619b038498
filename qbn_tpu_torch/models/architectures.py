"""Architectures (port of qbn_tpu/models/architectures.py).

* MLPNet, float, qat, convert and int modes: in -> 100 -> 100 -> 100
  (ReLU) -> {mu, log_var} heads; returns (mu, exp(log_var)).
* LeNet, float, qat, convert and int modes: conv(20, 5x5, pad 2) ->
  maxpool 2 -> conv(50) -> maxpool 2 -> flatten -> fc 500 + ReLU -> fc
  out -> softmax (the convs have no ReLU or BN). Returns probabilities.
* CIFAR ResNet-18, float, qat, convert and int modes: widths
  24/48/96/192, basic blocks, stages [2, 2, 2, 2], strides 1/2/2/2, a
  3x3/1 stem, every conv with batch norm, avgpool 4, fc, softmax.
  Returns probabilities, or the int8 activations at an `up_to` cut (int
  mode).
* ImageNet ResNet-50 v1.5, the same modes and returns: a 7x7/2 stem, a
  padded 3x3/2 max pool, bottleneck blocks, stages [3, 4, 6, 3] at widths
  64/128/256/512 x 4, global avgpool, fc to 1000 classes.

As in qbn_tpu, one definition serves every method: `stochastic` makes the
blocks Bayes-by-backprop (int mode: the merged layout over drawn weights,
(B, S, classes) out), `dropout_p` adds the always-on MC-Dropout sites
(int mode: S masked samples from `masks`, (S, B, classes) out; float and
qat modes: one mask per site, the source's first sample); pointwise and an
SGHMC ensemble member run the deterministic blocks on one input, (B,
classes) out. Data layout NHWC.

The float, qat and convert modes take qbn_tpu's `train` and
`update_stats` flags, a noise source, a mask source, the `kl` dict and the
`mutable` collections (models/layers.py); the call order of the noise and
mask draws is qbn_tpu's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.models.layers import (
    MODES, BernoulliDropout, ConvBlock, DenseBlock, InputQuant,
    MergedQTensor, ResidualAdd, avg_pool, child, dequant, flatten, max_pool,
    scope,
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

    def _drop(self, name, x, variables, masks, mode="int", mutable=None,
              **kw):
        if self.dropout_p <= 0:
            return x
        if masks is None:
            raise ValueError("an MC-Dropout model needs a mask source")
        if mode == "int":
            return getattr(self, name)(x, scope(variables, name), masks)
        return getattr(self, name)(x, scope(variables, name), masks,
                                   mode=mode, mutable=child(mutable, name),
                                   **kw)


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError(f"unknown mode '{mode}'")


class MLPNet(_Sites):
    """Regression MLP with mean and log-variance heads."""

    def __init__(self, output_size: int = 1,
                 hidden: Sequence[int] = (100, 100, 100),
                 stochastic: bool = False, dropout_p: float = 0.0,
                 sigma_prior: float = 1.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.hidden, self.dropout_p = tuple(hidden), dropout_p
        self.stochastic = stochastic
        self.input_quant = InputQuant(quant)
        kw = dict(use_bias=True, stochastic=stochastic,
                  sigma_prior=sigma_prior, std_init=-3.0, quant=quant)
        for i, h in enumerate(self.hidden):
            self.add_module(f"dense_{i}", DenseBlock(h, relu=True, **kw))
            if i != len(self.hidden) - 1:
                self._site(f"drop_{i}", quant)
        self._site("drop_mu", quant)
        self._site("drop_log_var", quant)
        self.mu = DenseBlock(output_size, **kw)
        self.log_var = DenseBlock(output_size, **kw)

    def init(self, generator, input_size: Sequence[int]):
        """The 'params' tree for (features,) inputs (or any shape, which
        the forward flattens)."""
        params, fan_in = {}, math.prod(input_size)
        for i, h in enumerate(self.hidden):
            params[f"dense_{i}"] = getattr(self, f"dense_{i}").init(
                generator, fan_in)
            fan_in = h
        for name in ("mu", "log_var"):
            params[name] = getattr(self, name).init(generator, fan_in)
        return params

    def forward(self, x, variables, *, train: bool = False,
                mode: str = "float", noise=None, kl: dict = None,
                masks=None, update_stats: bool = False,
                mutable: dict = None, initializing: bool = False):
        """x: (B, features) float32 (or (B, ...), flattened); noise, kl,
        masks, mutable as for the LeNet. Returns (mu, var), each (B,
        out), or (S, B, out) under MC-Dropout in int mode."""
        _check_mode(mode)
        kw = dict(train=train, mode=mode, noise=noise,
                  update_stats=update_stats, initializing=initializing)
        dkw = dict(mode=mode, train=train, update_stats=update_stats,
                   initializing=initializing, mutable=mutable)
        if mode == "int":
            kw = dkw = dict(mode="int")
        x = x.reshape(x.shape[0], -1) if x.ndim > 2 else x
        x = self.input_quant(x, scope(variables, "input_quant"), mode=mode,
                             update_stats=update_stats,
                             mutable=child(mutable, "input_quant"),
                             initializing=initializing)

        def dense(name, inp):
            if mode == "int":
                return getattr(self, name)(inp, scope(variables, name),
                                           mode="int")
            return getattr(self, name)(inp, scope(variables, name),
                                       kl=_child(kl, name),
                                       mutable=child(mutable, name), **kw)

        for i in range(len(self.hidden)):
            x = dense(f"dense_{i}", x)
            if i != len(self.hidden) - 1:
                x = self._drop(f"drop_{i}", x, variables, masks, **dkw)
        mu_in = self._drop("drop_mu", x, variables, masks, **dkw)
        lv_in = self._drop("drop_log_var", x, variables, masks, **dkw)
        mu, log_var = dense("mu", mu_in), dense("log_var", lv_in)
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
                masks=None, update_stats: bool = False,
                mutable: dict = None, initializing: bool = False):
        """x: (B, H, W, C) float32 images; noise: the noise source of the
        stochastic layers (float, qat, convert); kl: a dict that receives
        each layer's KL under its name, as qbn_tpu's 'kl' collection;
        masks: the MC-Dropout mask source. Returns (B, classes)
        probabilities, or (S, B, classes) under MC-Dropout in int mode."""
        _check_mode(mode)
        kw = dict(train=train, mode=mode, noise=noise,
                  update_stats=update_stats, initializing=initializing)
        dkw = dict(mode=mode, train=train, update_stats=update_stats,
                   initializing=initializing)
        x = self.input_quant(x, scope(variables, "input_quant"), mode=mode,
                             update_stats=update_stats,
                             mutable=child(mutable, "input_quant"),
                             initializing=initializing)
        x = self.conv_0(x, scope(variables, "conv_0"),
                        kl=_child(kl, "conv_0"),
                        mutable=child(mutable, "conv_0"), **kw)
        x = self._drop("drop_0", x, variables, masks, mutable=mutable, **dkw)
        x = max_pool(x, 2, 2)
        x = self.conv_1(x, scope(variables, "conv_1"),
                        kl=_child(kl, "conv_1"),
                        mutable=child(mutable, "conv_1"), **kw)
        x = self._drop("drop_1", x, variables, masks, mutable=mutable, **dkw)
        x = max_pool(x, 2, 2)
        x = flatten(x)                      # (h, w, c) order, as in NHWC
        x = self.fc_0(x, scope(variables, "fc_0"), kl=_child(kl, "fc_0"),
                      mutable=child(mutable, "fc_0"), **kw)
        x = self._drop("drop_2", x, variables, masks, mutable=mutable, **dkw)
        x = self.fc_1(x, scope(variables, "fc_1"), kl=_child(kl, "fc_1"),
                      mutable=child(mutable, "fc_1"), **kw)
        return torch.softmax(dequant(x), dim=-1)


class _Residual(_Sites):
    """A ResNet block: the convs of `main` in order, each followed by its
    MC-Dropout site, an optional 1x1 conv+BN shortcut with its site, and
    the residual add + ReLU. In int mode on merged-layout input
    (Bayes-by-backprop) with no sites, the add and its ReLU run inside the
    last conv's kernel launch."""

    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int, main,
                 stochastic: bool, dropout_p: float, sigma_prior: float,
                 quant: QuantConfig):
        """main: [(name, features, kernel, stride, padding, relu)]."""
        super().__init__()
        self.dropout_p = dropout_p
        kw = dict(bn=True, stochastic=stochastic, sigma_prior=sigma_prior,
                  std_init=-10.0, quant=quant)
        self.main = []
        for i, (name, feats, k, st, pad, relu) in enumerate(main):
            self.add_module(name, ConvBlock(feats, (k, k), (st, st),
                                            padding=pad, relu=relu, **kw))
            self._site(f"drop_{i}", quant)
            self.main.append((name, f"drop_{i}"))
        self.features = planes * self.expansion
        self.shortcut = None
        if stride != 1 or in_planes != self.features:
            self.shortcut = ConvBlock(self.features, (1, 1), (stride, stride),
                                      padding=0, **kw)
            self._site("drop_sc", quant)
        self.add = ResidualAdd(quant, relu=True)

    def init(self, generator, cin: int):
        params, c = {}, cin
        for name, _site in self.main:
            params[name] = getattr(self, name).init(generator, c)
            c = getattr(self, name).features
        if self.shortcut is not None:
            params["shortcut"] = self.shortcut.init(generator, cin)
        return params

    def forward(self, x, variables, masks=None, *, mode: str = "int",
                train: bool = False, update_stats: bool = False, noise=None,
                kl: dict = None, mutable: dict = None,
                initializing: bool = False):
        kw = dict(train=train, mode=mode, noise=noise,
                  update_stats=update_stats, initializing=initializing)
        dkw = dict(mode=mode, train=train, update_stats=update_stats,
                   initializing=initializing, mutable=mutable)

        def conv(name, inp, **extra):
            return getattr(self, name)(inp, scope(variables, name),
                                       kl=_child(kl, name),
                                       mutable=child(mutable, name), **kw,
                                       **extra)

        if (mode == "int" and self.dropout_p <= 0
                and isinstance(x, MergedQTensor)):
            # per-sample weights in the merged layout and no site between
            # the last conv and the add: the add and its ReLU run in that
            # conv's epilogue (bitwise the add's own pass)
            shortcut = x if self.shortcut is None else conv("shortcut", x)
            out = x
            for name, _site in self.main[:-1]:
                out = conv(name, out)
            return conv(self.main[-1][0], out, residual=self.add.epilogue(
                shortcut, scope(variables, "add")))
        out = x
        for name, site in self.main:
            out = conv(name, out)
            out = self._drop(site, out, variables, masks, **dkw)
        shortcut = x
        if self.shortcut is not None:
            shortcut = conv("shortcut", x)
            shortcut = self._drop("drop_sc", shortcut, variables, masks,
                                  **dkw)
        if mode == "int":
            return self.add(out, shortcut, scope(variables, "add"))
        return self.add(out, shortcut, scope(variables, "add"), mode=mode,
                        update_stats=update_stats,
                        mutable=child(mutable, "add"),
                        initializing=initializing)


class BasicBlock(_Residual):
    """ResNet basic block: two 3x3 conv+BN (conv_bn_relu carries the
    stride), sites drop_0 and drop_1 after them."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 stochastic: bool = False, dropout_p: float = 0.0,
                 sigma_prior: float = 1.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__(in_planes, planes, stride, [
            ("conv_bn_relu", planes, 3, stride, 1, True),
            ("conv_bn", planes, 3, 1, 1, False)], stochastic, dropout_p,
            sigma_prior, quant)


class Bottleneck(_Residual):
    """ResNet v1.5 bottleneck block (torchvision's): 1x1 conv+BN+ReLU to
    `planes`, 3x3 conv+BN+ReLU carrying the stride, 1x1 conv+BN to 4 x
    planes; sites drop_0, drop_1 and drop_2 after them."""

    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 stochastic: bool = False, dropout_p: float = 0.0,
                 sigma_prior: float = 1.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__(in_planes, planes, stride, [
            ("conv_0", planes, 1, 1, 0, True),
            ("conv_1", planes, 3, stride, 1, True),
            ("conv_2", planes * self.expansion, 1, 1, 0, False)],
            stochastic, dropout_p, sigma_prior, quant)


def _global_pool(x):
    """Average pool over the whole (square) feature map."""
    codes = x if isinstance(x, torch.Tensor) else x.codes
    return avg_pool(x, codes.shape[-2])


class ResNet(_Sites):
    """CIFAR ResNet-18 at widths 24/48/96/192 (the defaults); with
    `block`, `stem` and `stem_pool` the other ResNets of the family
    (ImageNetResNet)."""

    def __init__(self, output_size: int = 10,
                 widths: Sequence[int] = (24, 48, 96, 192),
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 strides: Sequence[int] = (1, 2, 2, 2),
                 stochastic: bool = False, dropout_p: float = 0.0,
                 sigma_prior: float = 1.0,
                 quant: QuantConfig = QuantConfig(), block=BasicBlock,
                 stem: Tuple[int, int, int] = (3, 1, 1),
                 stem_pool: Optional[Tuple[int, int, int]] = None):
        """stem: the stem conv's (kernel, stride, padding); stem_pool: the
        max pool after it, (window, stride, padding), or None."""
        super().__init__()
        self.stochastic, self.dropout_p = stochastic, dropout_p
        self.stem_pool = stem_pool
        self.input_quant = InputQuant(quant)
        k, st, pad = stem
        self.stem = ConvBlock(widths[0], (k, k), (st, st), padding=pad,
                              bn=True, relu=True, stochastic=stochastic,
                              sigma_prior=sigma_prior, std_init=-10.0,
                              quant=quant)
        self._site("drop_stem", quant)
        self.stages = []
        in_planes = widths[0]
        for s, (planes, blocks, stride) in enumerate(
                zip(widths, num_blocks, strides)):
            names = []
            for b in range(blocks):
                name = f"stage{s}_block{b}"
                blk = block(in_planes, planes, stride if b == 0 else 1,
                            stochastic, dropout_p, sigma_prior, quant)
                self.add_module(name, blk)
                names.append(name)
                in_planes = blk.features
            self.stages.append(names)
        self.fc = DenseBlock(output_size, use_bias=False,
                             stochastic=stochastic, sigma_prior=sigma_prior,
                             std_init=-3.0, quant=quant)

    def init(self, generator, input_size: Sequence[int]):
        """The 'params' tree for (H, W, C) inputs."""
        _h, _w, c = input_size
        params = {"stem": self.stem.init(generator, c)}
        cin = self.stem.features
        for names in self.stages:
            for name in names:
                block = getattr(self, name)
                params[name] = block.init(generator, cin)
                cin = block.features
        params["fc"] = self.fc.init(generator, cin)
        return params

    def forward(self, x, variables, up_to: str = None, masks=None, *,
                mode: str = "int", train: bool = False,
                update_stats: bool = False, noise=None, kl: dict = None,
                mutable: dict = None, initializing: bool = False):
        """x: (B, H, W, C) float32 images; variables: the state (in int
        mode {'qconst': ...} and, for Bayes-by-backprop, 'sampled' with
        (S, ...) weight codes per stochastic layer); masks: the MC-Dropout
        mask source; noise, kl, mutable as for the LeNet. Returns (B, S,
        classes) probabilities (BBB, int), (S, B, classes) (MC-Dropout,
        int) or (B, classes), or the codes at `up_to` (one of CUTS, int
        mode; "stem" after the stem's pool)."""
        _check_mode(mode)
        if up_to is not None and (up_to not in CUTS or mode != "int"):
            raise ValueError(f"up_to must be one of {CUTS}, in int mode")
        kw = dict(train=train, mode=mode, noise=noise,
                  update_stats=update_stats, initializing=initializing)
        dkw = dict(mode=mode, train=train, update_stats=update_stats,
                   initializing=initializing, mutable=mutable)
        x = self.input_quant(x, scope(variables, "input_quant"), mode=mode,
                             update_stats=update_stats,
                             mutable=child(mutable, "input_quant"),
                             initializing=initializing)
        x = self.stem(x, scope(variables, "stem"), kl=_child(kl, "stem"),
                      mutable=child(mutable, "stem"), **kw)
        x = self._drop("drop_stem", x, variables, masks, **dkw)
        if self.stem_pool is not None:
            x = max_pool(x, *self.stem_pool)
        if up_to == "stem":
            return x
        for s, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(
                    x, scope(variables, name), masks, kl=_child(kl, name),
                    mutable=child(mutable, name), **kw)
            if up_to == f"stage{s}":
                return x
        x = flatten(_global_pool(x))
        if up_to == "pool":
            return x
        x = self.fc(x, scope(variables, "fc"), kl=_child(kl, "fc"),
                    mutable=child(mutable, "fc"), **kw)
        return torch.softmax(dequant(x), dim=-1)


class ImageNetResNet(ResNet):
    """ImageNet ResNet-50 v1.5 (torchvision's resnet50): a 7x7/2 stem of
    64 channels with padding 3, BN and ReLU, a 3x3/2 max pool with
    padding 1, bottleneck stages [3, 4, 6, 3] at widths 64/128/256/512
    (outputs 4 x), the stride on each stage's first 3x3, global average
    pool, dense head (no bias, as the CIFAR ResNet's)."""

    def __init__(self, output_size: int = 1000,
                 widths: Sequence[int] = (64, 128, 256, 512),
                 num_blocks: Sequence[int] = (3, 4, 6, 3), **kw):
        super().__init__(output_size, widths, num_blocks, (1, 2, 2, 2),
                         block=Bottleneck, stem=(7, 2, 3),
                         stem_pool=(3, 2, 1), **kw)
