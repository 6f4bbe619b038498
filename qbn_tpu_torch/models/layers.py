"""Layers in float mode and in INT mode's merged layout (port of the float
and int branches of qbn_tpu/models/layers.py).

The modules hold the architecture only. Their state is a variable tree in
flax's nesting (collections 'qconst', 'sampled', 'params', ... each keyed
by module name), passed to `forward` and narrowed to a child's subtree with
`scope`, so that each module reads the constants its flax counterpart
wrote, under the same path.

Each block's `forward` takes qbn_tpu's `mode`: 'float' (the float32
forward; Bayes-by-backprop blocks train by local reparametrisation and
evaluate on one weight sample, drawing from a noise source, and write
their KL into the `kl` dict given) or 'int'. `init` makes a block's
'params' subtree with qbn_tpu's init laws from a torch.Generator.

INT Monte-Carlo evaluation runs every posterior sample in ONE forward:
conv activations are (B, H, W, S*C) int8 codes with sample-major channel
groups, dense activations (B, S, F) (MergedQTensor). The stem enters the
layout from the shared (B, H, W, C) input (QTensor).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.ops.integer import int_conv_merged, int_dense_merged
from qbn_tpu_torch.ops.stochastic import (
    conv_nhwc, kl_divergence, local_reparam_conv, local_reparam_dense_auto,
    sample_weights, softplus)


@dataclass
class QTensor:
    """Quantised activation: ZERO-POINT-REMOVED int8 codes + qparams.
    codes = q - zp; dequant = codes * scale."""
    codes: torch.Tensor   # int8
    scale: torch.Tensor   # f32 scalar
    zp: torch.Tensor      # int32 scalar


@dataclass
class MergedQTensor:
    """Quantised activations of ALL posterior samples in the merged layout:
    conv (B, H, W, S*C), dense (B, S, F); one scale/zp for every sample."""
    codes: torch.Tensor
    scale: torch.Tensor
    zp: torch.Tensor
    s: int = 1


def scope(variables, name: str):
    """The variables of child module `name`: each collection's subtree."""
    return {c: tree[name] for c, tree in variables.items()
            if isinstance(tree, dict) and name in tree}


def quantize_codes(x, scale, zp, a_lo: int, a_hi: int):
    """Float -> zero-point-removed int8 codes clamped to the sub-8-bit
    bounds: clip(round(x / scale) + zp) - zp."""
    zp_f = zp.to(torch.float32)
    q = torch.clamp(torch.round(x / scale) + zp_f, a_lo, a_hi)
    return (q.to(torch.int32) - zp).to(torch.int8)


def dequantize_codes(codes, scale):
    return codes.to(torch.float32) * scale


# -- init laws (qbn_tpu's), drawn on the CPU from a torch.Generator ------

def _uniform(generator, shape, bound):
    out = torch.empty(shape, dtype=torch.float32)
    return out.uniform_(-bound, bound, generator=generator)


def _torch_linear_init(generator, shape):
    """torch nn.Linear/Conv2d default init: U(-1/sqrt(fan_in), +)."""
    fan_in = shape[0] if len(shape) == 2 else shape[0] * shape[1] * shape[2]
    return _uniform(generator, shape, 1.0 / math.sqrt(fan_in))


def _bbb_weight_init(generator, shape):
    return _uniform(generator, shape, 0.01)


def _torch_bias_init(fan_in: int):
    """torch default bias init: U(-1/sqrt(fan_in of the weight), +)."""
    def init(generator, shape):
        return _uniform(generator, shape, 1.0 / float(fan_in) ** 0.5)
    return init


def _init_params(generator, kshape, features, stochastic, std_init,
                 use_bias, fan_in):
    """{'kernel', 'std', 'bias'} of a dense or conv block, in qbn_tpu's
    order and laws."""
    w_init = _bbb_weight_init if stochastic else _torch_linear_init
    params = {"kernel": w_init(generator, kshape)}
    if stochastic:
        params["std"] = torch.full(kshape, float(std_init))
    if use_bias:
        b_init = _bbb_weight_init if stochastic else _torch_bias_init(fan_in)
        params["bias"] = b_init(generator, (features,))
    return params


def _sow_kl(kl, kernel, sp, sigma_prior):
    """KL of the posterior against the zero-mean sigma_prior Gaussian prior
    into kl['kl'] (qbn_tpu's sow into the 'kl' collection)."""
    if kl is not None:
        kl["kl"] = kl_divergence(kernel, sp, torch.zeros_like(kernel),
                                 torch.full_like(sp, sigma_prior))


class DenseBlock(nn.Module):
    """Dense layer + optional fused ReLU, pointwise or Bayes-by-backprop."""

    def __init__(self, features: int, use_bias: bool = True,
                 stochastic: bool = False, relu: bool = False,
                 sigma_prior: float = 1.0, std_init: float = -3.0,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.features, self.use_bias, self.relu = features, use_bias, relu
        self.stochastic, self.sigma_prior = stochastic, sigma_prior
        self.std_init, self.quant = std_init, quant

    def init(self, generator, in_features: int):
        return _init_params(generator, (in_features, self.features),
                            self.features, self.stochastic, self.std_init,
                            self.use_bias, in_features)

    def forward(self, x, variables, *, train: bool = False,
                mode: str = "float", noise=None, kl: Optional[dict] = None):
        if mode == "int":
            return self._int_forward(x, variables)
        if mode != "float":
            raise NotImplementedError(f"mode '{mode}' is not ported")
        p = variables["params"]
        kernel, bias = p["kernel"], p.get("bias")
        if not self.stochastic:
            y = torch.matmul(x, kernel)
            y = y + bias if bias is not None else y
        else:
            sp = softplus(p["std"])
            _sow_kl(kl, kernel, sp, self.sigma_prior)
            if train:
                y = local_reparam_dense_auto(x, kernel, sp, noise, bias,
                                             fused=self.quant.tpu_fused)
            else:
                y = torch.matmul(x, sample_weights(kernel, sp, noise))
                y = y + bias if bias is not None else y
        return torch.relu(y) if self.relu else y

    def _int_forward(self, x, variables):
        qc = variables["qconst"]["q"]
        presampled = variables["sampled"]["w"]          # (S, F, O)
        bias = variables["params"]["bias"] if self.use_bias else None
        a_lo, a_hi = self.quant.a_bounds
        codes = int_dense_merged(
            x.codes, x.scale, presampled, qc["add_scale"], qc["add_zp"],
            bias, qc["act_scale"], qc["act_zp"], a_lo, a_hi, relu=self.relu,
            shared_x=isinstance(x, QTensor))
        return MergedQTensor(codes, qc["act_scale"], qc["act_zp"],
                             s=presampled.shape[0])


class ConvBlock(nn.Module):
    """Conv + optional fused ReLU, pointwise or Bayes-by-backprop. Float
    mode has no batch norm yet; in int mode BN is folded into the int
    constants."""

    def __init__(self, features: int, kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding: int = 0,
                 use_bias: bool = False, stochastic: bool = False,
                 relu: bool = False, sigma_prior: float = 1.0,
                 std_init: float = -10.0, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.features, self.kernel_size = features, tuple(kernel_size)
        self.strides, self.padding = tuple(strides), padding
        self.use_bias, self.stochastic, self.relu = use_bias, stochastic, relu
        self.sigma_prior, self.std_init, self.quant = (sigma_prior, std_init,
                                                       quant)

    def init(self, generator, cin: int):
        kshape = (*self.kernel_size, cin, self.features)
        return _init_params(generator, kshape, self.features,
                            self.stochastic, self.std_init, self.use_bias,
                            math.prod(kshape[:3]))

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        (kh, kw), (sh, sw), p = self.kernel_size, self.strides, self.padding
        return (h + 2 * p - kh) // sh + 1, (w + 2 * p - kw) // sw + 1

    def forward(self, x, variables, *, train: bool = False,
                mode: str = "float", noise=None, kl: Optional[dict] = None):
        if mode == "int":
            return self._int_forward(x, variables)
        if mode != "float":
            raise NotImplementedError(f"mode '{mode}' is not ported")
        p = variables["params"]
        kernel, bias = p["kernel"], p.get("bias")
        if not self.stochastic:
            y = conv_nhwc(x, kernel, self.strides, self.padding)
            y = y + bias if bias is not None else y
        else:
            sp = softplus(p["std"])
            _sow_kl(kl, kernel, sp, self.sigma_prior)
            if train:
                y = local_reparam_conv(x, kernel, sp, noise, self.strides,
                                       self.padding, bias)
            else:
                y = conv_nhwc(x, sample_weights(kernel, sp, noise),
                              self.strides, self.padding)
                y = y + bias if bias is not None else y
        return torch.relu(y) if self.relu else y

    def _int_forward(self, x, variables):
        qc = variables["qconst"]["q"]
        presampled = variables["sampled"]["w"]  # (S, kh, kw, cin, cout)
        a_lo, a_hi = self.quant.a_bounds
        out = int_conv_merged(
            x.codes, x.scale, presampled, qc["add_scale"], qc["add_zp"],
            qc["bias_f"], qc["act_scale"], qc["act_zp"], self.strides,
            [(self.padding, self.padding)] * 2, a_lo, a_hi, relu=self.relu,
            shared_x=isinstance(x, QTensor))
        return MergedQTensor(out, qc["act_scale"], qc["act_zp"],
                             s=presampled.shape[0])


class ResidualAdd(nn.Module):
    """Quantised residual add: dequant both operands, add, requant to the
    add observer's grid; relu folds the block's post-add ReLU in."""

    def __init__(self, quant: QuantConfig = QuantConfig(),
                 relu: bool = False):
        super().__init__()
        self.quant, self.relu = quant, relu

    def forward(self, a, b, variables):
        qc = variables["qconst"]["q"]
        s, z = qc["scale"], qc["zp"]
        a_lo, a_hi = self.quant.a_bounds
        total = (dequantize_codes(a.codes, a.scale)
                 + dequantize_codes(b.codes, b.scale))
        codes = quantize_codes(total, s, z, a_lo, a_hi)
        if self.relu:
            codes = torch.clamp(codes, min=0)   # u >= 0 <=> q >= zp
        return MergedQTensor(codes, s, z, s=a.s)


class InputQuant(nn.Module):
    """QuantStub equivalent: float input -> activation codes in int mode,
    the input itself in float mode."""

    def __init__(self, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.quant = quant

    def forward(self, x, variables, *, mode: str = "float"):
        if mode == "float":
            return x
        qc = variables["qconst"]["q"]
        s, z = qc["scale"], qc["zp"]
        a_lo, a_hi = self.quant.a_bounds
        return QTensor(quantize_codes(x, s, z, a_lo, a_hi), s, z)


def dequant(x):
    """Codes back to float32; merged dense (B, S, F) stays (B, S, F). A
    float tensor passes through."""
    if isinstance(x, torch.Tensor):
        return x
    return dequantize_codes(x.codes, x.scale)


def max_pool(x, window: int = 2, stride: int = 2):
    """Max pool of float NHWC activations, 'VALID' windows. (Pooling of
    int codes goes with the int LeNet, not ported yet.)"""
    if not isinstance(x, torch.Tensor):
        raise NotImplementedError("max_pool of int codes is not ported")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
    return y.permute(0, 2, 3, 1)


def avg_pool(x: MergedQTensor, window: int) -> MergedQTensor:
    """Average pool of codes, rounding half to even (FBGEMM's quantised
    avg-pool keeps scale/zp and rounds); windows that do not fit are
    dropped, as with 'VALID' padding."""
    b, h, w, c = x.codes.shape
    ho, wo = h // window, w // window
    codes = x.codes[:, :ho * window, :wo * window].to(torch.int32)
    summed = codes.reshape(b, ho, window, wo, window, c).sum(dim=(2, 4))
    pooled = torch.round(summed.to(torch.float32) / (window * window))
    return MergedQTensor(pooled.to(torch.int8), x.scale, x.zp, s=x.s)


def flatten(x):
    """Float (B, H, W, C) -> (B, H*W*C) in (h, w, c) order, as qbn_tpu's
    NHWC activations flatten. Merged codes (B, H, W, S*C) -> (B, S, H*W*C):
    per-sample flattening, so that the dense weights see the feature order
    of one sample's (H, W, C)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(x.shape[0], -1)
    b, h, w, sc = x.codes.shape
    c = sc // x.s
    codes = x.codes.reshape(b, h, w, x.s, c).permute(0, 3, 1, 2, 4)
    return MergedQTensor(codes.reshape(b, x.s, h * w * c), x.scale, x.zp,
                         s=x.s)


def relu(x: MergedQTensor) -> MergedQTensor:
    """ReLU on codes: max(code, zero point), i.e. u >= 0."""
    return MergedQTensor(torch.clamp(x.codes, min=0), x.scale, x.zp, s=x.s)
