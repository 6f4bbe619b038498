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

INT Monte-Carlo evaluation of Bayes-by-backprop runs every posterior
sample in ONE forward: conv activations are (B, H, W, S*C) int8 codes with
sample-major channel groups, dense activations (B, S, F) (MergedQTensor).
The stem enters the layout from the shared (B, H, W, C) input (QTensor).
The deterministic blocks (MC-Dropout, pointwise, an ensemble member) take
one set of weights: a QTensor in, a QTensor out, computed once; after an
MC-Dropout site the activations of the S samples lie on a leading axis,
(S, B, H, W, C) or (S, B, F) (SampleQTensor), as qbn_tpu's QTensor under
its vmap over samples.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.ops.integer import (
    int_conv, int_conv_merged, int_dense, int_dense_merged)
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


@dataclass
class SampleQTensor:
    """Quantised activations of S samples on a leading axis: conv
    (S, B, H, W, C), dense (S, B, F); one scale/zp for every sample."""
    codes: torch.Tensor
    scale: torch.Tensor
    zp: torch.Tensor


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


def _sampled(variables):
    """A Bayes-by-backprop block's drawn weight codes, (S, *kernel shape)."""
    sampled = variables.get("sampled")
    if sampled is None:
        raise NotImplementedError(
            "a Bayes-by-backprop block in int mode takes its drawn weights "
            "('sampled', evaluation.mc.draw_sampled_weights); qbn_tpu's "
            "draw inside the forward is not ported")
    return sampled["w"]


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
        bias = variables["params"]["bias"] if self.use_bias else None
        a_lo, a_hi = self.quant.a_bounds
        if self.stochastic:
            presampled = _sampled(variables)            # (S, F, O)
            codes = int_dense_merged(
                x.codes, x.scale, presampled, qc["add_scale"], qc["add_zp"],
                bias, qc["act_scale"], qc["act_zp"], a_lo, a_hi,
                relu=self.relu, shared_x=isinstance(x, QTensor))
            return MergedQTensor(codes, qc["act_scale"], qc["act_zp"],
                                 s=presampled.shape[0])
        w = qc["w_codes"]
        if isinstance(x, MergedQTensor):
            # merged activations through a deterministic dense: the shared
            # weights broadcast over the sample groups
            codes = int_dense_merged(
                x.codes, x.scale, w.expand(x.s, *w.shape), qc["w_scale"],
                qc["w_zp"], bias, qc["act_scale"], qc["act_zp"], a_lo, a_hi,
                relu=self.relu)
        else:
            codes = int_dense(
                x.codes, x.scale, w, qc["w_scale"], qc["w_zp"], bias,
                qc["act_scale"], qc["act_zp"], a_lo, a_hi, relu=self.relu)
        return dataclasses.replace(x, codes=codes, scale=qc["act_scale"],
                                   zp=qc["act_zp"])


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
        a_lo, a_hi = self.quant.a_bounds
        pad = [(self.padding, self.padding)] * 2
        if self.stochastic:
            presampled = _sampled(variables)    # (S, kh, kw, cin, cout)
            out = int_conv_merged(
                x.codes, x.scale, presampled, qc["add_scale"], qc["add_zp"],
                qc["bias_f"], qc["act_scale"], qc["act_zp"], self.strides,
                pad, a_lo, a_hi, relu=self.relu,
                shared_x=isinstance(x, QTensor))
            return MergedQTensor(out, qc["act_scale"], qc["act_zp"],
                                 s=presampled.shape[0])
        args = (x.scale, qc["w_codes"], qc["w_scale"], qc["w_zp"],
                qc["bias_f"], qc["act_scale"], qc["act_zp"], self.strides,
                pad, a_lo, a_hi)
        if isinstance(x, MergedQTensor):
            # merged activations through a deterministic conv: one set of
            # weights for every sample group
            out = int_conv_merged(x.codes, *args, relu=self.relu)
        else:
            out = int_conv(x.codes, *args, relu=self.relu)
        return dataclasses.replace(x, codes=out, scale=qc["act_scale"],
                                   zp=qc["act_zp"])


class BernoulliDropout(nn.Module):
    """Always-on Bernoulli dropout, int mode (port of the int branch of
    qbn_tpu's BernoulliDropout, the MC-Dropout posterior): masks per
    (sample, image, channel) for 4-D activations, per element for dense
    ones, from `masks(shape, keep, device)` ((S, *shape) float32, see
    ops/stochastic.py). The mask is quantised on the multiply's output grid
    (mul_scale, mul_zp) and dequantised, the activations dequantised,
    multiplied and requantised to that grid; the output scale is
    mul_scale / (1 - p). On a grid of 2 or more (which 4-bit activations
    reach) the kept mask 1.0 rounds to the zero point and every activation
    goes to zero, as in qbn_tpu and the reference.

    A shared input (QTensor) leaves as S samples (SampleQTensor)."""

    def __init__(self, p: float = 0.0, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.p, self.quant = p, quant

    def forward(self, x, variables, masks):
        qc = variables["qconst"]["q"]
        ms, mz = qc["mul_scale"], qc["mul_zp"]
        a_lo, a_hi = self.quant.a_bounds
        per_sample = isinstance(x, SampleQTensor)
        shape = x.codes.shape[1:] if per_sample else x.codes.shape
        mask_shape = ((shape[0], 1, 1, shape[-1]) if len(shape) > 2
                      else tuple(shape))
        mask = masks(mask_shape, 1.0 - self.p, x.codes.device)
        if per_sample and mask.shape[0] != x.codes.shape[0]:
            raise ValueError(f"{mask.shape[0]} masks for "
                             f"{x.codes.shape[0]} samples")
        mz_f = mz.to(torch.float32)
        mask_q = torch.clamp(torch.round(mask / ms) + mz_f, 0, 255)
        mask_deq = (mask_q.to(torch.int32).to(torch.float32) - mz_f) * ms
        prod = dequantize_codes(x.codes, x.scale) * mask_deq
        codes = quantize_codes(prod, ms, mz, a_lo, a_hi)
        multiplier = torch.tensor(1.0 / (1.0 - self.p), dtype=torch.float32,
                                  device=ms.device)
        return SampleQTensor(codes, ms * multiplier, mz)


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
        return dataclasses.replace(a, codes=codes, scale=s, zp=z)


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
    """Max pool over (H, W), 'VALID' windows: float NHWC activations, or
    int codes (..., H, W, C) of any of the code layouts, pooled by max
    directly as qbn_tpu's reduce_window does."""
    if isinstance(x, torch.Tensor):
        y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride)
        return y.permute(0, 2, 3, 1)
    h, w = x.codes.shape[-3:-1]
    ho, wo = (h - window) // stride + 1, (w - window) // stride + 1
    out = None
    for i in range(window):
        for j in range(window):
            v = x.codes[..., i:i + (ho - 1) * stride + 1:stride,
                        j:j + (wo - 1) * stride + 1:stride, :]
            out = v if out is None else torch.maximum(out, v)
    return dataclasses.replace(x, codes=out.contiguous())


def avg_pool(x, window: int):
    """Average pool of codes (..., H, W, C), rounding half to even
    (FBGEMM's quantised avg-pool keeps scale/zp and rounds); windows that
    do not fit are dropped, as with 'VALID' padding."""
    *lead, h, w, c = x.codes.shape
    ho, wo = h // window, w // window
    codes = x.codes[..., :ho * window, :wo * window, :].to(torch.int32)
    summed = codes.reshape(*lead, ho, window, wo, window, c).sum(
        dim=(-4, -2))
    pooled = torch.round(summed.to(torch.float32) / (window * window))
    return dataclasses.replace(x, codes=pooled.to(torch.int8))


def flatten(x):
    """Float (B, H, W, C) -> (B, H*W*C) in (h, w, c) order, as qbn_tpu's
    NHWC activations flatten; codes likewise ((S, B, H, W, C) -> (S, B,
    H*W*C)). Merged codes (B, H, W, S*C) -> (B, S, H*W*C): per-sample
    flattening, so that the dense weights see the feature order of one
    sample's (H, W, C)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(x.shape[0], -1)
    if not isinstance(x, MergedQTensor):
        return dataclasses.replace(
            x, codes=x.codes.reshape(*x.codes.shape[:-3], -1))
    b, h, w, sc = x.codes.shape
    c = sc // x.s
    codes = x.codes.reshape(b, h, w, x.s, c).permute(0, 3, 1, 2, 4)
    return MergedQTensor(codes.reshape(b, x.s, h * w * c), x.scale, x.zp,
                         s=x.s)


def relu(x: MergedQTensor) -> MergedQTensor:
    """ReLU on codes: max(code, zero point), i.e. u >= 0."""
    return MergedQTensor(torch.clamp(x.codes, min=0), x.scale, x.zp, s=x.s)
