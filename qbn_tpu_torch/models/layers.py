"""INT-mode layers in the merged layout (port of the int branches of
qbn_tpu/models/layers.py).

The modules hold the architecture only. Their state is a variable tree in
flax's nesting (collections 'qconst', 'sampled', 'params', ... each keyed
by module name), passed to `forward` and narrowed to a child's subtree with
`scope`, so that each module reads the constants its flax counterpart
wrote, under the same path.

INT Monte-Carlo evaluation runs every posterior sample in ONE forward:
conv activations are (B, H, W, S*C) int8 codes with sample-major channel
groups, dense activations (B, S, F) (MergedQTensor). The stem enters the
layout from the shared (B, H, W, C) input (QTensor).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.ops.integer import int_conv_merged, int_dense_merged


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


class DenseBlock(nn.Module):
    """Dense layer + optional fused ReLU, Bayes-by-backprop, int mode."""

    def __init__(self, features: int, use_bias: bool = True,
                 relu: bool = False, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.features, self.use_bias, self.relu = features, use_bias, relu
        self.quant = quant

    def forward(self, x, variables):
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
    """Conv (BN folded into the int constants) + optional fused ReLU,
    Bayes-by-backprop, int mode."""

    def __init__(self, features: int, kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding: int = 0,
                 relu: bool = False, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.features, self.kernel_size = features, tuple(kernel_size)
        self.strides, self.padding = tuple(strides), padding
        self.relu, self.quant = relu, quant

    def forward(self, x, variables):
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
    """QuantStub equivalent: float input -> activation codes."""

    def __init__(self, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.quant = quant

    def forward(self, x, variables):
        qc = variables["qconst"]["q"]
        s, z = qc["scale"], qc["zp"]
        a_lo, a_hi = self.quant.a_bounds
        return QTensor(quantize_codes(x, s, z, a_lo, a_hi), s, z)


def dequant(x):
    """Codes back to float32; merged dense (B, S, F) stays (B, S, F)."""
    return dequantize_codes(x.codes, x.scale)


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


def flatten(x: MergedQTensor) -> MergedQTensor:
    """(B, H, W, S*C) -> (B, S, H*W*C): per-sample flattening, so that the
    dense weights see the feature order of one sample's (H, W, C)."""
    b, h, w, sc = x.codes.shape
    c = sc // x.s
    codes = x.codes.reshape(b, h, w, x.s, c).permute(0, 3, 1, 2, 4)
    return MergedQTensor(codes.reshape(b, x.s, h * w * c), x.scale, x.zp,
                         s=x.s)


def relu(x: MergedQTensor) -> MergedQTensor:
    """ReLU on codes: max(code, zero point), i.e. u >= 0."""
    return MergedQTensor(torch.clamp(x.codes, min=0), x.scale, x.zp, s=x.s)
