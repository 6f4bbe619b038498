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
their KL into the `kl` dict given), 'qat' (the fake-quantised forward:
weights, stds and activations through their observers, batch norm folded
into the conv's weights as qbn_tpu folds it), 'convert' (the 'qat' eval
forward that also writes the block's int constants, 'qconst') or 'int'.
`init` makes a block's 'params' subtree with qbn_tpu's init laws from a
torch.Generator.

State that a forward updates (batch norm's running statistics in
'batch_stats', the observers in 'quant', the int constants in 'qconst')
is read from `variables` and written into `mutable`: a dict of the
collections the call may write, each narrowed to the module as
`variables` is, as flax returns the mutable collections of an `apply`.
A collection absent from `mutable` is not written. With `initializing`
a call declares every variable it reads (fresh observers, unit running
variance, qbn_tpu's qconst placeholders) and updates none, as flax's
`init` does.

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
from qbn_tpu_torch.quant.bn_fold import fuse_conv_bn_weights, sqrt_rn
from qbn_tpu_torch.quant.fake_quant import fake_quantize, quantize
from qbn_tpu_torch.quant.observer import (
    calculate_qparams, obs_init, obs_update)
from qbn_tpu_torch.ops.collectives import data_group, global_moments
from qbn_tpu_torch.ops.integer import (
    int_conv, int_conv_merged, int_dense, int_dense_merged)
from qbn_tpu_torch.ops.stochastic import (
    conv_nhwc, kl_divergence, local_reparam_conv, local_reparam_dense_auto,
    sample_weights, softplus)
from qbn_tpu_torch.profiling import span


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


def child(mutable, name: str):
    """The subtree of child `name` in each collection of `mutable` (None
    when the call writes none), made where missing."""
    if mutable is None:
        return None
    return {c: tree.setdefault(name, {}) for c, tree in mutable.items()}


def _write(mutable, collection: str, name: str, value):
    if mutable is not None and collection in mutable:
        mutable[collection][name] = value


class Observers:
    """The observers of one module call (port of qbn_tpu's QuantOps
    mixin): each named state is read from the 'quant' collection of
    `variables` (fresh where absent), updated by the observed tensor when
    `update`, and written into `mutable`'s 'quant'."""

    def __init__(self, variables, mutable, update: bool, device):
        self.current = dict(variables.get("quant", {}))
        self.mutable, self.update, self.device = mutable, update, device

    def state(self, name: str):
        st = self.current.get(name)
        return obs_init(self.device) if st is None else st

    def declare(self, name: str):
        """The observer exists (float mode keeps qbn_tpu's tree)."""
        _write(self.mutable, "quant", name, self.state(name))

    def fq(self, name: str, x, bounds):
        """Observe x (when updating) and fake-quantise it with the qparams
        of the UPDATED state (qbn_tpu's _fq)."""
        st = self.state(name)
        if self.update:
            st = obs_update(st, x)
        self.current[name] = st
        _write(self.mutable, "quant", name, st)
        scale, zp = calculate_qparams(st["min_val"], st["max_val"], *bounds)
        return fake_quantize(x, scale, zp, *bounds)

    def qparams(self, name: str, bounds):
        st = self.state(name)
        return calculate_qparams(st["min_val"], st["max_val"], *bounds)


def _qc_placeholder(shapes, device):
    """qbn_tpu's zero-filled qconst placeholder: scales 1.0, zero points
    0, code arrays zeros."""
    out = {}
    for k, v in shapes.items():
        if v == "scalar_f":
            out[k] = torch.ones((), device=device)
        elif v == "scalar_i":
            out[k] = torch.zeros((), dtype=torch.int32, device=device)
        else:
            out[k] = torch.zeros(v, dtype=torch.int8, device=device)
    return out


def _block_placeholder(kshape, stochastic: bool, quant: QuantConfig,
                       device, bias_features: Optional[int] = None):
    """The qconst placeholder of a dense or conv block (a conv's with
    its folded bias, `bias_features` zeros)."""
    scalars = {}
    for name in ("w", "std", "mul", "add", "act"):
        scalars[f"{name}_scale"] = "scalar_f"
        scalars[f"{name}_zp"] = "scalar_i"
    out = _qc_placeholder({"w_codes": kshape, "std_codes": kshape,
                           **scalars}, device)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=device)
    if bias_features is not None:
        out["bias_f"] = torch.zeros((bias_features,), device=device)
    out.update(is_stoch=i32(int(stochastic)), w_lo=i32(quant.w_bounds[0]),
               w_hi=i32(quant.w_bounds[1]))
    return out


def _write_scalar_qconst(mutable, obs, name, keys, bounds, initializing):
    """Convert of a block whose constants are one (scale, zp) pair (the
    dropout multiply, the residual add, the input quantiser)."""
    device = obs.device
    if initializing:
        value = _qc_placeholder({keys[0]: "scalar_f", keys[1]: "scalar_i"},
                                device)
    else:
        s, z = obs.qparams(name, bounds)
        value = {keys[0]: s, keys[1]: z}
    _write(mutable, "qconst", "q", value)


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
            "('sampled', evaluation.mc.PosteriorDraw); qbn_tpu's "
            "draw inside the forward is not ported")
    return sampled["w"]


MODES = ("float", "qat", "convert", "int")


def _current_qconst(variables, kshape, stochastic, quant, device):
    """A copy of the block's qconst entry, or qbn_tpu's placeholder:
    convert rewrites the entries it computes and keeps the others (a
    deterministic block's std and noise constants)."""
    qc = variables.get("qconst", {}).get("q")
    if qc is None:
        return _block_placeholder(tuple(kshape), stochastic, quant, device)
    return dict(qc)


def _weight_qconst(obs, quant, w, sp):
    """The weight, std and activation constants of a dense or conv block
    from its observers (qbn_tpu's _write_qconst): w the (folded) weight,
    sp the (folded) softplus std of a stochastic block, else None."""
    wb, ab = quant.w_bounds, quant.a_bounds
    ws, wz = obs.qparams("weight", wb)
    out = {"w_codes": quantize(w, ws, wz, *wb), "w_scale": ws, "w_zp": wz}
    if sp is not None:
        ss, sz = obs.qparams("std_w", wb)
        out.update(std_codes=quantize(sp, ss, sz, *wb), std_scale=ss,
                   std_zp=sz)
        out["mul_scale"], out["mul_zp"] = obs.qparams("mul_noise", wb)
        out["add_scale"], out["add_zp"] = obs.qparams("add_weight", wb)
    out["act_scale"], out["act_zp"] = obs.qparams("act", ab)
    return out


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
                mode: str = "float", noise=None, kl: Optional[dict] = None,
                update_stats: bool = False, mutable: Optional[dict] = None,
                initializing: bool = False):
        if mode == "int":
            return self._int_forward(x, variables)
        if mode not in MODES:
            raise ValueError(f"unknown mode '{mode}'")
        p = variables["params"]
        kernel, std, bias = p["kernel"], p.get("std"), p.get("bias")
        if initializing and self.quant.enabled:
            _write(mutable, "qconst", "q", _block_placeholder(
                tuple(kernel.shape), self.stochastic, self.quant,
                kernel.device))
        sp = softplus(std) if self.stochastic else None
        if self.stochastic:
            _sow_kl(kl, kernel, sp, self.sigma_prior)
        if mode == "float":
            y = self._float_forward(x, kernel, sp, bias, train, noise)
            return torch.relu(y) if self.relu else y
        obs = Observers(variables, mutable, update_stats and not initializing,
                        kernel.device)
        y = self._qat_forward(x, kernel, sp, bias, train, noise, obs)
        if self.relu:
            y = torch.relu(y)
        y = obs.fq("act", y, self.quant.a_bounds)
        if mode == "convert" and not initializing:
            self._write_qconst(variables, mutable, obs, kernel, std)
        return y

    def _float_forward(self, x, kernel, sp, bias, train, noise):
        if not self.stochastic:
            y = torch.matmul(x, kernel)
            return y + bias if bias is not None else y
        if train:
            return local_reparam_dense_auto(x, kernel, sp, noise, bias,
                                            fused=self.quant.tpu_fused)
        y = torch.matmul(x, sample_weights(kernel, sp, noise))
        return y + bias if bias is not None else y

    def _qat_forward(self, x, kernel, sp, bias, train, noise, obs):
        wb = self.quant.w_bounds
        w_fq = obs.fq("weight", kernel, wb)
        if not self.stochastic:
            y = torch.matmul(x, w_fq)
            return y + bias if bias is not None else y
        std_fq = obs.fq("std_w", sp, wb)
        if train:
            return local_reparam_dense_auto(x, w_fq, std_fq, noise, bias,
                                            fused=self.quant.tpu_fused)
        # eval: one weight sample through the observed multiply and add
        eps = noise(kernel.shape, kernel.device)
        prod = obs.fq("mul_noise", eps * std_fq, wb)
        w_s = obs.fq("add_weight", w_fq + prod, wb)
        y = torch.matmul(x, w_s)
        return y + bias if bias is not None else y

    def _write_qconst(self, variables, mutable, obs, kernel, std):
        entry = _current_qconst(variables, kernel.shape, self.stochastic,
                                self.quant, kernel.device)
        with torch.no_grad():
            entry.update(_weight_qconst(obs, self.quant, kernel,
                                        softplus(std) if self.stochastic
                                        else None))
        _write(mutable, "qconst", "q", entry)

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
    """Conv (+ optional batch norm) + optional fused ReLU, pointwise or
    Bayes-by-backprop. QAT with batch norm folds it as qbn_tpu does: the
    weight and the softplus std are scaled by bn_scale / running std
    before their fake quant, the conv output is divided by that factor,
    the bias added, and the real batch norm applied; convert folds BN
    fully into the int constants, which int mode reads."""

    def __init__(self, features: int, kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), padding: int = 0,
                 use_bias: bool = False, stochastic: bool = False,
                 bn: bool = False, relu: bool = False,
                 sigma_prior: float = 1.0, std_init: float = -10.0,
                 bn_eps: float = 1e-5, bn_momentum: float = 0.1,
                 quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.features, self.kernel_size = features, tuple(kernel_size)
        self.strides, self.padding = tuple(strides), padding
        self.use_bias, self.stochastic, self.relu = use_bias, stochastic, relu
        self.bn, self.bn_eps, self.bn_momentum = bn, bn_eps, bn_momentum
        self.sigma_prior, self.std_init, self.quant = (sigma_prior, std_init,
                                                       quant)

    def init(self, generator, cin: int):
        kshape = (*self.kernel_size, cin, self.features)
        params = _init_params(generator, kshape, self.features,
                              self.stochastic, self.std_init, self.use_bias,
                              math.prod(kshape[:3]))
        if self.bn:
            params["bn_scale"] = torch.ones((self.features,))
            params["bn_bias"] = torch.zeros((self.features,))
        return params

    def out_hw(self, h: int, w: int) -> Tuple[int, int]:
        (kh, kw), (sh, sw), p = self.kernel_size, self.strides, self.padding
        return (h + 2 * p - kh) // sh + 1, (w + 2 * p - kw) // sw + 1

    def forward(self, x, variables, *, train: bool = False,
                mode: str = "float", noise=None, kl: Optional[dict] = None,
                update_stats: bool = False, mutable: Optional[dict] = None,
                initializing: bool = False, residual: Optional[dict] = None):
        """residual (int mode only): a residual add's arguments to
        `int_conv_merged` (`ResidualAdd.epilogue`), run in this conv's
        epilogue; the output is then on the add's grid."""
        if mode == "int":
            return self._int_forward(x, variables, residual)
        if residual is not None:
            raise ValueError("a residual runs in the conv's epilogue in int "
                             "mode only")
        if mode not in MODES:
            raise ValueError(f"unknown mode '{mode}'")
        p = variables["params"]
        kernel, std, bias = p["kernel"], p.get("std"), p.get("bias")
        update = update_stats and not initializing
        stats = None
        if self.bn:
            stats = variables.get("batch_stats")
            if stats is None:
                stats = {"mean": torch.zeros((self.features,),
                                             device=kernel.device),
                         "var": torch.ones((self.features,),
                                           device=kernel.device)}
            if initializing:
                _write(mutable, "batch_stats", "mean", stats["mean"])
                _write(mutable, "batch_stats", "var", stats["var"])
        if initializing and self.quant.enabled:
            _write(mutable, "qconst", "q", _block_placeholder(
                tuple(kernel.shape), self.stochastic, self.quant,
                kernel.device, self.features))
        sp = softplus(std) if self.stochastic else None
        if self.stochastic:
            _sow_kl(kl, kernel, sp, self.sigma_prior)
        if mode == "float":
            y = self._conv_forward(x, kernel, sp, bias, train, noise)
            if self.bn:
                y = self._batch_norm(y, p, stats, train, update, mutable)
            return torch.relu(y) if self.relu else y

        obs = Observers(variables, mutable, update, kernel.device)
        if self.bn:
            # the folding dance: fake-quant W * sf and softplus(std) * sf
            # with sf from the running variance BEFORE this step's update
            sf = p["bn_scale"] / sqrt_rn(stats["var"] + self.bn_eps)
            y = self._conv_forward(x, kernel * sf, sp, None, train, noise,
                                   obs, std_scale_factor=sf)
            y = y / sf
            if bias is not None:
                y = y + bias
            y = self._batch_norm(y, p, stats, train, update, mutable)
        else:
            y = self._conv_forward(x, kernel, sp, bias, train, noise, obs)
        if self.relu:
            y = torch.relu(y)
        y = obs.fq("act", y, self.quant.a_bounds)
        if mode == "convert" and not initializing:
            self._write_qconst(variables, mutable, obs, p, stats)
        return y

    def _conv_forward(self, x, w_eff, sp, bias, train, noise, obs=None,
                      std_scale_factor=None):
        """The float (obs None) or fake-quantised conv: local
        reparametrisation in training, one weight sample in evaluation,
        for Bayes-by-backprop. w_eff is the (BN-scaled) kernel, sp the
        softplus std."""
        wb = self.quant.w_bounds
        w = obs.fq("weight", w_eff, wb) if obs is not None else w_eff
        if not self.stochastic:
            y = conv_nhwc(x, w, self.strides, self.padding)
            return y + bias if bias is not None else y
        if std_scale_factor is not None:
            sp = sp * std_scale_factor
        if obs is not None:
            sp = obs.fq("std_w", sp, wb)
        if train:
            return local_reparam_conv(x, w, sp, noise, self.strides,
                                      self.padding, bias)
        eps = noise(w.shape, w.device)
        if obs is not None:
            prod = obs.fq("mul_noise", eps * sp, wb)
            w_s = obs.fq("add_weight", w + prod, wb)
        else:
            w_s = w + sp * eps
        y = conv_nhwc(x, w_s, self.strides, self.padding)
        return y + bias if bias is not None else y

    def _batch_norm(self, y, p, stats, train, update, mutable):
        """Batch norm over (B, H, W): batch statistics (biased variance) in
        training, the running ones in evaluation; with `update` the
        running variance moves toward the UNBIASED batch variance. In a
        data-parallel forward the statistics are the global batch's."""
        if train:
            group = data_group()
            if group is None:
                m = torch.mean(y, dim=(0, 1, 2))
                v = torch.var(y, dim=(0, 1, 2), correction=0)
                n = y.shape[0] * y.shape[1] * y.shape[2]
            else:
                m, v, n = global_moments(y, (0, 1, 2), group)
            if update:
                unbiased = v.detach() * n / max(n - 1, 1)
                mom = self.bn_momentum
                _write(mutable, "batch_stats", "mean",
                       (1 - mom) * stats["mean"] + mom * m.detach())
                _write(mutable, "batch_stats", "var",
                       (1 - mom) * stats["var"] + mom * unbiased)
        else:
            m, v = stats["mean"], stats["var"]
        y = (y - m) * torch.rsqrt(v + self.bn_eps)
        return y * p["bn_scale"] + p["bn_bias"]

    def _write_qconst(self, variables, mutable, obs, p, stats):
        kernel, std, bias = p["kernel"], p.get("std"), p.get("bias")
        entry = _current_qconst(variables, kernel.shape, self.stochastic,
                                self.quant, kernel.device)
        with torch.no_grad():
            sp = softplus(std) if std is not None else None
            w, b = kernel, bias
            if self.bn:
                w, b, folded_std = fuse_conv_bn_weights(
                    kernel, bias, std, stats["mean"], stats["var"],
                    self.bn_eps, p["bn_scale"], p["bn_bias"])
                sp = softplus(folded_std) if folded_std is not None else None
            entry.update(_weight_qconst(obs, self.quant, w, sp))
            entry["bias_f"] = (b.detach() if b is not None else
                               torch.zeros((self.features,),
                                           device=kernel.device))
        _write(mutable, "qconst", "q", entry)

    def _int_forward(self, x, variables, residual=None):
        qc = variables["qconst"]["q"]
        a_lo, a_hi = self.quant.a_bounds
        pad = [(self.padding, self.padding)] * 2
        res = residual or {}
        scale, zp = ((res["res_out_scale"], res["res_out_zp"]) if res
                     else (qc["act_scale"], qc["act_zp"]))
        if self.stochastic:
            presampled = _sampled(variables)    # (S, kh, kw, cin, cout)
            out = int_conv_merged(
                x.codes, x.scale, presampled, qc["add_scale"], qc["add_zp"],
                qc["bias_f"], qc["act_scale"], qc["act_zp"], self.strides,
                pad, a_lo, a_hi, relu=self.relu,
                shared_x=isinstance(x, QTensor), **res)
            return MergedQTensor(out, scale, zp, s=presampled.shape[0])
        args = (x.scale, qc["w_codes"], qc["w_scale"], qc["w_zp"],
                qc["bias_f"], qc["act_scale"], qc["act_zp"], self.strides,
                pad, a_lo, a_hi)
        if isinstance(x, MergedQTensor):
            # merged activations through a deterministic conv: one set of
            # weights for every sample group
            out = int_conv_merged(x.codes, *args, relu=self.relu, **res)
        else:
            out = int_conv(x.codes, *args, relu=self.relu)
        return dataclasses.replace(x, codes=out, scale=scale, zp=zp)


class BernoulliDropout(nn.Module):
    """Always-on Bernoulli dropout (the MC-Dropout posterior), port of
    qbn_tpu's BernoulliDropout: masks per (image, channel) for 4-D
    activations, per element for dense ones, from a mask source
    `masks(shape, keep, device)` ((S, *shape) float32, ops/stochastic.py).

    float: x * mask / (1 - p), one mask (the source's first sample).
    qat / convert: the product x * mask through the 'mul_mask' observer,
    then / (1 - p); convert writes the multiply's grid (mul_scale,
    mul_zp).
    int: the mask is quantised on the multiply's output grid and
    dequantised, the activations dequantised, multiplied and requantised
    to that grid; the output scale is mul_scale / (1 - p). On a grid of 2
    or more (which 4-bit activations reach) the kept mask 1.0 rounds to
    the zero point and every activation goes to zero, as in qbn_tpu and
    the reference. A shared input (QTensor) leaves as S samples
    (SampleQTensor)."""

    def __init__(self, p: float = 0.0, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.p, self.quant = p, quant

    def forward(self, x, variables, masks, *, mode: str = "int",
                train: bool = False, update_stats: bool = False,
                mutable: Optional[dict] = None, initializing: bool = False):
        if mode == "int":
            return self._int_forward(x, variables, masks)
        multiplier = 1.0 / (1.0 - self.p)
        mask_shape = ((x.shape[0], 1, 1, x.shape[-1]) if x.ndim > 2
                      else tuple(x.shape))
        mask = masks(mask_shape, 1.0 - self.p, x.device)[0]
        obs = Observers(variables, mutable, update_stats and not initializing,
                        x.device)
        if mode == "float":
            if self.quant.enabled and initializing:
                obs.declare("mul_mask")
            return x * mask * multiplier
        y = obs.fq("mul_mask", x * mask, self.quant.a_bounds)
        if mode == "convert":
            _write_scalar_qconst(mutable, obs, "mul_mask",
                                 ("mul_scale", "mul_zp"),
                                 self.quant.a_bounds, initializing)
        return y * multiplier

    def _int_forward(self, x, variables, masks):
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
    """Residual add; relu folds the block's post-add ReLU in. qat /
    convert observe the PRE-relu sum ('add_act'); int dequantises both
    operands, adds and requantises to the add observer's grid."""

    def __init__(self, quant: QuantConfig = QuantConfig(),
                 relu: bool = False):
        super().__init__()
        self.quant, self.relu = quant, relu

    def forward(self, a, b, variables, *, mode: str = "int",
                update_stats: bool = False, mutable: Optional[dict] = None,
                initializing: bool = False):
        if mode == "int":
            return self._int_forward(a, b, variables)
        obs = Observers(variables, mutable, update_stats and not initializing,
                        a.device)
        if mode == "float":
            if self.quant.enabled and initializing:
                obs.declare("add_act")
            y = a + b
        else:
            y = obs.fq("add_act", a + b, self.quant.a_bounds)
            if mode == "convert":
                _write_scalar_qconst(mutable, obs, "add_act", ("scale", "zp"),
                                     self.quant.a_bounds, initializing)
        return torch.relu(y) if self.relu else y

    def epilogue(self, b, variables):
        """The int-mode add of `b` (and the ReLU) as the residual
        arguments of `int_conv_merged`, which runs them in the epilogue of
        the conv that makes `a`: the arithmetic of `_int_forward`, held
        bitwise equal to it, with no pass of its own over the
        activations."""
        qc = variables["qconst"]["q"]
        return dict(residual=b.codes, res_scale=b.scale,
                    res_out_scale=qc["scale"], res_out_zp=qc["zp"],
                    res_relu=self.relu)

    def _int_forward(self, a, b, variables):
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
    """QuantStub equivalent: the input itself in float mode (its observer
    declared when quantisation is on), fake-quantised through the 'act'
    observer in qat / convert (convert writes its grid), codes in int
    mode."""

    def __init__(self, quant: QuantConfig = QuantConfig()):
        super().__init__()
        self.quant = quant

    def forward(self, x, variables, *, mode: str = "float",
                update_stats: bool = False, mutable: Optional[dict] = None,
                initializing: bool = False):
        if mode == "int":
            qc = variables["qconst"]["q"]
            s, z = qc["scale"], qc["zp"]
            a_lo, a_hi = self.quant.a_bounds
            return QTensor(quantize_codes(x, s, z, a_lo, a_hi), s, z)
        obs = Observers(variables, mutable, update_stats and not initializing,
                        x.device)
        if mode == "float" or not self.quant.enabled:
            if self.quant.enabled and initializing:
                obs.declare("act")
            return x
        y = obs.fq("act", x, self.quant.a_bounds)
        if mode == "convert":
            _write_scalar_qconst(mutable, obs, "act", ("scale", "zp"),
                                 self.quant.a_bounds, initializing)
        return y


def dequant(x):
    """Codes back to float32; merged dense (B, S, F) stays (B, S, F). A
    float tensor passes through."""
    if isinstance(x, torch.Tensor):
        return x
    return dequantize_codes(x.codes, x.scale)


def max_pool(x, window: int = 2, stride: int = 2, padding: int = 0):
    """Max pool over (H, W): float NHWC activations, or int codes (..., H,
    W, C) of any of the code layouts, pooled by max directly as qbn_tpu's
    reduce_window does. `padding` pads each side (padding 0: 'VALID'
    windows), floats with -inf and codes with the lowest code, so that the
    padding never wins. The codes' pass is a span `op.max_pool`
    (profiling.span)."""
    if isinstance(x, torch.Tensor):
        y = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride, padding)
        return y.permute(0, 2, 3, 1)
    with span("op.max_pool"):
        codes = x.codes
        if padding:
            low = torch.iinfo(codes.dtype).min
            codes = F.pad(codes, (0, 0, padding, padding, padding, padding),
                          value=low)
        h, w = codes.shape[-3:-1]
        ho, wo = (h - window) // stride + 1, (w - window) // stride + 1
        out = None
        for i in range(window):
            for j in range(window):
                v = codes[..., i:i + (ho - 1) * stride + 1:stride,
                          j:j + (wo - 1) * stride + 1:stride, :]
                out = v if out is None else torch.maximum(out, v)
        return dataclasses.replace(x, codes=out.contiguous())


def avg_pool(x, window: int):
    """Average pool over (H, W), 'VALID' windows of stride `window`: float
    NHWC activations, or codes (..., H, W, C), rounding half to even
    (FBGEMM's quantised avg-pool keeps scale/zp and rounds)."""
    if isinstance(x, torch.Tensor):
        y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, window)
        return y.permute(0, 2, 3, 1)
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
