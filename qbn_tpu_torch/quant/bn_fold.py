"""Batch-norm folding, the Bayes-by-backprop posterior std included (port
of qbn_tpu/quant/bn_fold.py): softplus(std') = softplus(std) * gamma /
sqrt(var + eps). Conv kernels are HWIO, so the per-output-channel factor
broadcasts on the last axis.
"""

from __future__ import annotations

import torch

from qbn_tpu_torch.ops.stochastic import softplus


def sqrt_rn(x):
    """float32 square root, correctly rounded on every device, as XLA
    computes it (torch's vectorised CPU sqrt is not always): the float64
    root rounded once to float32, which double rounding cannot move."""
    return torch.sqrt(x.double()).to(x.dtype)


def softplusinv(x):
    """Inverse of softplus, log(exp(x) - 1), as x + log(-expm1(-x))."""
    return x + torch.log(-torch.expm1(-x))


def fuse_conv_bn_weights(conv_w, conv_b, conv_std, bn_rm, bn_rv, bn_eps,
                         bn_w, bn_b):
    """Fold the BN statistics and affine into the conv's weight, bias and
    (if given) pre-softplus std; returns (w, b, std), std None without
    one. The std goes through softplusinv(softplus(std) * c), as in
    qbn_tpu, and the caller applies softplus again: the round trip decides
    which codes land on a rounding edge, so it is kept as it is."""
    if conv_b is None:
        conv_b = torch.zeros_like(bn_rm)
    rstd = 1.0 / sqrt_rn(bn_rv + bn_eps)
    c = bn_w * rstd
    folded_w = conv_w * c
    folded_std = None
    if conv_std is not None:
        folded_std = softplusinv(softplus(conv_std) * c)
    folded_b = (conv_b - bn_rm) * rstd * bn_w + bn_b
    return folded_w, folded_b, folded_std
