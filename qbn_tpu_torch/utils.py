"""Shared helpers of the port (counterparts of qbn_tpu/utils.py)."""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asked
    for the CPU. Raises rather than carrying on quietly on the CPU when
    the card was asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return device


@contextlib.contextmanager
def full_float32():
    """Full float32 in cuBLAS products and cuDNN convolutions, as qbn_tpu's
    float32 computes them (cuDNN takes TF32 by default, which keeps about
    3 decimal digits)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def prune(tree):
    """Drop the empty dicts of a nested dict (the collections of modules
    that sowed nothing), recursively."""
    if not isinstance(tree, dict):
        return tree
    out = {k: prune(v) for k, v in tree.items()}
    return {k: v for k, v in out.items() if not (isinstance(v, dict)
                                                 and not v)}


def tree_update(old, new):
    """`old` with every leaf that `new` holds replaced (a mutable
    collection after a call: the variables it wrote, the others as they
    were)."""
    if not isinstance(old, dict) or not isinstance(new, dict):
        return new
    out = dict(old)
    for k, v in new.items():
        out[k] = tree_update(old[k], v) if k in old else v
    return out


def _sources(generator):
    return GeneratorNoise(generator), BernoulliMasks(generator, 1)


def init_variables(model, generator: torch.Generator,
                   input_size: Sequence[int], device="cuda",
                   quantized: bool = False):
    """The variable tree of `model` for (H, W, C) inputs, drawn from
    `generator` (a CPU generator: the same seed gives the same weights on
    every device) with qbn_tpu's init laws: 'params', 'batch_stats' where
    the model has batch norm, 'kl' where it has Bayesian layers, and with
    `quantized` the 'quant' observers and the 'qconst' placeholders. Like
    qbn_tpu's init it runs one eval forward, in 'convert' mode when
    quantized (so that every observer and constant exists), else in
    'float'; the params are leaves that require grad."""
    device = resolve_device(device)
    params = model.init(generator, tuple(input_size))
    params = _to(params, device)
    kl: dict = {}
    mutable: dict = {"batch_stats": {}, "quant": {}, "qconst": {}}
    x = torch.zeros((1,) + tuple(input_size), device=device)
    noise, masks = _sources(generator)
    with torch.no_grad(), full_float32():
        model(x, {"params": params}, train=False,
              mode="convert" if quantized else "float", noise=noise,
              masks=masks, kl=kl, mutable=mutable, initializing=True)
    out = {"params": params}
    for name, tree in (("batch_stats", mutable["batch_stats"]),
                       ("quant", mutable["quant"]),
                       ("qconst", mutable["qconst"]), ("kl", kl)):
        tree = prune(tree)
        if tree:
            out[name] = tree
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device).requires_grad_()


def apply_model(model, variables, x, *, train: bool, mode: str,
                update_stats: bool = False, noise=None, masks=None,
                collections=None):
    """Apply a model; returns (output, kl, new_variables), as qbn_tpu's
    apply_model: the collections the call may write ('batch_stats' and
    'quant' with update_stats, none without, or those named in
    `collections`) take the values it wrote, merged key by key into the
    old ones; kl is the sum of the 'kl' collection the call sowed."""
    if collections is None:
        collections = ("batch_stats", "quant") if update_stats else ()
    kl: dict = {}
    mutable = {c: {} for c in collections} or None
    out = model(x, variables, train=train, mode=mode,
                update_stats=update_stats, noise=noise, masks=masks, kl=kl,
                mutable=mutable)
    new_vars = dict(variables)
    for col, tree in (mutable or {}).items():
        tree = prune(tree)
        if tree:
            new_vars[col] = tree_update(variables.get(col, {}), tree)
    return out, sum_kl(kl), new_vars


def convert_model(model, variables, sample_input, noise=None, masks=None):
    """The conversion pass (qbn_tpu's convert_model): one eval forward in
    'convert' mode on `sample_input`, which computes the 'qconst' int
    constants from the params, the BN running statistics and the
    observers; returns the variables with the new 'qconst'. The
    constants do not depend on the input or on the noise and masks drawn
    (by default from a generator seeded with 0)."""
    if noise is None or masks is None:
        gen = torch.Generator(device=sample_input.device).manual_seed(0)
        noise, masks = _sources(gen)
    with torch.no_grad(), full_float32():
        _out, _kl, new_vars = apply_model(
            model, variables, sample_input, train=False, mode="convert",
            noise=noise, masks=masks, collections=("qconst",))
    return new_vars


def tree_leaves(tree):
    """The leaves of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


def sum_kl(kl_collection) -> torch.Tensor:
    """Sum every KL leaf of a (nested) 'kl' collection into one scalar."""
    leaves = list(tree_leaves(kl_collection))
    if not leaves:
        return torch.zeros(())
    return sum(torch.sum(leaf) for leaf in leaves)
