"""Shared helpers of the port (counterparts of qbn_tpu/utils.py)."""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from qbn_tpu_torch.ops.stochastic import GeneratorNoise


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


def init_variables(model, generator: torch.Generator,
                   input_size: Sequence[int], device="cuda"):
    """The float variable tree {'params', 'kl'} of `model` for (H, W, C)
    inputs, drawn from `generator` (a CPU generator: the same seed gives
    the same weights on every device) with qbn_tpu's init laws. Like
    qbn_tpu's init, it runs one eval forward to fill the 'kl' collection
    (absent when no layer is Bayesian); the params are leaves that
    require grad."""
    device = resolve_device(device)
    params = model.init(generator, tuple(input_size))
    params = {m: {k: v.to(device).requires_grad_() for k, v in p.items()}
              for m, p in params.items()}
    kl: dict = {}
    x = torch.zeros((1,) + tuple(input_size), device=device)
    with torch.no_grad(), full_float32():
        model(x, {"params": params}, train=False,
              noise=GeneratorNoise(generator), kl=kl)
    kl = {name: sown for name, sown in kl.items() if sown}
    return {"params": params, **({"kl": kl} if kl else {})}


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
