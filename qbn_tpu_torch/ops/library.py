"""The port's kernels as PyTorch operators, `torch.ops.qbn_tpu_torch.*`.

Each hand-written kernel is reached through an operator of this namespace
with an explicit schema, a CPU implementation (the kernel's plain
version), a CUDA implementation (the kernel's launch) and a fake
implementation that gives the output's shape and type from the inputs'.
Dispatch is by the inputs' device: a CUDA input launches the kernel or
raises, as the eager entries always did; there is no fallback. Through
the operators the kernels are visible to `torch.export`: an exported
program holds a call of the operator where the kernel runs, and loading
it needs only these registrations (importing `qbn_tpu_torch.ops`), not
the model code.

The entries in `ops/sample_weights.py` and `ops/int_conv.py` define their
operators here at import time; nothing is built until a CUDA
implementation first runs.
"""

from __future__ import annotations

import torch

NAMESPACE = "qbn_tpu_torch"

_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cpu, cuda, fake):
    """Define `qbn_tpu_torch::<name>` with `schema` (the argument list and
    return type, as in a native_functions.yaml entry) and its CPU, CUDA
    and fake implementations; returns the operator."""
    _LIB.define(f"{name}{schema}")
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
