"""Tracing, profiling and runtime-sanitising utilities (port of
qbn_tpu/profiling.py):

  * PhaseTimer - accumulating wall-clock timers (train/val phases);
  * trace() - a torch.profiler trace of the CPU and, where present, the
    card, written as a Chrome trace (chrome://tracing, Perfetto), gated
    by a flag so that headless runs pay nothing;
  * enable_nan_debugging - the runtime sanitiser, qbn_tpu's jax debug-NaN
    mode: a forward hook on every module raises on the first non-finite
    floating-point output and names the module, with its inputs'
    statistics; autograd's anomaly mode does the same for the backward;
  * model_size_bytes - the serialised size of a variable tree (the
    port's msgpack, byte for byte qbn_tpu's).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

log = logging.getLogger(__name__)


class PhaseTimer:
    """Accumulating wall-clock timers keyed by phase name."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.time() - t0

    def report(self) -> Dict[str, float]:
        return dict(self.totals)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True):
    """torch.profiler trace of the enclosed work, written to
    <log_dir>/trace.json (by rank r > 0 of a process group,
    trace_rank<r>.json); a no-op when disabled."""
    if not enabled or not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    rank = dist.get_rank() if dist.is_initialized() else 0
    path = os.path.join(log_dir, TRACE_FILE if rank == 0 else
                        TRACE_FILE.replace(".json", f"_rank{rank}.json"))
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


class NonFiniteError(FloatingPointError):
    """A module's forward gave a non-finite floating-point output: its
    name (a path in the model that enable_nan_debugging was given, else
    its class) and the statistics of its floating-point inputs (the
    activations; not the variable tree)."""

    def __init__(self, module: str, inputs):
        self.module, self.inputs = module, inputs
        stats = "; ".join(f"{k}: {v}" for k, v in inputs)
        super().__init__(f"non-finite output of module {module}; "
                         f"inputs: {stats or 'no float tensors'}")


def _tensors(obj):
    """The floating-point tensors in a module's inputs or outputs: tensors,
    tuples, lists, dicts and dataclass-like holders of tensors."""
    if isinstance(obj, torch.Tensor):
        if obj.is_floating_point():
            yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, name))


def tensor_stats(t: torch.Tensor) -> dict:
    """shape, the count of non-finite entries, and min / max / mean / std
    of the finite ones."""
    t = t.detach().float()
    finite = t[torch.isfinite(t)]
    out = {"shape": list(t.shape), "non_finite": int(t.numel()
                                                     - finite.numel())}
    if finite.numel():
        out.update(min=float(finite.min()), max=float(finite.max()),
                   mean=float(finite.mean()),
                   std=float(finite.std()) if finite.numel() > 1 else 0.0)
    return out


_NAMES: "weakref.WeakKeyDictionary[nn.Module, str]" = \
    weakref.WeakKeyDictionary()
_HOOK = None


def _check_output(module, inputs, output):
    for t in _tensors(output):
        if not bool(torch.isfinite(t).all()):
            name = _NAMES.get(module, type(module).__name__)
            # the activations: a module's positional inputs other than
            # its variable tree (a dict)
            acts = [a for a in inputs if not isinstance(a, dict)]
            stats = [(f"input {i}", tensor_stats(x))
                     for i, x in enumerate(_tensors(acts))]
            raise NonFiniteError(name, stats)


def enable_nan_debugging(model: Optional[nn.Module] = None) -> None:
    """Raise NonFiniteError on the first non-finite floating-point output
    of any module's forward, and turn on autograd's anomaly detection
    (the backward raises at the first NaN gradient, naming its forward
    op). `model` names its modules by their paths in it; without it a
    module is named by its class. Costs a device synchronise per module
    call while on."""
    global _HOOK
    if model is not None:
        for name, mod in model.named_modules():
            _NAMES[mod] = name or type(model).__name__
    if _HOOK is None:
        _HOOK = nn.modules.module.register_module_forward_hook(_check_output)
    torch.autograd.set_detect_anomaly(True)


def disable_nan_debugging() -> None:
    """Undo enable_nan_debugging."""
    global _HOOK
    if _HOOK is not None:
        _HOOK.remove()
        _HOOK = None
    torch.autograd.set_detect_anomaly(False)


@contextlib.contextmanager
def nan_debugging(model: Optional[nn.Module] = None):
    """enable_nan_debugging for the enclosed work only."""
    enable_nan_debugging(model)
    try:
        yield
    finally:
        disable_nan_debugging()


def model_size_bytes(variables) -> int:
    """Serialised size of a variable tree in bytes."""
    from qbn_tpu_torch.convert import to_numpy_state
    from qbn_tpu_torch.training.checkpoint import msgpack_serialize
    return len(msgpack_serialize(to_numpy_state(variables)))
