"""Tracing, profiling and runtime-sanitising utilities (port of
qbn_tpu/profiling.py):

  * span() - the program's spans: named host intervals at its layer
    boundaries (the loader's batch, the MC batch, the training step,
    the served call, the port's operators), kept in memory while the
    recorder is on (`start` / `stop`), on the clock of torch.profiler's
    events (`time.time_ns`, Unix nanoseconds: a profile's
    `trace_start_ns()` places them on its timeline). While a profile
    also runs, each span opens a `record_function` range of its name.
    Off (the default) a span is one test of a module flag and a shared
    null context: no allocation, no clock read, no range;
  * trace() - a torch.profiler trace of the CPU and, where present, the
    card, written as a Chrome trace (chrome://tracing, Perfetto) that
    carries the program's spans as ranges, gated by a flag so that
    headless runs pay nothing;
  * enable_nan_debugging - the runtime sanitiser, qbn_tpu's jax debug-NaN
    mode: a forward hook on every module raises on the first non-finite
    floating-point output and names the module, with its inputs'
    statistics; autograd's anomaly mode does the same for the backward;
  * model_size_bytes - the serialised size of a variable tree (the
    port's msgpack, byte for byte qbn_tpu's).
"""

from __future__ import annotations

import contextlib
import gc
import logging
import os
import weakref
from time import time_ns
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

log = logging.getLogger(__name__)


# spans kept by one recording at most; those past it are counted as dropped
SPAN_CAP = 1 << 20


class Span(NamedTuple):
    """One span: its name, start and end (Unix ns, torch.profiler's
    clock), the index of the span enclosing it in its recording (-1: a
    root span) and its unit (an id that every span under one root span
    shares; each root span opens a new one)."""
    name: str
    start_ns: int
    end_ns: int
    parent: int
    unit: int


class SpanList(list):
    """The spans of one recording in the order they opened (a span still
    open at `stop` ends there), and how many were dropped past its
    cap."""
    dropped = 0


class _Recorder:
    __slots__ = ("rows", "stack", "dropped", "unit", "ranges", "gc_start")

    def __init__(self, ranges: bool):
        self.rows: list = []      # [name, start_ns, end_ns, parent, unit]
        self.stack: list = []     # indices of the open spans (-1: dropped)
        self.ranges = ranges
        self.dropped = self.unit = self.gc_start = 0

    def open(self, row) -> int:
        """Appends `row` (its parent and unit set here); its index, or -1
        past the cap."""
        stack = self.stack
        if stack:
            row[3] = stack[-1]
        else:
            self.unit += 1
        row[4] = self.unit
        if len(self.rows) >= SPAN_CAP:
            self.dropped += 1
            return -1
        self.rows.append(row)
        return len(self.rows) - 1


# the recorder while on; None is off (the flag that span() tests)
_REC: Optional[_Recorder] = None
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec", "index", "range")

    def __init__(self, name: str, rec: _Recorder):
        self.name, self.rec, self.range = name, rec, None

    def __enter__(self):
        rec = self.rec
        # the row is made before its index is taken: a collection that
        # its allocation sets off appends its own span first
        row = [self.name, time_ns(), 0, -1, 0]
        self.index = rec.open(row)
        rec.stack.append(self.index)
        if rec.ranges and torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        rec = self.rec
        if self.index >= 0:
            rec.rows[self.index][2] = time_ns()
        rec.stack.pop()
        return False


def span(name: str):
    """A context manager: while the recorder is on, the enclosed work is a
    span `name` (and, while a torch.profiler profile runs, a
    `record_function` range of that name); off, the shared null
    context."""
    rec = _REC
    if rec is None:
        return _OFF
    return _Span(name, rec)


def _on_gc(phase: str, info: dict):
    """gc.callbacks hook while on: each collection is a span
    gc.gen<generation>."""
    rec = _REC
    if rec is None:
        return
    if phase == "start":
        rec.gc_start = time_ns()
    elif rec.gc_start:                  # not a collection begun before on
        rec.open([f"gc.gen{info['generation']}", rec.gc_start, time_ns(),
                  -1, 0])
        rec.gc_start = 0


def recording() -> bool:
    """Whether the recorder is on."""
    return _REC is not None


def start(ranges: bool = True) -> None:
    """Turn the recorder on: spans (at most SPAN_CAP; the rest counted as
    dropped) and garbage collections are kept until `stop`. ranges:
    spans open `record_function` ranges while a profile runs (a profile
    of the card alone, which shows no host range, passes False)."""
    global _REC
    if _REC is not None:
        raise RuntimeError("the span recorder is already on")
    _REC = _Recorder(ranges)
    gc.callbacks.append(_on_gc)


def stop() -> SpanList:
    """Turn the recorder off and hand over its spans (empty when it was
    off)."""
    global _REC
    rec, _REC = _REC, None
    out = SpanList()
    if rec is None:
        return out
    gc.callbacks.remove(_on_gc)
    now = time_ns()
    out.extend(Span(n, s, e or now, p, u) for n, s, e, p, u in rec.rows)
    out.dropped = rec.dropped
    return out


@contextlib.contextmanager
def paused():
    """The recorder off for the enclosed work (a torch.export trace of the
    program: its graph holds no range), and back as it was after."""
    global _REC
    rec, _REC = _REC, None
    try:
        yield
    finally:
        _REC = rec


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str], enabled: bool = True):
    """torch.profiler trace of the enclosed work, written to
    <log_dir>/trace.json (by rank r > 0 of a process group,
    trace_rank<r>.json), with the span recorder on so that the program's
    spans show as ranges; a no-op when disabled."""
    if not enabled or not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    own = not recording()
    with profile(activities=activities) as prof:
        if own:
            start()
        try:
            yield
        finally:
            if own:
                stop()
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
