"""The traced sub-window of a `--trace 1` run and what the per-layer
readers read from it.

`Tracer.step(done)` is called by a driver each time a timed unit (a batch,
a step, a call) completes. The traced sub-window has two phases of
`count` units each, with a device synchronise at both ends of each:

* the device phase, units `start` .. `start + count`, profiles the card
  alone (torch.profiler's CUDA activity), so the host runs at nearly its
  untraced pace: the device operations with their intervals, the
  phase's wall time and its units' sizes, from which the idle share, the
  step's share of the peak, the rooflines and the device times come;
* the host phase, the next `count` units, profiles the host as well
  (CPU and CUDA activities), which slows the host by the profiler's cost
  on every call: the host's aten calls, the device time inside the
  benchmark's own profiler ranges, and the host's calls that label the
  idle gaps of the breakdown.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

# the profiler range around a driver's wait for its next unit's input
NEXT_UNIT = "portbench.next_input"
# the port's hand-written kernels, by the names nvcc gives them
PORT_KERNELS = ("int_conv_kernel", "int_conv_halo_kernel",
                "int_conv_pixel_kernel", "draw_kernel", "bbb_dense_kernel")


@dataclass
class Trace:
    # the device phase
    window_s: float
    units: int
    unit_sizes: List[int]                 # rows (examples) of each unit
    ops: List[Tuple[str, float, float]]   # device ops: (name, start, end) s
    # the host phase (host_units 0: the window ended before it)
    host_units: int = 0
    host_ops: int = 0                     # aten calls on the host
    ranges: Dict[str, float] = field(default_factory=dict)  # device s
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    host_phase_ops: List[Tuple[str, float, float]] = field(
        default_factory=list)
    extra: dict = field(default_factory=dict)   # the driver's facts

    def busy_s(self) -> float:
        """Seconds of the device phase in which some operation ran."""
        total, end = 0.0, None
        for _n, s, e in sorted(self.ops, key=lambda o: o[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total

    def device_s(self, match) -> float:
        """Device seconds of the device phase's operations whose name
        `match` accepts."""
        return sum(e - s for n, s, e in self.ops if match(n))

    def breakdown(self, top: int = 10):
        """The device phase's costliest operations, and the host phase's
        longest idle gaps, each labelled with the innermost host call
        running at its middle."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        ordered = sorted(self.host_phase_ops or self.ops, key=lambda o: o[1])
        end = ordered[0][2] if ordered else None
        for n, s, e in ordered[1:]:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        idle = []
        for g0, g1 in gaps[:top]:
            mid = (g0 + g1) / 2
            inside = [(e - s, n) for n, s, e in self.host if s <= mid <= e]
            label = min(inside)[1] if inside else "host: outside any op"
            idle.append([label, g1 - g0])
        return {"device_ops": [[n, v] for n, v in device_ops],
                "idle_gaps": idle}


def labelled(items, tracer):
    """The items of an iterator, each fetch inside a NEXT_UNIT range while
    the host phase runs (the idle gaps' label)."""
    it = iter(items)
    while True:
        if tracer.host_phase:
            with torch.profiler.record_function(NEXT_UNIT):
                item = next(it, None)
        else:
            item = next(it, None)
        if item is None:
            return
        yield item


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def warm_profiler():
    """Start and stop both kinds of profile once, so that the profiler's
    first start-up (the CUPTI library's) falls in set-up and not in the
    traced window."""
    from torch.profiler import profile
    for host in (False, True):
        with profile(activities=_activities(host)):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()


def _activities(host: bool):
    from torch.profiler import ProfilerActivity
    return ([ProfilerActivity.CPU] if host else []) + [ProfilerActivity.CUDA]


class Tracer:
    """Profiles units start .. start + 2 count of a window in its two
    phases (`count` 0: never)."""

    def __init__(self, start: int = 0, count: int = 0,
                 ranges: Tuple[str, ...] = (NEXT_UNIT,)):
        self.start, self.count, self.ranges = start, count, ranges
        self.prof = None
        self.sizes: List[int] = []
        self.trace: Optional[Trace] = None
        self._pending = [(start, False), (start + count, True)] \
            if count > 0 else []
        self._phases: List[dict] = []
        self._t0 = 0.0
        self._end = 0
        self._host = False

    @property
    def host_phase(self) -> bool:
        return self.prof is not None and self._host

    def done(self, timed_out: bool) -> bool:
        """Whether the window ends: untraced, when its time is up; traced,
        when both phases are done (whatever the time)."""
        return self.trace is not None if self.count > 0 else timed_out

    def step(self, done: int, size: int = 0):
        """`done` units have completed; the last had `size` rows."""
        if self.prof is not None:
            if size:
                self.sizes.append(size)
            if done == self._end:
                self._finish(self.count)
        if self.prof is None and self._pending and \
                done == self._pending[0][0]:
            self._begin(*self._pending.pop(0))

    def close(self):
        """End a profile the window cut short (counted as it stands)."""
        if self.prof is not None:
            self._finish(len(self.sizes))
        if self._phases and self.trace is None:
            self.trace = _merge(self._phases)

    def _begin(self, at: int, host: bool):
        from torch.profiler import profile
        torch.cuda.synchronize()
        self.prof = profile(activities=_activities(host))
        self.prof.__enter__()
        self.sizes, self._host, self._end = [], host, at + self.count
        self._t0 = time.perf_counter()

    def _finish(self, units: int):
        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        self.prof.__exit__(None, None, None)
        self._phases.append(_collect(self.prof, window, units, self.sizes,
                                     self.ranges, self._host))
        self.prof = None
        if len(self._phases) == 2:
            self.trace = _merge(self._phases)


def _collect(prof, window_s, units, sizes, ranges, host_phase) -> dict:
    from torch.autograd import DeviceType
    ops, host, host_ops = [], [], 0
    range_s = {r: 0.0 for r in ranges}
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            if e.name not in range_s:      # a range's span on the device
                ops.append((e.name, start, end))
            continue
        host.append((e.name, start, end))
        if e.name.startswith("aten::"):
            host_ops += 1
        if e.name in range_s:
            range_s[e.name] += e.device_time_total * 1e-6
    return {"host_phase": host_phase, "window_s": window_s, "units": units,
            "sizes": list(sizes), "ops": ops, "host": host,
            "host_ops": host_ops, "ranges": range_s}


def _merge(phases) -> Trace:
    dev = next(p for p in phases if not p["host_phase"])
    trace = Trace(window_s=dev["window_s"], units=dev["units"],
                  unit_sizes=dev["sizes"], ops=dev["ops"])
    for p in phases:
        if p["host_phase"]:
            trace.host_units, trace.host_ops = p["units"], p["host_ops"]
            trace.ranges, trace.host = p["ranges"], p["host"]
            trace.host_phase_ops = p["ops"]
    return trace
