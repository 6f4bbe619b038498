"""The traced sub-window's two phases, with the profiler stood in for:
the device phase profiles the card alone over units start .. start +
count, the host phase the host as well over the next count units, and
the trace takes each reading from its phase."""

import pytest
import torch

from portbench import tracing


class FakeProfile:
    opened = []

    def __init__(self, activities):
        self.host = len(activities) == 2

    def __enter__(self):
        FakeProfile.opened.append([self.host, None])

    def __exit__(self, *exc):
        FakeProfile.opened[-1][1] = "closed"


def fake_collect(prof, window_s, units, sizes, ranges, host_phase):
    return {"host_phase": host_phase, "window_s": 1.0 + host_phase,
            "units": units, "sizes": list(sizes),
            "ops": [("k", 0.0, 0.25 * (1 + host_phase))],
            "host": [("aten::add", 0.0, 1.0)] if host_phase else [],
            "host_ops": 7 * units if host_phase else 0,
            "ranges": {r: 0.5 * host_phase for r in ranges}}


@pytest.fixture
def fake(monkeypatch):
    import torch.profiler
    FakeProfile.opened = []
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(tracing, "_collect", fake_collect)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_the_phases_follow_each_other(fake):
    t = tracing.Tracer(start=2, count=3)
    seen = []
    for done in range(1, 12):
        t.step(done, size=10 + done)
        seen.append((done, t.host_phase, t.done(False)))
        if t.done(False):
            break
    assert [h for h, _c in FakeProfile.opened] == [False, True]
    assert all(c == "closed" for _h, c in FakeProfile.opened)
    assert seen[-1] == (8, False, True)
    assert [d for d, h, _ in seen if h] == [5, 6, 7]
    tr = t.trace
    assert (tr.units, tr.unit_sizes, tr.window_s) == (3, [13, 14, 15], 1.0)
    assert tr.busy_s() == 0.25 and tr.ops == [("k", 0.0, 0.25)]
    assert (tr.host_units, tr.host_ops) == (3, 21)
    assert tr.ranges[tracing.NEXT_UNIT] == 0.5
    assert tr.host_phase_ops == [("k", 0.0, 0.5)]


def test_a_window_cut_short_keeps_the_device_phase(fake):
    t = tracing.Tracer(start=1, count=4)
    for done in range(1, 7):
        t.step(done, size=1)
    t.close()
    assert t.trace.units == 4 and t.trace.host_units == 1


def test_untraced_windows_end_by_the_clock():
    t = tracing.Tracer()
    t.step(5, 1)
    assert not t.done(False) and t.done(True) and t.trace is None
    assert not t.host_phase
