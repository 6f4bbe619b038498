"""The port's presentation figures (qbn_tpu_torch.evaluation.presentation)
against qbn_tpu/evaluation/presentation.py: both sides draw into a
recorder that stands in for matplotlib.pyplot, and every plotting call
(the series, error bars, box data and positions, ticks, labels and
legends) must be the same, argument for argument. Then the port's
figures are drawn for real where matplotlib is present, and are no-ops
without it (the card's machine has none)."""

import builtins
import json
import math
import os

import numpy as np
import pytest

from qbn_tpu.evaluation import presentation as J

from qbn_tpu_torch.evaluation import presentation as T


def _norm(v):
    """Comparable form of a plotting argument."""
    if isinstance(v, Rec):
        return "<artist>"
    if isinstance(v, np.ndarray):
        return _norm(v.tolist())
    if isinstance(v, (list, tuple, range)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (float, np.floating)):
        return "nan" if math.isnan(v) else float(v)
    if isinstance(v, np.integer):
        return int(v)
    return v


class Rec:
    """Records every call made on it or on what it returns."""

    def __init__(self, log, name="plt"):
        self._log, self._name = log, name

    def __getattr__(self, attr):
        if attr.startswith("__"):
            raise AttributeError(attr)
        return Rec(self._log, f"{self._name}.{attr}")

    def __call__(self, *args, **kwargs):
        self._log.append((self._name, _norm(args), _norm(kwargs)))
        if self._name == "plt.subplots":
            n = args[1] if len(args) > 1 else 1
            axes = [Rec(self._log, f"ax{i}") for i in range(n)]
            return Rec(self._log, "fig"), axes if n > 1 else axes[0]
        return Rec(self._log, f"{self._name}()")

    def __getitem__(self, key):
        return Rec(self._log, f"{self._name}[{key}]")


def _drawn(module, fn_name, *args, **kwargs):
    log = []
    orig = module._plt
    module._plt = lambda: Rec(log)
    try:
        getattr(module, fn_name)(*args, **kwargs)
    finally:
        module._plt = orig
    return log


def _cls(scale=1.0):
    return {"error": {"rotation": {str(l): [0.1 * l * scale, 0.01]
                                   for l in range(5)},
                      "shift": {str(l): [0.2 * l * scale, 0.01]
                                for l in range(5)},
                      "brightness": {str(l): [0.05 * l, 0.0]
                                     for l in range(5)},
                      "test": [0.08 * scale, 0.01]},
            "nll": {"test": [1.2 * scale, 0.1],
                    "rotation": {"0": [150.0, 1.0]}}}


def _reg(shift=0.0):
    return {m: {ds: {"test": [v + shift, 0.01]}
                for ds, v in (("regression_housing", 0.4),
                              ("regression_yacht", 0.6),
                              ("regression_power", 1e3),
                              ("regression_synthetic", 0.2))}
            for m in ("error", "nll")}


CASES = {
    "distortion_grid": ("plot_distortion_grid",
                        ({"bbb": _cls(), "pointwise": _cls(2.0)}, "error",
                         "grid.png"), {}),
    "bitwidth_lines": ("plot_bitwidth_lines",
                       ({"bbb": _cls(), "sgld": _cls(1.5)},
                        {"bbb": {"a_7_w_8": _cls(), "a_7_w_4": _cls(3.0)},
                         "sgld": {"a_3_w_8": _cls(0.5)}},
                        "error", "test", "bits.png"), {}),
    "bitwidth_lines_cells": ("plot_bitwidth_lines",
                             ({"bbb": _cls()}, {"bbb": {"a_7_w_8": _cls()}},
                              "nll", "test", "b.png"),
                             {"cells": ["a_7_w_8", "a_5_w_8"]}),
    "uci_lines": ("plot_uci_bitwidth_lines",
                  ({"bbb": _reg()}, {"bbb": {"a_7_w_8": _reg(0.1)}},
                   "error", "u.png"), {"cells": ["a_7_w_8", "a_7_w_6"]}),
    "uci_lines_nll": ("plot_uci_bitwidth_lines",
                      ({"bbb": _reg(), "mcdropout": _reg(0.3)},
                       {"bbb": {"a_7_w_8": _reg(0.1)}, "mcdropout": {}},
                       "nll", "u.png"), {}),
    "synthetic_lines": ("plot_uci_bitwidth_lines",
                        ({"bbb": _reg()}, {"bbb": {"a_7_w_8": _reg()}},
                         "error", "s.png"),
                        {"cells": ["a_7_w_8"], "which": "synthetic"}),
    "candlesticks": ("plot_candlestick_grid",
                     ({"bbb": _cls(), "pointwise": _cls(2.0),
                       "mcdropout": _cls(0.5)}, "error", "c.png"), {}),
    "candlesticks_nll": ("plot_candlestick_grid",
                         ({"sgld": _cls()}, "nll", "c.png"), {}),
    "uci_candlesticks": ("plot_uci_candlestick_grid",
                         ({"bbb": _reg(), "pointwise": _reg(0.2)},
                          {"bbb": {"a_7_w_8": _reg()},
                           "pointwise": {"a_7_w_8": _reg(0.1)}},
                          "error", "uc.png"), {"cells": ["a_7_w_8"]}),
    "uci_candlesticks_nll": ("plot_uci_candlestick_grid",
                             ({"bbb": _reg()}, {"bbb": {"a_7_w_8": _reg(),
                                                        "a_5_w_8": _reg()}},
                              "nll", "uc.png"), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plotted_series_equal_qbn_tpus(case):
    fn, args, kwargs = CASES[case]
    got = _drawn(T, fn, *args, **kwargs)
    want = _drawn(J, fn, *args, **kwargs)
    assert got == want
    assert any(name.endswith(("errorbar", "boxplot"))
               for name, _a, _k in got)


def test_labels_and_outlier_filter_are_qbn_tpus():
    assert T.METHOD_LABELS == J.METHOD_LABELS
    assert T.METRIC_LABELS == J.METRIC_LABELS
    assert T.DISTORTIONS == J.DISTORTIONS
    for v in (0.5, 91.0, -90.5, float("inf"), -float("inf"), float("nan"),
              89.9):
        assert T.isoutlier(v) == J.isoutlier(v)


def test_figures_drawn_and_summary_read(tmp_path):
    pytest.importorskip("matplotlib")
    for case, (fn, args, kwargs) in CASES.items():
        path = str(tmp_path / f"{case}.png")
        args = tuple(path if isinstance(a, str) and a.endswith(".png")
                     else a for a in args)
        getattr(T, fn)(*args, **kwargs)
        assert os.path.getsize(path) > 1000, case
    (tmp_path / "avg").mkdir()
    (tmp_path / "avg" / "results.json").write_text(json.dumps(_cls()))
    assert T.load_summary(str(tmp_path / "avg")) == J.load_summary(
        str(tmp_path / "avg"))


def test_no_matplotlib_no_figure(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_mpl(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    path = tmp_path / "grid.png"
    T.plot_distortion_grid({"bbb": _cls()}, "error", str(path))
    T.plot_uci_candlestick_grid({"bbb": _reg()}, {"bbb": {}}, "error",
                                str(path))
    assert not path.exists()
