"""Presentation plots over aggregated sweep results (port of
qbn_tpu/evaluation/presentation.py, the same functions and labels):
box-plot grids of a metric vs distortion level (or vs UCI dataset) for
the four methods, and line+errorbar plots of a metric vs quantisation
bit-width with x-ticks 'Float32, Q:A7W8 ... Q:A3W8'.

Input: summary results.json files written by `average_results` (leaves
are [mean, std] pairs). Plotting is optional, as in plots.py: matplotlib
is imported when a figure is drawn, and where it is missing (the card's
machine has none) each figure is a no-op with a warning; the figures are
drawn elsewhere from the results.json.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)

METHOD_LABELS = {"pointwise": "Pointwise", "mcdropout": "MC-Dropout",
                 "bbb": "BBB", "sgld": "SGHMC"}
METRIC_LABELS = {
    "error": "Error [%]", "ece": "ECE [%]", "entropy": "Entropy [nats]",
    "nll": "NLL [nats]", "brier": "Brier score",
    "rmse": "RMSE", "mse": "MSE", "mae": "MAE",
}
DISTORTIONS = ["rotation", "shift", "brightness"]


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        log.warning("matplotlib unavailable (%s): skipping the figure", e)
        return None


def _leaf_mean(v):
    if isinstance(v, (list, tuple)):
        return float(v[0])
    return float(v)


def _leaf_std(v):
    if isinstance(v, (list, tuple)) and len(v) > 1:
        return float(v[1])
    return 0.0


def plot_distortion_grid(results_by_method: Dict[str, dict], metric: str,
                         path: str) -> None:
    """Metric vs distortion severity, one panel per distortion, one line
    (with std band) per method."""
    plt = _plt()
    if plt is None:
        return
    f, axes = plt.subplots(1, len(DISTORTIONS),
                           figsize=(4 * len(DISTORTIONS), 3), sharey=True)
    for ax, distortion in zip(axes, DISTORTIONS):
        for method, res in results_by_method.items():
            tree = res.get(metric, {}).get(distortion, {})
            if not tree:
                continue
            levels = sorted(tree, key=int)
            means = [_leaf_mean(tree[l]) for l in levels]
            stds = [_leaf_std(tree[l]) for l in levels]
            xs = [int(l) + 1 for l in levels]
            ax.errorbar(xs, means, yerr=stds, marker="o",
                        label=METHOD_LABELS.get(method, method))
        ax.set_xlabel(f"{distortion} level")
        ax.set_title(distortion)
    axes[0].set_ylabel(METRIC_LABELS.get(metric, metric))
    axes[0].legend(fontsize="small")
    f.tight_layout()
    f.savefig(path)
    plt.close(f)


def plot_bitwidth_lines(float_results: Dict[str, dict],
                        quant_results: Dict[str, Dict[str, dict]],
                        metric: str, split: str, path: str,
                        cells: Optional[Sequence[str]] = None) -> None:
    """Metric vs precision: x-ticks Float32, Q:A7W8 ... Q:A3W8
    (reference plot_continous.py:52-55,99-116).

    quant_results: method -> cell name ('a_7_w_8') -> results tree.
    """
    plt = _plt()
    if plt is None:
        return
    if cells is None:
        cells = (["a_7_w_%d" % w for w in (8, 7, 6, 5, 4, 3)]
                 + ["a_%d_w_8" % a for a in (6, 5, 4, 3)])
    ticks = ["Float32"] + [
        "Q:A{}W{}".format(c.split("_")[1], c.split("_")[3]) for c in cells]
    f, ax = plt.subplots(1, 1, figsize=(7, 3))
    for method in quant_results:
        ys, es = [], []
        fl = float_results.get(method, {}).get(metric, {}).get(split)
        ys.append(_leaf_mean(fl) if fl is not None else np.nan)
        es.append(_leaf_std(fl) if fl is not None else 0.0)
        for cell in cells:
            v = quant_results[method].get(cell, {}).get(metric,
                                                        {}).get(split)
            ys.append(_leaf_mean(v) if v is not None else np.nan)
            es.append(_leaf_std(v) if v is not None else 0.0)
        ax.errorbar(range(len(ticks)), ys, yerr=es, marker="o",
                    label=METHOD_LABELS.get(method, method))
    ax.set_xticks(range(len(ticks)))
    ax.set_xticklabels(ticks, rotation=45, fontsize=8)
    ax.set_ylabel(METRIC_LABELS.get(metric, metric))
    ax.legend(fontsize="small")
    f.tight_layout()
    f.savefig(path)
    plt.close(f)


def plot_uci_bitwidth_lines(float_results: Dict[str, dict],
                            quant_results: Dict[str, Dict[str, dict]],
                            metric: str, path: str,
                            cells: Optional[Sequence[str]] = None,
                            which: str = "uci") -> None:
    """Regression-tier metric vs precision lines.

    Regression results nest per-dataset under the metric
    (metric -> regression_<ds> -> split), so the classification
    plot_bitwidth_lines extractor can't read them. The reference's
    regression line plot takes, per precision point, the MEAN +- STD over
    the UCI datasets' test metric (isoutlier-filtered, NLL sign-flipped;
    reference: experiments/presentation/plot_continous.py:68-86), or the
    synthetic dataset's own [mean, std] for the synthetic variant.
    """
    plt = _plt()
    if plt is None:
        return
    if cells is None:
        cells = (["a_7_w_%d" % w for w in (8, 7, 6, 5, 4, 3)]
                 + ["a_%d_w_8" % a for a in (6, 5, 4, 3)])

    def value(res):
        tree = res.get(metric, {})
        if which == "synthetic":
            v = tree.get("regression_synthetic", {}).get("test")
            if v is None or isoutlier(_leaf_mean(v)):
                return np.nan, 0.0
            m = _leaf_mean(v)
            return (-m if metric == "nll" else m), _leaf_std(v)
        vals = []
        for ds in sorted(k for k in tree
                         if isinstance(k, str)
                         and k.startswith("regression_")
                         and k != "regression_synthetic"):
            v = tree[ds].get("test")
            if v is None or isoutlier(_leaf_mean(v)):
                continue
            m = _leaf_mean(v)
            vals.append(-m if metric == "nll" else m)
        if not vals:
            return np.nan, 0.0
        return float(np.mean(vals)), float(np.std(vals))

    ticks = ["Float32"] + [
        "Q:A{}W{}".format(c.split("_")[1], c.split("_")[3]) for c in cells]
    f, ax = plt.subplots(1, 1, figsize=(7, 3))
    for method in quant_results:
        ys, es = [], []
        y, e = value(float_results.get(method, {}))
        ys.append(y)
        es.append(e)
        for cell in cells:
            y, e = value(quant_results[method].get(cell, {}))
            ys.append(y)
            es.append(e)
        ax.errorbar(range(len(ticks)), ys, yerr=es, marker="o",
                    label=METHOD_LABELS.get(method, method))
    ax.set_xticks(range(len(ticks)))
    ax.set_xticklabels(ticks, rotation=45, fontsize=8)
    ax.set_ylabel(METRIC_LABELS.get("rmse" if metric == "error" else metric,
                                    metric))
    ax.set_xlabel("Bit-width & Precision")
    ax.legend(fontsize="small")
    f.tight_layout()
    f.savefig(path)
    plt.close(f)


def isoutlier(val: float) -> bool:
    """Reference outlier filter for presentation plots
    (reference: src/utils.py:100-101)."""
    return (val == np.inf or val == -np.inf or val < -9e1 or val > 9e1
            or bool(np.isnan(val)))


def plot_candlestick_grid(results_by_method: Dict[str, dict], metric: str,
                          path: str, levels: int = 5) -> None:
    """Box-plot (candlestick) grid: one box per (method, severity level),
    the box spanning the 3 distortions at that level, level '-1' being the
    clean test split — the reference's published-figure format
    (reference: experiments/presentation/plot_candlesticks.py:57-111)."""
    plt = _plt()
    if plt is None:
        return
    fig = plt.figure(figsize=(7, 2.6))
    plt.grid(True)
    bps, labels = [], []
    methods = [m for m in ("pointwise", "mcdropout", "bbb", "sgld")
               if m in results_by_method] or list(results_by_method)
    for i, method in enumerate(methods):
        res = results_by_method[method]
        data = []
        for level in range(-1, levels):
            vals = []
            for distortion in DISTORTIONS:
                if level == -1:
                    v = res.get(metric, {}).get("test")
                else:
                    v = res.get(metric, {}).get(distortion,
                                                {}).get(str(level))
                if v is None:
                    continue
                v = _leaf_mean(v)
                if not isoutlier(v):
                    vals.append(v)
            data.append(vals or [np.nan])
        positions = np.array([1 + k * (len(methods) + 1) + i
                              for k in range(levels + 1)])
        bp = plt.boxplot(
            data, positions=positions, showfliers=False, patch_artist=True,
            medianprops=dict(linewidth=2, color="black"),
            boxprops=dict(facecolor=f"C{i}", hatch="//" if i == 0 else ""),
            widths=1)
        bps.append(bp)
        labels.append(METHOD_LABELS.get(method, method))
    ax = fig.gca()
    ticks = ["Test data\n(clean)"] + [f"level {k + 1}"
                                      for k in range(levels)]
    tick_pos = np.array([1 + k * (len(methods) + 1)
                         + (len(methods) - 1) / 2.0
                         for k in range(levels + 1)])
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    plt.xticks(ticks=tick_pos, labels=ticks, fontsize=8)
    plt.tick_params(axis="x", which="both", bottom=False)
    plt.xlabel("Distortions")
    plt.ylabel(METRIC_LABELS.get(metric, metric))
    plt.tight_layout()
    ax.legend([bp["boxes"][0] for bp in bps], labels, loc="upper center",
              bbox_to_anchor=(0.5, 1.25), ncol=max(len(labels), 1),
              fontsize="small")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def plot_uci_candlestick_grid(float_results: Dict[str, dict],
                              quant_results: Dict[str, Dict[str, dict]],
                              metric: str, path: str,
                              cells: Optional[Sequence[str]] = None
                              ) -> None:
    """Regression box-plot grid: one box per (method, precision cell),
    the box spanning the UCI datasets' test metric at that precision —
    Float32 leftmost, then the quant cells (reference:
    experiments/presentation/plot_candlesticks.py:113-175, incl. the
    isoutlier filter and the reference's NLL sign flip)."""
    plt = _plt()
    if plt is None:
        return
    if cells is None:
        cells = sorted({c for m in quant_results.values() for c in m})
    methods = [m for m in ("pointwise", "mcdropout", "bbb", "sgld")
               if m in float_results] or list(float_results)

    def _vals(res):
        out = []
        for ds in sorted(k for k in res.get(metric, {})
                         if isinstance(k, str)
                         and k.startswith("regression_")
                         and k != "regression_synthetic"):
            v = res[metric][ds].get("test")
            if v is None:
                continue
            v = _leaf_mean(v)
            if isoutlier(v):
                continue
            out.append(-v if metric == "nll" else v)
        return out or [np.nan]

    fig = plt.figure(figsize=(7, 2.6))
    plt.grid(True)
    bps, labels = [], []
    n_pos = 1 + len(cells)
    for i, method in enumerate(methods):
        data = [_vals(float_results[method])]
        for cell in cells:
            res = quant_results.get(method, {}).get(cell, {})
            data.append(_vals(res))
        positions = np.array([1 + k * (len(methods) + 1) + i
                              for k in range(n_pos)])
        bp = plt.boxplot(
            data, positions=positions, showfliers=False,
            patch_artist=True,
            medianprops=dict(linewidth=2, color="black"),
            boxprops=dict(facecolor=f"C{i}", hatch="//" if i == 0 else ""),
            widths=1)
        bps.append(bp)
        labels.append(METHOD_LABELS.get(method, method))
    ax = fig.gca()
    ticks = ["Float32"] + [
        "Q:A{}W{}".format(c.split("_")[1], c.split("_")[3])
        for c in cells]
    tick_pos = np.array([1 + k * (len(methods) + 1)
                         + (len(methods) - 1) / 2.0 for k in range(n_pos)])
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    plt.xticks(ticks=tick_pos, labels=ticks, fontsize=8)
    plt.tick_params(axis="x", which="both", bottom=False)
    plt.xlabel("Bit-width & Precision")
    plt.ylabel({"error": "RMSE", "nll": "-NLL"}.get(metric, metric))
    plt.tight_layout()
    ax.legend([bp["boxes"][0] for bp in bps], labels, loc="upper center",
              bbox_to_anchor=(0.5, 1.25), ncol=max(len(labels), 1),
              fontsize="small")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def load_summary(path: str) -> dict:
    with open(os.path.join(path, "results.json")) as fh:
        return json.load(fh)
