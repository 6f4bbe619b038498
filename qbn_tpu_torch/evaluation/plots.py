"""Diagnostic plots (port of qbn_tpu/evaluation/plots.py): the
reliability diagram, the confidence histogram, the regression uncertainty
decomposition, from numpy arrays.

Plotting is optional: matplotlib is imported when a plot is drawn, and
where it is missing (the card's machine has none) each plot is a no-op
with a warning. A plot is not a result: results.json holds the metrics.
"""

from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:
        log.warning("matplotlib unavailable (%s): skipping the plot", e)
        return None


def plot_reliability(probs: np.ndarray, labels: np.ndarray, path: str,
                     n_bins: int = 10) -> None:
    """Reliability diagram: per-bin accuracy vs confidence with gap bars."""
    plt = _plt()
    if plt is None:
        return
    conf = probs.max(1)
    correct = (probs.argmax(1) == labels).astype(np.float64)
    bins = np.clip((conf * n_bins).astype(int), 0, n_bins - 1)
    acc_b = np.zeros(n_bins)
    conf_b = np.zeros(n_bins)
    for b in range(n_bins):
        m = bins == b
        if m.any():
            acc_b[b] = correct[m].mean()
            conf_b[b] = conf[m].mean()
    edges = np.linspace(0, 1, n_bins + 1)[:-1]
    width = 1.0 / n_bins
    f, ax = plt.subplots(1, 1, figsize=(4, 2.5))
    ax.bar(edges, acc_b, width=width, align="edge", alpha=0.75,
           edgecolor="b", label="Outputs")
    ax.bar(edges, conf_b - acc_b, bottom=acc_b, width=width, align="edge",
           color=[1, 0.7, 0.7], alpha=0.5, hatch="//", edgecolor="r",
           label="Gap")
    ax.plot([0, 1], [0, 1], "--", color="gray")
    ax.set_xlabel("Confidence")
    ax.set_ylabel("Accuracy")
    ax.legend(loc="best", fontsize="small")
    f.tight_layout()
    f.savefig(path)
    plt.close(f)


def plot_confidence_histogram(probs: np.ndarray, path: str,
                              n_bins: int = 10) -> None:
    plt = _plt()
    if plt is None:
        return
    conf = np.nan_to_num(probs.max(1))
    f, ax = plt.subplots(1, 1, figsize=(4, 2.5))
    height, edges = np.histogram(conf, bins=n_bins)
    height = height / max(float(height.max()), 1.0)
    ax.bar(edges[:-1], height, width=edges[1] - edges[0], align="center",
           color="b", label="Normalized counts")
    ax.set_xlabel("Confidence")
    ax.legend()
    f.tight_layout()
    f.savefig(path)
    plt.close(f)


def plot_regression_uncertainty(x_grid, y_true, mean, epistemic, aleatoric,
                                x_train, y_train, path: str,
                                multi_sample: bool = True) -> None:
    """Predictive mean with epistemic/aleatoric/total bands on the synthetic
    1-D task (reference: experiments/utils.py:261-289)."""
    plt = _plt()
    if plt is None:
        return
    x_grid = np.asarray(x_grid).reshape(-1)
    mean = np.asarray(mean).reshape(-1)
    epistemic = np.asarray(epistemic).reshape(-1)
    aleatoric = np.asarray(aleatoric).reshape(-1)
    total = np.sqrt(epistemic + aleatoric)
    f, ax = plt.subplots(1, 1)
    ax.plot(x_grid, np.asarray(y_true).reshape(-1), label="True function",
            color="k")
    ax.plot(x_grid, mean, label="Predicted mean", color="r", linestyle="--")
    ax.scatter(np.asarray(x_train).reshape(-1),
               np.asarray(y_train).reshape(-1),
               label="Random training points", color="b")
    if multi_sample:
        ax.fill_between(x_grid, mean - total, mean + total, color="r",
                        alpha=0.3, label="Total uncertainty")
        ax.fill_between(x_grid, mean - np.sqrt(aleatoric),
                        mean + np.sqrt(aleatoric), color="b", alpha=0.3,
                        label="Aleatoric uncertainty")
        ax.fill_between(x_grid, mean - np.sqrt(epistemic),
                        mean + np.sqrt(epistemic), color="g", alpha=0.4,
                        label="Epistemic uncertainty")
    else:
        ax.fill_between(x_grid, mean - aleatoric, mean + aleatoric,
                        color="g", alpha=0.4, label="Aleatoric uncertainty")
    ax.legend(loc="upper left")
    f.tight_layout()
    f.savefig(path)
    plt.close(f)
