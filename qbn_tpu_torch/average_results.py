"""Aggregate results.json files across seeds into (nanmean, nanstd)
leaves (port of qbn_tpu's experiments/average_results.py).

    python -m qbn_tpu_torch.average_results --save SUMMARY_DIR DIR1 DIR2 ...

Walks the nested results dicts of N seed runs and replaces every numeric
leaf with [nanmean, nanstd] (NumPy's NaN-ignoring statistics over the
runs that have the leaf); strings (the dataset and model labels) pass
through from the first run, and `n_runs` is added.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from qbn_tpu_torch.evaluation.results import results_path


def aggregate(trees):
    """Recursively merge: numeric leaves -> [nanmean, nanstd]."""
    first = trees[0]
    if isinstance(first, dict):
        out = {}
        for k in first:
            vals = [t[k] for t in trees if isinstance(t, dict) and k in t]
            out[k] = aggregate(vals)
        return out
    if isinstance(first, (int, float)):
        arr = np.asarray([t for t in trees if isinstance(t, (int, float))],
                         dtype=np.float64)
        return [float(np.nanmean(arr)), float(np.nanstd(arr))]
    return first  # strings (dataset/model labels) pass through


def main(argv=None):
    p = argparse.ArgumentParser("python -m qbn_tpu_torch.average_results")
    p.add_argument("dirs", nargs="+", help="experiment dirs to average")
    p.add_argument("--save", required=True, help="output summary dir")
    args = p.parse_args(argv)

    trees = []
    for d in args.dirs:
        with open(results_path(d)) as fh:
            trees.append(json.load(fh))
    summary = aggregate(trees)
    summary["n_runs"] = len(trees)
    os.makedirs(args.save, exist_ok=True)
    with open(results_path(args.save), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(f"wrote {results_path(args.save)} ({len(trees)} runs)")


if __name__ == "__main__":
    main(sys.argv[1:])
