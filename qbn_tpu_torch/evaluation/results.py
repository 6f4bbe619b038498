"""Results store (port of qbn_tpu/evaluation/results.py): one JSON file,
results.json, with qbn_tpu's schema:

  {dataset, model,
   error/nll/ece/entropy/latency:
       {train/valid/test/random: float,
        <distortion>: {"0".."4": float},
        regression_<ds>: {train/valid/test: float}},
   model_size}

The 'latency' slot holds the example-samples per second of each split's
evaluation, on the device that ran it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

METRIC_KEYS = ("error", "nll", "ece", "entropy", "latency")


def init_results(cfg) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "dataset": getattr(cfg, "dataset", ""),
        "model": getattr(cfg, "model", ""),
    }
    for k in METRIC_KEYS:
        out[k] = {}
    return out


def results_path(save_dir: str) -> str:
    return os.path.join(save_dir, "results.json")


def save_results(results: Dict[str, Any], save_dir: str) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = results_path(save_dir)
    with open(path, "w") as fh:
        json.dump(results, fh, indent=2, default=float)
    return path


def load_results(save_dir: str) -> Dict[str, Any]:
    path = results_path(save_dir)
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)
