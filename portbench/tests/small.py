"""Small cells for the CPU tests: the cells of BENCHMARK.json at sizes the
CPU runs in seconds, and the card's calls made harmless on the CPU."""

from __future__ import annotations

import torch

from portbench import cells

SMALL = {
    "mc_eval": {"images": 20, "batch": 8, "samples": 2,
                "checked_batches": 2},
    "train": {"images": 84, "batch": 8,
              "timed_check": {"after": 1, "span": 2}},
    "serve": {"images": 4, "samples": 2, "checked_calls": 2},
}
SEED = 2 ** 31 + 4099


def small_cell(name: str):
    cell = cells.find(name)
    cell.traffic.update(SMALL[cell.driver])
    return cell


def on_cpu(monkeypatch):
    """torch.cuda's calls of a run, as no-ops on the CPU."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "cpu")
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)


def cells_of(driver: str):
    spec = cells.load_spec()
    return [w["name"] for w in spec["workloads"]
            if cells.find(w["name"], spec).driver == driver]
