"""Find a cell of BENCHMARK.json and the files it names.

A cell's configuration is the JSON file its `configs` entry names; its
traffic mix is `traffic/<traffic>.json`; a per-layer metric is the reader
`metrics/<metric name>.py` (a module with `read(ctx)`, which returns a
number or None when the run gives it nothing to read). Nothing here knows
a cell, a configuration or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
SPEC = ROOT / "BENCHMARK.json"
# build and export caches of the program, at a fixed path in the checkout
CACHE_DIR = ROOT / ".portbench_cache"


def load_spec(path: Path = SPEC) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, spec: Optional[dict] = None,
         root: Path = ROOT) -> Cell:
    """The cell `name` with its configuration, traffic and metrics."""
    spec = load_spec(root / "BENCHMARK.json") if spec is None else spec
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json "
                       f"({sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf_entry = configs[entry["config"]]
    with open(root / conf_entry["file"]) as fh:
        config = json.load(fh)
    with open(root / "portbench" / "traffic" / f"{entry['traffic']}.json") \
            as fh:
        traffic = json.load(fh)
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _reports(m, name) and m["moves"] in reported]
    return Cell(name=name, chips=int(entry["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=layer)


def reader(metric: str, root: Path = ROOT):
    """The `read(ctx)` of metrics/<metric>.py."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def readers(cell: Cell, root: Path = ROOT) -> Dict[str, object]:
    return {m["name"]: reader(m["name"], root) for m in cell.per_layer}
