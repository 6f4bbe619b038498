"""What a run loads: after a CPU run of each cell's code no module whose
top-level name is jax, jaxlib, flax or qbn_tpu is loaded (compared whole:
qbn_tpu_torch is the program); the reference loads qbn_tpu_torch neither.
Each check runs in a fresh interpreter, so that nothing else of the test
session counts."""

import json
import subprocess
import sys

import pytest

from portbench import cells
from portbench.tests.small import cells_of

FORBIDDEN = {"jax", "jaxlib", "flax", "qbn_tpu"}

RUN = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from portbench import run
from portbench.tests.small import SEED, small_cell
import portbench.drivers.serve as serve
for name in ("synchronize", "max_memory_allocated", "get_device_name",
             "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: 0)
serve.CACHE_DIR = serve.CACHE_DIR.parent / {cache!r}
run.execute(small_cell({name!r}), SEED, 0.5, False, torch.device("cpu"),
            time.time())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REFERENCE = """
import json, sys, torch
sys.path.insert(0, {root!r})
from portbench.reference import (data, draw, float_resnet, int_resnet,
                                 msgpack, replay, states)
from portbench.cells import ROOT
cfg = json.load(open(ROOT / "portbench/configs/bbb-resnet18-cifar10.json"))
qc = states.qconst(cfg, ROOT)
x = data.normalize_cifar(torch.rand(2, 32, 32, 3))
int_resnet.predictive(qc, x, cfg["architecture"], (0, 127), 1,
                      method="bbb", sampled=draw.draw(qc, 1, 5, 0, "cpu"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(code):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=cells.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("name", [w["name"] for w in
                                  cells.load_spec()["workloads"]])
def test_a_run_loads_no_jax(name, tmp_path):
    loaded = _modules(RUN.format(root=str(cells.ROOT), name=name,
                                 cache=str(tmp_path / "cache")))
    assert "qbn_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_no_program():
    loaded = _modules(REFERENCE.format(root=str(cells.ROOT)))
    assert not loaded & (FORBIDDEN | {"qbn_tpu_torch"})


def test_without_a_card_a_run_fails_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         cells_of("mc_eval")[0], "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cells.ROOT,
        timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout == ""
