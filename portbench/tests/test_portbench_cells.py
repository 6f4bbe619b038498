"""BENCHMARK.json and the files it names: every cell resolves, by name
alone, to its configuration, traffic mix, metric readers and limits; a
cell added as files alone is picked up; the file keeps the contract's
shapes."""

import json
import re
import shutil

import pytest

from portbench import cells

SPEC = cells.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves(name):
    cell = cells.find(name)
    assert cell.config["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == name)
    assert (cells.PACKAGE / "drivers" / f"{cell.driver}.py").exists()
    assert (cells.PACKAGE / "limits" / f"{name}.json").exists()
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for metric, read in cells.readers(cell).items():
        assert callable(read), metric


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    reported = {m["name"] for w in SPEC["workloads"]
                for m in cells.find(w["name"]).per_layer}
    assert reported == {m["name"] for m in SPEC["per_layer"]}


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    items = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + \
        SPEC["per_layer"]
    for item in items:
        assert NAME.match(item["name"]), item["name"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in SPEC["configs"]:
        assert c["reduced"] == [] and c["file"].startswith("portbench/")
        with open(cells.ROOT / c["file"]) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(cells.PACKAGE, root / "portbench")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({
        "name": "bbb.int8-eval.b64-s5", "config": "bbb-resnet18-cifar10",
        "traffic": "eval.b64-s5", "chips": 1, "why": "a test cell"})
    spec["end_to_end"][0]["workloads"].append("bbb.int8-eval.b64-s5")
    spec["per_layer"][0]["workloads"].append("bbb.int8-eval.b64-s5")
    traffic = json.loads(
        (cells.PACKAGE / "traffic" / "eval.b256-s20.json").read_text())
    traffic.update(batch=64, samples=5)
    (root / "portbench" / "traffic" / "eval.b64-s5.json").write_text(
        json.dumps(traffic))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.find("bbb.int8-eval.b64-s5", root=root)
    assert cell.traffic["samples"] == 5 and cell.driver == "mc_eval"
    # metrics that list their cells report it only where it is listed
    assert [m["name"] for m in cell.end_to_end] == ["eval_throughput",
                                                    "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["eval_step_mfu"]
    assert callable(cells.readers(cell, root)["eval_step_mfu"])
