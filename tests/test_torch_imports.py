"""The port and chip_smoke.py import nothing of JAX, of the JAX package or
of what only the JAX package needs (flax, optax, msgpack); its entry points
run on the card by default and raise without one.

An AST scan of the sources, not sys.modules: the test process has JAX
imported already."""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack", "qbn_tpu",
             "parity"}
SOURCES = sorted((ROOT / "qbn_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_found():
    assert len(SOURCES) > 10
    assert all(p.exists() for p in SOURCES)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path} imports {bad}"


def test_new_sources_scanned():
    names = {str(p.relative_to(ROOT)) for p in SOURCES}
    for rel in ("qbn_tpu_torch/flows.py", "qbn_tpu_torch/ops/stochastic.py",
                "qbn_tpu_torch/ops/bbb_dense.py",
                "qbn_tpu_torch/training/optim.py",
                "qbn_tpu_torch/training/trainer.py",
                "qbn_tpu_torch/training/losses.py",
                "qbn_tpu_torch/presets.py",
                "qbn_tpu_torch/ops/library.py",
                "qbn_tpu_torch/serving/__init__.py",
                "qbn_tpu_torch/serving/export.py",
                "qbn_tpu_torch/serving/__main__.py",
                "qbn_tpu_torch/profiling.py", "qbn_tpu_torch/sweep.py",
                "qbn_tpu_torch/average_results.py", "qbn_tpu_torch/cli.py",
                "qbn_tpu_torch/evaluation/presentation.py",
                "qbn_tpu_torch/parallel/__init__.py",
                "qbn_tpu_torch/parallel/mesh.py",
                "qbn_tpu_torch/parallel/sharded.py",
                "qbn_tpu_torch/parallel/sweep.py",
                "qbn_tpu_torch/ops/collectives.py"):
        assert rel in names, rel


DRAW_OWNERS = {ROOT / "qbn_tpu_torch" / "evaluation" / "mc.py",
               ROOT / "qbn_tpu_torch" / "ops" / "sample_weights.py"}
PACKAGE = [p for p in SOURCES if p.parent != ROOT and p not in DRAW_OWNERS]
PACKING = {"pack_layers", "draw_layers", "_unpack", "LayerPack"}


@pytest.mark.parametrize("path", PACKAGE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_one_owner_packs_the_draw(path):
    """The INT posterior draw is packed and unpacked in one place: outside
    the owner (evaluation/mc.py PosteriorDraw) and the kernel's
    module, no source names the pack's functions, by import or by
    attribute, or imports the kernel module's `unpack`."""
    tree = ast.parse(path.read_text(), filename=str(path))
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    used |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)
                and (n.module or "").endswith("sample_weights")
                for a in n.names}
    bad = (used & PACKING) | (imported & (PACKING | {"unpack"}))
    assert not bad, f"{path} names {sorted(bad)}"


def test_the_draw_has_one_owner():
    """The draw's old second and third owners are gone: no per-call pack
    in evaluation/mc.py, no hand-named pack buffers in serving, and no
    evaluation entry takes a plan (they take a PosteriorDraw)."""
    from qbn_tpu_torch.evaluation import mc
    from qbn_tpu_torch.ops import sample_weights
    from qbn_tpu_torch.parallel import sharded
    from qbn_tpu_torch.serving import export
    for module, name in ((mc, "draw_sampled_weights"), (mc, "plan_layers"),
                         (mc, "sampled_tree"), (export, "_PACK_FIELDS"),
                         (sample_weights, "_unpack")):
        assert not hasattr(module, name), name
    for fn in (mc.mc_predict, sharded.local_outputs,
               sharded.sharded_mc_predict, sharded.make_sharded_mc_eval):
        params = inspect.signature(fn).parameters
        assert "plan" not in params and params["draw"].default is None


LOWER = [p for p in SOURCES if p.parent.name in (
    "ops", "models", "quant", "training")]


@pytest.mark.parametrize("path", LOWER,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_lower_layers_import_no_parallel(path):
    """The layers, ops, observers and training steps sit below
    qbn_tpu_torch.parallel (the mesh and its launcher): none imports it
    when it is imported (a step that takes a mesh imports it inside)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = [n.module for n in tree.body
            if isinstance(n, ast.ImportFrom) and n.module]
    mods += [a.name for n in tree.body if isinstance(n, ast.Import)
             for a in n.names]
    bad = [m for m in mods if m.startswith("qbn_tpu_torch.parallel")]
    assert not bad, f"{path} imports {bad}"


def _entry_points():
    from qbn_tpu_torch.evaluation.mc import evaluate
    from qbn_tpu_torch.flows import fit
    from qbn_tpu_torch.models.factory import load_trained
    from qbn_tpu_torch.training.trainer import Trainer
    from qbn_tpu_torch.utils import init_variables
    return {"fit": fit, "evaluate": evaluate, "load_trained": load_trained,
            "Trainer": Trainer, "init_variables": init_variables}


@pytest.mark.parametrize("name", ["fit", "evaluate", "load_trained",
                                  "Trainer", "init_variables"])
def test_entry_points_default_to_the_card(name):
    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no CUDA device, the default device raises instead of carrying
    on on the CPU."""
    from qbn_tpu_torch.presets import preset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    eps = _entry_points()
    batch = [(np.zeros((2, 28, 28, 1), np.float32), np.zeros(2, np.int64))]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eps["fit"](preset("bbb", "mnist", tpu_fused=True, epochs=1), batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eps["evaluate"](None, {}, batch, samples=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eps["load_trained"](str(ROOT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eps["Trainer"](None, None, None, "float", 1, 1, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eps["init_variables"](None, torch.Generator(), (28, 28, 1))


def test_serving_cli_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """`python -m qbn_tpu_torch.serving` exports on the card unless given
    --device cpu, and raises without one."""
    from qbn_tpu_torch.serving import __main__ as serving_cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = ROOT / "examples" / "campaign" / "bbb-cifar-a_7_w_8-seed1"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_cli.main(["--exp", str(exp), "--out", str(tmp_path)])
