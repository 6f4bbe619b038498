"""`correct` on the CPU at small sizes, through the run's own path
(run.execute with the look for a card skipped): sound runs pass; the
control (the reference one precision below) and each fault planted in
the timed path make `correct` false."""

import time

import pytest
import torch

from portbench import run
from portbench.drivers import serve
from portbench.tests.small import SEED, cells_of, on_cpu, small_cell

CPU = torch.device("cpu")
EVAL = cells_of("mc_eval")
SERVE = cells_of("serve")
TRAIN = cells_of("train")


@pytest.fixture
def cpu(monkeypatch, tmp_path):
    on_cpu(monkeypatch)
    monkeypatch.setattr(serve, "CACHE_DIR", tmp_path / "cache")


def execute(name):
    result, _n = run.execute(small_cell(name), SEED, 1.0, False, CPU,
                             time.time())
    return result


@pytest.mark.parametrize("name", EVAL + SERVE + TRAIN)
def test_sound_runs_are_correct(cpu, name):
    result = execute(name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("name", EVAL + SERVE)
def test_the_int4_control_fails(cpu, name):
    import importlib
    cell = small_cell(name)
    driver = importlib.import_module(f"portbench.drivers.{cell.driver}")
    session = driver.Session(cell, SEED, CPU)
    session.setup()
    from portbench.tracing import Tracer
    session.window(0.5, Tracer())
    session.release()
    limits = run.load_limits(name)
    numbers, _n = session.check(weight_bits=4)
    assert any(v > limits[k] for k, v in numbers)


def _half_samples(monkeypatch, module):
    original = module.aggregate

    def aggregate(outs, task="classification"):
        return original(outs[: max(1, outs.shape[0] // 2)], task)
    monkeypatch.setattr(module, "aggregate", aggregate)


def _altered(monkeypatch, module):
    original = module.aggregate

    def aggregate(outs, task="classification"):
        out = original(outs, task).clone()
        out[0] = out[0].roll(1)
        return out
    monkeypatch.setattr(module, "aggregate", aggregate)


@pytest.mark.parametrize("fault", [_half_samples, _altered])
@pytest.mark.parametrize("name", EVAL + SERVE)
def test_a_broken_predictive_is_not_correct(cpu, monkeypatch, name, fault):
    import qbn_tpu_torch.evaluation.mc as mc
    import qbn_tpu_torch.serving.export as export
    fault(monkeypatch, mc if name in EVAL else export)
    assert not execute(name)["correct"]


def _unchanged(monkeypatch):
    from qbn_tpu_torch.training import trainer

    def apply_update(tx, state, grads, loss, new_vars):
        return (trainer.tree_map(torch.Tensor.detach, state.params),
                state.model_state, state.opt_state)
    monkeypatch.setattr(trainer, "apply_update", apply_update)


def _half_batch(monkeypatch):
    from qbn_tpu_torch.training.trainer import Trainer
    original = Trainer._tensors

    def tensors(self, x, y):
        x, y = original(self, x, y)
        return x[: len(x) // 2], y[: len(y) // 2]
    monkeypatch.setattr(Trainer, "_tensors", tensors)


def _unchanged_once_warm(monkeypatch):
    """Sound through set-up (the checked first steps and the ragged
    batch's) and the window's first step, then a step that returns its
    state unchanged: as a step replayed wrongly after an eager warm-up."""
    from qbn_tpu_torch.training import trainer
    original, calls = trainer.apply_update, []
    warm = small_cell(TRAIN[0]).traffic["checked_steps"] + 2

    def apply_update(tx, state, grads, loss, new_vars):
        calls.append(1)
        if len(calls) <= warm:
            return original(tx, state, grads, loss, new_vars)
        return (trainer.tree_map(torch.Tensor.detach, state.params),
                state.model_state, state.opt_state)
    monkeypatch.setattr(trainer, "apply_update", apply_update)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _unchanged_once_warm])
@pytest.mark.parametrize("name", TRAIN)
def test_a_broken_step_is_not_correct(cpu, monkeypatch, name, fault):
    fault(monkeypatch)
    result = execute(name)
    assert not result["correct"]
    late = fault is _unchanged_once_warm
    for key, c in result["checks"].items():
        if late and key.endswith(".first"):
            assert c["value"] <= c["limit"], (key, c)
