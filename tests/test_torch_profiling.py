"""The port's profiling utilities (qbn_tpu_torch.profiling) against
qbn_tpu/profiling.py: `model_size_bytes` equals qbn_tpu's on the same
weights carried across (the same msgpack bytes); the NaN hook names the
first module whose output is non-finite, with its inputs' statistics,
where qbn_tpu's debug-NaN mode raises inside the jitted program; the
`debug_nans` and `profile` fields of the config reach the runner, and a
`--profile --debug` CPU run writes its trace, the program's spans in it;
the span recorder times phases (tests/test_torch_spans.py tests it
further)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.config import Config as JConfig
from qbn_tpu.models.factory import build_model as j_build_model
from qbn_tpu.profiling import model_size_bytes as j_model_size_bytes
from qbn_tpu.utils import init_variables as j_init_variables

from qbn_tpu_torch import profiling, run
from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.utils import init_variables


@pytest.fixture
def nan_mode_off():
    yield
    profiling.disable_nan_debugging()


@pytest.mark.parametrize("model,shape,quantized", [
    ("linear", (1,), False), ("conv_lenet_bbb", (28, 28, 1), False),
    ("conv_lenet_mc", (28, 28, 1), True)])
def test_model_size_bytes_equals_qbn_tpus(model, shape, quantized):
    cfg = JConfig(model=model, task="regression" if model == "linear"
                  else "classification", q=quantized, at=quantized)
    jm = j_build_model(cfg)
    v = j_init_variables(jm, jax.random.PRNGKey(0),
                         jnp.ones((2,) + shape), quantized=quantized)
    state = from_jax_state(jax.tree.map(np.asarray, v))
    assert profiling.model_size_bytes(state) == j_model_size_bytes(v)


def test_phase_timer():
    """The span recorder in the place of the phase timer: each phase's
    total nanoseconds, summed over its spans (collections, which the
    recorder also keeps, left out)."""
    profiling.start()
    try:
        for _ in range(2):
            with profiling.span("train"):
                pass
        with profiling.span("val"):
            pass
    finally:
        spans = profiling.stop()
    totals = {}
    for s in spans:
        if s.name.startswith("gc."):
            continue
        totals[s.name] = totals.get(s.name, 0) + (s.end_ns - s.start_ns)
    assert set(totals) == {"train", "val"}
    assert all(v >= 0 for v in totals.values())
    assert not profiling.recording()


def _lenet():
    cfg = Config(model="conv_lenet", input_size=(28, 28, 1))
    model = build_model(cfg)
    state = init_variables(model, torch.Generator().manual_seed(0),
                           (28, 28, 1), "cpu")
    return model, state, torch.rand((2, 28, 28, 1))


@pytest.mark.parametrize("named", [True, False])
def test_nan_hook_names_the_first_non_finite_module(nan_mode_off, named):
    model, state, x = _lenet()
    with torch.no_grad():
        state["params"]["fc_0"]["kernel"][3, 7] = float("nan")
    profiling.enable_nan_debugging(model if named else None)
    assert torch.is_anomaly_enabled()
    with pytest.raises(profiling.NonFiniteError) as err:
        with torch.no_grad():
            model(x, state, mode="float", train=False)
    want = "fc_0" if named else "DenseBlock"
    assert err.value.module == want
    (label, stats), = err.value.inputs
    assert label == "input 0"
    assert stats["shape"] == [2, 2450] and stats["non_finite"] == 0
    assert np.isfinite([stats["min"], stats["max"], stats["mean"]]).all()
    assert want in str(err.value)


def test_nan_hook_is_quiet_on_finite_outputs_and_undone(nan_mode_off):
    model, state, x = _lenet()
    with profiling.nan_debugging(model):
        with torch.no_grad():
            out = model(x, state, mode="float", train=False)
    assert bool(torch.isfinite(out).all())
    assert not torch.is_anomaly_enabled()
    with torch.no_grad():
        state["params"]["conv_0"]["kernel"].fill_(float("inf"))
        model(x, state, mode="float", train=False)    # no hook: no raise


def test_tensor_stats():
    s = profiling.tensor_stats(torch.tensor([1.0, float("nan"), 3.0,
                                             float("-inf")]))
    assert s == {"shape": [4], "non_finite": 2, "min": 1.0, "max": 3.0,
                 "mean": 2.0,
                 "std": pytest.approx(np.std([1.0, 3.0], ddof=1), 1e-7)}


def test_config_fields_reach_the_runner():
    cfg = Config()
    assert cfg.debug_nans is False and cfg.profile is False
    args = run.build_parser().parse_args(
        ["--method", "bbb", "--tier", "mnist", "--debug_nans", "--profile"])
    assert run._overrides(args) == {"debug_nans": True, "profile": True}
    assert set(Config.__dataclass_fields__) >= {
        k for k in ("debug_nans", "profile")
        if k in JConfig.__dataclass_fields__}


def test_profile_debug_run_writes_a_trace(tmp_path, nan_mode_off):
    save = run.main(["--method", "pointwise", "--tier", "regression",
                     "--device", "cpu", "--debug", "--epochs", "1",
                     "--profile", "--debug_nans", "--save",
                     str(tmp_path / "r")])
    trace = os.path.join(save, "profile", profiling.TRACE_FILE)
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    names = {str(e.get("name", "")) for e in events}
    assert {"train.step", "train.forward", "train.backward",
            "train.update"} <= names
    cfg = json.loads(open(os.path.join(save, "config.json")).read())
    assert cfg["profile"] is True and cfg["debug_nans"] is True
    assert os.path.exists(os.path.join(save, "DONE"))
    # the NaN mode ends with the training loop
    assert profiling._HOOK is None and not torch.is_anomaly_enabled()
