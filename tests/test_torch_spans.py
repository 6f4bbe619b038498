"""The span recorder of qbn_tpu_torch.profiling and the spans at the
port's layer boundaries, on the CPU.

- Off, `span` is one shared null context: no record, no clock read, no
  profiler range. On, spans nest (parent indices, one unit id per root
  span), stop at the cap (the rest counted as dropped), garbage
  collections are spans, and a span is a `record_function` range on the
  profiler's own clock: placed by the profile's `trace_start_ns()`, it
  covers the aten call it encloses.
- The layers: the loader's batch and upload, `evaluate`'s batch with its
  upload, draw, forward, aggregate and sync in that order, the training
  step's forward, backward and update, the served call's upload and
  program, the int8 conv operator's host side. The exported graph holds
  no profiler node, recorder on or off.
- The recorder changes no output: `evaluate`'s probabilities and a
  training step's parameters are bitwise the same on and off.
"""

import contextlib
import gc
import json

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from qbn_tpu_torch import profiling
from qbn_tpu_torch.config import Config
from qbn_tpu_torch.data.loaders import ArrayLoader
from qbn_tpu_torch.evaluation.mc import evaluate
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops import int_conv
from qbn_tpu_torch.ops.stochastic import GeneratorNoise
from qbn_tpu_torch.serving import export_predictor, load_predictor
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import convert_model, init_variables, tree_leaves

LENET = (28, 28, 1)


class Recorded:
    spans = None


@contextlib.contextmanager
def recorded():
    """The recorder on for the enclosed work (off after it, whatever
    happens); its spans in the yielded holder's `spans`. Automatic garbage
    collection is off meanwhile, so that no collection span falls into the
    spans a test compares (gc.collect() still records one)."""
    out = Recorded()
    automatic = gc.isenabled()
    gc.disable()
    profiling.start()
    try:
        yield out
    finally:
        out.spans = profiling.stop()
        if automatic:
            gc.enable()


def _names(spans):
    return [s.name for s in spans]


def _children(spans, index):
    return [s.name for s in spans if s.parent == index]


@pytest.fixture(scope="module")
def int_lenet():
    """A BBB LeNet converted to INT by the port, with a 10-image split."""
    cfg = Config(model="conv_lenet_bbb", q=True, at=True, samples=2,
                 input_size=LENET, output_size=10)
    model = build_model(cfg)
    x = torch.rand((4,) + LENET, generator=torch.Generator().manual_seed(5))
    state = init_variables(model, torch.Generator().manual_seed(0), LENET,
                           "cpu", quantized=True)
    state = tree_map(lambda t: t.detach(), convert_model(model, state, x))
    rng = np.random.RandomState(0)
    xs = rng.rand(10, *LENET).astype(np.float32)
    return model, state, xs, np.arange(10) % 10


def _evaluate(int_lenet):
    model, state, xs, ys = int_lenet
    loader = ArrayLoader(xs, ys, 4, device="cpu")
    gen = torch.Generator().manual_seed(3)
    return evaluate(model, state, loader, 2, gen, "cpu")[1]


def _mlp_trainer():
    cfg = Config(model="linear_bbb", task="regression", samples=2,
                 input_size=(1,), dataset="regression_synthetic",
                 batch_size=8)
    model = build_model(cfg)
    variables = init_variables(model, torch.Generator().manual_seed(0),
                               (1,), "cpu")
    tx, _schedule = build_optimizer(cfg, 2)
    trainer = Trainer(model, cfg, tx, "float", 2, 16,
                      GeneratorNoise(torch.Generator().manual_seed(1)),
                      "cpu")
    rng = np.random.RandomState(2)
    loader = ArrayLoader(rng.rand(16, 1).astype(np.float32),
                         rng.rand(16, 1).astype(np.float32), 8,
                         shuffle=True, seed=4, device="cpu")
    return trainer, trainer.init_state(tree_map(torch.Tensor.detach,
                                                variables)), loader


def test_off_records_nothing_and_shares_one_null(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("called while the recorder is off")

    assert not profiling.recording()
    monkeypatch.setattr(profiling, "time_ns", forbidden)
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with a:
            with profiling.span("inner"):
                torch.ones(2).add_(1)
    assert not [e for e in prof.events() if e.name in ("a", "inner")]
    assert profiling.stop() == []


def test_nesting_gives_parents_and_units():
    with recorded() as rec:
        with profiling.span("root"):
            with profiling.span("child"):
                with profiling.span("grandchild"):
                    pass
            with profiling.span("second"):
                pass
        with profiling.span("next_root"):
            pass
    spans = rec.spans
    assert _names(spans) == ["root", "child", "grandchild", "second",
                             "next_root"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0, -1]
    units = [s.unit for s in spans]
    assert len(set(units[:4])) == 1 and units[4] != units[0]
    for s in spans:
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert spans.dropped == 0


def test_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    with recorded() as rec:
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass
        with pytest.raises(RuntimeError):
            profiling.start()               # already on
    assert _names(rec.spans) == ["s0", "s1", "s2"]
    assert rec.spans.dropped == 2


def test_a_collection_is_a_span():
    with recorded() as rec:
        with profiling.span("work"):
            gc.collect()
    spans = rec.spans
    gcs = [s for s in spans if s.name == "gc.gen2"]
    assert gcs and gcs[0].parent == 0 and gcs[0].unit == spans[0].unit
    assert spans[0].start_ns <= gcs[0].start_ns <= gcs[0].end_ns \
        <= spans[0].end_ns
    assert profiling._on_gc not in gc.callbacks


def test_a_span_is_a_range_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorded() as rec:
            with profiling.span("host.add"):
                torch.ones(8).add_(1)
    (sp,) = rec.spans
    origin = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()}
    assert "host.add" in events                    # the range
    add = events["aten::add_"].time_range           # us from the origin
    start_us = (sp.start_ns - origin) / 1e3
    end_us = (sp.end_ns - origin) / 1e3
    assert start_us <= add.start <= add.end <= end_us


def test_without_ranges_a_span_opens_no_range(monkeypatch):
    """start(ranges=False), as under a profile of the card alone: spans
    are kept, and no record_function is entered."""
    def forbidden(*a, **k):
        raise AssertionError("a range was opened")

    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        profiling.start(ranges=False)
        try:
            with profiling.span("host.add"):
                torch.ones(8).add_(1)
        finally:
            spans = profiling.stop()
    assert _names(spans) == ["host.add"]
    assert not [e for e in prof.events() if e.name == "host.add"]


def test_the_chrome_trace_carries_the_spans(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("phase.work"):
            torch.ones(4).mul_(2)
    assert not profiling.recording()
    with open(tmp_path / profiling.TRACE_FILE) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "phase.work" for e in events)


def test_evaluate_records_the_loader_and_the_batch(int_lenet):
    with recorded() as rec:
        _evaluate(int_lenet)
        assert profiling._REC.stack == []        # nothing left open
    spans = rec.spans
    batches = [i for i, s in enumerate(spans) if s.name == "mc.batch"]
    loads = [s for s in spans if s.name == "loader.batch"]
    assert len(batches) == 3 and len(loads) == 3
    for i in batches:
        assert spans[i].parent == -1
        assert _children(spans, i) == ["mc.upload", "mc.draw", "mc.forward",
                                       "mc.aggregate", "mc.sync"]
    # the loader's batch ends before the consumer's work on it
    for load, i in zip(loads, batches):
        assert load.parent == -1 and load.end_ns <= spans[i].start_ns
        up, = [s for s in spans if s.name == "loader.upload"
               and s.parent == spans.index(load)]
        assert load.start_ns <= up.start_ns <= up.end_ns <= load.end_ns


def test_evaluate_is_bitwise_the_same_on_and_off(int_lenet):
    off = _evaluate(int_lenet)
    with recorded() as rec:
        on = _evaluate(int_lenet)
    assert "mc.batch" in _names(rec.spans)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_train_epoch_records_the_step():
    trainer, state, loader = _mlp_trainer()
    with recorded() as rec:
        trainer.train_epoch(state, loader)
    spans = rec.spans
    steps = [i for i, s in enumerate(spans) if s.name == "train.step"]
    assert len(steps) == 2
    for i in steps:
        assert spans[i].parent == -1
        assert _children(spans, i) == ["train.forward", "train.backward",
                                       "train.update"]
    assert _names(spans).count("loader.batch") == 2


def test_a_training_step_is_bitwise_the_same_on_and_off():
    runs = []
    for on in (False, True):
        trainer, state, loader = _mlp_trainer()
        batch = [next(iter(loader))]
        with (recorded() if on else contextlib.nullcontext(Recorded())) \
                as rec:
            state, _m = trainer.train_epoch(state, batch)
        assert ("train.step" in _names(rec.spans or [])) == on
        runs.append([p.detach().clone() for p in tree_leaves(state.params)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("on_at_export", [False, True])
def test_the_served_call_and_a_graph_without_ranges(tmp_path, on_at_export):
    cfg = Config(model="linear_bbb", task="regression", q=True, at=True,
                 samples=4, input_size=(1,), dataset="regression_synthetic")
    model = build_model(cfg)
    x = torch.rand((8, 1), generator=torch.Generator().manual_seed(5))
    state = init_variables(model, torch.Generator().manual_seed(0), (1,),
                           "cpu", quantized=True)
    state = tree_map(lambda t: t.detach(), convert_model(model, state, x))
    from torch.profiler import ProfilerActivity, profile
    # on: the recorder and a profile both running while it exports
    with (profile(activities=[ProfilerActivity.CPU]) if on_at_export
          else contextlib.nullcontext()), \
            (recorded() if on_at_export else
             contextlib.nullcontext(Recorded())) as rec:
        export_predictor(model, state, cfg, mode="int", batch=8,
                         input_shape=(1,), path=str(tmp_path))
    # the export's trace of the forward ran with the recorder paused
    assert [s for s in rec.spans or [] if not s.name.startswith("gc.")] \
        == []
    loaded = load_predictor(str(tmp_path))
    for n in loaded.exported.graph.nodes:
        assert "profiler" not in str(n.target), n
        assert "record_function" not in str(n.target), n
    off = loaded.call(x, 2)
    with recorded() as rec:
        on = loaded.call(x, 2)
    spans = rec.spans
    assert _names(spans) == ["serve.call", "serve.upload", "serve.program"]
    assert [s.parent for s in spans] == [-1, 0, 0]
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_the_conv_operators_host_side_is_a_span(monkeypatch):
    """The CUDA implementation's checks, plan and launch are the span
    op.int_conv (its launch stood in for, so that it runs on CPU
    tensors)."""
    launched = []
    monkeypatch.setattr(int_conv, "_launch",
                        lambda *a, **k: launched.append(profiling.recording()))
    x = torch.zeros((1, 6, 6, 2 * 3), dtype=torch.int8)
    w = torch.zeros((2, 3, 3, 3, 4), dtype=torch.int8)
    one = torch.tensor(1.0)
    zero = torch.tensor(0)
    with recorded() as rec:
        out = int_conv._merged_cuda(x, one, w, one, zero, None, one, zero, 1,
                                    1, -128, 127, False, False, None, None,
                                    None, None, False, None)
    assert out.shape == (1, 6, 6, 8) and launched == [True]
    assert _names(rec.spans) == ["op.int_conv"]
