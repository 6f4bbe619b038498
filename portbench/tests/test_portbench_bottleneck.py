"""The bottleneck ResNet-50 cell on the CPU: its shapes' counts
(portbench/roofline_bottleneck.py), its four readers on traces built by
hand, the seeded state's degeneracy guard on planted states, and
`correct` through the run's own path at a small size (widths 4/4/8/8,
one block a stage, 32 x 32 images, 10 classes): a sound run is correct,
and the int4 control, half the samples and an altered answer are not."""

import json
import time

import pytest
import torch

from portbench import cells, roofline, roofline_bottleneck as RB, run
from portbench.reference import seeded_state
from portbench.tests.small import SEED, on_cpu
from portbench.tracing import Trace, Tracer

CPU = torch.device("cpu")
NAME = "bbb-r50.int8-eval.b256-s20"
ARCH = json.loads((cells.PACKAGE / "configs" / "bbb-resnet50-imagenet.json")
                  .read_text())["architecture"]
SMALL_ARCH = dict(ARCH, widths=[4, 4, 8, 8], blocks=[1, 1, 1, 1],
                  input=[32, 32, 3], classes=10)


def test_fifty_three_convs_and_their_work():
    convs = RB.bottleneck_convs(ARCH)
    assert len(convs) == 53 and sum(c.residual for c in convs) == 16
    assert sum(c.conv.name.endswith("shortcut") for c in convs) == 4
    macs = sum(RB.conv_work(c, 1, 1)[1] for c in convs) // 2
    assert round(macs / 1e9, 3) == 4.087
    assert sum(RB.stochastic_layer_codes(ARCH)) == 25_502_912
    # the residual reads: S B H' W' C of each block's last conv
    plain = sum(roofline.conv_work(c.conv, 256, 20, False)[0]
                for c in convs)
    reads = sum(20 * 256 * roofline.out_hw(c.conv) ** 2 * c.conv.cout
                for c in convs if c.residual)
    total = sum(RB.conv_work(c, 256, 20)[0] for c in convs)
    assert total - plain == reads
    t, by = RB.conv_bound_s(ARCH, 256, 20)
    assert by == "bytes" and round(1e3 * t, 1) == 40.0
    ops = RB.int8_ops_per_example(ARCH, 20) * 256
    assert ops == pytest.approx(41.85e12 + 2 * 20 * 256 * 2048 * 1000,
                                rel=1e-3)


def _trace(extra, ops=(), sizes=(256, 256)):
    return Trace(window_s=2.0, units=len(sizes), unit_sizes=list(sizes),
                 ops=list(ops), extra=extra)


FACTS = {"samples": 20, "method": "bbb", "architecture": ARCH,
         "launches_by_design": {"halo": 0, "pixel": 0, "im2col": 106}}


def test_the_readers_on_a_trace_built_by_hand():
    ops = [("void int_conv_kernel<12, false>", 0.0, 0.4),
           ("void int_conv_kernel<12, false>", 0.5, 0.9),
           ("draw_kernel(signed char const*)", 1.0, 1.01)]
    tr = _trace(FACTS, ops)
    read = {m: cells.reader(m) for m in (
        "bottleneck.eval_step_mfu", "bottleneck.int_conv.roofline",
        "bottleneck.draw.roofline", "bottleneck.conv_im2col_share")}
    mfu = RB.int8_ops_per_example(ARCH, 20) * 512 / 2.0 / 1979e12
    assert read["bottleneck.eval_step_mfu"](tr) == pytest.approx(100 * mfu)
    bound = 2 * RB.conv_bound_s(ARCH, 256, 20)[0]
    assert read["bottleneck.int_conv.roofline"](tr) == pytest.approx(
        100 * bound / 0.8)
    draw = 2 * (20 + 2) * 25_502_912 / 3.35e12
    assert read["bottleneck.draw.roofline"](tr) == pytest.approx(
        100 * draw / 0.01)
    assert read["bottleneck.conv_im2col_share"](tr) == 100.0
    tr.extra = dict(FACTS, launches_by_design={"halo": 30, "pixel": 10,
                                               "im2col": 60})
    assert read["bottleneck.conv_im2col_share"](tr) == 60.0
    # nothing to read: a basic-block ResNet's facts, or a program that
    # counts no launches
    basic = dict(FACTS, architecture={"widths": [24], "blocks": [2]},
                 launches_by_design={})
    for name, r in read.items():
        assert r(_trace(basic, ops)) is None, name


@pytest.fixture
def small(monkeypatch, tmp_path):
    """The cell at the small size, the program's model built at its
    widths, torch.cuda's calls as no-ops."""
    from qbn_tpu_torch.models import factory
    from qbn_tpu_torch.models.architectures import ImageNetResNet
    on_cpu(monkeypatch)
    real = factory.build_model

    def build(cfg):
        full = real(cfg)
        model = ImageNetResNet(
            output_size=10, widths=tuple(SMALL_ARCH["widths"]),
            num_blocks=tuple(SMALL_ARCH["blocks"]),
            stochastic=full.stochastic, sigma_prior=cfg.sigma_prior,
            quant=full.fc.quant)
        model.method, model.task = full.method, full.task
        return model
    monkeypatch.setattr(factory, "build_model", build)
    cell = cells.find(NAME)
    cell.traffic.update(images=20, batch=8, samples=2, checked_batches=2,
                        image_shape=[32, 32, 3], classes=10)
    cell.config["architecture"] = dict(SMALL_ARCH)
    cell.config["port"] = dict(cell.config["port"], output_size=10,
                               input_size=[32, 32, 3])
    return cell


def test_a_sound_run_is_correct_and_the_control_is_not(small):
    result, _n = run.execute(small, SEED, 1.0, False, CPU, time.time())
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    from portbench.drivers import mc_eval_bottleneck as driver
    session = driver.Session(small, SEED, CPU)
    session.setup()
    session.window(0.5, Tracer())
    session.release()
    (name, value), = session.check(weight_bits=4)[0]
    assert value > run.load_limits(NAME)[name]
    assert set(session.facts()["launches_by_design"]) == {"halo", "pixel",
                                                          "im2col"}


def _half_samples(outs, task, original):
    return original(outs[: max(1, outs.shape[0] // 2)], task)


def _altered(outs, task, original):
    out = original(outs, task).clone()
    out[0] = out[0].roll(1)
    return out


@pytest.mark.parametrize("fault", [_half_samples, _altered])
def test_a_broken_predictive_is_not_correct(small, monkeypatch, fault):
    import qbn_tpu_torch.evaluation.mc as mc
    original = mc.aggregate
    monkeypatch.setattr(mc, "aggregate", lambda outs, task="classification":
                        fault(outs, task, original))
    result, _n = run.execute(small, SEED, 1.0, False, CPU, time.time())
    assert not result["correct"]


def _config(**state):
    cfg = json.loads((cells.PACKAGE / "configs" /
                      "bbb-resnet50-imagenet.json").read_text())
    cfg["architecture"] = dict(SMALL_ARCH)
    cfg["state"] = dict(cfg["state"], **state)
    return cfg


def test_the_seeded_state_is_sound_at_the_small_size():
    qc = seeded_state.qconst(_config(), SEED, CPU)
    assert list(qc)[:2] == ["input_quant", "stem"] and list(qc)[-1] == "fc"
    assert list(qc["stage0_block0"]) == ["conv_0", "conv_1", "conv_2",
                                         "shortcut", "add"]
    q = qc["stage1_block0"]["conv_1"]["q"]
    assert q["w_codes"].dtype == torch.int8 and q["w_zp"].dtype == \
        torch.int32 and q["bias_f"].shape == (4,)


def test_the_guard_fires_on_planted_states(monkeypatch):
    # no posterior spread: every drawn sample is the mean
    with pytest.raises(RuntimeError, match="predictives are identical"):
        seeded_state.qconst(_config(std_to_bound=0.0), SEED, CPU)
    # one calibration image repeated: the images tell nothing apart
    from portbench import inputs
    real = inputs.images

    def same(n, shape, classes, seed, salt=0):
        x, y = real(1, shape, classes, seed, salt)
        return x.repeat(n, 0), y.repeat(n, 0)
    monkeypatch.setattr(inputs, "images", same)
    with pytest.raises(RuntimeError, match="degenerate"):
        seeded_state.qconst(_config(), SEED, CPU)
    # each rule on readings planted by hand
    many = {("stem",): torch.arange(16, dtype=torch.int8)}
    probs = [torch.eye(3), 2 * torch.eye(3)]
    assert seeded_state.degenerate(many, torch.eye(3), probs) is None
    few = {("stem",): torch.tensor([0, 1, 2], dtype=torch.int8)}
    assert "stem's codes take 3 values" in seeded_state.degenerate(
        few, torch.eye(3), probs)
    one = torch.zeros((3, 3))
    one[:, 1] = 1.0
    assert "same top-1 class" in seeded_state.degenerate(many, one, probs)
    # a flat predictive: under half of the rule's head_top_prob
    flat = 0.01 * torch.eye(3)
    assert "top-1 probability averages" in seeded_state.degenerate(
        many, flat, probs, top=0.9)
    assert seeded_state.degenerate(many, 10 * torch.eye(3), probs,
                                   top=0.9) is None


RUN = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from portbench import cells, run
from portbench.tests.small import SEED
from qbn_tpu_torch.models import factory
from qbn_tpu_torch.models.architectures import ImageNetResNet
real = factory.build_model


def build(cfg):
    full = real(cfg)
    model = ImageNetResNet(output_size=10, widths=(4, 4, 8, 8),
                           num_blocks=(1, 1, 1, 1), stochastic=True,
                           quant=full.fc.quant)
    model.method, model.task = full.method, full.task
    return model


factory.build_model = build
for name in ("synchronize", "max_memory_allocated", "get_device_name",
             "empty_cache"):
    setattr(torch.cuda, name, lambda *a, **k: 0)
cell = cells.find({name!r})
cell.traffic.update(images=20, batch=8, samples=2, checked_batches=2,
                    image_shape=[32, 32, 3], classes=10)
cell.config["architecture"] = {arch!r}
cell.config["port"] = dict(cell.config["port"], output_size=10,
                           input_size=[32, 32, 3])
run.execute(cell, SEED, 0.5, False, torch.device("cpu"), time.time())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    """As test_portbench_imports.py's check, in a fresh interpreter, at
    the small size."""
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(cells.ROOT), name=NAME,
                                          arch=SMALL_ARCH)],
        capture_output=True, text=True, cwd=cells.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "qbn_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "qbn_tpu"}
