"""The port's serving export (qbn_tpu_torch.serving), case for case with
tests/test_serving.py, and held against qbn_tpu's own Monte-Carlo
predictor.

- A loaded `torch.export` artifact runs the same aten ops and operators
  in the same order as the live module, so its outputs are bitwise the
  live predictor's on the CPU, float included (qbn_tpu's XLA AOT round
  trip needed 1e-5 there).
- The frozen bank of int8 codes, fed to qbn_tpu's `mc_predict` as
  `presampled` on the same weights (qbn_tpu's converted states carried
  across), gives the port's codes bitwise at every cut of the ResNet and
  probabilities within 1e-6 (a float32 softmax and mean whose summation
  orders differ), for the BBB LeNet and a small ResNet-18 (widths 8/16/
  16/16).
- Every random source follows `seed` through a key tensor; the exported
  graph calls the `qbn_tpu_torch::` operators, no plain version, and a
  fresh process loads it with only torch and `qbn_tpu_torch.ops`.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

import qbn_tpu.evaluation.mc as JMC
from qbn_tpu.config import Config as JConfig
from qbn_tpu.models.architectures import ResNet as JResNet
from qbn_tpu.models.factory import build_model as j_build_model
from qbn_tpu.models.layers import QuantConfig as JQuant
from qbn_tpu.utils import split_rngs

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.evaluation import ensemble as TE
from qbn_tpu_torch.evaluation.mc import (
    PosteriorDraw, aggregate, mc_predict)
from qbn_tpu_torch.models.architectures import CUTS, BasicBlock, ResNet
from qbn_tpu_torch.models.factory import build_model, load_trained
from qbn_tpu_torch.ops.stochastic import SeedMasks
from qbn_tpu_torch.serving import (export_predictor, load_predictor,
                                   make_predictor)
from qbn_tpu_torch.serving import __main__ as serving_cli
from qbn_tpu_torch.serving.export import (DRAW_STREAM, MASK_STREAM,
                                          seed_key)
from qbn_tpu_torch.utils import convert_model, init_variables

from test_torch_int_methods import convert
from test_torch_residual_route import eager_block_forward

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(ROOT, "examples", "campaign",
                        "bbb-cifar-a_7_w_8-seed1")
KEY = jax.random.PRNGKey(0)
LENET = (28, 28, 1)
WIDTHS = (8, 16, 16, 16)


def _same(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.shape == v.shape
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _int_lenet(model_name, samples, **kw):
    """qbn_tpu's converted LeNet (as tests/test_serving.py makes it),
    carried across: (cfg, model, state, x, jmodel, jstate)."""
    jcfg = JConfig(model=model_name, sigma_prior=0.1, p=0.3, output_size=10,
                   at=True, q=True, samples=samples, **kw)
    jm = j_build_model(jcfg)
    x = jax.random.uniform(jax.random.PRNGKey(2), (2,) + LENET)
    jst = convert(jm, x, KEY)
    cfg = Config(model=model_name, sigma_prior=0.1, p=0.3, output_size=10,
                 at=True, q=True, samples=samples, input_size=LENET, **kw)
    return (cfg, build_model(cfg), from_jax_state(jst),
            torch.from_numpy(np.array(x)), jm, jst)


@pytest.fixture(scope="module")
def lenet():
    return _int_lenet("conv_lenet_bbb", 4)


@pytest.fixture(scope="module")
def resnet():
    """A small BBB ResNet-18 converted by qbn_tpu, carried across."""
    x = jax.random.uniform(jax.random.PRNGKey(1), (2, 32, 32, 3))
    jm = JResNet(widths=WIDTHS, stochastic=True, quant=JQuant(enabled=True))
    jst = convert(jm, x, KEY)
    model = ResNet(widths=WIDTHS, stochastic=True,
                   quant=QuantConfig(enabled=True))
    model.method, model.task = "bbb", "classification"
    cfg = Config(model="conv_resnet_bbb", q=True, at=True, samples=4)
    return (cfg, model, from_jax_state(jst), torch.from_numpy(np.array(x)),
            jm, jst)


def _float_model(name, input_shape, samples=4, **kw):
    cfg = Config(model=name, sigma_prior=0.1, p=0.2, output_size=10,
                 samples=samples, input_size=input_shape, **kw)
    model = build_model(cfg)
    state = init_variables(model, torch.Generator().manual_seed(0),
                           input_shape, "cpu")
    return cfg, model, tree_map(lambda t: t.detach(), state)


def test_export_roundtrip_bitwise_float(tmp_path):
    cfg, model, state = _float_model("conv_lenet_bbb", LENET)
    x = torch.rand((2,) + LENET, generator=torch.Generator().manual_seed(3))
    fn = make_predictor(model, state, cfg, mode="float")
    with torch.no_grad():
        direct = fn(x, torch.tensor(7))
        other = fn(x, torch.tensor(8))
    export_predictor(model, state, cfg, mode="float", batch=2,
                     input_shape=LENET, path=str(tmp_path))
    loaded = load_predictor(str(tmp_path))
    _same(loaded.call(x, 7), direct)
    assert not torch.equal(direct, other)    # the weight draws follow seed
    assert loaded.manifest["task"] == "classification"
    assert loaded.manifest["samples"] == 4
    assert loaded.manifest["weights_mb"] > 0


def test_export_roundtrip_bitwise_int(tmp_path, lenet):
    cfg, model, state, x = lenet[:4]
    fn = make_predictor(model, state, cfg, mode="int", samples=2)
    with torch.no_grad():
        direct = fn(x, torch.tensor(11))
    export_predictor(model, state, cfg, mode="int", batch=2,
                     input_shape=LENET, path=str(tmp_path), samples=2)
    served = load_predictor(str(tmp_path)).call(x, 11)
    _same(served, direct)
    np.testing.assert_allclose(served.sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("model_name", ["linear_bbb", "linear"])
def test_export_regression_mean_var(tmp_path, model_name):
    cfg, model, state = _float_model(model_name, (1,), task="regression",
                                     dataset="regression_synthetic")
    x = torch.rand((8, 1), generator=torch.Generator().manual_seed(5))
    fn = make_predictor(model, state, cfg, mode="float")
    with torch.no_grad():
        d_mean, d_var = fn(x, torch.tensor(1))
    export_predictor(model, state, cfg, mode="float", batch=8,
                     input_shape=(1,), path=str(tmp_path))
    loaded = load_predictor(str(tmp_path))
    s_mean, s_var = loaded.call(x, 1)
    _same((s_mean, s_var), (d_mean, d_var))
    assert s_mean.shape == (8, 1) and bool((s_var > 0).all())
    assert loaded.manifest["output"] == "(mean, total_var)"


def test_export_regression_int(tmp_path):
    """The BBB MLP converted by the port: the INT regression predictor
    (one draw, the merged dense layers) round-trips bitwise, with the
    draw operator in its graph and (mean, total_var) out."""
    cfg = Config(model="linear_bbb", task="regression", q=True, at=True,
                 samples=4, input_size=(1,), dataset="regression_synthetic")
    model = build_model(cfg)
    x = torch.rand((8, 1), generator=torch.Generator().manual_seed(5))
    state = init_variables(model, torch.Generator().manual_seed(0), (1,),
                           "cpu", quantized=True)
    state = tree_map(lambda t: t.detach(),
                     convert_model(model, state, x))
    fn = make_predictor(model, state, cfg, mode="int")
    with torch.no_grad():
        direct = fn(x, torch.tensor(2))
    export_predictor(model, state, cfg, mode="int", batch=8,
                     input_shape=(1,), path=str(tmp_path))
    loaded = load_predictor(str(tmp_path))
    _same(loaded.call(x, 2), direct)
    assert _kernel_ops(loaded) == ["qbn_tpu_torch.draw_int8.default"]
    assert bool((direct[1] > 0).all())


def test_freeze_draws_fixed_sample_bank(tmp_path, lenet):
    """--freeze_draws holds the bank as a buffer: the served outputs are
    mc_predict's on the same eagerly drawn codes, independent of the seed
    (all randomness was in the weights), and round-trip bitwise."""
    cfg, model, state, x = lenet[:4]
    draw = PosteriorDraw(state, 4)
    frozen = draw(key=seed_key(3, DRAW_STREAM))
    with torch.no_grad():
        expected = aggregate(mc_predict(model, state, x, samples=4,
                                        draw=draw, presampled=frozen))
        fn = make_predictor(model, state, cfg, mode="int", use_plan=True,
                            freeze_draws=3)
        got_a, got_b = fn(x, torch.tensor(11)), fn(x, torch.tensor(99))
    _same(got_a, expected)
    _same(got_a, got_b)
    export_predictor(model, state, cfg, mode="int", batch=2,
                     input_shape=LENET, path=str(tmp_path), use_plan=True,
                     freeze_draws=3)
    loaded = load_predictor(str(tmp_path))
    assert loaded.manifest["freeze_draws"] == 3
    _same(loaded.call(x, 11), expected)


def test_frozen_draw_is_its_draw_under_the_key(lenet):
    """A frozen PosteriorDraw's bank is bitwise its draw under the same
    key, whatever a later call passes; it then holds the bank alone, and
    so does a frozen predictor, where a seeded one holds the pack."""
    cfg, model, state = lenet[:3]
    draw = PosteriorDraw(state, 4)
    drawn = draw(key=seed_key(3, DRAW_STREAM))
    draw.freeze(seed_key(3, DRAW_STREAM))
    for got in (draw(), draw(key=seed_key(4, DRAW_STREAM))):
        assert got.keys() == drawn.keys()
        for a, b in zip(jax.tree.leaves(to_numpy_state(got)),
                        jax.tree.leaves(to_numpy_state(drawn))):
            np.testing.assert_array_equal(a, b)
    assert [n for n, _b in draw.named_buffers()] == ["bank"]
    for freeze, want in ((3, {"draw.bank"}),
                         (None, {"draw.w", "draw.std", "draw.qtab",
                                 "draw.meta", "draw.tile_layer"})):
        fn = make_predictor(model, state, cfg, mode="int", use_plan=True,
                            freeze_draws=freeze)
        assert {n for n, _b in fn.named_buffers()
                if n.startswith("draw.")} == want


@pytest.mark.parametrize("freeze", [5, None])
def test_chunked_matches_unchunked(lenet, freeze):
    """Chunked consumption of the bank (frozen, or drawn per call from the
    same seed) equals the unchunked path bitwise."""
    cfg, model, state, x = lenet[:4]
    whole = make_predictor(model, state, cfg, mode="int", use_plan=True,
                           freeze_draws=freeze)
    chunked = make_predictor(model, state, cfg, mode="int", use_plan=True,
                             chunk=2, freeze_draws=freeze)
    with torch.no_grad():
        _same(chunked(x, torch.tensor(1)), whole(x, torch.tensor(1)))


def test_seeded_predictor_is_the_live_path(lenet):
    """Without freeze_draws each call draws from (seed, DRAW_STREAM): the
    predictor is mc_predict + aggregate on that draw, and seeds differ."""
    cfg, model, state, x = lenet[:4]
    fn = make_predictor(model, state, cfg, mode="int")
    draw = PosteriorDraw(state, 4)
    with torch.no_grad():
        for seed in (0, 12):
            drawn = draw(key=seed_key(seed, DRAW_STREAM))
            _same(fn(x, torch.tensor(seed)), aggregate(mc_predict(
                model, state, x, samples=4, draw=draw, presampled=drawn)))
        assert not torch.equal(fn(x, torch.tensor(0)),
                               fn(x, torch.tensor(12)))


def _kernel_ops(loaded):
    return sorted({str(n.target) for n in loaded.exported.graph.nodes
                   if n.op == "call_function"
                   and str(n.target).startswith("qbn_tpu_torch.")})


@pytest.mark.parametrize("freeze", [None, 0])
def test_graph_calls_the_kernel_operators(tmp_path, resnet, freeze):
    """The ResNet's exported graph calls the draw (unless frozen) and the
    merged int8 conv operators, and holds no plain version: no library
    convolution, nothing in float64."""
    cfg, model, state, x = resnet[:4]
    export_predictor(model, state, cfg, mode="int", batch=2,
                     input_shape=(32, 32, 3), path=str(tmp_path),
                     use_plan=True, freeze_draws=freeze)
    loaded = load_predictor(str(tmp_path))
    want = ["qbn_tpu_torch.int_conv_merged.default"]
    if freeze is None:
        want = ["qbn_tpu_torch.draw_int8.default"] + want
    assert _kernel_ops(loaded) == want
    convs = [n for n in loaded.exported.graph.nodes
             if n.op == "call_function" and n.target == torch.ops.qbn_tpu_torch
             .int_conv_merged.default]
    assert len(convs) == 20                 # the ResNet-18's convs
    for n in loaded.exported.graph.nodes:
        assert "convolution" not in str(n.target)
        val = n.meta.get("val")
        if isinstance(val, torch.Tensor):
            assert val.dtype != torch.float64, n


def test_flagship_graph_adds_in_the_conv_epilogue(tmp_path, monkeypatch):
    """The exported flagship (cut to S=2, B=2, seeded draws) makes its 8
    residual adds in the epilogue of 8 of its 20 merged conv nodes, and
    answers for fixed seeds bitwise as the live predictor with the adds as
    passes of their own (ConvBlock then ResidualAdd), which is what an
    export of that graph answers."""
    cfg, model, state = load_trained(FLAGSHIP, device="cpu")
    export_predictor(model, state, cfg, mode="int", batch=2,
                     input_shape=(32, 32, 3), path=str(tmp_path), samples=2,
                     use_plan=True)
    loaded = load_predictor(str(tmp_path))
    op = torch.ops.qbn_tpu_torch.int_conv_merged.default
    names = [a.name for a in op._schema.arguments]
    residual = [{**dict(zip(names, n.args)), **n.kwargs}.get("residual")
                is not None for n in loaded.exported.graph.nodes
                if n.op == "call_function" and n.target == op]
    assert len(residual) == 20 and sum(residual) == 8
    monkeypatch.setattr(BasicBlock, "forward", eager_block_forward)
    eager = make_predictor(model, state, cfg, mode="int", samples=2,
                           use_plan=True)
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        for seed in (0, 2 ** 31 + 5):
            _same(loaded.call(x, seed), eager(x, torch.tensor(seed)))


def test_frozen_bank_against_qbn_tpu_lenet(lenet):
    cfg, model, state, x, jm, jst = lenet
    fn = make_predictor(model, state, cfg, mode="int", use_plan=True,
                        freeze_draws=7)
    bank = to_numpy_state(PosteriorDraw(state, 4)(
        key=seed_key(7, DRAW_STREAM)))
    jouts = JMC.mc_predict(jm, jst, jnp.asarray(x.numpy()),
                           jax.random.PRNGKey(1), samples=4, mode="int",
                           presampled=jax.tree.map(jnp.asarray, bank),
                           merged=True)
    with torch.no_grad():
        touts = mc_predict(model, state, x, samples=4,
                           presampled=from_jax_state(bank))
        got = fn(x, torch.tensor(0))
    np.testing.assert_allclose(touts.numpy(), np.asarray(jouts), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JMC.aggregate("classification", jouts, 4)),
        rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def resnet_bank(resnet):
    cfg, model, state, x, jm, jst = resnet
    fn = make_predictor(model, state, cfg, mode="int", use_plan=True,
                        freeze_draws=7)
    bank = to_numpy_state(PosteriorDraw(state, 4)(
        key=seed_key(7, DRAW_STREAM)))
    with torch.no_grad():
        got = fn(x, torch.tensor(0))
    return bank, got


def test_frozen_bank_against_qbn_tpu_resnet(resnet, resnet_bank):
    cfg, model, state, x, jm, jst = resnet
    bank, got = resnet_bank
    jouts = JMC.mc_predict(jm, jst, jnp.asarray(x.numpy()),
                           jax.random.PRNGKey(1), samples=4, mode="int",
                           presampled=jax.tree.map(jnp.asarray, bank),
                           merged=True)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JMC.aggregate("classification", jouts, 4)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("cut", CUTS)
def test_frozen_bank_codes_at_each_cut(resnet, resnet_bank, cut):
    """The frozen bank through qbn_tpu's forward and the port's: the int8
    codes at every cut bitwise."""
    cfg, model, state, x, jm, jst = resnet
    bank, _got = resnet_bank
    jout, _ = jm.apply({**jst, "sampled": jax.tree.map(jnp.asarray, bank)},
                       jnp.asarray(x.numpy()), train=False, mode="int",
                       update_stats=False, up_to=cut,
                       rngs=split_rngs(jax.random.PRNGKey(1)),
                       mutable=["kl"])
    with torch.no_grad():
        tout = mc_predict(model, state, x, samples=4,
                          presampled=from_jax_state(bank), up_to=cut)
    assert tout.codes.dtype == torch.int8
    np.testing.assert_array_equal(tout.codes.numpy(), np.asarray(jout.codes))


def test_mc_dropout_masks_follow_the_seed(tmp_path):
    """MC-Dropout's masks come from (seed, MASK_STREAM) through SeedMasks:
    the predictor is mc_predict + aggregate with those masks, seeds
    differ, and the artifact round-trips bitwise."""
    cfg, model, state, x = _int_lenet("conv_lenet_mc", 4)[:4]
    fn = make_predictor(model, state, cfg, mode="int")
    with torch.no_grad():
        live = aggregate(mc_predict(
            model, state, x, samples=4,
            masks=SeedMasks(seed_key(5, MASK_STREAM), 4)))
        _same(fn(x, torch.tensor(5)), live)
        assert not torch.equal(live, fn(x, torch.tensor(6)))
    export_predictor(model, state, cfg, mode="int", batch=2,
                     input_shape=LENET, path=str(tmp_path))
    loaded = load_predictor(str(tmp_path))
    _same(loaded.call(x, 5), live)
    assert _kernel_ops(loaded) == ["qbn_tpu_torch.int_conv.default",
                                   "qbn_tpu_torch.seeded_draw.default"]


def test_ensemble_roundtrip(tmp_path):
    """An SGHMC ensemble (stacked members): one forward per member,
    exported and loaded bitwise."""
    cfg, model, _state, x, jm, _j = _int_lenet("conv_lenet", 3)
    members = [from_jax_state(convert(jm, jnp.asarray(x.numpy()),
                                      jax.random.PRNGKey(20 + i)))
               for i in range(3)]
    stacked = TE.stack_variables(members)
    fn = make_predictor(model, stacked, cfg, mode="int", ensemble=True)
    with torch.no_grad():
        live = aggregate(mc_predict(model, stacked, x, samples=3,
                                    ensemble=True))
        _same(fn(x, torch.tensor(0)), live)
    export_predictor(model, stacked, cfg, mode="int", batch=2,
                     input_shape=LENET, path=str(tmp_path), ensemble=True)
    _same(load_predictor(str(tmp_path)).call(x, 0), live)


def test_argument_checks(lenet):
    cfg, model, state, x = lenet[:4]
    with pytest.raises(ValueError, match="chunk 3 must divide"):
        make_predictor(model, state, cfg, mode="int", use_plan=True, chunk=3)
    with pytest.raises(ValueError, match="freeze_draws requires"):
        make_predictor(model, state, cfg, mode="int", freeze_draws=1)
    with pytest.raises(ValueError, match="unknown mode"):
        make_predictor(model, state, cfg, mode="int4")
    mc = _int_lenet("conv_lenet_mc", 2)
    with pytest.raises(ValueError, match="freeze_draws requires"):
        make_predictor(mc[1], mc[2], mc[0], mode="int", use_plan=True,
                       freeze_draws=1)


_STANDALONE = """
import sys, torch
import qbn_tpu_torch.ops
ep = torch.export.load(sys.argv[1] + "/predictor.pt2")
x, seed, want = torch.load(sys.argv[2])
got = ep.module()(x, seed)
assert torch.equal(got, want), "differs"
loaded = sorted(m for m in sys.modules if m.startswith("qbn_tpu_torch"))
assert not any(m.startswith(("qbn_tpu_torch.models",
                             "qbn_tpu_torch.evaluation",
                             "qbn_tpu_torch.serving")) for m in loaded), loaded
print("ok")
"""


def test_cpu_artifact_manifest_and_standalone_load(tmp_path, lenet):
    """A CPU export carries its manifest (qbn_tpu's keys, torch_version for
    jax_version, the export's device for platforms); a fresh process
    with only torch and the operators' registrations answers as the live
    predictor (the artifact binds to the operators, as qbn_tpu's binds to
    its Mosaic custom call)."""
    cfg, model, state, x = lenet[:4]
    art = tmp_path / "art"
    blob = export_predictor(model, state, cfg, mode="int", batch=2,
                            input_shape=LENET, path=str(art), use_plan=True,
                            chunk=2)
    manifest = json.loads((art / "manifest.json").read_text())
    assert manifest["platforms"] == ["cpu"]
    assert manifest["torch_version"] == torch.__version__
    assert set(manifest) == {
        "model", "task", "mode", "samples", "ensemble", "use_plan", "chunk",
        "freeze_draws", "batch", "input_shape", "platforms",
        "torch_version", "weights_mb", "output"}
    assert os.path.getsize(blob) > 1000
    fn = make_predictor(model, state, cfg, mode="int", use_plan=True,
                        chunk=2)
    with torch.no_grad():
        want = fn(x, torch.tensor(4))
    torch.save((x, torch.tensor(4), want), tmp_path / "io.pt")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _STANDALONE, str(art),
                          str(tmp_path / "io.pt")], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


def test_serving_cli_on_the_flagship(tmp_path, capsys):
    """`python -m qbn_tpu_torch.serving --freeze_draws 0 --device cpu` on
    the committed flagship (cut to S=2, B=2): the manifest and the
    artifact's size are printed, and the artifact answers."""
    out = tmp_path / "art"
    serving_cli.main(["--exp", FLAGSHIP, "--out", str(out), "--freeze_draws",
                      "0", "--device", "cpu", "--samples", "2", "--batch",
                      "2"])
    printed = capsys.readouterr().out
    assert '"freeze_draws": 0' in printed and "MB)" in printed
    loaded = load_predictor(str(out))
    assert loaded.manifest["mode"] == "int"
    assert loaded.manifest["use_plan"] is True
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    a, b = loaded.call(x, 0), loaded.call(x, 1)
    assert a.shape == (2, 10) and bool(torch.isfinite(a).all())
    _same(a, b)
    np.testing.assert_allclose(a.sum(-1).numpy(), 1.0, rtol=1e-5)
