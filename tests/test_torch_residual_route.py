"""The residual adds of the BBB ResNet-18 in the int8 conv's epilogue.

In int mode on merged-layout input (per-sample weights) with no dropout
site, each BasicBlock hands its add and the ReLU to conv_bn's
`int_conv_merged` call as a residual (`ResidualAdd.epilogue`); every other
block keeps the eager `ResidualAdd`.

- The committed flagship at B=2, S=2 (explicit noise through the plain
  draw): 8 of the forward's 20 convs carry a residual, no add runs eagerly,
  and the codes at every `up_to` cut and the probabilities are bitwise
  those of the blocks composed from ConvBlock then ResidualAdd
  (`eager_block_forward`). The qbn_tpu parity of the same codes is
  tests/test_torch_resnet.py's.
- A small BBB ResNet converted by the port at A7 and A4: the same, on
  the seeded draw.
- The MC-Dropout, pointwise and SGHMC ResNets (the port's init, QAT pass
  and convert at widths 8/16/16/16) make all 8 adds eagerly, and no conv
  carries a residual.
- A float or QAT conv given a residual raises.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.evaluation import ensemble as TE
from qbn_tpu_torch.evaluation.mc import PosteriorDraw, mc_predict
from qbn_tpu_torch.models import layers as TL
from qbn_tpu_torch.models.architectures import CUTS, BasicBlock, ResNet
from qbn_tpu_torch.models.factory import load_trained
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.utils import apply_model, convert_model, init_variables

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "campaign", "bbb-cifar-a_7_w_8-seed1")
B, S = 2, 2
WIDTHS = (8, 16, 16, 16)
BLOCKS = 8                      # the ResNet-18's residual adds


def eager_block_forward(self, x, variables, masks=None, *, mode="int",
                        **_kw):
    """A BasicBlock with no dropout site in int mode, composed from
    ConvBlock then ResidualAdd: the add as a pass of its own."""
    assert mode == "int" and self.dropout_p == 0

    def conv(name, inp):
        return getattr(self, name)(inp, TL.scope(variables, name), mode=mode)

    out = conv("conv_bn", conv("conv_bn_relu", x))
    shortcut = x if self.shortcut is None else conv("shortcut", x)
    return self.add(out, shortcut, TL.scope(variables, "add"))


class Calls:
    """From its making to the test's end: the model's `int_conv_merged`
    calls (whether each carried a residual), its `int_conv` calls and its
    eager adds."""

    def __init__(self, monkeypatch):
        self.merged, self.shared, self.adds = [], 0, 0
        real_merged, real_shared = TL.int_conv_merged, TL.int_conv
        real_add = TL.ResidualAdd._int_forward

        def merged(*args, **kwargs):
            out = real_merged(*args, **kwargs)
            res = kwargs.get("residual")
            if res is not None:
                assert res.shape == out.shape and res.dtype == torch.int8
            self.merged.append(res is not None)
            return out

        def shared(*args, **kwargs):
            self.shared += 1
            return real_shared(*args, **kwargs)

        def add(module, *args):
            self.adds += 1
            return real_add(module, *args)

        monkeypatch.setattr(TL, "int_conv_merged", merged)
        monkeypatch.setattr(TL, "int_conv", shared)
        monkeypatch.setattr(TL.ResidualAdd, "_int_forward", add)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        return
    assert type(a) is type(b) and a.codes.dtype == torch.int8
    np.testing.assert_array_equal(a.codes.numpy(), b.codes.numpy())
    assert float(a.scale) == float(b.scale) and int(a.zp) == int(b.zp)


@pytest.fixture(scope="module")
def flagship():
    _cfg, model, state = load_trained(EXP, device="cpu")
    draw = PosteriorDraw(state, S)
    g = torch.Generator().manual_seed(3)
    noise = [torch.randn((S,) + shape, generator=g) for shape in draw.shapes]
    sampled = draw(noise=noise)
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 1.0, (B, 32, 32, 3)).astype(np.float32))
    return model, state, sampled, x


def test_flagship_adds_run_in_the_conv_epilogue(flagship, monkeypatch):
    model, state, sampled, x = flagship
    calls = Calls(monkeypatch)
    with torch.no_grad():
        out = mc_predict(model, state, x, samples=S, presampled=sampled)
    assert out.shape == (S, B, 10)
    assert len(calls.merged) == 20 and sum(calls.merged) == BLOCKS
    assert calls.adds == 0 and calls.shared == 0


@pytest.mark.parametrize("cut", CUTS + (None,))
def test_flagship_bitwise_against_conv_then_add(flagship, monkeypatch, cut):
    model, state, sampled, x = flagship
    with torch.no_grad():
        got = mc_predict(model, state, x, samples=S, presampled=sampled,
                         up_to=cut)
        monkeypatch.setattr(BasicBlock, "forward", eager_block_forward)
        want = mc_predict(model, state, x, samples=S, presampled=sampled,
                          up_to=cut)
    _same(got, want)


def port_int_state(model, seed, x):
    """The port's INT state of `model` on x's device: init, an evaluation
    pass in QAT mode that fits the observers to the activations the INT
    forward will see (the running statistics stay at init), convert."""
    g = torch.Generator().manual_seed(seed)
    v = tree_map(torch.Tensor.detach, init_variables(
        model, g, (32, 32, 3), x.device, quantized=True))
    if model.stochastic:
        # Bayes-by-backprop's init, U(-0.01, 0.01), fades the signal to
        # zero codes by stage 3: widen it to the pointwise init's range
        v["params"] = _widened(v["params"], 10.0)
    with torch.no_grad():
        _out, _kl, v = apply_model(model, v, x, train=False, mode="qat",
                                   update_stats=True,
                                   noise=GeneratorNoise(g),
                                   masks=BernoulliMasks(g, 1))
    return convert_model(model, v, x)


def _widened(tree, factor):
    return {k: _widened(t, factor) if isinstance(t, dict)
            else t * factor if k == "kernel" else t
            for k, t in tree.items()}


@pytest.mark.parametrize("a_bits", [7, 4])
def test_small_bbb_resnet_bitwise_against_conv_then_add(monkeypatch, a_bits):
    quant = QuantConfig(enabled=True, a_bits=a_bits)
    model = ResNet(widths=WIDTHS, stochastic=True, quant=quant)
    x = torch.rand((B, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    state = port_int_state(model, 5, x)
    with torch.no_grad():
        calls = Calls(monkeypatch)
        got = mc_predict(model, state, x, samples=3,
                         generator=torch.Generator().manual_seed(9))
        assert sum(calls.merged) == BLOCKS and calls.adds == 0
        monkeypatch.setattr(BasicBlock, "forward", eager_block_forward)
        want = mc_predict(model, state, x, samples=3,
                          generator=torch.Generator().manual_seed(9))
    assert calls.adds == BLOCKS
    _same(got, want)


@pytest.mark.parametrize("method", ["mcdropout", "pointwise", "sgld"])
def test_other_methods_keep_the_eager_add(monkeypatch, method):
    quant = QuantConfig(enabled=True)
    model = ResNet(widths=WIDTHS, dropout_p=0.15 if method == "mcdropout"
                   else 0.0, quant=quant)
    x = torch.rand((B, 32, 32, 3), generator=torch.Generator().manual_seed(1))
    members = 2 if method == "sgld" else 1
    states = [port_int_state(model, 7 + m, x) for m in range(members)]
    state = TE.stack_variables(states) if method == "sgld" else states[0]
    calls = Calls(monkeypatch)
    with torch.no_grad():
        out = mc_predict(model, state, x, samples=members if method == "sgld"
                         else 3, ensemble=method == "sgld",
                         generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(out).all()
    assert calls.adds == BLOCKS * members
    assert not any(calls.merged)
    assert calls.shared == 20 * members


@pytest.mark.parametrize("mode", ["float", "qat"])
def test_a_residual_outside_int_mode_raises(mode):
    """The residual epilogue is the int conv's: a float or QAT conv given
    one raises rather than leave the add out."""
    model = ResNet(widths=WIDTHS, quant=QuantConfig(enabled=True))
    conv = next(m for m in model.modules() if isinstance(m, TL.ConvBlock))
    x = torch.zeros((1, 32, 32, 3))
    with pytest.raises(ValueError, match="int mode only"):
        conv(x, {}, mode=mode, residual=dict(residual=torch.zeros(1)))
