"""Convert (the int constants 'qconst' from a QAT state): the port
against qbn_tpu, on the CPU.

States: qbn_tpu's quantised init of the narrow ResNet-18 (widths
8/16/16/16, 32x32 inputs) and of the LeNet, after a QAT training pass and
a QAT validation pass (as tests/test_torch_int_methods.py makes them),
carried across as numpy; and the committed flagship
(examples/campaign/bbb-cifar-a_7_w_8-seed1: params, batch_stats, quant).

Tolerances:
- qconst: w_codes, every scale and zero point, bias_f and the flags
  bitwise. std_codes go through softplusinv(softplus(std) * c) and
  softplus again, whose float32 transcendentals XLA:CPU and torch compute
  differently in the last ulp: at most 1 code apart, on at most 1e-4 of
  the state's std_codes elements (the counts are printed, per leaf and
  in all).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.config import Config as JConfig
from qbn_tpu.models.architectures import LeNet as JLeNet
from qbn_tpu.models.architectures import ResNet as JResNet
from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.models.layers import QuantConfig as JQuant
from qbn_tpu.training.checkpoint import load_variables as j_load
from qbn_tpu.utils import apply_model, convert_model, init_variables

from qbn_tpu_torch.config import Config, QuantConfig
from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.models.architectures import LeNet, ResNet
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.training.checkpoint import read_checkpoint
from qbn_tpu_torch.utils import convert_model as t_convert

WIDTHS = (8, 16, 16, 16)
B, P = 2, 0.15
FLAGSHIP = "examples/campaign/bbb-cifar-a_7_w_8-seed1"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def qat_state(jm, x, seed):
    """qbn_tpu's QAT state of `jm`: quantised init, a QAT training pass
    and a QAT validation pass (which sets the observers that only eval
    forwards reach), numpy leaves."""
    key = jax.random.PRNGKey(seed)
    v = init_variables(jm, key, x, quantized=True)
    _, _, v = apply_model(jm, v, x, key, train=True, mode="qat",
                          update_stats=True)
    _, _, v = apply_model(jm, v, x, key, train=False, mode="qat",
                          update_stats=True)
    return jax.tree.map(np.asarray, v)


def j_qconst(jm, state, x):
    out = convert_model(jm, jax.tree.map(jnp.asarray, state),
                        jnp.asarray(x), jax.random.PRNGKey(9))
    return jax.tree.map(np.asarray, out)


def assert_qconst_match(t, j):
    """The port's qconst (tensor leaves) against qbn_tpu's (numpy)."""
    jl = dict(_leaves(j))
    tl = dict(_leaves(to_numpy_state(t)))
    assert jl.keys() == tl.keys()
    off_total = n_total = 0
    for p in jl:
        a, b = tl[p], jl[p]
        assert a.dtype == b.dtype and a.shape == b.shape, p
        if p[-1] == "std_codes":
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            off = int((d > 0).sum())
            off_total += off
            n_total += d.size
            if off:
                print(f"std_codes {'/'.join(p[:-2])}: {off} of {d.size} "
                      "one code apart")
            assert d.max() <= 1, p
        else:
            np.testing.assert_array_equal(a, b, err_msg=str(p))
    print(f"std_codes: {off_total} of {n_total} elements differ")
    assert off_total <= 1e-4 * n_total
    return off_total


def _resnet(method, quant=True):
    kw = dict(widths=WIDTHS, stochastic=method == "bbb",
              dropout_p=P if method == "mcdropout" else 0.0,
              sigma_prior=0.05)
    tm = ResNet(quant=QuantConfig(enabled=quant, tpu_fused=True), **kw)
    tm.method, tm.task = method, "classification"
    return JResNet(quant=JQuant(enabled=quant, tpu_fused=True), **kw), tm


def _lenet(method):
    kw = dict(stochastic=method == "bbb", sigma_prior=0.1,
              dropout_p=P if method == "mcdropout" else 0.0)
    tm = LeNet(quant=QuantConfig(enabled=True, tpu_fused=True), **kw)
    tm.method, tm.task = method, "classification"
    return JLeNet(quant=JQuant(enabled=True, tpu_fused=True), **kw), tm


def _x(shape, seed=1):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("arch,method", [
    ("resnet", "pointwise"), ("resnet", "mcdropout"), ("resnet", "bbb"),
    ("lenet", "pointwise"), ("lenet", "bbb"), ("lenet", "mcdropout")])
def test_convert_matches(arch, method):
    jm, tm = _resnet(method) if arch == "resnet" else _lenet(method)
    x = _x((B, 32, 32, 3) if arch == "resnet" else (B, 28, 28, 1))
    state = qat_state(jm, jnp.asarray(x), 3)
    want = j_qconst(jm, state, x)["qconst"]
    got = t_convert(tm, from_jax_state(state), torch.from_numpy(x))
    assert_qconst_match(got["qconst"], want)


def test_convert_flagship():
    """The committed flagship's params, batch_stats and quant, merged into
    each package's quantised init, then converted on the CPU."""
    with open(FLAGSHIP + "/config.json") as fh:
        raw = json.load(fh)
    jcfg = JConfig(**{k: v for k, v in raw.items()
                      if k in JConfig.__dataclass_fields__})
    jm = j_build(jcfg)
    x = jnp.zeros((1, 32, 32, 3))
    jv = j_load(init_variables(jm, jax.random.PRNGKey(0), x, quantized=True),
                FLAGSHIP + "/weights.msgpack")
    want = j_qconst(jm, jax.tree.map(np.asarray, jv), x)["qconst"]
    model = build_model(Config.from_json(FLAGSHIP + "/config.json"))
    state = from_jax_state(read_checkpoint(FLAGSHIP + "/weights.msgpack"))
    state.pop("qconst")
    from qbn_tpu_torch.utils import init_variables as t_init
    fresh = t_init(model, torch.Generator().manual_seed(0), (32, 32, 3),
                   "cpu", quantized=True)
    state["qconst"] = fresh["qconst"]
    got = t_convert(model, state, torch.zeros((1, 32, 32, 3)))
    assert_qconst_match(got["qconst"], want)
