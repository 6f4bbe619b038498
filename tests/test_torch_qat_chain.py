"""The chain QAT step -> convert -> INT Monte-Carlo evaluation, and the
INT evaluation of the Bayes-by-backprop LeNet and MLP (the merged layout
over drawn weights): the port against qbn_tpu, on the CPU.

States as in tests/test_torch_convert.py (whose helpers this file uses):
qbn_tpu's QAT state of the narrow ResNet-18 (widths 8/16/16/16, 32x32
inputs), of the LeNet and of the MLP, carried across as numpy.

Tolerances: qconst as in tests/test_torch_convert.py; INT evaluation:
codes at every module bitwise (with their scales), the probabilities and
the regression mean and variance within 1e-6. The Bayes-by-backprop
weights are drawn once, through qbn_tpu's plain draw from numpy noise,
and given to both forwards as `presampled`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbn_tpu.evaluation.mc as JMC
from qbn_tpu.config import Config as JConfig
from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.ops.pallas.sample_weights import sample_weights_oracle
from qbn_tpu.utils import split_rngs

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state, to_numpy_state
from qbn_tpu_torch.evaluation.mc import mc_predict, presample_plan
from qbn_tpu_torch.models.architectures import BasicBlock
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training import metrics as TM
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import convert_model as t_convert

from test_torch_convert import (
    B, _lenet, _resnet, _x, assert_qconst_match, j_qconst, qat_state)
from test_torch_int_methods import assert_layers_equal, j_run, t_run
from test_torch_residual_route import eager_block_forward

S = 3
QPARAM_KEYS = ("w_scale", "w_zp", "std_scale", "std_zp", "mul_scale",
               "mul_zp", "add_scale", "add_zp")


def j_presample(jvars, samples, seed):
    """Posterior draws of every stochastic layer through qbn_tpu's plain
    draw from numpy noise: (qbn_tpu's 'sampled' tree, the port's)."""
    rng = np.random.default_rng(seed)
    jsampled, tsampled = {}, {}
    for path, lo, hi in JMC.presample_plan(jvars):
        node = jvars["qconst"]
        for k in path:
            node = node[k]
        shape = node["w_codes"].shape
        m = int(np.prod(shape[:-1]))
        eps = rng.standard_normal((samples, m, shape[-1])).astype(np.float32)
        codes = sample_weights_oracle(
            jnp.asarray(node["w_codes"]).reshape(m, -1),
            jnp.asarray(node["std_codes"]).reshape(m, -1),
            {k: jnp.asarray(node[k]) for k in QPARAM_KEYS},
            jnp.asarray(eps), lo, hi).reshape((samples,) + shape)
        for tree, v in ((jsampled, codes),
                        (tsampled, torch.from_numpy(np.array(codes)))):
            cursor = tree
            for k in path[:-1]:
                cursor = cursor.setdefault(k, {})
            cursor["w"] = v
    return jsampled, tsampled


def merged_run(jm, tm, jvars, tstate, x, samples, seed=0):
    """Both packages' INT forward over the same drawn weights:
    (qbn_tpu's mc_predict, the port's, {module: qbn_tpu's output},
    {module: the port's output})."""
    jsampled, tsampled = j_presample(jvars, samples, seed)
    jv = jax.tree.map(jnp.asarray, jvars)
    jout = JMC.mc_predict(jm, jv, jnp.asarray(x), jax.random.PRNGKey(1),
                          samples=samples, mode="int", presampled=jsampled,
                          merged=True)
    _o, upd = jm.apply({**jv, "sampled": jsampled}, jnp.asarray(x),
                       train=False, mode="int", update_stats=False,
                       rngs=split_rngs(jax.random.PRNGKey(1)),
                       mutable=["kl", "intermediates"],
                       capture_intermediates=True)
    jl = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                if hasattr(v[0], "codes"):
                    jl[".".join(path)] = v[0]
            else:
                walk(v, path + (k,))

    walk(upd["intermediates"], ())
    tl = {}
    hooks = [m.register_forward_hook(
        lambda _m, _a, out, name=n: tl.setdefault(name, out))
        for n, m in tm.named_modules() if n]
    try:
        with torch.no_grad():
            tout = mc_predict(tm, tstate, torch.from_numpy(x),
                              samples=samples, presampled=tsampled)
    finally:
        for h in hooks:
            h.remove()
    return jout, tout, jl, tl


def assert_merged_layers_equal(jl, tl, min_layers):
    assert len(jl) >= min_layers
    for name, j in jl.items():
        t = tl[name]
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes),
                                      err_msg=name)
        assert float(t.scale) == float(j.scale), name


def _close(t, j):
    for a, b in zip(t if isinstance(t, tuple) else (t,),
                    j if isinstance(j, tuple) else (j,)):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("method", ["pointwise", "mcdropout", "bbb"])
def test_qat_step_convert_int_chain(method, monkeypatch):
    """One QAT step of the port's trainer from qbn_tpu's QAT state, the
    port's convert of the stepped state against qbn_tpu's, then INT
    Monte-Carlo evaluation of each package's converted state in each
    package: codes bitwise at every module."""
    jm, tm = _resnet(method)
    x = _x((B, 32, 32, 3))
    state = qat_state(jm, jnp.asarray(x), 4)
    cfg = preset(method, "cifar", "qat", tpu_fused=True)
    tx, _ = build_optimizer(cfg, 1)
    gen = torch.Generator().manual_seed(5)
    trainer = Trainer(tm, cfg, tx, "qat", 1, B, GeneratorNoise(gen), "cpu",
                      masks=BernoulliMasks(gen, 1))
    t0 = trainer.init_state(from_jax_state(state))
    y = torch.from_numpy(np.random.default_rng(2).integers(0, 10, B))
    t1, _m, logs = trainer.train_step(t0, TM.cls_metrics_init(),
                                      torch.from_numpy(x), y, trainer.noise,
                                      trainer.masks)
    assert np.isfinite(float(logs["obj"]))
    stepped = to_numpy_state(trainer.variables(t1))
    assert not np.array_equal(stepped["params"]["stem"]["kernel"],
                              state["params"]["stem"]["kernel"])
    jconv = j_qconst(jm, stepped, x)
    tconv = t_convert(tm, from_jax_state(stepped), torch.from_numpy(x))
    assert_qconst_match(tconv["qconst"], jconv["qconst"])
    tstate = {k: v for k, v in tconv.items() if k != "params"}
    tstate["params"] = tconv["params"]
    xe = _x((B, 32, 32, 3), seed=7)
    if method == "bbb":
        # the port runs each block's add in conv_bn's epilogue: module by
        # module, the blocks composed from ConvBlock then ResidualAdd (the
        # arithmetic that route is held bitwise to) against qbn_tpu's
        # modules; then the route itself, its conv_bn outputs against
        # qbn_tpu's adds and its probabilities bitwise the composition's
        with monkeypatch.context() as mp:
            mp.setattr(BasicBlock, "forward", eager_block_forward)
            jout, eager, jl, tl = merged_run(jm, tm, jconv, tstate, xe, S)
        assert_merged_layers_equal(jl, tl, 30)
        _jo, tout, _jl, route = merged_run(jm, tm, jconv, tstate, xe, S)
        adds = {n: jl[n] for n in jl if n.endswith(".add")}
        assert_merged_layers_equal(adds, {
            n: route[n[:-len("add")] + "conv_bn"] for n in adds}, 8)
        assert torch.equal(tout, eager)
    else:
        samples = S if method == "mcdropout" else 1
        jout, jl, masks = j_run(jm, jconv, xe, samples, monkeypatch)
        tout, tl = t_run(tm, tstate, xe, samples,
                         masks if method == "mcdropout" else None)
        assert_layers_equal(jl, tl, samples,
                            58 if method == "mcdropout" else 38)
    _close(tout, jout)


def test_bbb_lenet_int():
    """M7: the converted Bayes-by-backprop LeNet in INT mode, every
    module's codes bitwise, the probabilities within 1e-6."""
    jm, tm = _lenet("bbb")
    x = _x((B, 28, 28, 1), seed=3)
    jconv = j_qconst(jm, qat_state(jm, jnp.asarray(x), 5), x)
    tstate = from_jax_state(jconv)
    assert len(presample_plan(tstate)) == 4
    jout, tout, jl, tl = merged_run(jm, tm, jconv, tstate, x, S)
    assert tout.shape == (S, B, 10)
    assert_merged_layers_equal(jl, tl, 5)
    _close(tout, jout)


def test_bbb_mlp_int():
    """M7: the converted Bayes-by-backprop regression MLP in INT mode
    (built by both factories from the same config), every module's codes
    bitwise, the mean and variance within 1e-6."""
    f = 5
    kw = dict(model="linear_bbb", at=True, q=True, task="regression",
              input_size=(f,))
    jm = j_build(JConfig(**kw))
    tm = build_model(Config(**kw))
    x = np.random.default_rng(4).normal(0, 1, (16, f)).astype(np.float32)
    jconv = j_qconst(jm, qat_state(jm, jnp.asarray(x), 6), x)
    tstate = from_jax_state(jconv)
    assert len(presample_plan(tstate)) == 5
    jout, tout, jl, tl = merged_run(jm, tm, jconv, tstate, x, S)
    assert tout[0].shape == tout[1].shape == (S, 16, 1)
    assert_merged_layers_equal(jl, tl, 6)
    _close(tout, jout)
