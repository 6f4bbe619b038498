"""INT MC evaluation of MC-Dropout, pointwise and SGHMC ensembles: the
port's ResNet-18 (narrow widths 8/16/16/16, 32x32 inputs, B=2) against
qbn_tpu's, on the CPU, through the entry points (`mc_predict`,
`aggregate`, `evaluate`, `load_trained`).

qbn_tpu's INT states are built as tests/test_mc_int_dropout.py builds
them (init, two QAT passes, convert) and carried across with
`from_jax_state`. The dropout masks are fixed on both sides: the test
replaces `jax.random.bernoulli` (which qbn_tpu's BernoulliDropout calls)
with a function that hands out masks from a table made with numpy, one
entry per dropout site and sample, and gives the port the same table
through `QueueMasks`; the sample a mask goes to is found from the key
qbn_tpu's `mc_predict` gives that sample (its `_one_sample`, wrapped for
this, which also captures every module's output). qbn_tpu's own
`mc_predict` runs: its vmap over keys or members and its conv rules.

Tolerances: int8 codes at every module (every conv, dropout site,
residual add and the head) bitwise, with their scales; probabilities
within 1e-6 (a float32 softmax and mean whose summation orders differ).
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qbn_tpu.evaluation.mc as JMC
from qbn_tpu.evaluation.ensemble import stack_variables as j_stack
from qbn_tpu.models.architectures import ResNet as JResNet
from qbn_tpu.models.layers import QuantConfig as JQuant
from qbn_tpu.training.checkpoint import list_snapshots as j_list_snapshots
from qbn_tpu.utils import (apply_model, convert_model, init_variables,
                           split_rngs)

from qbn_tpu_torch.config import QuantConfig
from qbn_tpu_torch.convert import from_jax_state
from qbn_tpu_torch.evaluation import ensemble as TE
from qbn_tpu_torch.evaluation.mc import aggregate, evaluate, mc_predict
from qbn_tpu_torch.models import layers as TL
from qbn_tpu_torch.models.architectures import CUTS, ResNet
from qbn_tpu_torch.models.factory import load_trained
from qbn_tpu_torch.ops.stochastic import QueueMasks
from qbn_tpu_torch.training.checkpoint import save_variables

WIDTHS = (8, 16, 16, 16)
B, S, MEMBERS = 2, 3, 3
P = 0.15


def convert(model, x, key):
    """qbn_tpu's INT state of `model`, numpy leaves."""
    v = init_variables(model, key, x, quantized=True)
    _, _, v = apply_model(model, v, x, key, train=True, mode="qat",
                          update_stats=True)
    _, _, v = apply_model(model, v, x, key, train=False, mode="qat",
                          update_stats=True)
    return jax.tree.map(np.asarray, convert_model(model, v, x, key))


@contextlib.contextmanager
def fixed_masks(monkeypatch, keys, seed):
    """Within: qbn_tpu's dropout masks come from `table` (one (S, *shape)
    boolean array per site, made on first use, in call order) and its
    `_one_sample` also returns every module's output. Yields the table."""
    rng = np.random.default_rng(seed)
    table, state = [], {}
    keys = jnp.asarray(keys)

    def bernoulli(_key, keep, shape):
        i = state["calls"]
        state["calls"] += 1
        if i == len(table):
            table.append(rng.random((len(keys),) + tuple(shape)) < keep)
        return jnp.asarray(table[i])[state["idx"]]

    def one_sample(model, mode, variables, x, key):
        # which sample this is: the key mc_predict split for it
        state["idx"] = jnp.argmax(jnp.all(key[None] == keys, axis=-1))
        state["calls"] = 0
        out, upd = model.apply(variables, x, train=False, mode=mode,
                               update_stats=False, rngs=split_rngs(key),
                               mutable=["kl", "intermediates"],
                               capture_intermediates=True)
        return out, upd["intermediates"]

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    monkeypatch.setattr(JMC, "_one_sample", one_sample)
    yield table


def j_run(model, variables, x, samples, monkeypatch, ensemble=False,
          seed=0):
    """qbn_tpu's mc_predict: (outputs, {module path: QTensor of codes with
    the sample axis in front}, the mask table)."""
    key = jax.random.PRNGKey(seed + 2)
    keys = jax.random.split(key, samples)
    with fixed_masks(monkeypatch, keys, seed) as table:
        out, inter = JMC.mc_predict(model, variables, jnp.asarray(x), key,
                                    samples=samples, mode="int",
                                    ensemble=ensemble)
    layers = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "__call__":
                if hasattr(v[0], "codes"):
                    layers[".".join(path)] = v[0]
            else:
                walk(v, path + (k,))

    walk(inter, ())
    return out, layers, [t.astype(np.float32) for t in table]


def t_run(model, state, x, samples, masks=None, ensemble=False):
    """The port's mc_predict: (outputs, {module name: [outputs of its
    calls]}), recorded by forward hooks."""
    layers = {}
    hooks = [m.register_forward_hook(
        lambda _m, _a, out, name=name: layers.setdefault(name, []).append(
            out)) for name, m in model.named_modules() if name]
    try:
        with torch.no_grad():
            out = mc_predict(model, state, torch.from_numpy(x),
                             samples=samples, ensemble=ensemble,
                             masks=None if masks is None
                             else QueueMasks(masks))
    finally:
        for h in hooks:
            h.remove()
    return out, layers


def assert_layers_equal(jlayers, tlayers, samples, min_layers):
    """Every module output of qbn_tpu ((S, ...) codes) against the port's:
    one output per module ((S, B, ...) per-sample codes, or (B, ...)
    computed once for every sample), or one per ensemble member."""
    assert len(jlayers) >= min_layers
    for name, j in jlayers.items():
        outs = tlayers[name]
        if len(outs) > 1:                       # one call per member
            codes = np.stack([o.codes.numpy() for o in outs])
            scale = np.stack([o.scale.numpy() for o in outs])
        else:
            codes, scale = outs[0].codes.numpy(), outs[0].scale.numpy()
        jc = np.asarray(j.codes)
        assert codes.dtype == np.int8 and jc.shape[0] == samples, name
        np.testing.assert_array_equal(np.broadcast_to(codes, jc.shape), jc,
                                      err_msg=name)
        np.testing.assert_array_equal(
            np.broadcast_to(scale, np.shape(j.scale)), np.asarray(j.scale),
            err_msg=name)


def assert_close(t, j):
    t = t if isinstance(t, tuple) else (t,)
    j = j if isinstance(j, tuple) else (j,)
    for a, b in zip(t, j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.fixture(scope="module")
def resnets():
    x = np.array(jax.random.uniform(jax.random.PRNGKey(1), (B, 32, 32, 3)))
    q = JQuant(enabled=True)
    jm_mc = JResNet(widths=WIDTHS, dropout_p=P, quant=q)
    jm_pw = JResNet(widths=WIDTHS, quant=q)
    mc = convert(jm_mc, jnp.asarray(x), jax.random.PRNGKey(0))
    members = [convert(jm_pw, jnp.asarray(x), jax.random.PRNGKey(10 + i))
               for i in range(MEMBERS)]
    quant = QuantConfig(enabled=True)
    return dict(
        x=x, jm_mc=jm_mc, jm_pw=jm_pw, mc=mc, members=members,
        tm_mc=ResNet(widths=WIDTHS, dropout_p=P, quant=quant),
        tm_pw=ResNet(widths=WIDTHS, quant=quant))


@pytest.fixture(scope="module")
def runs(resnets):
    """Each method through qbn_tpu's mc_predict and the port's, once."""
    r = resnets
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        jo, jl, masks = j_run(r["jm_mc"], r["mc"], r["x"], S, mp)
        to, tl = t_run(r["tm_mc"], from_jax_state(r["mc"]), r["x"], S,
                       masks)
        out["mcdropout"] = (jo, jl, to, tl, S, masks)
        jo, jl, _ = j_run(r["jm_pw"], r["members"][0], r["x"], 1, mp)
        to, tl = t_run(r["tm_pw"], from_jax_state(r["members"][0]), r["x"],
                       1)
        out["pointwise"] = (jo, jl, to, tl, 1, None)
        stacked = j_stack(r["members"])
        jo, jl, _ = j_run(r["jm_pw"], stacked, r["x"], MEMBERS, mp,
                          ensemble=True)
        to, tl = t_run(r["tm_pw"], TE.stack_variables(
            [from_jax_state(m) for m in r["members"]]), r["x"], MEMBERS,
            ensemble=True)
        out["sgld"] = (jo, jl, to, tl, MEMBERS, None)
    finally:
        mp.undo()
    return out


METHODS = ["mcdropout", "pointwise", "sgld"]


@pytest.mark.parametrize("method", METHODS)
def test_codes_bitwise_at_every_module(runs, method):
    jo, jl, to, tl, samples, _m = runs[method]
    # 8 blocks, their convs, adds and (MC-Dropout) dropout sites, the
    # stem, the input quantisation and the head
    assert_layers_equal(jl, tl, samples, 58 if method == "mcdropout" else 38)


@pytest.mark.parametrize("method", METHODS)
def test_probabilities_and_aggregate(runs, method):
    jo, _jl, to, _tl, samples, _m = runs[method]
    assert to.shape == (samples, B, 10)
    assert_close(to, jo)
    agg = aggregate(to)
    assert_close(agg, JMC.aggregate("classification", jo, samples))
    np.testing.assert_allclose(agg.sum(-1).numpy(), 1.0, atol=1e-5)


def test_mc_dropout_samples_differ(runs):
    """Every site drew per-(sample, image, channel) masks, so the samples'
    outputs differ; the stem ran once, before the first site."""
    jo, _jl, to, tl, _s, masks = runs["mcdropout"]
    assert len(masks) == 20 and masks[0].shape == (S, B, 1, 1, WIDTHS[0])
    assert not torch.equal(to[0], to[1])
    assert len(tl["stem"]) == 1 and tl["stem"][0].codes.shape[0] == B
    assert isinstance(tl["stage0_block0"][0], TL.SampleQTensor)


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("method", ["mcdropout", "pointwise"])
def test_codes_at_each_cut(resnets, runs, method, cut):
    """The port's `up_to` cuts equal qbn_tpu's outputs of the same
    modules (the pool cut: qbn_tpu's avg_pool and flatten of stage 3)."""
    from qbn_tpu.models.layers import QTensor, avg_pool, flatten
    r = resnets
    _jo, jl, _to, _tl, samples, masks = runs[method]
    model, state = ((r["tm_mc"], r["mc"]) if method == "mcdropout"
                    else (r["tm_pw"], r["members"][0]))
    t = mc_predict(model, from_jax_state(state), torch.from_numpy(r["x"]),
                   samples=samples, up_to=cut,
                   masks=None if masks is None else QueueMasks(masks))
    name = {"stem": "drop_stem" if method == "mcdropout" else "stem",
            "pool": "stage3_block1"}.get(cut, f"{cut}_block1")
    j = jl[name]
    want = np.asarray(j.codes)
    if cut == "pool":
        want = np.asarray(jax.vmap(lambda c: flatten(avg_pool(
            QTensor(c, j.scale[0], j.zp[0]), 4)).codes)(j.codes))
    np.testing.assert_array_equal(
        np.broadcast_to(t.codes.numpy(), want.shape), want)


def test_ensemble_state_stacks_like_qbn_tpu(resnets):
    """The port's stack of the members' trees equals qbn_tpu's stacked tree
    carried across, leaf for leaf; `member` takes one back."""
    r = resnets
    ours = TE.stack_variables([from_jax_state(m) for m in r["members"]])
    theirs = from_jax_state(jax.tree.map(np.asarray, j_stack(r["members"])))
    flat_o = dict(_leaves(ours))
    flat_t = dict(_leaves(theirs))
    assert flat_o.keys() == flat_t.keys()
    for k in flat_o:
        assert flat_o[k].dtype == flat_t[k].dtype
        assert torch.equal(flat_o[k], flat_t[k]), k
    assert TE.members(ours) == MEMBERS
    one = dict(_leaves(TE.member(ours, 1)))
    for k, v in _leaves(from_jax_state(r["members"][1])):
        assert torch.equal(one[k], v), k


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _exp_dir(tmp_path, model, q_states, **cfg):
    """An experiment directory as qbn_tpu's flows leave it: config.json and
    weights.msgpack, or SGHMC snapshots weights_<epoch>.msgpack."""
    with open(tmp_path / "config.json", "w") as fh:
        json.dump({"model": model, "q": True, "input_size": [32, 32, 3],
                   "output_size": 10, **cfg}, fh)
    if len(q_states) == 1:
        save_variables(q_states[0], str(tmp_path / "weights.msgpack"))
    for epoch, st in zip((8, 10, 12, 14)[-len(q_states):], q_states):
        if len(q_states) > 1:
            save_variables(st, str(tmp_path / f"weights_{epoch}.msgpack"))
    return str(tmp_path)


def test_load_trained_and_evaluate_mc_dropout(resnets, tmp_path):
    """The entry points on a converted MC-Dropout ResNet-18 (full widths
    are chip_smoke.py's; here the narrow state in a ResNet of those
    widths would not load, so the model is rebuilt at them)."""
    r = resnets
    exp = _exp_dir(tmp_path, "conv_resnet_mc", [r["mc"]], p=P, samples=S)
    cfg, model, state = load_trained(exp, device="cpu")
    assert (cfg.method, cfg.p, model.method, model.dropout_p) == (
        "mcdropout", P, "mcdropout", P)
    model = ResNet(widths=WIDTHS, dropout_p=P, quant=QuantConfig(
        enabled=True))
    model.method, model.task = "mcdropout", "classification"
    y = np.array([3, 7])
    g = torch.Generator().manual_seed(4)
    ms, probs, secs = evaluate(model, state, [(r["x"], y)] * 2, samples=S,
                               generator=g, device="cpu")
    assert len(probs) == len(secs) == 2 and float(ms["count"]) == 2 * B
    for p in probs:
        assert p.shape == (B, 10) and torch.isfinite(p).all()
    # the generator advanced: the second batch drew other masks
    assert not torch.equal(probs[0], probs[1])


def test_load_trained_ensemble_takes_the_last_snapshots(resnets, tmp_path):
    r = resnets
    exp = _exp_dir(tmp_path, "conv_resnet_sgld",
                   [r["members"][0]] + r["members"], samples=MEMBERS)
    from qbn_tpu_torch.training.checkpoint import list_snapshots
    assert [os.path.basename(p) for p in list_snapshots(exp)] == [
        os.path.basename(p) for p in j_list_snapshots(exp)] == [
        "weights_8.msgpack", "weights_10.msgpack", "weights_12.msgpack",
        "weights_14.msgpack"]
    cfg, model, state = load_trained(exp, device="cpu")
    assert model.method == "sgld" and TE.members(state) == MEMBERS
    for m in range(MEMBERS):
        want = dict(_leaves(from_jax_state(r["members"][m])))
        for k, v in _leaves(TE.member(state, m)):
            assert torch.equal(v, want[k]), (m, k)
    model = ResNet(widths=WIDTHS, quant=QuantConfig(enabled=True))
    model.method, model.task = "sgld", "classification"
    ms, probs, _s = evaluate(model, state, [(r["x"], np.array([1, 2]))],
                             samples=MEMBERS, device="cpu")
    assert float(ms["count"]) == B
    assert torch.isfinite(probs[0]).all()
