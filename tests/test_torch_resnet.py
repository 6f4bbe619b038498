"""The port's INT8 MC evaluation of the trained BBB ResNet-18 against
qbn_tpu's, on the committed flagship checkpoint at B=2, S=2.

The posterior draw is made once from numpy noise through each package's
plain draw (qbn_tpu's XLA oracle, the port's plain version) and fed to
both forwards through `presampled`. Tolerances: the int8 codes at every
`up_to` cut are integers and must be bitwise equal; the probabilities
and metric state come from a float32 softmax, mean and log whose
summation orders differ, so they agree within 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from qbn_tpu.config import Config as JConfig
from qbn_tpu.evaluation.mc import aggregate as j_aggregate
from qbn_tpu.evaluation.mc import mc_predict as j_mc_predict
from qbn_tpu.evaluation.mc import presample_plan as j_presample_plan
from qbn_tpu.models.factory import build_model as j_build_model
from qbn_tpu.ops.pallas.sample_weights import sample_weights_oracle
from qbn_tpu.training import metrics as JM
from qbn_tpu.training.checkpoint import checkpoint_path
from qbn_tpu.utils import split_rngs

from qbn_tpu_torch.evaluation import mc as TMC
from qbn_tpu_torch.evaluation.mc import (
    PosteriorDraw, aggregate, evaluate, mc_predict, presample_plan)
from qbn_tpu_torch.models.architectures import CUTS
from qbn_tpu_torch.models.factory import load_trained
from qbn_tpu_torch.ops.sample_weights import (
    QPARAM_KEYS, draw_layers, key_from_generator, pack_layers)
from qbn_tpu_torch.training import metrics as TM

EXP = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "examples", "campaign", "bbb-cifar-a_7_w_8-seed1")
B, S = 2, 2


@pytest.fixture(scope="module")
def flagship():
    import json
    with open(os.path.join(EXP, "config.json")) as fh:
        raw = json.load(fh)
    raw["input_size"] = tuple(raw["input_size"])
    jcfg = JConfig(**{k: v for k, v in raw.items()
                      if k in JConfig.__dataclass_fields__})
    jmodel = j_build_model(jcfg)
    # the restored tree holds every collection an int-mode apply reads
    with open(checkpoint_path(EXP), "rb") as fh:
        jvars = jax.tree.map(jnp.asarray,
                             serialization.msgpack_restore(fh.read()))
    cfg, model, state = load_trained(EXP, device="cpu")

    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 1.0, (B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, (B,))
    plan = presample_plan(state)
    jplan = j_presample_plan(jvars)
    assert sorted((tuple(p), lo, hi) for p, lo, hi in jplan) == sorted(plan)
    noise, jsampled = {}, {}
    for path, lo, hi in jplan:
        node = jvars["qconst"]
        for k in path:
            node = node[k]
        shape = node["w_codes"].shape
        m = int(np.prod(shape[:-1]))
        eps = rng.standard_normal((S, m, shape[-1])).astype(np.float32)
        qp = {k: node[k] for k in ("w_scale", "w_zp", "std_scale", "std_zp",
                                   "mul_scale", "mul_zp", "add_scale",
                                   "add_zp")}
        codes = sample_weights_oracle(node["w_codes"].reshape(m, -1),
                                      node["std_codes"].reshape(m, -1), qp,
                                      jnp.asarray(eps), lo, hi)
        cursor = jsampled
        for k in path[:-1]:
            cursor = cursor.setdefault(k, {})
        cursor["w"] = codes.reshape((S,) + shape)
        noise[tuple(path)] = torch.from_numpy(eps.reshape((S,) + shape))
    noise = [noise[p] for p, _lo, _hi in plan]
    sampled = PosteriorDraw(state, S)(noise=noise)
    return dict(jmodel=jmodel, jvars=jvars, jsampled=jsampled, model=model,
                state=state, sampled=sampled, x=x, y=y, noise=noise,
                cfg=cfg, jcfg=jcfg)


def test_config_fields_match_qbn_tpu(flagship):
    cfg, jcfg = flagship["cfg"], flagship["jcfg"]
    for field in ("model", "input_size", "output_size", "q",
                  "activation_precision", "weight_precision", "samples",
                  "batch_size"):
        assert getattr(cfg, field) == getattr(jcfg, field), field


def test_plan_and_draw_bitwise(flagship):
    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, tree
    j = dict(leaves(flagship["jsampled"]))
    t = dict(leaves(flagship["sampled"]))
    assert j.keys() == t.keys() and len(t) == 21
    for k in t:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


@pytest.mark.parametrize("cut", CUTS)
def test_codes_bitwise_at_cut(flagship, cut):
    f = flagship
    jout, _ = f["jmodel"].apply(
        {**f["jvars"], "sampled": f["jsampled"]}, jnp.asarray(f["x"]),
        train=False, mode="int", update_stats=False, up_to=cut,
        rngs=split_rngs(jax.random.PRNGKey(1)), mutable=["kl"])
    tout = mc_predict(f["model"], f["state"], torch.from_numpy(f["x"]),
                      samples=S, presampled=f["sampled"], up_to=cut)
    assert tout.s == jout.s == S
    assert tout.codes.dtype == torch.int8
    np.testing.assert_array_equal(tout.codes.numpy(), np.asarray(jout.codes))
    assert float(tout.scale) == float(jout.scale)


def test_probabilities_and_metrics(flagship):
    f = flagship
    jouts = j_mc_predict(f["jmodel"], f["jvars"], jnp.asarray(f["x"]),
                         jax.random.PRNGKey(1), samples=S, mode="int",
                         presampled=f["jsampled"], merged=True)
    jagg = j_aggregate("classification", jouts, S)
    jstate = JM.cls_metrics_update(JM.cls_metrics_init(), jagg,
                                   jnp.asarray(f["y"]))
    touts = mc_predict(f["model"], f["state"], torch.from_numpy(f["x"]),
                       samples=S, presampled=f["sampled"])
    assert touts.shape == (S, B, 10)
    np.testing.assert_allclose(touts.numpy(), np.asarray(jouts), rtol=0,
                               atol=1e-6)
    tagg = touts.mean(0)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), rtol=0,
                               atol=1e-6)
    tstate = TM.cls_metrics_update(TM.cls_metrics_init(), tagg,
                                   torch.from_numpy(f["y"]))
    for k in jstate:
        np.testing.assert_allclose(tstate[k].numpy(), np.asarray(jstate[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_evaluate_entry_point_on_cpu(flagship):
    """The entry point draws its own weights from the generator: finite
    probabilities that sum to one, and a metric state counting B."""
    f = flagship
    g = torch.Generator().manual_seed(5)
    state, probs, seconds = evaluate(f["model"], f["state"],
                                     [(f["x"], f["y"])] * 2, samples=S,
                                     generator=g, device="cpu")
    assert len(probs) == len(seconds) == 2
    for p in probs:
        assert p.shape == (B, 10) and torch.isfinite(p).all()
        np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, atol=1e-5)
    assert float(state["count"]) == 2 * B
    assert float(state["ece_count"].sum()) == 2 * B


def _three_batches(f):
    rng = np.random.default_rng(12)
    return [(rng.uniform(0.0, 1.0, f["x"].shape).astype(np.float32), f["y"])
            for _ in range(3)]


def test_evaluate_packs_the_draw_once(flagship, monkeypatch):
    """`evaluate` packs the state's 21 stochastic layers once a call (its
    PosteriorDraw), not once a batch."""
    calls = []

    def counted(layers, samples):
        calls.append(len(layers))
        return pack_layers(layers, samples)
    monkeypatch.setattr(TMC, "pack_layers", counted)
    f = flagship
    _ms, probs, _sec = evaluate(f["model"], f["state"], _three_batches(f),
                                samples=S, generator=torch.Generator()
                                .manual_seed(5), device="cpu")
    assert len(probs) == 3 and calls == [21]


def test_evaluate_draws_as_a_pack_per_batch(flagship):
    """Packed once, `evaluate` draws bitwise what a pack built anew each
    batch draws, each batch's key taken from the generator at the same
    point: the same outputs and the generator's same final state."""
    f = flagship
    g = torch.Generator().manual_seed(5)
    g_ref = torch.Generator().manual_seed(5)
    ms, probs, _sec = evaluate(f["model"], f["state"], _three_batches(f),
                               samples=S, generator=g, device="cpu")
    state = f["state"]
    layers = []
    for path, lo, hi in presample_plan(state):
        node = state["qconst"]
        for k in path:
            node = node[k]
        layers.append((node["w_codes"], node["std_codes"],
                       {k: node[k] for k in QPARAM_KEYS}, lo, hi))
    with torch.no_grad():
        for (x, _y), got in zip(_three_batches(f), probs):
            codes = draw_layers(pack_layers(layers, S),
                                key=key_from_generator(g_ref))
            sampled = {}
            for (path, _lo, _hi), c in zip(presample_plan(state), codes):
                cursor = sampled
                for k in path[:-1]:
                    cursor = cursor.setdefault(k, {})
                cursor["w"] = c
            want = aggregate(mc_predict(f["model"], state,
                                        torch.from_numpy(x), samples=S,
                                        presampled=sampled))
            assert torch.equal(got, want)
    assert torch.equal(g.get_state(), g_ref.get_state())
    assert float(ms["count"]) == 3 * B
