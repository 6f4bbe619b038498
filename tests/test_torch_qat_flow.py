"""The port's QAT flow (`flows.qat`, qbn_tpu's `_qat_one`) on the CPU,
from the committed float checkpoint of the MC-Dropout ResNet-18
(examples/campaign/mcdropout-cifar-seed1) at full width, B=2.

- The start of the fine-tune: the float checkpoint merged into the
  quantised init is qbn_tpu's `load_variables` of its own quantised init
  leaf for leaf (params and running statistics from the file, every
  observer fresh, the qconst placeholders), bitwise.
- The flow end to end: one QAT step, convert, the directory it saves
  read back by `load_trained` (the same state), and `evaluate` on it.
- Its device default.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.models.factory import build_model as j_build
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training.checkpoint import load_variables as j_load
from qbn_tpu.utils import init_variables as j_init

from qbn_tpu_torch.convert import to_numpy_state
from qbn_tpu_torch.evaluation.mc import evaluate
from qbn_tpu_torch.flows import fit, qat
from qbn_tpu_torch.models.factory import load_trained
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training import metrics as TM
from qbn_tpu_torch.training.checkpoint import checkpoint_path, read_checkpoint

FLOAT = "examples/campaign/mcdropout-cifar-seed1"
B = 2


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _batches(seed, n):
    rng = np.random.default_rng(seed)
    return [(rng.random((B, 32, 32, 3), dtype=np.float32),
             rng.integers(0, 10, B)) for _ in range(n)]


def test_float_checkpoint_merges_into_the_quantised_init():
    jcfg = j_preset("mcdropout", "cifar", "qat")
    jm = j_build(jcfg)
    jv = j_load(j_init(jm, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                       quantized=True), checkpoint_path(FLOAT))
    want = dict(_leaves(jax.tree.map(np.asarray, jv)))
    cfg = preset("mcdropout", "cifar", "qat", epochs=0)
    _m, trainer, state = fit(cfg, _batches(0, 1), device="cpu",
                             init_from=read_checkpoint(
                                 checkpoint_path(FLOAT)))
    got = dict(_leaves(to_numpy_state(trainer.variables(state))))
    assert got.keys() == want.keys()
    assert {p[0] for p in got} == {"params", "batch_stats", "quant",
                                   "qconst"}
    for p in want:
        assert got[p].dtype == want[p].dtype, p
        np.testing.assert_array_equal(got[p], want[p], err_msg=str(p))
    assert all(np.isinf(v) for p, v in got.items() if p[0] == "quant")


def test_qat_flow_saves_a_state_that_load_trained_evaluates(tmp_path):
    cfg = preset("mcdropout", "cifar", "qat", epochs=1, seed=2)
    save = str(tmp_path / "q")
    model, trainer, conv = qat(cfg, FLOAT, _batches(1, 1), device="cpu",
                               save_dir=save)
    assert np.isfinite(trainer.history[0]["train"]["obj"])
    observed = [v for p, v in _leaves(to_numpy_state(conv["quant"]))]
    assert observed and all(np.isfinite(v) for v in observed)
    assert os.path.exists(checkpoint_path(save))
    cfg2, model2, state = load_trained(save, device="cpu")
    assert (cfg2.model, cfg2.q, cfg2.at, cfg2.p) == ("conv_resnet_mc", True,
                                                     True, cfg.p)
    saved = dict(_leaves(to_numpy_state(state)))
    for p, v in _leaves(to_numpy_state(conv)):
        np.testing.assert_array_equal(saved[p], v, err_msg=str(p))
    metric_state, probs, _s = evaluate(
        model2, state, _batches(3, 1), samples=3,
        generator=torch.Generator().manual_seed(4), device="cpu")
    assert probs[0].shape == (B, 10)
    np.testing.assert_allclose(probs[0].sum(-1).numpy(), 1.0, atol=1e-5)
    assert all(np.isfinite(float(v)) for v in TM.cls_metrics_compute(
        metric_state).values())


def test_qat_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """Like every entry point, flows.qat runs on the card unless the
    caller asks for the CPU, and raises rather than carrying on on the
    CPU when there is no card."""
    assert inspect.signature(qat).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qat(preset("bbb", "mnist", "qat"), FLOAT, _batches(0, 1))

