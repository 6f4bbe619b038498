"""Vmapped multi-seed training (qbn_tpu_torch.parallel.sweep) on the CPU:

- qbn_tpu's test_vmapped_multi_seed_training for the port: the linear
  regression model, 3 seeds, Adam at 1e-2, 30 steps on one shared batch:
  every seed's loss falls and the seeds' params differ;
- each seed of a stack against its own one-state run (the init from
  its seed, the training draws from a generator seeded with seed + 9999
  through GeneratorNoise and BernoulliMasks, training/trainer.py's
  step): the BBB and MC-Dropout regression MLPs of the regression tier,
  5 steps. The same float32 math, the stacked run's products batched
  over the seed axis: the loss within 1e-5 relative and the params
  within 1e-5 relative (atol 1e-6) after 5 steps;
- a model built with tpu_fused is refused (K5's autograd Function has no
  vmap rule; the vmapped step takes the unfused layers).
"""

import numpy as np
import pytest
import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.parallel.sweep import (
    init_seed_states, init_stacked_metrics, make_vmapped_train_step)
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.training.optim import build_optimizer, tree_map
from qbn_tpu_torch.training.trainer import (
    TrainState, make_train_step, metrics_init)
from qbn_tpu_torch.utils import init_variables, tree_leaves

SEEDS = [1, 2, 3]
STEPS = 5


def test_vmapped_multi_seed_training():
    cfg = Config(model="linear", task="regression",
                 dataset="regression_synthetic", batch_size=64,
                 optimizer="adam", learning_rate=1e-2,
                 lr_schedule="constant", gamma=0.0, input_size=(1,))
    model = build_model(cfg)
    tx, _ = build_optimizer(cfg, 10)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 1)).astype(np.float32))
    y = 2 * x + 8
    states = init_seed_states(model, cfg, tx, x, SEEDS, device="cpu")
    step = make_vmapped_train_step(model, cfg, tx, "float", 10, 640)
    metrics = init_stacked_metrics(cfg, len(SEEDS))
    first = None
    for _ in range(30):
        states, metrics, logs = step(states, metrics, x, y)
        if first is None:
            first = logs["obj"].numpy()
    last = logs["obj"].numpy()
    assert last.shape == (3,)
    assert np.all(last < first)
    p = next(tree_leaves(states.state.params)).numpy()
    assert not np.allclose(p[0], p[1])
    assert metrics["count"].tolist() == [30 * 64] * 3


def _cfg(method):
    return preset(method, "regression", batch_size=16, input_size=(1,))


def _batch():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((16, 1)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(2 * x + 8)


def _one_state_run(method, seed):
    cfg = _cfg(method)
    model = build_model(cfg)
    tx, _ = build_optimizer(cfg, 10)
    v = init_variables(model, torch.Generator().manual_seed(seed), (1,),
                       "cpu")
    params = v.pop("params")
    state = TrainState(params, v, tx.init(tree_map(torch.Tensor.detach,
                                                   params)))
    g = torch.Generator().manual_seed(seed + 9999)
    step = make_train_step(model, cfg, tx, "float", 10, 160)
    x, y = _batch()
    m = metrics_init(cfg.task)
    objs = []
    for _ in range(STEPS):
        state, m, logs = step(state, m, x, y, GeneratorNoise(g),
                              BernoulliMasks(g, 1))
        objs.append(float(logs["obj"]))
    return state, objs


@pytest.fixture(scope="module")
def stacked():
    out = {}
    for method in ("bbb", "mcdropout"):
        cfg = _cfg(method)
        model = build_model(cfg)
        tx, _ = build_optimizer(cfg, 10)
        x, y = _batch()
        states = init_seed_states(model, cfg, tx, x, SEEDS, device="cpu")
        step = make_vmapped_train_step(model, cfg, tx, "float", 10, 160)
        metrics = init_stacked_metrics(cfg, len(SEEDS))
        objs = []
        for _ in range(STEPS):
            states, metrics, logs = step(states, metrics, x, y)
            objs.append(logs["obj"].numpy())
        out[method] = (states, np.stack(objs, 1))
    return out


def _check_seed(stacked, method, i):
    states, objs = stacked[method]
    one, one_objs = _one_state_run(method, SEEDS[i])
    np.testing.assert_allclose(objs[i], one_objs, rtol=1e-5)
    for a, b in zip(tree_leaves(states.state.params),
                    tree_leaves(one.params)):
        np.testing.assert_allclose(a[i].numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_each_seed_is_its_one_state_run(stacked, i):
    """The BBB MLP: noise per seed from its own generator."""
    _check_seed(stacked, "bbb", i)


def test_mcdropout_seeds_are_their_one_state_runs(stacked):
    """The MC-Dropout MLP: masks per seed from its own generator."""
    for i in range(len(SEEDS)):
        _check_seed(stacked, "mcdropout", i)


def test_fused_model_is_refused():
    cfg = preset("bbb", "mnist", tpu_fused=True)
    tx, _ = build_optimizer(cfg, 10)
    with pytest.raises(ValueError, match="tpu_fused"):
        make_vmapped_train_step(build_model(cfg), cfg, tx, "float", 10, 100)
