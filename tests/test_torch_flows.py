"""The port's training flow against two properties of qbn_tpu's.

- The validation pass draws from its own noise (qbn_tpu keys its eval from
  PRNGKey(cfg.seed + 17)), so the parameters that `fit` trains do not
  depend on whether validation batches are given.
- 'whole' loss scaling multiplies the likelihood by the dataset size
  before the valid split, which qbn_tpu's loaders carry as
  `dataset_size`, not by the size of the train subset.
Both run on the CPU at B=8 with MNIST-shaped inputs made from a seed.

And every (method, tier) of the presets, float and QAT, through the
flows on the CPU at B=2 (one epoch; SGHMC two, its snapshot at epoch 0):
`fit` trains with finite metrics and writes its files, `qat` converts,
`load_trained` reads the result and `evaluate` runs it, INT and float.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qbn_tpu.data import loaders as JLoaders
from qbn_tpu.presets import preset as j_preset
from qbn_tpu.training.losses import classification_loss as j_loss

from qbn_tpu_torch.evaluation.mc import evaluate
from qbn_tpu_torch.flows import fit, qat
from qbn_tpu_torch.models.factory import load_trained
from qbn_tpu_torch.models.factory import build_model
from qbn_tpu_torch.ops.stochastic import GeneratorNoise
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.utils import full_float32, init_variables, sum_kl


def _images(rng, n):
    return (rng.random((n, 28, 28, 1), dtype=np.float32),
            rng.integers(0, 10, n))


def test_validation_leaves_the_training_trajectory_alone():
    cfg = preset("bbb", "mnist", tpu_fused=True, epochs=2, seed=3)
    rng = np.random.default_rng(0)
    batches = [_images(rng, 8) for _ in range(2)]
    valid = [_images(rng, 8)]
    _m, plain, a = fit(cfg, batches, device="cpu")
    _m, validated, b = fit(cfg, batches, valid_batches=valid, device="cpu")
    assert "valid" not in plain.history[0]
    assert [set(r["valid"]) for r in validated.history] == \
        [set(plain.history[0]["train"]) - {"obj", "main_obj", "kl"}] * 2
    for layer in a.params:
        for leaf in a.params[layer]:
            assert torch.equal(a.params[layer][leaf],
                               b.params[layer][leaf]), (layer, leaf)


def test_whole_scaling_counts_the_dataset_before_the_valid_split(
        monkeypatch):
    rng = np.random.default_rng(1)
    x, y = _images(rng, 50)
    jcfg = j_preset("bbb", "mnist", valid_portion=0.1, seed=4)
    monkeypatch.setattr(JLoaders.D, "load_images",
                        lambda *_a, **_k: (x, y))
    train, valid = JLoaders.get_train_loaders(jcfg)
    assert (len(train.x), len(valid.x), train.dataset_size) == (45, 5, 50)

    cfg = preset("bbb", "mnist", tpu_fused=True, epochs=1, seed=4,
                 loss_scaling="whole", loss_multiplier=2.0)
    batches = [(train.x, train.y)]
    _m, trainer, _s = fit(cfg, batches, valid_batches=[(valid.x, valid.y)],
                          device="cpu",
                          generator=torch.Generator().manual_seed(9),
                          dataset_size=train.dataset_size)
    got = trainer.history[0]["train"]["main_obj"]

    # the same step's probabilities and KL, then qbn_tpu's loss with its
    # loader's n_points
    model = build_model(cfg)
    variables = init_variables(model, torch.Generator().manual_seed(4),
                               cfg.input_size, "cpu")
    kl = {}
    with torch.no_grad(), full_float32():
        probs = model(torch.from_numpy(train.x), variables, train=True,
                      noise=GeneratorNoise(torch.Generator().manual_seed(9)),
                      kl=kl)
    n_points = getattr(train, "dataset_size", train.num_examples)
    _loss, want, _kl = j_loss(jnp.asarray(probs.numpy()),
                              jnp.asarray(train.y), float(sum_kl(kl)),
                              cfg.gamma, 1, n_points, scaling="whole",
                              loss_multiplier=cfg.loss_multiplier)
    assert got == pytest.approx(float(want), rel=1e-6)


SHAPES = {"regression": (13,), "mnist": (28, 28, 1), "cifar": (32, 32, 3)}


@pytest.mark.parametrize("method", ["pointwise", "mcdropout", "bbb",
                                    "sgld"])
@pytest.mark.parametrize("tier", sorted(SHAPES))
def test_every_preset_trains_and_converts(tmp_path, tier, method):
    rng = np.random.default_rng(7)
    x = rng.random((2,) + SHAPES[tier], dtype=np.float32)
    y = (rng.standard_normal((2, 1)).astype(np.float32)
         if tier == "regression" else rng.integers(0, 10, 2))
    over = dict(epochs=2, burnin_epochs=0, samples=1) \
        if method == "sgld" else dict(epochs=1)
    cfg = preset(method, tier, tpu_fused=True, **over)
    _m, trainer, _s = fit(cfg, [(x, y)], device="cpu",
                          save_dir=str(tmp_path / "f"))
    assert all(np.isfinite(v) for v in trainer.history[-1]["train"].values())
    qcfg = preset(method, tier, "qat", tpu_fused=True, epochs=1,
                  samples=cfg.samples)
    qat(qcfg, str(tmp_path / "f"), [(x, y)], device="cpu",
        save_dir=str(tmp_path / "q"))
    for d, mode in (("q", "int"), ("f", "float")):
        c, model, state = load_trained(str(tmp_path / d), device="cpu")
        assert (c.q, c.at) == ((True, True) if mode == "int"
                               else (False, False))
        _ms, outs, _t = evaluate(model, state, [(x, y)], c.samples,
                                 torch.Generator().manual_seed(1), "cpu",
                                 mode=mode)
        out = outs[0] if tier != "regression" else outs[0][0]
        assert out.shape[0] == 2 and bool(torch.isfinite(out).all())
