"""Uncertainty evaluation harness (port of qbn_tpu/evaluation/harness.py).

For a trained classifier: the train, valid and test splits, the OOD set
(FashionMNIST for MNIST, SVHN for CIFAR) under the key 'random', and the
3 distortions x 5 levels of the test set, each recorded as error, ECE,
entropy and NLL (and the example-samples per second in the latency slot)
into results.json in cfg.save, with the reliability and confidence plots.
For regression: the synthetic task and the six UCI datasets, fold by
fold, each fold's state read from cfg.save, RMSE and NLL averaged over
the folds (nanmean), and the synthetic task's uncertainty decomposition
plot. The model's method chooses the Monte-Carlo path (evaluation/mc.py);
everything runs on `device`, the card unless the caller asks for the CPU.
With cfg.mesh_shape (inside a launched group, parallel/mesh.py) every
split, the OOD set and the sweep are evaluated sample-sharded over the
mesh, on the mesh's device; rank 0 alone writes results.json and the
plots.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import to_device
from qbn_tpu_torch.data import get_test_loader, get_train_loaders
from qbn_tpu_torch.data.datasets import regression_data_generator
from qbn_tpu_torch.evaluation.mc import (
    evaluate_distortion_sweep, evaluate_with_loader, mc_predict)
from qbn_tpu_torch.evaluation.plots import (
    plot_confidence_histogram, plot_regression_uncertainty, plot_reliability)
from qbn_tpu_torch.evaluation.results import (
    init_results, load_results, save_results)
from qbn_tpu_torch.models.factory import build_model, load_state
from qbn_tpu_torch.parallel.mesh import mesh_from_config
from qbn_tpu_torch.training.checkpoint import model_size_mb
from qbn_tpu_torch.utils import full_float32, resolve_device

log = logging.getLogger(__name__)

REGRESSION_DATASETS = [("synthetic", 1), ("housing", 10), ("concrete", 10),
                       ("energy", 10), ("power", 10), ("wine", 10),
                       ("yacht", 10)]


def _record(results, split, error, ece, entropy, nll, sps):
    for key, val in (("error", error), ("ece", ece), ("entropy", entropy),
                     ("nll", nll), ("latency", sps)):
        results[key][split] = val


def _record_distortion(results, distortion, level, error, ece, entropy, nll):
    for key, val in (("error", error), ("ece", ece), ("entropy", entropy),
                     ("nll", nll)):
        results[key].setdefault(distortion, {})[str(level)] = val


def _main(mesh) -> bool:
    """Whether this process writes the run's files (rank 0 of a mesh)."""
    return mesh is None or mesh.is_main


def _device(device, mesh):
    return resolve_device(device) if mesh is None else mesh.device


def evaluate_and_record(model, state, cfg: Config, mode: str, results,
                        device="cuda", mesh=None):
    """The train, valid and test splits into `results`. Returns the test
    split's (probabilities, targets) for the calibration plots."""
    train_loader, val_loader = get_train_loaders(cfg, device=device)
    test_loader = get_test_loader(cfg, device=device)
    out = tgt = None
    for split, loader in (("train", train_loader), ("valid", val_loader),
                          ("test", test_loader)):
        if loader is None:
            continue
        error, ece, entropy, nll, o, t, sps = evaluate_with_loader(
            loader, model, state, cfg, mode, salt=split, device=device,
            mesh=mesh)
        log.info("## %s error=%.4f ece=%.4f entropy=%.4f nll=%.4f "
                 "(%.0f example-samples/s) ##", split, error, ece, entropy,
                 nll, sps)
        _record(results, split, error, ece, entropy, nll, sps)
        if split == "test":
            out, tgt = o, t
    return out, tgt


def evaluate_classification_uncertainty(model, state, cfg: Config,
                                        mode: str, device="cuda"):
    """The full MNIST/CIFAR uncertainty protocol of a model and its state
    (float or converted, as `mode` says; an SGHMC state stacked).
    Returns the results dict, also saved as cfg.save/results.json."""
    mesh = mesh_from_config(cfg)
    device = _device(device, mesh)
    state = to_device(state, device)
    results = load_results(cfg.save) or init_results(cfg)
    results["model_size"] = model_size_mb(state)
    out, tgt = evaluate_and_record(model, state, cfg, mode, results,
                                   device, mesh)
    main = _main(mesh)
    if out is not None and main:
        plot_reliability(out, tgt, os.path.join(cfg.save, "ece_test.png"))
        plot_confidence_histogram(out, os.path.join(cfg.save,
                                                    "certainty_test.png"))

    ood_loader = get_test_loader(
        cfg.replace(dataset="random_" + cfg.dataset), device=device)
    error, ece, entropy, nll, out, tgt, sps = evaluate_with_loader(
        ood_loader, model, state, cfg, mode, salt="random", device=device,
        mesh=mesh)
    log.info("## random error=%.4f ece=%.4f entropy=%.4f nll=%.4f ##",
             error, ece, entropy, nll)
    _record(results, "random", error, ece, entropy, nll, sps)
    if out is not None and main:
        plot_reliability(out, tgt, os.path.join(cfg.save, "ece_random.png"))
        plot_confidence_histogram(out, os.path.join(cfg.save,
                                                    "certainty_random.png"))

    for distortion, level, error, ece, entropy, nll in \
            evaluate_distortion_sweep(model, state, cfg, mode,
                                      device=device, mesh=mesh):
        log.info("## %s level %d: error=%.4f ece=%.4f entropy=%.4f "
                 "nll=%.4f ##", distortion, level + 1, error, ece, entropy,
                 nll)
        _record_distortion(results, distortion, level, error, ece, entropy,
                           nll)
    if main:
        save_results(results, cfg.save)
    return results


def evaluate_regression_uncertainty(cfg: Config, mode: str, datasets=None,
                                    device="cuda"):
    """The regression protocol over (dataset, folds) pairs (by default
    the synthetic task and the six UCI datasets of 10 folds): each fold's
    state read from cfg.save (weights_<dataset>_<fold>.msgpack, or an
    SGHMC run's last cfg.samples snapshots), its train, valid and test
    splits evaluated (seed = the fold), RMSE and NLL averaged over the
    folds. Returns the results dict, also saved as cfg.save/results.json,
    and draws the synthetic task's plot."""
    mesh = mesh_from_config(cfg)
    device = _device(device, mesh)
    results = load_results(cfg.save) or init_results(cfg)
    datasets = datasets if datasets is not None else REGRESSION_DATASETS
    for dataset, n_folds in datasets:
        name = f"regression_{dataset}"
        per_split = {s: {"rmse": [], "nll": []}
                     for s in ("train", "valid", "test")}
        for fold in range(n_folds):
            fcfg = cfg.replace(dataset=name)
            train_loader, val_loader = get_train_loaders(fcfg, split=fold,
                                                         device=device)
            test_loader = get_test_loader(fcfg, split=fold, device=device)
            # qbn_tpu reads one batch first (its input size): the train
            # split is then evaluated in the loader's second permutation
            next(iter(train_loader))
            model = build_model(fcfg)
            state = to_device(load_state(fcfg, cfg.save,
                                         f"_{dataset}_{fold}"), device)
            results["model_size"] = model_size_mb(state)
            for split, loader in (("train", train_loader),
                                  ("valid", val_loader),
                                  ("test", test_loader)):
                if loader is None:
                    continue
                error, _, _, nll, _, _, _ = evaluate_with_loader(
                    loader, model, state, fcfg, mode, seed=fold,
                    collect_outputs=False, salt=f"{name}_{split}",
                    device=device, mesh=mesh)
                per_split[split]["rmse"].append(error)
                per_split[split]["nll"].append(nll)
            if cfg.debug:
                break
        for split in ("train", "valid", "test"):
            if not per_split[split]["rmse"]:
                continue
            rmse = float(np.nanmean(per_split[split]["rmse"]))
            nll = float(np.nanmean(per_split[split]["nll"]))
            results["error"].setdefault(name, {})[split] = rmse
            results["nll"].setdefault(name, {})[split] = nll
            log.info("## %s %s rmse=%.4f nll=%.4f ##", name, split, rmse,
                     nll)
    if _main(mesh):
        save_results(results, cfg.save)
        plot_synthetic_decomposition(cfg, mode, device=device)
    return results


def plot_synthetic_decomposition(cfg: Config, mode: str, n_grid: int = 1000,
                                 device="cuda"):
    """The epistemic and aleatoric uncertainty of the synthetic task's
    model over x in [-5, 5] (100 Monte-Carlo samples, or the ensemble's
    members), drawn into cfg.save/regression.png."""
    device = resolve_device(device)
    scfg = cfg.replace(dataset="regression_synthetic", input_size=(1,))
    ensemble = cfg.method == "sgld"
    samples = cfg.samples
    if not ensemble and samples != 1:
        samples = 100
    model = build_model(scfg)
    try:
        state = to_device(load_state(scfg, cfg.save, "_synthetic_0"),
                          device)
    except FileNotFoundError:
        log.warning("no synthetic checkpoint found: skipping the plot")
        return
    x_grid = np.linspace(-5, 5, n_grid, dtype=np.float32).reshape(-1, 1)
    gen = torch.Generator(device=device).manual_seed(7)
    mus, ep, al = [], [], []
    with torch.no_grad(), full_float32():
        for i in range(0, n_grid, 25):
            xb = torch.from_numpy(x_grid[i:i + 25]).to(device)
            mu, var = mc_predict(model, state, xb, samples=samples,
                                 generator=gen, ensemble=ensemble,
                                 mode=mode)
            mu, var = mu.cpu().numpy(), var.cpu().numpy()
            mus.append(mu.mean(0))
            ep.append(mu.var(0, ddof=1) if mu.shape[0] > 1
                      else np.zeros_like(mu[0]))
            al.append(var.mean(0))
    x_tr, y_tr = regression_data_generator(n_points=20, seed=cfg.seed)
    plot_regression_uncertainty(
        x_grid, 2 * x_grid + 8, np.concatenate(mus), np.concatenate(ep),
        np.concatenate(al), x_tr, y_tr,
        os.path.join(cfg.save, "regression.png"), multi_sample=samples > 1)
