"""Experiment flows (port of qbn_tpu/flows.py): the run directory
(`setup_experiment`), the float and QAT runs of classification and
regression (`run_float_classification`, `run_float_regression`,
`run_qat_classification`, `run_qat_regression`, which `run.py` drives),
and the training steps they rest on, qbn_tpu's `_fit` and `_qat_one`.

`fit` builds the model, draws its init from `cfg.seed`, builds the
optimiser (Adam, SGD, or the adaptive clip and SGHMC) and the trainer,
runs `cfg.epochs` epochs over its training batches (`train_loop`) and
returns the model, the trainer (per-epoch metrics in `trainer.history`)
and the final state; with `save_dir` it writes the run's config.json,
its checkpoints under qbn_tpu's names (best-only or save-last,
weights{special_info}.msgpack, and an SGHMC run's posterior snapshots
weights{special_info}_<epoch>.msgpack) and scalars.jsonl. `qat` is the
QAT flow: the model with its quantisation machinery, a float or QAT
checkpoint merged into its quantised init (fresh observers where the
checkpoint has none), `fit` in 'qat' mode, the conversion to int
constants, and the converted state saved where asked; for an SGHMC run
(`cfg.method == 'sgld'`) it does so for each of the last `cfg.samples`
snapshots.

The batches are a loader of `data/loaders.py` (`get_train_loaders`),
iterated afresh every epoch (a new permutation, new crop and flip
draws), whose `dataset_size` is the n_points of 'whole' loss scaling;
or a sequence of (x, y) batches, the same every epoch: x (B, H, W, C)
float32 images and y (B,) integer labels, or x (B, features) and y
(B, 1) float32 regression targets, numpy or torch. A regression fold's
files carry its special_info '_<dataset>_<fold>', as qbn_tpu's flows
name them.

    from qbn_tpu_torch.data import get_train_loaders
    from qbn_tpu_torch.presets import preset
    from qbn_tpu_torch.flows import fit, qat
    cfg = preset("sgld", "cifar", epochs=16, burnin_epochs=2)
    train, valid = get_train_loaders(cfg)
    model, trainer, state = fit(cfg, train, valid, save_dir="runs/f")
    qcfg = preset("sgld", "cifar", phase="qat")
    model, trainer, ensemble = qat(qcfg, "runs/f", *get_train_loaders(qcfg),
                                   save_dir="runs/q")

With `tpu_fused=True` every Bayes-by-backprop dense layer's training
forward (the LeNet's fc_0 and fc_1, the ResNet's fc, the MLP's five
layers) runs the CUDA kernel of `ops/bbb_dense.py`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import subprocess
import time
from typing import Optional, Union

import torch

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.convert import from_jax_state, to_device, to_numpy_state
from qbn_tpu_torch.data import ArrayLoader, get_train_loaders
from qbn_tpu_torch.evaluation.ensemble import stack_variables
from qbn_tpu_torch.evaluation.harness import (
    REGRESSION_DATASETS, evaluate_classification_uncertainty,
    evaluate_regression_uncertainty)
from qbn_tpu_torch.evaluation.results import init_results, save_results
from qbn_tpu_torch.evaluation.writer import ScalarWriter
from qbn_tpu_torch.models.factory import build_model, load_state
from qbn_tpu_torch.ops.stochastic import BernoulliMasks, GeneratorNoise
from qbn_tpu_torch.training.checkpoint import (
    checkpoint_path, list_snapshots, merge, read_checkpoint, save_variables)
from qbn_tpu_torch.training.optim import build_optimizer
from qbn_tpu_torch.training.trainer import Trainer
from qbn_tpu_torch.utils import convert_model, init_variables, resolve_device

log = logging.getLogger(__name__)


def _batches(batches):
    """A loader as it is (iterated afresh each epoch), anything else as a
    list (the same batches each epoch)."""
    if batches is None or isinstance(batches, ArrayLoader):
        return batches
    return list(batches)


def fit(cfg: Config, train_batches, valid_batches=None, device="cuda",
        generator: Optional[torch.Generator] = None,
        dataset_size: Optional[int] = None, init_from=None,
        save_dir: Optional[str] = None, special_info: str = ""):
    """Train one model; returns (model, trainer, state).

    generator: the source of the training noise and dropout masks (by
    default a generator on `device` seeded with cfg.seed + 1; SGHMC draws
    from its own, seeded with cfg.seed). The init always comes from a CPU
    generator seeded with cfg.seed, so a seed gives the same initial
    weights on every device; with cfg.q or cfg.at it is the quantised
    init (observers and int-constant placeholders). cfg.input_size is
    taken from the first batch, as qbn_tpu's _fit does (from a loader,
    whose draws it advances as qbn_tpu's does). init_from: a variable
    tree (tensor or numpy leaves) merged into the init, key by key.
    dataset_size: the number of examples before the valid split, the
    n_points of 'whole' loss scaling; without it, a loader's
    `dataset_size`, or the examples in a sequence of batches. A
    config with cfg.at (preset(..., phase='qat')) trains in 'qat' mode,
    the QAT fine-tune; any other in 'float' mode. save_dir and
    special_info: see the module docstring."""
    device = resolve_device(device)
    train_batches = _batches(train_batches)
    valid_batches = _batches(valid_batches)
    if dataset_size is not None:
        n_points = dataset_size
    elif isinstance(train_batches, ArrayLoader):
        n_points = train_batches.dataset_size
    else:
        n_points = sum(len(y) for _x, y in train_batches)
    x0, _y0 = next(iter(train_batches))
    cfg = cfg.replace(input_size=tuple(x0.shape[1:]), save=save_dir)
    writer = None
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        cfg.to_json(os.path.join(save_dir, "config.json"))
        writer = ScalarWriter(save_dir)
    model = build_model(cfg)
    variables = init_variables(
        model, torch.Generator().manual_seed(cfg.seed), cfg.input_size,
        device, quantized=bool(cfg.q or cfg.at))
    if init_from is not None:
        variables = to_device(from_jax_state(merge(
            to_numpy_state(variables), to_numpy_state(init_from))), device)
    tx, _ = build_optimizer(cfg, len(train_batches))
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    trainer = Trainer(model, cfg, tx, "qat" if cfg.at else "float",
                      len(train_batches), n_points,
                      GeneratorNoise(generator), device,
                      masks=BernoulliMasks(generator, 1), writer=writer)
    state = trainer.init_state(variables)
    try:
        state, _best = trainer.train_loop(state, train_batches,
                                          valid_batches, special_info)
    finally:
        if writer is not None:
            writer.close()
    return model, trainer, state


def _qat_one(cfg: Config, init_from, train_batches, valid_batches, device,
             generator, dataset_size, save_dir, special_info):
    """qbn_tpu's _qat_one: fit in 'qat' mode from init_from; with a
    save_dir, the state that train_loop saved (the best or the last)
    read back; convert on the first training batch, saved over it."""
    if isinstance(init_from, str):
        init_from = read_checkpoint(init_from)
    model, trainer, state = fit(cfg, train_batches, valid_batches, device,
                                generator, dataset_size, init_from,
                                save_dir, special_info)
    variables = trainer.variables(state)
    path = None
    if save_dir is not None:
        path = checkpoint_path(save_dir, special_info)
        variables = to_device(from_jax_state(merge(
            to_numpy_state(variables), read_checkpoint(path))), device)
    x0 = torch.as_tensor(next(iter(train_batches))[0], dtype=torch.float32,
                         device=device)
    variables = convert_model(model, variables, x0)
    if path is not None:
        save_variables(variables, path)
    return model, trainer, variables


def qat(cfg: Config, init_from: Union[str, dict], train_batches,
        valid_batches=None, device="cuda",
        generator: Optional[torch.Generator] = None,
        dataset_size: Optional[int] = None,
        save_dir: Optional[str] = None, special_info: str = ""):
    """Fine-tune quantised models and convert them (qbn_tpu's _qat_one,
    and its loop over SGHMC snapshots); returns (model, trainer,
    converted variables).

    cfg: a QAT config (preset(..., phase="qat")). init_from: an
    experiment directory or checkpoint file of a float or QAT run, or its
    variable tree. After `fit` in 'qat' mode, `convert_model` on the
    first training batch computes the int constants ('qconst'). With
    save_dir, the converted variables and the config are written there as
    `models.factory.load_trained` reads them. special_info: a regression
    fold's '_<dataset>_<fold>' (its checkpoint in init_from, and the
    name of what is saved).

    For cfg.method 'sgld', init_from is the float run's directory: each
    of its last cfg.samples snapshots weights{special_info}_<epoch>.msgpack
    is fine-tuned and converted on its own, from the same seed, and saved
    under its own name; the converted members are returned stacked (the
    trainer is the last member's). A loader serves the members in turn,
    its draws running on; `run_qat_classification` and
    `run_qat_regression` give each member fresh loaders, as qbn_tpu's
    flows do."""
    device = resolve_device(device)
    if not (cfg.q and cfg.at):
        raise ValueError("qat needs a config with q and at set "
                         "(preset(..., phase='qat'))")
    args = (_batches(train_batches), _batches(valid_batches), device,
            generator, dataset_size, save_dir)
    if cfg.method != "sgld":
        if isinstance(init_from, str) and os.path.isdir(init_from):
            init_from = checkpoint_path(init_from, special_info)
        return _qat_one(cfg, init_from, *args, special_info)
    if not (isinstance(init_from, str) and os.path.isdir(init_from)):
        raise ValueError("the QAT of an SGHMC run reads its snapshots from "
                         "the float run's directory")
    members = []
    for path, info in _snapshots(cfg, init_from, special_info):
        model, trainer, variables = _qat_one(cfg, path, *args, info)
        members.append(variables)
    return model, trainer, stack_variables(members)


def _snapshots(cfg: Config, run_dir: str, special_info: str = ""):
    """[(path, special_info)] of the last cfg.samples SGHMC snapshots
    weights{special_info}_<epoch>.msgpack of a float run."""
    snaps = list_snapshots(run_dir, special_info[1:] + "_" if special_info
                           else "")
    if len(snaps) < cfg.samples:
        raise FileNotFoundError(f"{len(snaps)} SGHMC snapshots in "
                                f"{run_dir}, {cfg.samples} needed")
    return [(p, "_" + os.path.basename(p).split("weights_")[1].split(
        ".msgpack")[0]) for p in snaps[-cfg.samples:]]


# ---------------------------------------------------------------------------
# The experiment runs (qbn_tpu/flows.py:58-244)
# ---------------------------------------------------------------------------

def setup_experiment(cfg: Config, label: str = "") -> Config:
    """Create the run directory and return cfg with `save` set to it: a
    directory '<label>-<dataset>-<task>-<stamp>' (label not_q, q, qat or
    not_qat from cfg.q and cfg.at) in the working directory, or inside
    cfg.save if that is a directory, or cfg.save itself. Writes
    config.json, GIT_REVISION (the checkout's commit, empty outside a
    git checkout) and an empty results.json, and sends this process's
    log to <run>/log.log (the previous run's log file closed)."""
    if not label:
        label = "q" if cfg.q else "not_q"
        if cfg.at:
            label += "at"
    save = f"{label}-{cfg.dataset}-{cfg.task}-{time.strftime('%Y%m%d-%H%M%S')}"
    if cfg.save not in ("EXP", "", None):
        save = (os.path.join(cfg.save, save) if os.path.isdir(cfg.save)
                else cfg.save)
    os.makedirs(save, exist_ok=True)
    cfg = cfg.replace(save=save)

    root = logging.getLogger()
    for h in list(root.handlers):
        if getattr(h, "_qbn_run_log", False):
            root.removeHandler(h)
            h.close()
    fh = logging.FileHandler(os.path.join(save, "log.log"))
    fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    fh._qbn_run_log = True
    root.addHandler(fh)
    root.setLevel(logging.INFO)

    cfg.to_json(os.path.join(save, "config.json"))
    try:
        rev = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__))
                             ).stdout.strip()
    except OSError:
        rev = ""
    with open(os.path.join(save, "GIT_REVISION"), "w") as f:
        f.write(rev + "\n")
    save_results(init_results(cfg), save)
    log.info("Experiment dir: %s", save)
    log.info("Config: %s", dataclasses.asdict(cfg))
    return cfg


def run_float_classification(cfg: Config, device="cuda") -> None:
    """Train cfg's classifier into cfg.save, then evaluate the saved state
    (the last or best checkpoint; for SGHMC the last cfg.samples
    snapshots) by the full protocol, in float."""
    train, valid = get_train_loaders(cfg, device=device)
    model, _trainer, _state = fit(cfg, train, valid, device,
                                  save_dir=cfg.save)
    evaluate_classification_uncertainty(
        model, load_state(cfg, cfg.save), cfg, "float", device)


def run_float_regression(cfg: Config, datasets=None, device="cuda") -> None:
    """Train one model per (dataset, fold) into cfg.save (with cfg.debug,
    fold 0 of each dataset), then the regression protocol in float."""
    datasets = datasets if datasets is not None else REGRESSION_DATASETS
    for dataset, n_folds in datasets:
        for fold in range(n_folds):
            fcfg = cfg.replace(dataset=f"regression_{dataset}")
            log.info("## training %s fold %d ##", dataset, fold)
            fit(fcfg, *get_train_loaders(fcfg, split=fold, device=device),
                device, save_dir=cfg.save,
                special_info=f"_{dataset}_{fold}")
            if cfg.debug:
                break
    # each fold's fit wrote its own config; the run's is cfg
    cfg.to_json(os.path.join(cfg.save, "config.json"))
    evaluate_regression_uncertainty(cfg, "float", datasets, device)


def _qat_run(cfg: Config, load_dir: str, fold: int, special_info: str,
             device):
    """Fine-tune and convert the float run's model of one fold (or of the
    classifier, fold -1), or each of its last cfg.samples SGHMC
    snapshots, into cfg.save, each from fresh loaders as qbn_tpu's _fit
    makes them."""
    if cfg.method == "sgld":
        todo = _snapshots(cfg, load_dir, special_info)
    else:
        todo = [(checkpoint_path(load_dir, special_info), special_info)]
    for path, info in todo:
        _qat_one(cfg, path, *get_train_loaders(cfg, split=fold,
                                               device=device),
                 resolve_device(device), None, None, cfg.save, info)


def run_qat_classification(cfg: Config, load_dir: str,
                           device="cuda") -> None:
    """QAT and convert of a float run's classifier (`load_dir`; each SGHMC
    snapshot on its own) into cfg.save, then the full protocol on the
    converted state, in INT."""
    _qat_run(cfg, load_dir, -1, "", device)
    evaluate_classification_uncertainty(
        build_model(cfg), load_state(cfg, cfg.save), cfg, "int", device)


def run_qat_regression(cfg: Config, load_dir: str, datasets=None,
                       device="cuda") -> None:
    """QAT and convert of each (dataset, fold) model of a float run (with
    cfg.debug, fold 0 of each), then the regression protocol in INT."""
    datasets = datasets if datasets is not None else REGRESSION_DATASETS
    for dataset, n_folds in datasets:
        for fold in range(n_folds):
            _qat_run(cfg.replace(dataset=f"regression_{dataset}"), load_dir,
                     fold, f"_{dataset}_{fold}", device)
            if cfg.debug:
                break
    cfg.to_json(os.path.join(cfg.save, "config.json"))
    evaluate_regression_uncertainty(cfg, "int", datasets, device)
