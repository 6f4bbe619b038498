"""The experiment runner (port of qbn_tpu's experiments/run.py):

    python -m qbn_tpu_torch.run --method {pointwise,mcdropout,bbb,sgld} \
        --tier {regression,mnist,cifar} --phase {float,qat} [--FIELD V ...]

  # float BBB CIFAR
  python -m qbn_tpu_torch.run --method bbb --tier cifar --phase float
  # QAT at A7/W8 from that run, then convert and the INT evaluation
  python -m qbn_tpu_torch.run --method bbb --tier cifar --phase qat \
      --load not_q-cifar-classification-<stamp>
  # the regression tier (the synthetic task and 6 UCI datasets x 10
  # folds) on the CPU
  python -m qbn_tpu_torch.run --method pointwise --tier regression \
      --device cpu

  # the same over 2 processes, the batch and the MC samples sharded
  python -m qbn_tpu_torch.run --method bbb --tier mnist --mesh_shape 2

The cell's preset (presets.py), with every `Config` field settable by a
flag of its name (booleans are switches; input_size takes '32,32,3',
mesh_shape '2' or '2,2').
The run writes its directory (flows.setup_experiment: config.json,
GIT_REVISION, log.log, results.json), the checkpoints, scalars.jsonl,
the plots where matplotlib is present, and DONE at the end. It runs on
the card; `--device cpu` runs the plain PyTorch versions on the CPU.
With --mesh_shape the directory is made first, then prod(mesh_shape)
processes are launched (parallel/mesh.py: one per card where there are
enough, NCCL; else ranks share cards over gloo), each running the flow
on its share; rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from qbn_tpu_torch.config import Config
from qbn_tpu_torch.presets import preset
from qbn_tpu_torch.utils import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("python -m qbn_tpu_torch.run")
    p.add_argument("--method", required=True,
                   choices=["pointwise", "mcdropout", "bbb", "sgld"])
    p.add_argument("--tier", required=True,
                   choices=["regression", "mnist", "cifar"])
    p.add_argument("--phase", default="float", choices=["float", "qat"])
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    for f in dataclasses.fields(Config):
        if isinstance(f.default, bool):
            p.add_argument(f"--{f.name}", action="store_true", default=None)
        else:
            p.add_argument(f"--{f.name}", default=None)
    return p


def _overrides(args) -> dict:
    out = {}
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name)
        if v is None:
            continue
        if isinstance(f.default, bool):
            out[f.name] = bool(v)
        elif isinstance(f.default, int):
            out[f.name] = int(v)
        elif isinstance(f.default, float):
            out[f.name] = float(v)
        elif isinstance(f.default, tuple) or f.name == "mesh_shape":
            out[f.name] = tuple(int(p) for p in
                                str(v).replace(",", " ").split())
        else:
            out[f.name] = v
    return out


def main(argv=None) -> str:
    """Run one experiment; returns its directory."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.phase == "qat" and not args.load:
        raise SystemExit("--load <float experiment dir> is required for "
                         "--phase qat")
    from qbn_tpu_torch.flows import setup_experiment
    cfg = setup_experiment(preset(args.method, args.tier, args.phase,
                                  **_overrides(args)))
    if cfg.mesh_shape is None:
        _run(cfg, args.tier, args.phase, args.load, device)
    else:
        import importlib
        from qbn_tpu_torch.parallel.mesh import launch
        # by its module's name, also when this file runs as __main__
        rank = importlib.import_module("qbn_tpu_torch.run")._rank
        launch(rank, cfg.mesh_shape, cfg, args.tier, args.phase, args.load,
               device=device)
    return cfg.save


def _rank(mesh, cfg, tier, phase, load):
    """One rank of a mesh run: rank 0 logs to the run's log.log."""
    if mesh.is_main:
        from qbn_tpu_torch.flows import attach_run_log
        attach_run_log(cfg.save)
    _run(cfg, tier, phase, load, mesh.device, mesh)


def _run(cfg, tier, phase, load, device, mesh=None):
    from qbn_tpu_torch.flows import (
        run_float_classification, run_float_regression,
        run_qat_classification, run_qat_regression)
    if phase == "float":
        if tier == "regression":
            run_float_regression(cfg, device=device)
        else:
            run_float_classification(cfg, device=device)
    elif tier == "regression":
        run_qat_regression(cfg, load, device=device)
    else:
        run_qat_classification(cfg, load, device=device)
    if mesh is None or mesh.is_main:
        # the end-of-run marker: a grid sweep skips the cells that have one
        with open(os.path.join(cfg.save, "DONE"), "w") as fh:
            fh.write("ok\n")
    if mesh is not None:
        mesh.barrier()          # every rank returns after rank 0's files


if __name__ == "__main__":
    main(sys.argv[1:])
