"""The experiment grid (port of qbn_tpu's experiments/sweep.py): every
cell's seed runs through `qbn_tpu_torch.run`, then their seed average.

Float grid: for each (method x tier), one float run per seed into
<out>/<method>-<tier>-seed<seed>, then <out>/<method>-<tier>-avg.

Quant grid: from each seed's float run, QAT + convert + INT evaluation at
weight precision w in {8..3} at a=7 and activation precision a in {6..3}
at w=8, each cell 'a_A_w_W' into <out>/<method>-<tier>-<cell>-seed<seed>,
then <out>/<method>-<tier>-<cell>-avg.

    python -m qbn_tpu_torch.sweep float --methods bbb --tiers cifar \
        --seeds 1 2 3
    python -m qbn_tpu_torch.sweep quant --methods bbb --tiers cifar \
        --load runs/bbb-cifar-seed{seed} [--cells a_7_w_8] \
        [--extra --device cpu --debug]

A cell's run directory with a DONE marker (written at the end of a run)
is skipped; one without it is cleared and run again.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

from qbn_tpu_torch import average_results
from qbn_tpu_torch.run import main as run_main

WEIGHT_SWEEP = [8, 7, 6, 5, 4, 3]          # at a=7
ACTIVATION_SWEEP = [6, 5, 4, 3]            # at w=8

# qbn_tpu's transient relay/device failure markers: a run that fails with
# one of them is retried once; anything else re-raises immediately.
TRANSIENT = ("remote_compile", "UNAVAILABLE", "DEADLINE_EXCEEDED",
             "response body closed", "Socket closed")
RETRY_COOLDOWN_S = 120


def _run_cell(argv, d: str, attempts: int = 2) -> None:
    """One grid-cell run with bounded retry on TRANSIENT failures: clear
    the half-written dir, cool down, run again. Non-transient errors and
    the final attempt re-raise, so that a real fault stops the grid."""
    for attempt in range(attempts):
        try:
            run_main(argv)
            return
        except Exception as e:  # noqa: BLE001 - marker-filtered below
            msg = repr(e)
            if (attempt + 1 >= attempts
                    or not any(t in msg for t in TRANSIENT)):
                raise
            print(f"[sweep] transient failure on {d}, retrying after "
                  f"{RETRY_COOLDOWN_S}s: {msg[:200]}", flush=True)
            time.sleep(RETRY_COOLDOWN_S)
            _fresh_dir(d)


def _fresh_dir(d: str) -> None:
    """Clear a half-written cell dir before rerunning it: setup_experiment
    nests a timestamped subdir when --save already exists, so a rerun over
    the leftovers would put its files one level down and leave the stale
    top-level results.json to poison the average."""
    if os.path.isdir(d) and not os.path.exists(os.path.join(d, "DONE")):
        shutil.rmtree(d)


def _seed_runs(args, method, tier, name, run_argv) -> None:
    """The cell's run per seed into <out>/<name>-seed<seed> (skipping those
    with DONE; run_argv(seed): the run's flags after --tier), then the
    average into <out>/<name>-avg."""
    run_dirs = []
    for seed in args.seeds:
        d = os.path.join(args.out, f"{name}-seed{seed}")
        if not os.path.exists(os.path.join(d, "DONE")):
            _fresh_dir(d)
            _run_cell(["--method", method, "--tier", tier]
                      + run_argv(seed) + ["--save", d] + args.extra, d)
        run_dirs.append(d)
    average_results.main(run_dirs + ["--save",
                                     os.path.join(args.out, f"{name}-avg")])


def main(argv=None):
    p = argparse.ArgumentParser("python -m qbn_tpu_torch.sweep")
    p.add_argument("grid", choices=["float", "quant"])
    p.add_argument("--methods", nargs="+",
                   default=["pointwise", "mcdropout", "bbb", "sgld"])
    p.add_argument("--tiers", nargs="+",
                   default=["regression", "mnist", "cifar"])
    p.add_argument("--seeds", nargs="+", type=int, default=[1, 2, 3])
    p.add_argument("--load", default=None,
                   help="float experiment dir (quant grid); '{seed}' is "
                        "substituted per seed. Default: the float grid's "
                        "own '<out>/<method>-<tier>-seed<seed>' layout")
    p.add_argument("--out", default="sweeps")
    p.add_argument("--cells", nargs="*", default=None,
                   help="restrict the quant grid to cells 'a_A_w_W'")
    p.add_argument("--extra", nargs=argparse.REMAINDER, default=[],
                   help="extra flags passed through to qbn_tpu_torch.run "
                        "(captures everything after --extra, including "
                        "--flags; put it last)")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    for method in args.methods:
        for tier in args.tiers:
            if args.grid == "float":
                _seed_runs(args, method, tier, f"{method}-{tier}",
                           lambda seed: ["--phase", "float",
                                         "--seed", str(seed)])
                continue
            cells = ([(7, w) for w in WEIGHT_SWEEP]
                     + [(a, 8) for a in ACTIVATION_SWEEP])
            if args.cells:
                cells = [(int(c.split("_")[1]), int(c.split("_")[3]))
                         for c in args.cells]
            for a_bits, w_bits in cells:
                def quant_argv(seed, a_bits=a_bits, w_bits=w_bits):
                    load = (args.load.replace("{seed}", str(seed))
                            if args.load else
                            os.path.join(args.out,
                                         f"{method}-{tier}-seed{seed}"))
                    return ["--phase", "qat", "--load", load,
                            "--seed", str(seed),
                            "--activation_precision", str(a_bits),
                            "--weight_precision", str(w_bits)]
                _seed_runs(args, method, tier,
                           f"{method}-{tier}-a_{a_bits}_w_{w_bits}",
                           quant_argv)


if __name__ == "__main__":
    main(sys.argv[1:])
