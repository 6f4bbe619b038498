"""Readings for the limits of a cell's `correct` (PERF.md sets each limit
from them): for each seed, the numbers that a run compares, of the
program against the plain reference and of each variant of the reference
put in the program's place that the cell's driver lists in its
`VARIANTS`: the control (the reference one precision below the
configuration's: int4 weights for the INT8 cells, TF32 products for the
float32 training) and, for training, the fault of a step that leaves
half of each batch out.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

On the card, at the cell's own sizes and load; each seed is a set-up and
a short window of its own. One JSON line per seed on standard output.
"""

from __future__ import annotations

import argparse
import importlib
import json

from portbench import cells
from portbench.tracing import Tracer


def readings(cell, seed: int, seconds: float, device):
    driver = importlib.import_module(f"portbench.drivers.{cell.driver}")
    session = driver.Session(cell, seed, device)
    session.setup()
    window = session.window(seconds, Tracer())
    session.release()
    out = {"seed": seed, "units": window["units"]}
    for name, kw in driver.VARIANTS.items():
        out[name] = dict(session.check(**kw)[0])
        if name == "program" and hasattr(session, "left_out"):
            out["left_out"] = ["/".join(k) for k in session.left_out]
    return out


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = cells.find(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.seconds, device)),
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
