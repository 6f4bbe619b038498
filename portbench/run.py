"""Run one cell of BENCHMARK.json once on the card and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Set-up (imports, the port's kernels built
or loaded from qbn_tpu_torch/_build/, state, data, warm-up) is timed from
the process's start to the first timed unit (`setup_s`). The window then
runs for --seconds; with --trace 1 a sub-window of it runs under
torch.profiler and the per-layer metrics are read from it (`metrics/`),
otherwise the end-to-end metrics are reported. After the window the
program's state is freed and the plain reference recomputes a sample of
what the window produced; each number compared is printed beside its
limit (`limits/<cell>.json`) as the last lines on standard error and
under "checks" in the result. The run fails, printing no result, without
a card, with fewer cards than the cell asks for, or when JAX or the JAX
package has been imported.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

from portbench import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "qbn_tpu")


def process_start() -> float:
    """The process's start on the time.time() clock (to 10 ms)."""
    with open("/proc/self/stat") as fh:
        fields = fh.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_limits(cell_name: str) -> dict:
    with open(cells.PACKAGE / "limits" / f"{cell_name}.json") as fh:
        return json.load(fh)


def _fail(msg: str, code: int):
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(code)


def chip(cell):
    """The card the cell runs on; exits when there are too few."""
    import torch
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark runs on the card only", 3)
    if torch.cuda.device_count() < cell.chips:
        _fail(f"{cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", 3)
    return torch.device("cuda", 0)


def execute(cell, seed: int, seconds: float, trace: bool, device,
            started: float):
    """One run of a cell on `device`: (result, sampled units checked)."""
    import torch
    driver = importlib.import_module(f"portbench.drivers.{cell.driver}")
    session = driver.Session(cell, seed, device)
    session.setup()
    from portbench.tracing import Tracer, warm_profiler
    tracer = Tracer()
    if trace:
        warm_profiler()
        spec = cell.traffic["trace"]
        tracer = Tracer(int(spec["start"]), int(spec["units"]))
        tracer.ranges = session.attach(tracer)
    torch.cuda.synchronize(device)
    setup_s = time.time() - started
    window = session.window(float(seconds), tracer)
    peak = torch.cuda.max_memory_allocated(device)
    session.release()
    numbers, checked = session.check()
    limits = load_limits(cell.name)
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in numbers}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window.get("failed", 0)}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    metrics = {}
    if trace:
        trace = tracer.trace
        if trace is None:
            _fail("the window ended before the traced units began", 5)
        trace.extra = session.facts()
        for name, read in cells.readers(cell).items():
            value = read(trace)
            if value is not None:
                metrics[name] = {"value": value, "unit": units[name]}
    else:
        values = dict(window["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(device),
                        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=trace.busy_s(),
                                window_s=trace.window_s)
        result["breakdown"] = trace.breakdown()
    result["checks"] = checks
    return result, checked


def main(argv=None):
    started = process_start()
    for sub, var in (("triton", "TRITON_CACHE_DIR"),
                     ("torch_extensions", "TORCH_EXTENSIONS_DIR"),
                     ("inductor", "TORCHINDUCTOR_CACHE_DIR")):
        os.environ[var] = str(cells.CACHE_DIR / sub)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.find(args.workload)
    result, checked = execute(cell, args.seed, args.seconds, bool(args.trace),
                              chip(cell), started)
    bad = forbidden_modules()
    if bad:
        _fail(f"modules of JAX or the JAX package were imported: {bad}", 4)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}; "
              f"{checked} sampled units)", file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
