"""The benchmark of qbn_tpu_torch, the PyTorch and CUDA port.

`python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on the card and prints
one JSON line. Each configuration (`configs/`), traffic mix (`traffic/`)
and per-layer metric (`metrics/`) is a file of its own, found by the name
that BENCHMARK.json gives it; the kind of work a traffic mix asks for
(its "driver") is a module of `drivers/`. The plain reference that decides
`correct` lives in `reference/` and imports nothing of the program.
"""
