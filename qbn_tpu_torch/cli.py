"""Console entry points (pyproject [project.scripts]): `qbn-torch-run`
(`qbn_tpu_torch.run`) and `qbn-torch-sweep` (`qbn_tpu_torch.sweep`)."""

from __future__ import annotations


def run_main(argv=None):
    from qbn_tpu_torch import run
    return run.main(argv)


def sweep_main(argv=None):
    from qbn_tpu_torch import sweep
    return sweep.main(argv)
