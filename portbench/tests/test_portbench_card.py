"""The controls on the card, at sizes a test run holds: a sound run is
within every limit, and the control (int4 weights for the INT8 cells,
TF32 products for the float32 training) and the training's half-batch
fault fail at least one. PERF.md gives the same readings at the cells'
own sizes (python3 -m portbench.calibrate). Run on the card with
python3 -m pytest portbench/tests -m card."""

import pytest

from portbench import calibrate, cells, run
from portbench.tests.small import SEED, small_cell

NAMES = [w["name"] for w in cells.load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_the_control_fails_on_the_card(card, name):
    cell = small_cell(name)
    limits = run.load_limits(name)
    r = calibrate.readings(cell, SEED, 0.5, card)
    assert all(v <= limits[k] for k, v in r["program"].items()), r
    for variant in set(r) - {"seed", "units", "program", "left_out"}:
        assert any(v > limits[k] for k, v in r[variant].items()), \
            (variant, r)
