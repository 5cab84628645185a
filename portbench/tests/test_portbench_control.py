"""The control: the plain reference computed in bfloat16, the precision
below the configurations' float32, put in the program's place, fails at
least one of its cell's limits, where the program's own float32 run at the
same inputs meets them all.  On the CPU at a small size; the test marked
``gpu`` runs the same at the cell's own size on the card (the readings that
set the limits come from ``portbench/limits.py`` on the card)."""

import pytest
import torch

from portbench import harness
from portbench.window import Window
from small import SMALL, small_driver

FULL = {name: {} for name in SMALL}


def readings(cell_name, device, size=None, seconds=0.3, seed=2**31 + 9):
    driver = small_driver(cell_name, dtype="float32", seed=seed, device=device, overrides=size)
    driver.warmup(harness.WARMUP_CALLS)
    window = Window(seconds, seed, harness.CHECKED_CALLS)
    window.open()
    driver.run_window(window)
    harness.sync(device)
    driver.release()
    worst = lambda rs: {k: max(r[k] for r in rs) for k in rs[0]}
    return driver.cell.workload["limits"], worst(driver.compare(torch.float64)), worst(driver.compare(control=True))


def check(limits, program, control):
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_control_fails_a_limit(cell_name):
    check(*readings(cell_name, "cpu"))


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", sorted(FULL))
def test_control_fails_a_limit_at_the_cells_size(card, cell_name):
    check(*readings(cell_name, card, FULL[cell_name], seconds=2.0))
