"""Each plain reference against the port's CPU path (the kernels' plain
versions) at a tiny batch and horizon in float64, through the cell's own
driver: every compared number at rounding level (the fleet loop keeps its
running statistics in float32 whatever the environment's type)."""

import pytest
import torch

from small import SMALL, small_driver

LIMITS = {"count_gap": 0.0, "flag_mismatch": 0.0, "stats_gap": 1e-6}


def within(readings):
    return all(v <= LIMITS.get(n, 1e-10) for r in readings for n, v in r.items())


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_reference_meets_the_port_in_float64(cell_name):
    driver = small_driver(cell_name)
    driver.warmup(3)
    readings = driver.compare(torch.float64)
    assert 1 <= len(readings) <= 2  # the start, from the benchmark's own inputs, and a fleet's last chunk
    assert within(readings), readings


@pytest.mark.parametrize("cell_name", sorted(SMALL))
def test_later_calls_follow_from_the_programs_state(cell_name):
    from portbench.window import Window

    driver = small_driver(cell_name)
    driver.warmup(2)
    window = Window(0.2, 7, 3)
    window.open()
    driver.run_window(window)
    readings = driver.compare(torch.float64)
    assert len(readings) >= 2
    assert within(readings), readings
