"""The cells at sizes a CPU test run holds."""

from portbench import harness

SMALL = {
    "pendulum-fleet-t4096": {"batch": 16, "chunk_steps": 40, "pool": 2},
    "pmsm-brusa-pi-fleet-t2048": {"batch": 16, "chunk_steps": 40},
    "pmsm-brusa-collect-t512": {"batch": 16, "chunk_steps": 40, "pool": 2, "checked_rows": 0},
}


def small_driver(cell_name, dtype="float64", seed=2**31 + 5, device="cpu", overrides=None):
    """The cell's driver at its small size (``overrides`` replace it)."""
    size = SMALL[cell_name] if overrides is None else overrides
    cell = harness.Cell(cell_name, {**size, "dtype": dtype})
    return harness.load_module(harness.HERE / "drivers" / f"{cell.workload['driver']}.py").Driver(cell, seed, device)
