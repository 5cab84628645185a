"""The benchmark's frozen work counts equal the bring-up's counts in
``chip_smoke.py`` at the cells' shapes, and give the bounds that PERF.md
prints: row 1a's 0.321 ms by bytes; row 4b's 0.5749 ms by operations less
the PI law's zero gains, which ``chip_smoke.py`` counts as a dense 2 x 10
law and the benchmark leaves out (a multiply and an add each), 0.4467 ms;
row 3e's 0.7814 ms by bytes for the whole collection, to which the
benchmark adds the six starting leaves per drive that
``chip_smoke.py::collect_bytes`` leaves out for the PMSM (it counts
``_ode_state_fields``, which the PMSM leaves empty): 0.7818 ms."""

import types

import pytest
import torch

import chip_smoke as cs
import exciting_environments_torch as ex
from portbench import harness
from portbench.work.peaks import least_seconds

B = 65536


def full_shapes(cell_name, overrides):
    """The driver's shapes, made at a small size and scaled to the cell's."""
    cell = harness.Cell(cell_name, overrides)
    driver = harness.load_module(harness.HERE / "drivers" / f"{cell.workload['driver']}.py").Driver(cell, 1, "cpu")
    shapes = driver.shapes()
    full = harness.Cell(cell_name)
    shapes.update(batch=full.batch, steps=full.steps, saves=full.steps if shapes["saves"] else 0)
    return full, shapes


def ms(work, cell, lib, shapes):
    ops, nbytes = work.work(cell.config["work"][lib], shapes)
    least, by = least_seconds(ops, nbytes)
    return least * 1e3, by, ops


def test_stepper():
    steps = 4096
    cell, shapes = full_shapes("pendulum-fleet-t4096", {"batch": 64, "chunk_steps": 8, "pool": 1})
    env = ex.Pendulum(batch_size=B, device="cpu")
    work = harness.load_module(harness.HERE / "work" / "stepper.py")
    got = ms(work, cell, "stepper", shapes)
    assert cs.ops_per_step(env, env._solver, False) == cell.config["work"]["stepper"]["ops_per_step"]
    assert got[:2] == pytest.approx(cs.bound(env, env._solver, B, steps, steps, 0, False), rel=1e-12)
    assert round(got[0], 3) == 0.321 and got[1] == "bytes"


def test_pmsm_closed_loop():
    cell, shapes = full_shapes("pmsm-brusa-pi-fleet-t2048", {"batch": 64, "chunk_steps": 8})
    env = ex.PMSM(batch_size=B, saturated=True, motor_variant=ex.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                  device="cpu")
    mix = cell.traffic["policy"]
    spec = ex.AffinePolicy(mix["K"], Ki=mix["Ki"]).kernel_spec(torch.float32, "cpu")
    (dense_ms, dense_by), dense_per_step = cs.pmsm_cl_bound(env, spec, B, 2048, 0, 2, 2)
    assert round(dense_ms, 4) == 0.5749 and dense_by == "operations"
    zero_gains = sum(g == 0 for rows in (mix["K"], mix["Ki"]) for row in rows for g in row)
    per_step = dense_per_step - 2 * zero_gains
    got = ms(harness.load_module(harness.HERE / "work" / "pmsm_closed_loop.py"), cell, "pmsm_closed_loop", shapes)
    assert zero_gains == 32 and per_step == 223 and got[2] == per_step * B * 2048
    assert got[0] == pytest.approx(dense_ms * per_step / dense_per_step, rel=1e-12)
    assert round(got[0], 4) == 0.4467 and got[1] == "operations"


def test_pmsm_stepper_and_the_collection():
    cell, shapes = full_shapes("pmsm-brusa-collect-t512", {"batch": 64, "chunk_steps": 8, "pool": 1,
                                                            "checked_rows": 8})
    env = harness.make_env(ex, cell, "cpu", per_drive={"r_s": torch.full((B,), 0.018)})
    work = harness.load_module(harness.HERE / "work" / "pmsm_stepper.py")
    got = ms(work, cell, "pmsm_stepper", shapes)
    assert got[:2] == pytest.approx(cs.pmsm_bound(env, env._solver, B, 512, 512), rel=1e-12)
    assert got[2] == cs.pmsm_ops(env, env._solver, 512, 512) * B
    assert cell.config["work"]["pmsm_stepper"]["table_values"] == env._lut.interleaved().numel()
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    batch = types.SimpleNamespace(actions=meta(B, 512, 2), observations=meta(B, 512, 10), rewards=meta(B, 512, 1),
                                  terminated=meta(B, 512, 1, dtype=torch.bool),
                                  truncated=meta(B, 512, 1, dtype=torch.bool))
    want = cs.collect_bytes(env, batch, 6, table=env._lut.interleaved().numel(), n_params=1)
    nbytes = work.collect_call_bytes(cell.config["work"]["pmsm_stepper"], shapes, cell.config["observation_columns"])
    assert round(least_seconds(0, want)[0] * 1e3, 4) == 0.7814
    assert nbytes == want + 4 * 6 * B
    least, by = least_seconds(0, nbytes)
    assert round(least * 1e3, 4) == 0.7818 and by == "bytes"
