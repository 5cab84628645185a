"""The cell ``pmsm-brusa-sched-sensorless-fleet-t2048`` at a size a CPU run
holds: its plain reference against the port's CPU path (the closed-loop
kernel's plain version with the per-drive gain-scheduled tile) in float64,
its frozen work count against ``chip_smoke.py``'s count, a run made not
correct by each fault the cell can have (every drive on the schedule's
first slice, each drive on its neighbour's slice, every slice holding one
speed's gains, the references swapped between drives, a step that returns
its state, a call that does not launch its kernel once), the wrong slices
caught by the set-up's cold-start call (``transient_gap``) at the cell's
own chunk of 2,048 steps, and the control (the reference in bfloat16)
failing a limit that the program's float32 run meets.  The tests marked
``gpu`` run the control and the wrong slices at the cell's own size on the
card."""

import json
import math

import pytest
import torch

from exciting_environments_torch.ops.kernels import pmsm_closed_loop
from exciting_environments_torch.ops.lut import ScheduledLUT
from exciting_environments_torch.utils import foc
from portbench import harness
from portbench.window import Window

CELL = "pmsm-brusa-sched-sensorless-fleet-t2048"
SMALL = {"batch": 16, "chunk_steps": 40}
SEED = 2**31 + 77


def driver(dtype="float64", seed=2**31 + 5, size=None, device="cpu"):
    cell = harness.Cell(CELL, {**(SMALL if size is None else size), "dtype": dtype})
    return harness.load_module(harness.HERE / "drivers" / f"{cell.workload['driver']}.py").Driver(cell, seed, device)


def run(trace=False):
    return harness.run_cell(CELL, SEED, 0.3, trace, "cpu", overrides={**SMALL, "dtype": "float32"},
                            log=lambda line: None)


def within(readings):
    limits = {"count_gap": 0.0, "stats_gap": 1e-6}
    return all(v <= limits.get(n, 1e-8) for r in readings for n, v in r.items())


def test_reference_meets_the_port_in_float64():
    d = driver()
    d.warmup(3)
    readings = d.compare(torch.float64)
    assert len(readings) == 2 and within(readings), readings


def test_the_drives_hold_their_own_operating_points_on_the_speed_grid():
    """The traffic's speeds (the 32-speed grid) and references reach the
    program per drive (the plant's speed, the tile's planes, a slice of the
    schedule per distinct speed) and the observer starts cold."""
    d = driver()
    grid = torch.linspace(0.0, 1000.0, 32, dtype=torch.float64)
    omega = d.state[0].physical_state.omega_el
    assert torch.equal(omega, d.omega) and omega.shape == (16,)
    assert all(bool((grid == w).any()) for w in omega.tolist())
    speeds = torch.unique(omega)
    assert d.sched.n_slices == len(speeds) and torch.equal(speeds[d.sched.slices.long()], omega)
    spec = d.policy.kernel_spec(torch.float64, "cpu")
    assert torch.equal(spec.planes[0], d.refs["i_d"]) and torch.equal(spec.planes[1], d.refs["i_q"])
    assert torch.equal(spec.planes[4], omega) and pmsm_closed_loop.kernel_variant(d.policy) == "scheduled_drive"
    carry = d.state[1]
    assert [float(c[0]) for c in carry] == [1.0, 0.0, 0.0, 0.0, 0.0, 0.0]
    assert d.solved == {"slices": len(speeds), "points": 28 * 53 * len(speeds), "drives": 16}


def test_the_reference_holds_the_configurations_constants():
    cell = harness.Cell(CELL)
    cfg, ref = cell.config, harness.load_module(harness.HERE / "reference" / "pmsm_brusa_sensorless.py")
    assert (ref.BANDWIDTH, ref.T_I, ref.Q_FLOOR) == (cfg["law"]["bandwidth"], cfg["law"]["t_i"], cfg["law"]["q_floor"])
    assert ref.SENSOR_STD == cfg["sensor_std"]["i_d"] == cfg["sensor_std"]["i_q"]
    assert ref.TAU == cfg["kwargs"]["tau"] and cfg["static_params"]["deadtime"] == ref.plant.DEADTIME == 1
    mix = json.loads((harness.HERE / "traffic" / "sched-operating-grid-t2048.json").read_text())
    assert mix["chunk_steps"] == 2048 and mix["speed_grid"] == {"lo": 0.0, "hi": 1000.0, "n": 32}


def test_work_count():
    """The frozen count, 424 operations a drive-step, equals
    ``chip_smoke.py::pmsm_cl_ops_per_step`` for the per-drive scheduled tile
    (ten scheduled channels, the currents' columns only); at B = 65,536 and
    2,048 steps its least time is 0.8494 ms by operations."""
    import chip_smoke as cs
    from portbench.work.peaks import least_seconds

    d = driver("float32")
    spec = d.policy.kernel_spec(torch.float32, "cpu")
    full = harness.Cell(CELL)
    counts = full.config["work"]["pmsm_closed_loop"]
    per_step = cs.pmsm_cl_ops_per_step(d.env, spec, 2, 10, 0, 0)
    assert per_step == counts["drive_ops_per_step"] == 424
    assert counts["table_values"] == 28 * 53 * (6 + 32 * 10)
    shapes = {**d.shapes(), "batch": full.batch, "steps": full.steps}
    work = harness.load_module(harness.HERE / "work" / "pmsm_closed_loop.py")
    ops, nbytes = work.work(counts, shapes)
    assert ops == per_step * full.batch * full.steps
    least, by = least_seconds(ops, nbytes)
    assert round(least * 1e3, 4) == 0.8494 and by == "operations"
    assert nbytes == 4 * (full.batch * (6 + 2 + 2 * 6 + 6 + 8) + spec.flat.numel() + counts["table_values"])


def one_slice(monkeypatch):
    """Every drive gathers the schedule's first slice."""
    original = foc.make_pmsm_saturated_sensorless_current_tile

    def factory(*args, **kwargs):
        policy, carry, sched = original(*args, **kwargs)
        first = ScheduledLUT(sched.values, sched.carry_idx, torch.zeros_like(sched.slices))
        policy.sched_lut = first
        return policy, carry, first
    monkeypatch.setattr(foc, "make_pmsm_saturated_sensorless_current_tile", factory)
    monkeypatch.setattr("exciting_environments_torch.make_pmsm_saturated_sensorless_current_tile", factory)


def neighbour_slice(monkeypatch):
    """Every drive gathers a slice beside its own: the next speed's, the
    last slice's drives the one before."""
    original = foc.make_pmsm_saturated_sensorless_current_tile

    def factory(*args, **kwargs):
        policy, carry, sched = original(*args, **kwargs)
        last = sched.n_slices - 1
        shifted = ScheduledLUT(sched.values, sched.carry_idx,
                               torch.where(sched.slices < last, sched.slices + 1, sched.slices - 1))
        policy.sched_lut = shifted
        return policy, carry, shifted
    monkeypatch.setattr(foc, "make_pmsm_saturated_sensorless_current_tile", factory)
    monkeypatch.setattr("exciting_environments_torch.make_pmsm_saturated_sensorless_current_tile", factory)


def one_speed_gains(monkeypatch):
    """Every slice holds the gains of the grid's last speed, as a schedule
    solved at one speed would."""
    original = foc.make_pmsm_saturated_sensorless_current_tile

    def factory(*args, **kwargs):
        policy, carry, sched = original(*args, **kwargs)
        values = torch.as_tensor(sched.values)
        stale = ScheduledLUT(values[-1:].expand_as(values).clone(), sched.carry_idx, sched.slices)
        policy.sched_lut = stale
        return policy, carry, stale
    monkeypatch.setattr(foc, "make_pmsm_saturated_sensorless_current_tile", factory)
    monkeypatch.setattr("exciting_environments_torch.make_pmsm_saturated_sensorless_current_tile", factory)


def swapped_references(monkeypatch):
    """The controller tracks its neighbour's references."""
    original = foc.make_pmsm_saturated_sensorless_current_tile

    def factory(model, *, i_d_ref, i_q_ref, **kwargs):
        return original(model, i_d_ref=i_d_ref.roll(1), i_q_ref=i_q_ref.roll(1), **kwargs)
    monkeypatch.setattr(foc, "make_pmsm_saturated_sensorless_current_tile", factory)
    monkeypatch.setattr("exciting_environments_torch.make_pmsm_saturated_sensorless_current_tile", factory)


def unchanged(monkeypatch):
    def loop(env, state, policy, n_steps, policy_carry=None, **kw):
        return env.generate_observation(state, env.env_properties), state, tuple(policy_carry)
    monkeypatch.setattr(pmsm_closed_loop, "pmsm_fused_closed_loop", loop)


def extra_launch(monkeypatch):
    counter = harness.launch_counters(["pmsm_closed_loop"])["pmsm_closed_loop"]
    original = harness.Window.complete

    def complete(self, *args, **kwargs):
        counter.launches["pmsm_closed_loop"] += 1
        return original(self, *args, **kwargs)
    monkeypatch.setattr(harness.Window, "complete", complete)


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert set(result["checks"]) == {"final_gap", "stats_gap", "count_gap", "transient_gap", "launch_gap"}


@pytest.mark.parametrize("fault", [one_slice, neighbour_slice, one_speed_gains, swapped_references, unchanged,
                                   extra_launch], ids=lambda f: f.__name__)
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    result = run()
    assert result["correct"] is False and result["failed"] > 0, result["checks"]


WRONG_SLICES = [one_slice, neighbour_slice, one_speed_gains]


def slice_readings(monkeypatch, fault, device, size):
    """The largest reading of each compared number, over a run of the cell
    at ``size`` (its own chunk of 2,048 steps) with ``fault`` in place."""
    if fault is not None:
        fault(monkeypatch)
    d = driver("float32", 2**31 + 13, size, device)
    d.warmup(1)
    d.release()
    readings = d.compare(torch.float64)
    return d.cell.workload["limits"], {k: max(r[k] for r in readings) for k in readings[0]}


@pytest.mark.parametrize("fault", [None, *WRONG_SLICES], ids=lambda f: getattr(f, "__name__", "sound"))
def test_the_cold_start_sees_the_slice_at_the_cells_chunk(monkeypatch, fault):
    """At the cell's chunk of 2,048 steps the chunk ends at the observer's
    fixed point, so a drive on a wrong slice shows in ``transient_gap``: a
    sound run within every limit, a wrong slice over the transient's
    (B = 4,096: the neighbouring slice reads 0.23 here, 1.1 at the cell's
    batch, whose more drives rail the voltage circle in the transient)."""
    limits, worst = slice_readings(monkeypatch, fault, "cpu", {"batch": 4096})
    if fault is None:
        assert all(worst[k] <= limits[k] for k in limits), worst
    else:
        assert worst["transient_gap"] > limits["transient_gap"], worst


@pytest.mark.gpu
@pytest.mark.parametrize("fault", WRONG_SLICES, ids=lambda f: f.__name__)
def test_a_wrong_slice_fails_at_the_cells_size(monkeypatch, card, fault):
    """B = 65,536 over the 32 slices: each wrong slice over the transient's
    limit, or some drive's loop diverging, which the program's own gate
    (``FleetRunner``'s non-finite statistics) stops at set-up, so that the
    run exits with no result."""
    try:
        limits, worst = slice_readings(monkeypatch, fault, card, {})
    except FloatingPointError as stopped:
        print(f"[sched] {fault.__name__}: stopped at set-up: {stopped}")
        return
    print(f"[sched] {fault.__name__}: {worst}")
    assert worst["transient_gap"] > limits["transient_gap"], worst


def readings(device, size=None, seconds=0.3, seed=2**31 + 9):
    d = driver("float32", seed, size, device)
    d.warmup(harness.WARMUP_CALLS)
    window = Window(seconds, seed, harness.CHECKED_CALLS)
    window.open()
    d.run_window(window)
    harness.sync(device)
    d.release()
    worst = lambda rs: {k: max(r[k] for r in rs) for k in rs[0]}
    return d.cell.workload["limits"], worst(d.compare(torch.float64)), worst(d.compare(control=True))


def check(limits, program, control):
    """The program within every limit; the control outside one, as the
    harness counts it (a reading that is not finite is outside: the control
    diverges at the cell's size)."""
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(not math.isfinite(control[k]) or control[k] > limits[k] for k in limits), control


def test_control_fails_a_limit():
    check(*readings("cpu", {**SMALL, "chunk_steps": 400}))


@pytest.mark.gpu
def test_control_fails_a_limit_at_the_cells_size(card):
    check(*readings(card, {}, seconds=2.0))
