"""The cell ``scim-sensorless-foc-fleet-t2048`` at a size a CPU run holds:
its plain reference against the port's CPU path (the closed-loop kernel's
plain version with the per-drive sensorless tile) in float64, its frozen
work count against the bring-up's count in ``chip_smoke.py``, a run made
not correct by each fault a cell can have (a step that returns its state,
half the batch left out of the running statistics, an answer altered, a
call that does not launch its kernel once), and the control (the reference
in bfloat16) failing a limit that the program's float32 run meets.  The
test marked ``gpu`` runs the control at the cell's own size on the card."""

import json

import pytest
import torch

import exciting_environments_torch as ex
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.kernels import closed_loop
from exciting_environments_torch.utils import fleet
from portbench import harness
from portbench.window import Window

CELL = "scim-sensorless-foc-fleet-t2048"
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
    return all(v <= limits.get(n, 1e-10) for r in readings for n, v in r.items())


def test_reference_meets_the_port_in_float64():
    d = driver()
    d.warmup(3)
    readings = d.compare(torch.float64)
    assert len(readings) == 2 and within(readings), readings


def test_later_calls_follow_from_the_programs_state():
    d = driver()
    d.warmup(2)
    window = Window(0.2, 7, 3)
    window.open()
    d.run_window(window)
    readings = d.compare(torch.float64)
    assert len(readings) >= 2 and within(readings), readings


def test_the_drives_start_cold_at_their_own_operating_points():
    """The traffic's speeds and setpoints reach the program per drive (the
    plant's omega, the tile's planes) and the fleet starts at rest with the
    tile's cold carry."""
    d = driver()
    omega = d.env.env_properties.static_params.omega
    assert torch.equal(omega, d.params["omega"]) and omega.shape == (16,) and float(omega.abs().max()) <= 628.3
    assert float(d.setpoints["torque"].abs().max()) <= 4.38
    spec = d.policy.kernel_spec(torch.float64, "cpu")
    assert torch.equal(spec.planes[0], omega) and torch.equal(spec.planes[1], d.setpoints["torque"])
    assert closed_loop.kernel_variant(4, spec) == "sensorless_foc_per_drive"
    st, carry = d.state
    assert all(float(getattr(st.physical_state, n).abs().max()) == 0.0 for n in d.env._ode_state_fields)
    assert [float(c.abs().max()) for c in carry] == [0.0] * 7 + [1.0]
    assert d.solved == {"solves": 1, "drives": 16}


def test_the_reference_holds_the_configurations_constants():
    cfg = harness.Cell(CELL).config
    ref = harness.load_module(harness.HERE / "reference" / "scim_gem.py")
    sp, law = cfg["static_params"], cfg["law"]
    assert (ref.R_S, ref.R_R, ref.L_M, ref.L_S, ref.L_R, ref.P) == (sp["r_s"], sp["r_r"], sp["l_m"], pytest.approx(
        sp["l_s"], rel=1e-12), pytest.approx(sp["l_r"], rel=1e-12), sp["p"])
    assert (ref.PSI_STAR, ref.I_MAX, ref.KP, ref.KI, ref.KP_PSI, ref.KI_PSI, ref.PSI_FLOOR) == (
        law["psi_ref"], law["i_max"], law["kp"], law["ki"], law["kp_psi"], law["ki_psi"], law["psi_floor"])
    assert ref.U_DC == cfg["kwargs"]["u_dc"] and ref.TAU == cfg["kwargs"]["tau"]
    assert cfg["action_normalizations"]["u_sd"] == [-ref.U_LIM, ref.U_LIM] == cfg["action_normalizations"]["u_sq"]
    assert ref.SENSOR_STD == cfg["sensor_std"]["i_sd"] == cfg["sensor_std"]["i_sq"]
    norms = ex.InductionMachine(batch_size=1, device="cpu").env_properties.physical_normalizations
    assert (norms.i_sd.max, norms.psi_rd.max) == (ref.BANDS["i"], ref.BANDS["psi"])
    assert json.loads((harness.HERE / "traffic" / "foc-operating-points-t2048.json").read_text())["chunk_steps"] == 2048


def test_work_count():
    """The frozen count, 235 operations a drive-step, equals
    ``chip_smoke.py::cl_bound``'s for the cell's per-drive tile; at B =
    65,536 and 2,048 steps its least time is 0.4708 ms by operations."""
    import chip_smoke as cs
    from portbench.work.peaks import least_seconds

    d = driver("float32")
    spec = d.policy.kernel_spec(torch.float32, "cpu")
    full = harness.Cell(CELL)
    shapes = {**d.shapes(), "batch": full.batch, "steps": full.steps}
    work = harness.load_module(harness.HERE / "work" / "closed_loop.py")
    ops, nbytes = work.work(full.config["work"]["closed_loop"], shapes)
    (want_ms, want_by), per_step = cs.cl_bound(d.env, spec, full.batch, full.steps, 0, 8, 0)
    assert per_step == full.config["work"]["closed_loop"]["ops_per_step"] == 235
    assert ops == per_step * full.batch * full.steps
    least, by = least_seconds(ops, nbytes)
    assert (least * 1e3, by) == (pytest.approx(want_ms, rel=1e-12), want_by)
    assert round(least * 1e3, 4) == 0.4708 and by == "operations"
    assert nbytes == 4 * (full.batch * (2 * 4 + 2 * 8 + 1 + 15) + spec.flat.numel())


def unchanged(monkeypatch):
    def loop(env, state, policy, n_steps, policy_carry=None, **kw):
        return env.generate_observation(state, env.env_properties), state, tuple(policy_carry)
    monkeypatch.setattr(closed_loop, "env_fused_closed_loop", loop)


def half_batch(monkeypatch):
    original = fleet.running_update
    monkeypatch.setattr(fleet, "running_update",
                        lambda stats, values, axis=None: original(stats, values[: values.shape[0] // 2], axis))


def altered(monkeypatch):
    original = closed_loop.env_fused_closed_loop
    bump = lambda leaf: torch.cat([leaf[:3], 1.5 * leaf[3:4] + 1.0, leaf[4:]])

    def loop(env, state, policy, n_steps, **kw):
        obs, final, carry = original(env, state, policy, n_steps, **kw)
        final = structures.replace(final, physical_state=structures.replace(
            final.physical_state, i_sq=bump(final.physical_state.i_sq)))
        return env.generate_observation(final, env.env_properties), final, carry
    monkeypatch.setattr(closed_loop, "env_fused_closed_loop", loop)


def extra_launch(monkeypatch):
    """Each call counts one launch more than it makes (on the CPU, where the
    program's plain path launches none, one)."""
    counter = harness.launch_counters(["closed_loop"])["closed_loop"]
    original = harness.Window.complete

    def complete(self, *args, **kwargs):
        counter.launches["closed_loop"] += 1
        return original(self, *args, **kwargs)
    monkeypatch.setattr(harness.Window, "complete", complete)


def test_a_sound_run_is_correct():
    result = run()
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert result["checks"]["launch_gap"] == {"value": 0.0, "limit": 0.0}
    assert set(result["checks"]) == {"final_gap", "stats_gap", "count_gap", "launch_gap"}


def test_a_traced_run_that_finds_no_kernel_gives_no_result():
    with pytest.raises(harness.MissingReading):
        run(trace=True)


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered, extra_launch], ids=lambda f: f.__name__)
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    result = run()
    assert result["correct"] is False and result["failed"] > 0, result["checks"]


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
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


def test_control_fails_a_limit():
    check(*readings("cpu", {**SMALL, "chunk_steps": 400}))


@pytest.mark.gpu
def test_control_fails_a_limit_at_the_cells_size(card):
    check(*readings(card, {}, seconds=2.0))
