"""The gain-scheduled sensorless tile of ``utils/foc.py`` over a fleet whose
drives each hold their own operating point: ``(B,)`` references and speeds
in ``make_pmsm_saturated_sensorless_current_tile``, one slice of the
schedule per distinct speed (``ScheduledLUT`` with ``slices``), and
``csrc/pmsm_closed_loop.cu::ScheduledDriveLaw``, which reads the operating
point from per-drive planes and gathers its drive's slice.

On the CPU (float64 unless stated): each slice's ten maps against the scalar
factory's at that speed and the per-drive plain closed loop against the
scalar tile built at each drive's speed and references, within 1e-10 (the
scalar factory's fixed point stops at a step of 1e-13, not at its limit);
the slices against the JAX package's scalar factory at two speeds; the
refusals; the counter ``foc.SCHEDULE_SOLVES`` and the span
``ee.sched.solve``; ``FleetRunner.run_policy`` with the schedule; the staged
launch's slice tiling (``pmsm_closed_loop.py::slice_tiling``) as a pure
function.  The tests marked ``gpu`` hold the kernel to the plain per-drive
tile, 0.0, on the global path and on the staged path (B = 65,536, with the
counts of ``SLICE_STAGING``), a fleet run to one tiling a launch plan, and
row 4c's scalar launch to its plain version.  Only the JAX comparison imports
JAX, inside its test, so on the card the file runs with
``--noconftest``."""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import exciting_environments_torch as P
from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
from exciting_environments_torch.ops.lut import ScheduledLUT
from exciting_environments_torch.utils import collect, foc
from exciting_environments_torch.utils.fleet import FleetRunner

SENSORS = {"i_d": 2.5, "i_q": 2.5}
SPEEDS = (0.0, 500.0, 1000.0)
T = 64


def _params():
    return dict(P.MotorVariant.BRUSA.get_params().static_params.__dict__, deadtime=1, l_d=math.nan, l_q=math.nan,
                psi_p=math.nan)


def _env(batch, dtype=torch.float64, device="cpu"):
    return P.PMSM(batch_size=batch, saturated=True, motor_variant=P.MotorVariant.BRUSA, tau=1e-4,
                  control_state=["i_d", "i_q"], static_params=_params(), device=device, dtype=dtype)


def _operating_points(batch, speeds, dtype, device, seed=0):
    """Each drive's speed from ``speeds`` and its references, drawn."""
    gen = torch.Generator().manual_seed(seed)
    omega = torch.tensor(speeds, dtype=torch.float64)[torch.randint(0, len(speeds), (batch,), generator=gen)]
    i_d = -200.0 + 190.0 * torch.rand(batch, generator=gen, dtype=torch.float64)
    i_q = -150.0 + 300.0 * torch.rand(batch, generator=gen, dtype=torch.float64)
    return tuple(t.to(dtype=dtype, device=device) for t in (i_d, i_q, omega))


def _start(env, i_d_ref, i_q_ref, omega, seed=1):
    """A drawn start: currents, angle and buffers, the speed held per drive."""
    gen = torch.Generator().manual_seed(seed)
    draw = lambda lo, hi: (lo + (hi - lo) * torch.rand(env.batch_size, generator=gen, dtype=torch.float64)).to(
        dtype=env.dtype, device=env.device)
    _, state = env.vmap_reset()
    phys = state.physical_state
    phys.i_d, phys.i_q, phys.epsilon = draw(-200.0, -10.0), draw(-150.0, 150.0), draw(-math.pi, math.pi)
    phys.u_d_buffer, phys.u_q_buffer, phys.omega_el = draw(-50.0, 50.0), draw(-50.0, 50.0), omega.clone()
    state.reference.i_d, state.reference.i_q = i_d_ref.clone(), i_q_ref.clone()
    return state


def _loop_inputs(env, state):
    phys = state.physical_state
    pn = env.env_properties.physical_normalizations
    refs = tuple(getattr(pn, n).normalize(getattr(state.reference, n)) for n in env.control_state)
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    kw = dict(tau=env.tau, solver=env._solver, props=env.env_properties, ref_leaves=refs)
    return state0, phys.omega_el, kw


@pytest.fixture(scope="module")
def fleet():
    env = _env(8)
    i_d, i_q, omega = _operating_points(8, SPEEDS, torch.float64, "cpu")
    tile, carry0, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=i_d, i_q_ref=i_q, omega_el=omega, measurement_std=SENSORS)
    return env, (i_d, i_q, omega), tile, carry0, sched


def test_the_per_drive_factory_holds_one_slice_per_speed(fleet):
    env, (i_d, i_q, omega), tile, carry0, sched = fleet
    nx, ny = env._lut.nx, env._lut.ny
    assert sched.values.shape == (3, 10, nx, ny) and sched.n_slices == 3 and sched.carry_idx == (0, 1)
    assert sched.slices.dtype == torch.int32 and sched.slices.shape == (8,)
    assert torch.equal(torch.tensor(SPEEDS, dtype=torch.float64)[sched.slices.long()], omega)
    assert tile.per_drive and tile.n_obs == 20 and tile.n_carry == 6 and len(carry0) == 6
    assert PCL.kernel_variant(tile) == "scheduled_drive"
    spec = tile.kernel_spec(torch.float64, "cpu")
    assert tile.PLANES == ("REF_D", "REF_Q", "FF_D", "FF_Q", "OMEGA") and len(spec.planes) == 5
    r_s = float(env.env_properties.static_params.r_s)
    for plane, want in zip(spec.planes, (i_d, i_q, r_s * i_d, r_s * i_q, omega)):
        assert torch.equal(plane, want)
    slots = dict(zip(tile.SLOTS, spec.flat.tolist()))
    assert all(slots[name] == 0.0 for name in tile.PLANES)
    # the magnetics are the drive's own table in every slice
    assert all(np.array_equal(s[:6], env._lut.values.numpy()) for s in sched.values)


def test_each_slice_and_each_drive_is_the_scalar_tile_at_its_operating_point(fleet):
    """Maps within 1e-10 of the scalar factory's at the slice's speed, and 64
    steps of the per-drive plain closed loop within 1e-10 of the scalar tile
    built at each drive's speed and references."""
    env, (i_d, i_q, omega), tile, carry0, sched = fleet
    state = _start(env, i_d, i_q, omega)
    state0, om, kw = _loop_inputs(env, state)
    final, u_last, carry, _, _ = PCL.plain_pmsm_closed_loop(env, state0, om, tile, T, policy_carry=carry0,
                                                            sched_lut=sched, **kw)
    assert all(bool(torch.isfinite(x).all()) for x in (*final, *carry))
    for b in range(env.batch_size):
        s_tile, s_c0, s_sched = foc.make_pmsm_saturated_sensorless_current_tile(
            env, i_d_ref=float(i_d[b]), i_q_ref=float(i_q[b]), omega_el=float(omega[b]), measurement_std=SENSORS)
        assert not s_tile.per_drive and s_sched.n_slices == 0
        np.testing.assert_allclose(sched.values[int(sched.slices[b])], s_sched.values, rtol=0, atol=1e-10)
        s_final, s_u, s_carry, _, _ = PCL.plain_pmsm_closed_loop(env, state0, om, s_tile, T, policy_carry=s_c0,
                                                                 sched_lut=s_sched, **kw)
        for got, want in zip((*final, *u_last, *carry), (*s_final, *s_u, *s_carry)):
            assert abs(float(got[b]) - float(want[b])) <= 1e-10 * max(1.0, abs(float(want[b])))


def test_the_slices_match_the_jax_scalar_factory_at_two_speeds():
    import exciting_environments_tpu as J
    from exciting_environments_tpu.utils import foc as jfoc

    speeds = (250.0, 1000.0)
    env = _env(4)
    omega = torch.tensor([speeds[1], speeds[0], speeds[1], speeds[0]], dtype=torch.float64)
    _, _, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=torch.full((4,), -100.0, dtype=torch.float64), i_q_ref=50.0, omega_el=omega,
        measurement_std=SENSORS)
    je = J.PMSM(batch_size=4, saturated=True, motor_variant=J.MotorVariant.BRUSA, static_params=_params())
    for s, w in enumerate(speeds):
        _, _, j_sched = jfoc.make_pmsm_saturated_sensorless_current_tile(je, i_d_ref=-100.0, i_q_ref=50.0,
                                                                         omega_el=w, measurement_std=SENSORS)
        np.testing.assert_allclose(sched.values[s], np.asarray(j_sched.values), rtol=1e-9, atol=1e-12)


def test_schedule_solves_count_one_slice_per_distinct_speed_inside_the_span():
    env = _env(6)
    omega = torch.tensor([0.0, 1000.0, 0.0, 0.0, 1000.0, 0.0], dtype=torch.float64)
    before = dict(foc.SCHEDULE_SOLVES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        foc.make_pmsm_saturated_sensorless_current_tile(env, i_d_ref=-50.0, i_q_ref=20.0, omega_el=omega,
                                                        measurement_std=SENSORS)
    points = env._lut.nx * env._lut.ny
    assert foc.SCHEDULE_SOLVES == {"slices": before["slices"] + 2, "points": before["points"] + 2 * points,
                                   "drives": before["drives"] + 6}
    foc.make_pmsm_saturated_sensorless_current_tile(env, i_d_ref=-50.0, i_q_ref=20.0, omega_el=500.0,
                                                    measurement_std=SENSORS)
    assert foc.SCHEDULE_SOLVES == {"slices": before["slices"] + 3, "points": before["points"] + 3 * points,
                                   "drives": before["drives"] + 7}
    assert sum(e.name == "ee.sched.solve" for e in prof.events()) == 1


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=str)
def test_the_fleet_runner_hands_the_schedule_to_every_chunk(dtype):
    """``FleetRunner.run_policy`` with the tile and its carry over two chunks
    equals the closed loop's own two calls with the factory's schedule,
    carry threaded between them: the tile holds its schedule."""
    env = _env(6, dtype)
    i_d, i_q, omega = _operating_points(6, (0.0, 1000.0), dtype, "cpu", seed=4)
    tile, carry0, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=i_d, i_q_ref=i_q, omega_el=omega, measurement_std=SENSORS)
    state = _start(env, i_d, i_q, omega, seed=5)
    final, carry = FleetRunner(env).run_policy(state, tile, 2, 16, policy_carry=carry0)
    st, c = state, carry0
    for _ in range(2):
        _, st, c = env.fused_closed_loop(st, tile, 16, policy_carry=c, sched_lut=sched)
    assert torch.equal(final.physical_state.i_d, st.physical_state.i_d)
    assert torch.equal(final.physical_state.i_q, st.physical_state.i_q)
    assert all(torch.equal(a, b) for a, b in zip(carry, c))


@pytest.mark.parametrize("per_drive", [False, True], ids=["scalar", "per_drive"])
def test_the_closed_loop_reads_the_schedule_the_tile_holds(per_drive):
    """The factory's tile holds the schedule it returns; the closed loop and
    ``tile_policy_scan`` given none gather that one, as if it were given."""
    env = _env(6)
    i_d, i_q, omega = _operating_points(6, SPEEDS, torch.float64, "cpu", seed=6)
    point = dict(i_d_ref=i_d, i_q_ref=i_q, omega_el=omega) if per_drive else \
        dict(i_d_ref=-100.0, i_q_ref=50.0, omega_el=500.0)
    tile, carry0, sched = foc.make_pmsm_saturated_sensorless_current_tile(env, measurement_std=SENSORS, **point)
    assert tile.sched_lut is sched and tile.per_drive == per_drive
    state = _start(env, i_d, i_q, omega if per_drive else torch.full_like(omega, 500.0), seed=7)
    given = env.fused_closed_loop(state, tile, 12, policy_carry=carry0, sched_lut=sched)
    held = env.fused_closed_loop(state, tile, 12, policy_carry=carry0)
    assert torch.equal(given[0], held[0]) and all(torch.equal(a, b) for a, b in zip(given[2], held[2]))
    scan = collect.tile_policy_scan(env, state, 12, tile, None, False, policy_carry=carry0)
    scan_given = collect.tile_policy_scan(env, state, 12, tile, None, False, policy_carry=carry0, sched_lut=sched)
    assert torch.equal(scan[0], scan_given[0]) and all(torch.equal(a, b) for a, b in zip(scan[-1], scan_given[-1]))


def test_refusals():
    env = _env(4)
    refs = dict(i_d_ref=-50.0, i_q_ref=20.0, measurement_std=SENSORS)
    too_many = torch.arange(257, dtype=torch.float64)
    with pytest.raises(ValueError, match="257 distinct speeds.*at most 256"):
        foc.make_pmsm_saturated_sensorless_current_tile(_env(257), omega_el=too_many, **refs)
    for bad in (torch.zeros(3, dtype=torch.float64), torch.zeros(4, dtype=torch.float32),
                torch.zeros(4, dtype=torch.float64, device="meta")):
        with pytest.raises(ValueError, match=r"a per-drive omega_el is a \(4,\) tensor"):
            foc.make_pmsm_saturated_sensorless_current_tile(env, omega_el=bad, **refs)
    values = np.zeros((2, 10, env._lut.nx, env._lut.ny))
    with pytest.raises(ValueError, match="slices must index"):
        ScheduledLUT(values, slices=torch.tensor([0, 2, 1, 0]))
    with pytest.raises(ValueError, match="integer tensor"):
        ScheduledLUT(values, slices=torch.zeros(4))
    with pytest.raises(ValueError, match=r"\(S, C, nx, ny\) with slices"):
        ScheduledLUT(values)
    tile, c0, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, omega_el=torch.zeros(4, dtype=torch.float64), **refs)
    _, state = env.vmap_reset()
    short = ScheduledLUT(sched.values, slices=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="one slice per drive"):
        env.fused_closed_loop(state, tile, 2, policy_carry=c0, sched_lut=short)


def _shared_memory(dtype):
    """``(slice_bytes, free_bytes)`` of the per-drive tile's launch on the
    BRUSA grid in ``dtype``: one interleaved slice of the schedule, and the
    shared memory a block has left after the magnetics table, the tile's flat
    slots and the 16 rotations, from the next 16-byte boundary."""
    lut = _env(2)._lut
    itemsize = torch.tensor([], dtype=dtype).element_size()
    n_slots = len(foc.ScheduledSensorlessPolicy.SLOTS)
    used = (lut.nx * lut.ny * 8 + n_slots + 16) * itemsize
    return lut.nx * lut.ny * 12 * itemsize, PCL.MAX_DYNAMIC_SMEM - -(-used // 16) * 16


def _slice_draw(batch, n_slices, weights=None, seed=0):
    gen = torch.Generator().manual_seed(seed)
    if weights is None:
        return torch.randint(0, n_slices, (batch,), generator=gen, dtype=torch.int32)
    return torch.multinomial(torch.as_tensor(weights, dtype=torch.float64), batch, replacement=True,
                             generator=gen).to(torch.int32)


#: name: (drives, slices, weights of the slices or None for uniform, dtype,
#: SMs, (threads, blocks) expected, staged share expected: 1.0 every drive,
#: "some" above 0 and below 1, None the global path)
TILINGS = {
    "cell": (65536, 32, None, torch.float32, 132, (512, 128), 1.0),
    "200_slices": (65536, 200, None, torch.float32, 132, (512, 128), "some"),
    "float64": (65536, 32, None, torch.float64, 132, None, None),
    "uneven_ragged": (4141, 7, [1, 1, 1, 1, 1, 1, 300], torch.float32, 132, (32, 130), "some"),
    "one_slice": (1000, 1, None, torch.float32, 132, (32, 32), 1.0),
    "two_waves": (200000, 32, None, torch.float32, 132, (512, 391), 1.0),
}


@pytest.mark.parametrize("case", list(TILINGS))
def test_the_slice_tiling_orders_every_drive_once_and_stages_what_fits(case):
    """``slice_tiling`` as a pure function of the slice plane, the slice's
    size, the free shared memory and the SM count: every drive once, ties in
    drive order, each block's staged slices within its shared memory and
    among the slices of its range, one wave where the fleet allows, and the
    staged share recounted here from the blocks' ranges."""
    batch, n_slices, weights, dtype, n_sm, shape, share = TILINGS[case]
    slices = _slice_draw(batch, n_slices, weights)
    slice_bytes, free_bytes = _shared_memory(dtype)
    tiling = PCL.slice_tiling(slices, n_slices, slice_bytes, free_bytes, n_sm, PCL.STAGED_THREADS[dtype])
    if share is None:
        assert tiling is None and free_bytes < slice_bytes
        return
    perm = tiling.perm
    assert perm.dtype == torch.int32 and torch.equal(perm.sort().values, torch.arange(batch, dtype=torch.int32))
    ordered = slices[perm.long()]
    assert bool((ordered[1:] >= ordered[:-1]).all())
    ties = ordered[1:] == ordered[:-1]
    assert bool((perm[1:][ties] > perm[:-1][ties]).all())
    assert (tiling.threads, tiling.blocks) == shape and tiling.threads % 32 == 0
    assert (tiling.blocks - 1) * tiling.threads < batch <= tiling.blocks * tiling.threads
    if batch <= n_sm * PCL.STAGED_THREADS[dtype]:
        assert tiling.blocks <= n_sm
    assert 1 <= tiling.n_staged <= PCL.MAX_STAGED and tiling.n_staged * slice_bytes <= free_bytes
    assert tiling.block_slices.dtype == torch.int32 and tiling.block_slices.is_contiguous()
    staged = 0
    for blk, row in enumerate(tiling.block_slices.tolist()):
        mine = ordered[blk * tiling.threads:(blk + 1) * tiling.threads]
        present = set(mine.tolist())
        held = [s for s in row if s >= 0]
        assert len(set(held)) == len(held) and set(held) <= present
        assert len(held) == min(tiling.n_staged, len(present))
        staged += sum(int((mine == s).sum()) for s in held)
    assert tiling.staged == staged
    if share == 1.0:
        assert staged == batch
    else:
        assert 0 < staged < batch


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")


def _flat(out):
    final, u_last, carry, traj, traj_carry = out
    return [*final, *u_last, *carry, *(traj or ()), *(traj_carry or ())]


def _max_abs(a, b):
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,stride", [(torch.float32, None), (torch.float32, 1), (torch.float64, 8)], ids=str)
def test_the_per_drive_kernel_is_the_plain_per_drive_tile(dtype, stride):
    """B = 4,096 drives over 7 speed slices, T = 64: the kernel's
    ``ScheduledDriveLaw`` launch equals the plain per-drive tile, 0.0."""
    _cuda()
    batch = 4096
    env = _env(batch, dtype, "cuda")
    i_d, i_q, omega = _operating_points(batch, tuple(np.linspace(0.0, 1000.0, 7)), dtype, "cuda", seed=7)
    tile, carry0, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=i_d, i_q_ref=i_q, omega_el=omega, measurement_std=SENSORS)
    assert sched.n_slices == 7
    state0, om, kw = _loop_inputs(env, _start(env, i_d, i_q, omega, seed=8))
    kw.update(policy_carry=carry0, sched_lut=sched, traj_stride=stride)
    before = dict(PCL.VARIANT_LAUNCHES)
    got = _flat(PCL.kernel_pmsm_closed_loop(env, state0, om, tile, T, **kw))
    torch.cuda.synchronize()
    assert PCL.VARIANT_LAUNCHES["scheduled_drive"] == before["scheduled_drive"] + 1
    assert PCL.VARIANT_LAUNCHES["scheduled"] == before["scheduled"]
    want = _flat(PCL.plain_pmsm_closed_loop(env, state0, om, tile, T, **kw))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _max_abs(got, want) == 0.0


@pytest.fixture(scope="module")
def big_fleet():
    """B = 65,536 float32 drives over 32 speeds drawn unevenly (slice s
    weighs 1 + s), the tile solved once on the card."""
    _cuda()
    batch = 65536
    env = _env(batch, torch.float32, "cuda")
    i_d, i_q, _ = _operating_points(batch, (0.0,), torch.float32, "cuda", seed=11)
    speeds = torch.linspace(0.0, 1000.0, 32, dtype=torch.float64)
    pick = _slice_draw(batch, 32, [1 + s for s in range(32)], seed=12).long()
    omega = speeds[pick].to(torch.float32).cuda()
    tile, carry0, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=i_d, i_q_ref=i_q, omega_el=omega, measurement_std=SENSORS)
    return env, (i_d, i_q, omega), tile, carry0, sched


def _spread_schedule(sched, n_slices, seed):
    """``sched``'s slices copied out to ``n_slices`` slices, each drive moved
    to a copy of its own slice: the same maps a drive, over many small
    slices."""
    n = sched.n_slices
    values = np.concatenate([sched.values] * -(-n_slices // n))[:n_slices]
    gen = torch.Generator().manual_seed(seed)
    old = sched.slices.cpu().long()
    copies = (n_slices - old + n - 1) // n  # copies of slice s below n_slices
    moved = old + n * (torch.rand(old.shape, generator=gen, dtype=torch.float64) * copies).long()
    return ScheduledLUT(values, sched.carry_idx, slices=moved.to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n_slices", [32, 200])
@pytest.mark.parametrize("stride", [None, 1], ids=["finals", "saves"])
def test_the_staged_kernel_is_the_plain_per_drive_tile(big_fleet, n_slices, stride):
    """B = 65,536 over 32 uneven slices, and the same maps over 200 slices,
    T = 64, float32: the staged launch equals the plain per-drive tile, 0.0,
    and ``SLICE_STAGING`` counts one staged launch with the staged share
    that ``slice_tiling`` gives for the card (a few drives read device
    memory at 32 uneven slices, more at 200)."""
    env, (i_d, i_q, omega), tile, carry0, sched = big_fleet
    if n_slices != sched.n_slices:
        sched = _spread_schedule(sched, n_slices, seed=13)
    state0, om, kw = _loop_inputs(env, _start(env, i_d, i_q, omega, seed=14))
    kw.update(policy_carry=carry0, sched_lut=sched, traj_stride=stride)
    card = torch.cuda.get_device_properties("cuda")
    slice_bytes, free_bytes = _shared_memory(torch.float32)
    want_tiling = PCL.slice_tiling(sched.slices, n_slices, slice_bytes, free_bytes, card.multi_processor_count)
    PCL.PLANS.clear()
    before = dict(PCL.SLICE_STAGING)
    got = _flat(PCL.kernel_pmsm_closed_loop(env, state0, om, tile, T, **kw))
    torch.cuda.synchronize()
    moved = {k: PCL.SLICE_STAGING[k] - before[k] for k in before}
    assert moved == {"staged_launches": 1, "global_launches": 0, "blocks": want_tiling.blocks,
                     "staged_drives": want_tiling.staged, "drives": env.batch_size, "idle_lanes": 0}
    # slice 0 holds ~124 drives, so a few blocks span three slices at 32
    share = want_tiling.staged / env.batch_size
    assert (0.99 < share < 1.0) if n_slices == 32 else (0.0 < share < 0.99)
    want = _flat(PCL.plain_pmsm_closed_loop(env, state0, om, tile, T, **kw))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert _max_abs(got, want) == 0.0


@pytest.mark.gpu
def test_a_fleet_run_sorts_its_drives_once_and_float64_takes_the_global_path(big_fleet, monkeypatch):
    """``FleetRunner.run_policy`` over 3 chunks: one plan miss builds the
    slice tiling, two hits reuse it, and the three launches are staged; the
    same fleet in float64 (142 KB slices beside a 95 KB table) launches on
    the global path."""
    env, (i_d, i_q, omega), tile, carry0, _ = big_fleet
    built = []
    tiling = PCL.slice_tiling
    monkeypatch.setattr(PCL, "slice_tiling", lambda *a, **k: built.append(1) or tiling(*a, **k))
    PCL.PLANS.clear()
    plans, staging = dict(PCL.LAUNCH_PLANS["pmsm_closed_loop"]), dict(PCL.SLICE_STAGING)
    state = _start(env, i_d, i_q, omega, seed=15)
    FleetRunner(env).run_policy(state, tile, 3, 16, policy_carry=carry0)
    torch.cuda.synchronize()
    assert len(built) == 1
    assert PCL.LAUNCH_PLANS["pmsm_closed_loop"]["misses"] - plans["misses"] == 1
    assert PCL.LAUNCH_PLANS["pmsm_closed_loop"]["hits"] - plans["hits"] == 2
    assert PCL.SLICE_STAGING["staged_launches"] - staging["staged_launches"] == 3
    assert PCL.SLICE_STAGING["global_launches"] == staging["global_launches"]

    batch = 4096
    env64 = _env(batch, torch.float64, "cuda")
    i_d, i_q, omega = _operating_points(batch, tuple(np.linspace(0.0, 1000.0, 7)), torch.float64, "cuda", seed=16)
    tile64, c64, sched64 = foc.make_pmsm_saturated_sensorless_current_tile(
        env64, i_d_ref=i_d, i_q_ref=i_q, omega_el=omega, measurement_std=SENSORS)
    state0, om, kw = _loop_inputs(env64, _start(env64, i_d, i_q, omega, seed=17))
    before = dict(PCL.SLICE_STAGING)
    PCL.kernel_pmsm_closed_loop(env64, state0, om, tile64, 8, policy_carry=c64, sched_lut=sched64, **kw)
    torch.cuda.synchronize()
    assert PCL.SLICE_STAGING["global_launches"] - before["global_launches"] == 1
    assert PCL.SLICE_STAGING["staged_launches"] == before["staged_launches"]
    assert PCL.SLICE_STAGING["staged_drives"] == before["staged_drives"]


@pytest.mark.gpu
def test_the_scalar_scheduled_launch_is_still_its_plain_version():
    """Row 4c: one operating point for the fleet (1,200 rad/s, -100 A,
    150 A), a 3 A sensor slab, T = 64: the ``ScheduledLaw`` launch equals its
    plain version, 0.0."""
    _cuda()
    batch = 4096
    env = P.PMSM(batch_size=batch, saturated=True, motor_variant=P.MotorVariant.BRUSA, tau=1e-4, device="cuda")
    tile, carry0, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=-100.0, i_q_ref=150.0, omega_el=1200.0, measurement_std={"i_d": 3.0, "i_q": 3.0})
    gen = torch.Generator(device="cuda").manual_seed(9)
    _, state = env.vmap_reset()
    phys = state.physical_state
    phys.i_d = -200.0 * torch.rand(batch, generator=gen, device="cuda")
    phys.i_q = 300.0 * torch.rand(batch, generator=gen, device="cuda") - 150.0
    phys.omega_el = torch.full((batch,), 1200.0, device="cuda")
    state0, om, kw = _loop_inputs(env, state)
    slab = 0.02 * torch.randn((T, batch, 2), generator=gen, device="cuda")
    kw.update(policy_carry=carry0, sched_lut=sched, traj_stride=1, obs_noise_tm=slab, obs_noise_cols=(0, 1))
    before = PCL.VARIANT_LAUNCHES["scheduled"]
    got = _flat(PCL.kernel_pmsm_closed_loop(env, state0, om, tile, T, **kw))
    torch.cuda.synchronize()
    assert PCL.VARIANT_LAUNCHES["scheduled"] == before + 1
    assert _max_abs(got, _flat(PCL.plain_pmsm_closed_loop(env, state0, om, tile, T, **kw))) == 0.0


@pytest.mark.gpu
def test_the_kernel_refuses_planes_and_schedules_it_does_not_take():
    _cuda()
    batch = 256
    env = _env(batch, torch.float32, "cuda")
    i_d, i_q, omega = _operating_points(batch, (0.0, 1000.0), torch.float32, "cuda")
    tile, carry0, sched = foc.make_pmsm_saturated_sensorless_current_tile(
        env, i_d_ref=i_d, i_q_ref=i_q, omega_el=omega, measurement_std=SENSORS)
    state0, om, kw = _loop_inputs(env, _start(env, i_d, i_q, omega))
    one = ScheduledLUT(sched.values[0])
    with pytest.raises(ValueError, match="per-drive ScheduledLUT"):
        PCL.kernel_pmsm_closed_loop(env, state0, om, tile, 4, policy_carry=carry0, sched_lut=one, **kw)
    law = P.AffinePolicy([[0.5] + [0.0] * 9, [0.0, 0.5] + [0.0] * 8])
    spec = law.kernel_spec(torch.float32, "cuda")
    law.kernel_spec = lambda dtype, device, params=None: spec._replace(planes=(om,) * 5)
    with pytest.raises(ValueError, match="takes for the per-drive ScheduledSensorlessPolicy"):
        PCL.kernel_pmsm_closed_loop(env, state0, om, law, 4, **kw)
