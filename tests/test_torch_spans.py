"""The port's own spans on the profiler's timeline, on CPU tensors.

``utils/profiling.py::annotate`` is one shared null context while no
profiler records and a ``record_function`` while one does.  Under
``torch.profiler`` a fleet chunk is ``ee.fleet.chunk`` holding its phases in
order (``ee.fleet.actions``, ``ee.fleet.rollout``, ``ee.fleet.stats``,
``ee.fleet.gate``, ``ee.fleet.readout``, then the sink, the checkpoint and
the hook where they run), at most 12 spans a chunk, told apart by their
start times; the entry points record ``ee.rollout.prepare`` and
``ee.rollout.rebuild`` (``ee.launch.*`` comes with a launch, on the card:
``tests/test_torch_gpu.py``); ``collect_fused`` records
``ee.collect.assemble``; the two closed-loop wrappers pack their policy
inside ``ee.policy.spec`` (``ops/kernels/closed_loop.py::policy_spec``).
The runner's throughput
readout is host floats: no device operation inside ``ee.fleet.readout``, and
elastic recovery rolls it back with the rest of the loop's bookkeeping.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import exciting_environments_torch as P
from exciting_environments_torch.io import ShardWriter
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.ops.policies import AffinePolicy
from exciting_environments_torch.utils import profiling
from exciting_environments_torch.utils.collect import RolloutCollector
from exciting_environments_torch.utils.fleet import FleetRunner

F64 = dict(device="cpu", dtype=torch.float64)
BATCH, STEPS, CHUNKS = 16, 8, 3
PHASES = ["ee.fleet.rollout", "ee.fleet.stats", "ee.fleet.gate", "ee.fleet.readout"]


def _pendulum():
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state = env.vmap_reset(R.split(R.PRNGKey(3, "cpu"), BATCH))
    gen = torch.Generator().manual_seed(4)
    slabs = [torch.rand((BATCH, STEPS, 1), generator=gen, dtype=torch.float64) * 2 - 1 for _ in range(CHUNKS)]
    return env, state, slabs


def _ee_spans(prof):
    """``(start, end, name)`` of the program's spans, by start."""
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events() if e.name.startswith("ee."))


def _inside(spans, outer):
    s0, e0, _ = outer
    return [sp for sp in spans if sp is not outer and s0 <= sp[0] and sp[1] <= e0]


def test_annotate_is_one_shared_null_context_when_nothing_records():
    assert profiling.annotate("ee.fleet.chunk") is profiling._OFF
    assert profiling.annotate("ee.fleet.gate") is profiling.annotate("other") is profiling._OFF
    with profiling.annotate("ee.x"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        span = profiling.annotate("ee.x")
        assert span is not profiling._OFF
        with span:
            pass
    assert profiling.annotate("ee.x") is profiling._OFF


def _check_chunks(prof, first_phase):
    spans = _ee_spans(prof)
    chunks = [sp for sp in spans if sp[2] == "ee.fleet.chunk"]
    assert len(chunks) == CHUNKS
    for chunk in chunks:
        inner = _inside(spans, chunk)
        names = [sp[2] for sp in inner]
        order = [n for n in names if n in [first_phase] + PHASES]
        assert order == ([first_phase] if first_phase else []) + PHASES
        # the entry point's prepare and rebuild run inside the enqueue
        rollout = next(sp for sp in inner if sp[2] == "ee.fleet.rollout")
        assert [sp[2] for sp in _inside(inner, rollout)] == ["ee.rollout.prepare", "ee.rollout.rebuild"]
        assert len(inner) + 1 <= 12
    # chunk k is the k-th by start time: each ends before the next starts
    assert all(a[1] <= b[0] for a, b in zip(chunks, chunks[1:]))


def test_fleet_run_records_each_chunk_and_its_phases():
    env, state, slabs = _pendulum()
    runner = FleetRunner(env)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run(state, lambda k: slabs[k], CHUNKS, STEPS)
    _check_chunks(prof, "ee.fleet.actions")


def test_fleet_run_policy_records_each_chunk_and_its_phases():
    env = P.Pendulum(batch_size=BATCH, control_state=["theta"], **F64)
    _, state = env.vmap_reset(R.split(R.PRNGKey(5, "cpu"), BATCH))
    state.reference.theta = torch.linspace(-1, 1, BATCH, dtype=torch.float64)
    policy = AffinePolicy([[-0.5, -0.1, 0.5]], Ki=[[0.0, 0.0, 0.1]])
    carry = (torch.zeros(BATCH, dtype=torch.float64),)
    runner = FleetRunner(env)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run_policy(state, policy, CHUNKS, STEPS, policy_carry=carry)
    _check_chunks(prof, None)


def test_fleet_chunk_with_sink_checkpoint_and_hook_opens_at_most_twelve_spans(tmp_path):
    env, state, slabs = _pendulum()
    seen = []
    (tmp_path / "ckpt").mkdir()
    with ShardWriter(str(tmp_path / "run.extpu"), use_native=False) as writer:
        runner = FleetRunner(env, writer=writer, write_actions=True, checkpoint_dir=str(tmp_path / "ckpt"),
                             checkpoint_every=1)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            runner.run(state, lambda k: slabs[k], CHUNKS, STEPS, metric_hook=lambda k, obs, st: seen.append(k))
    assert seen == list(range(CHUNKS))
    spans = _ee_spans(prof)
    for chunk in (sp for sp in spans if sp[2] == "ee.fleet.chunk"):
        names = [sp[2] for sp in _inside(spans, chunk)]
        assert names[-3:] == ["ee.fleet.sink", "ee.fleet.checkpoint", "ee.fleet.hook"]
        assert len(names) + 1 <= 12


def test_fleet_readout_runs_no_device_operation():
    """The throughput readout is host arithmetic: no aten operation (no
    clamp, no copy to the device) inside ``ee.fleet.readout``."""
    env, state, slabs = _pendulum()
    runner = FleetRunner(env, window=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        runner.run(state, lambda k: slabs[k], CHUNKS, STEPS)
    events = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events())
    readouts = [ev for ev in events if ev[2] == "ee.fleet.readout"]
    assert len(readouts) == CHUNKS
    for readout in readouts:
        assert not [ev for ev in _inside(events, readout) if ev[2].startswith("aten::")]
    assert list(runner.steps_window) == [BATCH * STEPS] * 2
    assert len(runner.time_window) == 2 and all(isinstance(t, float) and t > 0 for t in runner.time_window)


def test_fleet_retry_restores_the_readout_windows():
    """A chunk that fails after its readout (here in the hook) and is
    replayed from the snapshot is counted once: ``summary()`` matches a
    clean run's, wall time aside."""
    env, state, slabs = _pendulum()
    clean = FleetRunner(env, window=4)
    clean.run(state, lambda k: slabs[k], CHUNKS, STEPS)
    failed = []

    def flaky_hook(k, obs, st):
        if k == 1 and not failed:
            failed.append(k)
            raise RuntimeError("transient device error")

    retried = FleetRunner(env, window=4)
    retried.run(state, lambda k: slabs[k], CHUNKS, STEPS, metric_hook=flaky_hook, max_retries=1)
    assert failed == [1]
    a, b = clean.summary(), retried.summary()
    assert set(a) == set(b)
    for key in ("chunks", "env_steps"):
        assert a[key] == b[key]
    for key in ("obs_mean", "obs_std", "obs_min", "obs_max"):
        assert torch.equal(a[key], b[key])
    assert list(retried.steps_window) == list(clean.steps_window) == [BATCH * STEPS] * CHUNKS
    assert len(retried.time_window) == CHUNKS and retried.time_window.maxlen == 4
    assert b["env_steps_per_sec"] == pytest.approx(BATCH * STEPS / b["mean_chunk_seconds"], rel=1e-12)


@pytest.mark.parametrize("model", ["pendulum", "pmsm"])
def test_collect_fused_records_prepare_rebuild_and_assemble(model):
    if model == "pendulum":
        env, state, slabs = _pendulum()
        actions = slabs[0]
    else:
        env = P.PMSM(batch_size=BATCH, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
        _, state = env.vmap_reset(R.split(R.PRNGKey(6, "cpu"), BATCH))
        actions = 0.01 * torch.ones((BATCH, STEPS, 2), dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        batch, _ = RolloutCollector(env).collect_fused(state, actions)
    assert batch.observations.shape[:2] == (BATCH, STEPS)
    names = [sp[2] for sp in _ee_spans(prof)]
    assert names == ["ee.rollout.prepare", "ee.rollout.rebuild", "ee.collect.assemble"]


def test_policy_spec_opens_one_span_around_the_kernel_spec():
    """``policy_spec`` is the policy's kernel spec inside one
    ``ee.policy.spec`` span, and opens nothing else; a tile hands out the
    spec it packed first."""
    from exciting_environments_torch.ops.kernels import closed_loop as CL
    from exciting_environments_torch.utils import foc

    env = P.InductionMachine(batch_size=BATCH, **F64)
    tile, _ = foc.make_foc_tile(env, psi_ref=0.7, torque_ref=torch.linspace(-8.0, 8.0, BATCH, dtype=torch.float64))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        specs = [CL.policy_spec(tile, torch.float32, "cpu") for _ in range(3)]
    assert [name for *_, name in _ee_spans(prof)] == ["ee.policy.spec"] * 3
    assert all(s is specs[0] for s in specs) and len(specs[0].planes) == 3
    assert specs[0] is tile.kernel_spec(torch.float32, "cpu")


@pytest.mark.gpu
def test_closed_loop_wrappers_open_one_policy_spec_span_a_launch():
    """On the card: each launch of either closed-loop wrapper
    (``kernel_closed_loop``, ``kernel_pmsm_closed_loop``) opens one
    ``ee.policy.spec`` span, before its ``ee.launch`` span, also where it
    launches through a kept launch plan (the span then times the plan's
    check of the policy's spec)."""
    from exciting_environments_torch.ops.kernels import closed_loop as CL
    from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
    from exciting_environments_torch.utils import foc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    B = 256
    im = P.InductionMachine(batch_size=B)
    tile, carry = foc.make_foc_tile(im, psi_ref=0.7, torque_ref=torch.linspace(-8.0, 8.0, B, device="cuda"))
    y0 = tuple(torch.zeros(B, device="cuda") for _ in im._ode_state_fields)
    drive = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"])
    _, st = drive.vmap_reset()
    phys = st.physical_state
    refs = (torch.full((B,), -0.5, device="cuda"), torch.zeros(B, device="cuda"))
    pi = P.AffinePolicy([[-0.6] + [0] * 7 + [0.6, 0], [0, -0.6] + [0] * 7 + [0.6]])
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    calls = [lambda: CL.kernel_closed_loop(im, y0, tile, 8, tau=im.tau, solver=im._solver, props=im.env_properties,
                                           policy_carry=carry),
             lambda: PCL.kernel_pmsm_closed_loop(drive, state0, phys.omega_el, pi, 8, tau=drive.tau,
                                                 solver=drive._solver, props=drive.env_properties, ref_leaves=refs)]
    for call, plans in zip(calls, (CL.PLANS, PCL.PLANS)):
        call()  # the library's load outside the trace; the launch plan kept
        torch.cuda.synchronize()
        hits = plans.counts["hits"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        assert plans.counts["hits"] == hits + 3  # every traced launch through the plan
        host = [e for e in prof.events() if not str(e.device_type).endswith("CUDA")]  # not the device's copies
        names = [e.name for e in sorted(host, key=lambda e: e.time_range.start)
                 if e.name.startswith(("ee.policy.spec", "ee.launch."))]
        assert names == ["ee.policy.spec", names[1]] * 3 and names[1].startswith("ee.launch.")
