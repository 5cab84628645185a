"""The port's fleet loop (``utils/fleet.py``) on CPU tensors against the JAX
package's ``FleetRunner``.

* The contracts of ``tests/test_fleet.py``, each as a port test: path
  selection by the kernels' scope alone (on CPU tensors the fused paths run
  the kernels' plain versions, so an in-scope environment reports
  ``"fused"``/``"closed_loop_fused"`` here as on the card, and the JAX
  package's CPU guards have no counterpart), metrics, the shard sink,
  checkpoints and resume, elastic recovery, and ``ShardedEnv`` over
  ``["cpu"] * 4``.  An environment outside the kernels' scope is one with
  the implicit Euler solver (the port has no batch-tiling rule).
* Parity, float64: the same state and action chunks through both runners
  (the JAX runner on its CPU paths), Pendulum and saturated BRUSA open
  loops, the PD and the stateful PI closed loops.  Final states at
  rtol = atol = 1e-12 (classic) and rtol 1e-11, atol 1e-9 (PMSM, its state
  carried across from the JAX reset), as the other parity files.  The
  runners' statistics are float32 accumulators in both packages, fed the
  float64 observations cast to float32; XLA and PyTorch reduce the batch in
  different orders, so ``obs_mean``/``obs_std`` are held at rtol 1e-6, atol
  1e-7 (a few float32 ulps) and ``obs_min``/``obs_max``, which select
  values, and the counters exactly.
* Checkpoints across the packages: a fleet checkpoint written by the JAX
  runner (its ``.npz`` backend, as it writes without orbax) resumes in the
  port, and the reverse, with equal states, statistics and counters.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.utils import checkpoint as jck
from exciting_environments_tpu.utils.fleet import FleetRunner as JFleetRunner
from exciting_environments_torch.core import structures
from exciting_environments_torch.io import ShardWriter, read_shard
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.ops.kernels import closed_loop_path, rollout_path
from exciting_environments_torch.parallel import ShardedEnv, make_batch_mesh
from exciting_environments_torch.utils.checkpoint import leaves_with_path
from exciting_environments_torch.utils.collect import tile_policy_scan
from exciting_environments_torch.utils.convert import state_from_numpy
from exciting_environments_torch.utils.fleet import FleetRunner, _select_closed_loop, _select_rollout

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)
PMSM_TOL = dict(rtol=1e-11, atol=1e-9)
STATS_TOL = dict(rtol=1e-6, atol=1e-7)
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")
BATCH = 64
MESH = ["cpu"] * 4


def _keys(seed, n):
    return R.split(R.PRNGKey(seed, "cpu"), n)


def _slabs(seed, batch, chunk_steps, action_dim, n_chunks):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-0.8, 0.8, size=(batch, chunk_steps, action_dim)) for _ in range(n_chunks)]


def _actions(env, chunk_steps, seed0=0):
    def source(k):
        gen = torch.Generator().manual_seed(seed0 + k)
        return torch.rand((env.batch_size, chunk_steps, env.action_dim), generator=gen,
                          dtype=torch.float64) * 1.6 - 0.8

    return source


def _tracking(batch=BATCH, seed=5, **kw):
    env = P.Pendulum(batch_size=batch, control_state=["theta"], **kw, **F64)
    _, state = env.vmap_reset(_keys(seed, batch))
    state.reference.theta = torch.linspace(-1, 1, batch, dtype=torch.float64)
    return env, state


def _equal_trees(a, b):
    la, lb = leaves_with_path(a), leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y) or torch.equal(x.isnan(), y.isnan()) and torch.equal(x.nan_to_num(),
                                                                                           y.nan_to_num()), path
        else:
            assert x == y, path


def _pd_policy(obs, t):
    return (-0.8 * (obs[0] - obs[2]) - 0.3 * obs[1],)


# ---------------------------------------------------------------------------
# the contracts of tests/test_fleet.py
# ---------------------------------------------------------------------------


def test_fleet_runner_fused_path_and_metrics():
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state = env.vmap_reset(_keys(0, BATCH))
    runner = FleetRunner(env)
    assert runner.rollout_path == "fused"
    seen = []
    state = runner.run(
        state, _actions(env, 8), n_chunks=3, chunk_steps=8,
        metric_hook=lambda k, obs, st: seen.append(k),
    )
    s = runner.summary()
    assert seen == [0, 1, 2]
    assert s["chunks"] == 3 and s["env_steps"] == 3 * BATCH * 8
    assert s["obs_mean"].shape == (2,) and s["obs_mean"].dtype == torch.float32
    assert bool(torch.isfinite(s["obs_std"]).all())
    assert bool((s["obs_min"] <= s["obs_max"]).all())
    assert s["env_steps_per_sec"] > 0


def test_fleet_runner_pmsm_path():
    env = P.PMSM(batch_size=BATCH, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    _, state = env.vmap_reset(_keys(1, BATCH))
    runner = FleetRunner(env)
    assert runner.rollout_path == "pmsm_fused"
    state = runner.run(state, _actions(env, 4), n_chunks=2, chunk_steps=4)
    assert runner.summary()["chunks"] == 2


def test_fleet_runner_writer_and_checkpoint(tmp_path):
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state0 = env.vmap_reset(_keys(2, BATCH))
    shard = str(tmp_path / "fleet.extpu")
    ckpt_dir = str(tmp_path)
    with ShardWriter(shard, use_native=False) as w:
        runner = FleetRunner(env, writer=w, write_actions=True, checkpoint_dir=ckpt_dir, checkpoint_every=2)
        state = runner.run(state0, _actions(env, 8), n_chunks=4, chunk_steps=8)
    entries = dict(read_shard(shard))
    assert list(entries) == [f"chunk_{i:06d}" for i in range(1, 5)]
    leaves = entries["chunk_000001"]
    assert leaves["['final_obs']"].shape == (BATCH, 2)
    np.testing.assert_array_equal(leaves["['actions']"], _actions(env, 8)(0).numpy())
    ckpts = sorted(f for f in os.listdir(ckpt_dir) if f.startswith("fleet_"))
    assert ckpts == ["fleet_000002.npz", "fleet_000004.npz"]

    # process-death resume: a fresh runner restores state AND bookkeeping,
    # from a fresh state as the template
    assert FleetRunner.latest_checkpoint(ckpt_dir) == os.path.join(ckpt_dir, "fleet_000004.npz")
    runner2 = FleetRunner(env, checkpoint_dir=ckpt_dir)
    restored, done = runner2.resume(env.vmap_reset(_keys(9, BATCH))[1])
    assert done == 4 and runner2.env_steps == 4 * BATCH * 8
    for key in ("obs_mean", "obs_std", "obs_min", "obs_max"):  # statistics carried over exactly
        assert torch.equal(runner.summary()[key], runner2.summary()[key])
    _equal_trees(state, restored)
    runner2.run(restored, lambda k: _actions(env, 8)(k + done), n_chunks=1, chunk_steps=8)
    assert runner2.summary()["chunks"] == 5


def test_fleet_runner_sharded():
    env = P.Pendulum(batch_size=BATCH, **F64)
    senv = ShardedEnv(env, make_batch_mesh(MESH))
    _, state = senv.vmap_reset(_keys(3, BATCH))
    runner = FleetRunner(senv)
    assert runner.rollout_path == "sharded_fused"
    final = runner.run(state, _actions(env, 8), n_chunks=2, chunk_steps=8)
    assert runner.summary()["chunks"] == 2
    # the split run equals the unsplit one bit for bit
    whole = FleetRunner(env).run(state, _actions(env, 8), n_chunks=2, chunk_steps=8)
    _equal_trees(final, whole)


def test_fleet_select_fallback():
    """An environment outside the stepper kernel's scope drops to the scan."""
    env = P.Pendulum(batch_size=24, solver="implicit_euler", **F64)
    run, base, path = _select_rollout(env)
    assert path == "scan" and base is env
    _, state = env.vmap_reset()
    obs, last = run(state, torch.full((24, 4, 1), 0.2, dtype=torch.float64))
    assert obs.shape == (24, 2)


#: every route by environment and call kind: the scope rule's answer (which a
#: batch split shares), then the name FleetRunner reports for the plain and
#: for the split environment
ROUTES = {
    ("pendulum", "rollout"): ("fused", "fused", "sharded_fused"),
    ("pendulum", "sim_ahead_equal"): ("fused",),
    ("pendulum", "sim_ahead_unequal"): ("fused",),
    ("pendulum", "sim_ahead_noisy"): ("scan",),
    ("pendulum", "closed_loop"): ("closed_loop_fused", "closed_loop_fused", "sharded_closed_loop"),
    ("pmsm", "rollout"): ("pmsm_fused", "pmsm_fused", "sharded_fused"),
    ("pmsm", "sim_ahead_equal"): ("pmsm_fused",),
    ("pmsm", "sim_ahead_unequal"): ("scan",),
    ("pmsm", "sim_ahead_noisy"): ("scan",),
    ("pmsm", "closed_loop"): ("pmsm_closed_loop_fused", "pmsm_closed_loop_fused", "sharded_closed_loop"),
    ("out_of_scope", "rollout"): ("scan", "scan", "sharded_scan"),
    ("out_of_scope", "sim_ahead_equal"): ("scan",),
    ("out_of_scope", "sim_ahead_unequal"): ("scan",),
    ("out_of_scope", "sim_ahead_noisy"): ("scan",),
    ("out_of_scope", "closed_loop"): (None, "closed_loop_scan", "closed_loop_scan"),
}


def _route_env(kind, noisy):
    if kind == "pmsm":
        noise = dict(process_noise={"i_d": 2.0, "i_q": 2.0}) if noisy else {}
        return P.PMSM(batch_size=4, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                      control_state=["i_d", "i_q"], **noise, **F64)
    noise = dict(process_noise={"omega": 0.3}) if noisy else {}
    solver = dict(solver="implicit_euler") if kind == "out_of_scope" else {}
    return P.Pendulum(batch_size=4, control_state=["theta"], **solver, **noise, **F64)


@pytest.mark.parametrize("split", [False, True], ids=["plain", "sharded"])
@pytest.mark.parametrize("kind,call", sorted(ROUTES))
def test_one_rule_names_every_route(kind, call, split):
    """rollout_path and closed_loop_path name the route of every call kind,
    for the whole batch of a split as for the plain environment, and the
    environment's own entry point agrees with them: with ``strict=True`` (a
    closed loop always) it raises exactly where the rule says the kernels do
    not reach.  A PMSM sim-ahead needs equal stepsizes and no noise, a
    pendulum's an integral stepsize ratio and no noise."""
    env = _route_env(kind, noisy=call == "sim_ahead_noisy")
    target = ShardedEnv(env, make_batch_mesh(["cpu"] * 2)) if split else env
    route = ROUTES[kind, call]
    _, state = target.vmap_reset(_keys(30, 4))
    actions = torch.zeros((4, 2, env.action_dim), dtype=torch.float64)
    if call == "closed_loop":
        policy = lambda obs, t: tuple(0.0 * obs[0] for _ in range(env.action_dim))
        assert closed_loop_path(target) == route[0]
        assert _select_closed_loop(target, policy)[2] == route[2 if split else 1]
        in_scope = route[0] is not None
        launch = lambda: target.fused_closed_loop(state, policy, 2)
    elif call == "rollout":
        assert rollout_path(target) == route[0]
        assert FleetRunner(target).rollout_path == route[2 if split else 1]
        in_scope = route[0] != "scan"
        launch = lambda: target.fused_rollout(state, actions, strict=True)
    else:
        obs_stepsize = env.tau / 2 if call == "sim_ahead_unequal" else env.tau
        assert rollout_path(target, obs_stepsize, env.tau) == route[0]
        in_scope = route[0] != "scan"
        launch = lambda: target.fused_sim_ahead(state, actions, obs_stepsize, env.tau, strict=True)
    if in_scope:
        assert launch()[0].shape[0] == 4
    else:
        with pytest.raises(ValueError, match="scope"):
            launch()


def test_fleet_runner_closed_loop_fused():
    """run_policy drives chunks through the closed-loop kernel (its plain
    version on CPU tensors); stats and bookkeeping match the open loop's
    contract."""
    env, state = _tracking()
    runner = FleetRunner(env)
    seen = []
    state = runner.run_policy(
        state, _pd_policy, n_chunks=3, chunk_steps=6,
        metric_hook=lambda k, obs, st: seen.append(k),
    )
    assert runner.closed_loop_path == "closed_loop_fused"
    assert seen == [0, 1, 2]
    s = runner.summary()
    assert s["chunks"] == 3 and s["env_steps"] == 3 * BATCH * 6
    assert bool(torch.isfinite(s["obs_mean"]).all())


def _pi_policy(obs, t, carry):
    e = obs[2] - obs[0]
    integ = carry[0] + 0.05 * e
    return (0.7 * e + integ - 0.2 * obs[1],), (integ,)


def test_fleet_runner_closed_loop_stateful_carry():
    """run_policy(policy_carry=...) threads a PI integrator BETWEEN chunks:
    4 chunks x 8 steps equal one unchunked 32-step closed loop (final state
    AND carry), and it returns (final_state, final_carry)."""
    env, state = _tracking(seed=6)
    carry0 = (torch.zeros(BATCH, dtype=torch.float64),)
    runner = FleetRunner(env)
    final_state, final_carry = runner.run_policy(
        state, _pi_policy, n_chunks=4, chunk_steps=8, policy_carry=carry0,
        max_retries=1,  # the carry survives the snapshot machinery too
    )
    assert runner.closed_loop_path == "closed_loop_fused"
    assert runner.summary()["env_steps"] == 4 * BATCH * 8
    _, last_1, fc_1 = env.fused_closed_loop(state, _pi_policy, 32, policy_carry=carry0)
    assert torch.equal(final_state.physical_state.theta, last_1.physical_state.theta)
    assert torch.equal(final_state.physical_state.omega, last_1.physical_state.omega)
    assert torch.equal(final_carry[0], fc_1[0])


def test_fleet_runner_closed_loop_scan_fallback_matches_kernel():
    """An environment outside the closed-loop kernel's scope rides the scan
    closed loop with the SAME tile contract (matching the JAX package's scan
    at 1e-12), and on an in-scope environment the kernel path matches that
    scan over the same environment."""
    small = P.Pendulum(batch_size=24, control_state=["theta"], solver="implicit_euler", **F64)
    run, _, path = _select_closed_loop(small, _pd_policy)
    assert path == "closed_loop_scan"
    jsmall = J.Pendulum(batch_size=24, control_state=["theta"], solver="implicit_euler")
    jk = jax.random.split(jax.random.PRNGKey(6), 24)
    _, js = jsmall.vmap_reset(jk)
    js = jstructures.replace(js, reference=jstructures.replace(js.reference, theta=jnp.linspace(-1, 1, 24)))
    _, st = small.vmap_reset(torch.as_tensor(np.asarray(jk).astype(np.int64)))
    st.reference.theta = torch.linspace(-1, 1, 24, dtype=torch.float64)
    obs_scan, last_scan = run(st, 5, None)
    assert obs_scan.shape == (24, 3)
    from exciting_environments_tpu.utils.collect import tile_policy_scan as jtile_policy_scan

    jobs, jlast = jtile_policy_scan(jsmall, js, 5, _pd_policy, None, collect_trajectory=False)
    np.testing.assert_allclose(obs_scan.numpy(), np.asarray(jobs), **TOL)

    env, state = _tracking(batch=24, seed=6)
    runk, _, pathk = _select_closed_loop(env, _pd_policy)
    assert pathk == "closed_loop_fused"
    obs_k, last_k = runk(state, 5, None)
    obs_s, last_s = tile_policy_scan(env, state, 5, _pd_policy, None, collect_trajectory=False)
    np.testing.assert_allclose(obs_k.numpy(), obs_s.numpy(), **TOL)


def test_fleet_runner_closed_loop_pmsm():
    env = P.PMSM(batch_size=BATCH, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                 control_state=["i_d", "i_q"], **F64)
    _, state = env.vmap_reset(_keys(7, BATCH))
    state.reference.i_d = torch.linspace(-200.0, -10.0, BATCH, dtype=torch.float64)
    state.reference.i_q = torch.linspace(-150.0, 150.0, BATCH, dtype=torch.float64)
    runner = FleetRunner(env)

    def pi(obs, t):
        return (-0.6 * (obs[0] - obs[8]), -0.6 * (obs[1] - obs[9]))

    state = runner.run_policy(state, pi, n_chunks=2, chunk_steps=4)
    assert runner.closed_loop_path == "pmsm_closed_loop_fused"
    assert runner.summary()["chunks"] == 2


def test_fleet_runner_closed_loop_sharded():
    env, state = _tracking(seed=8)
    senv = ShardedEnv(env, make_batch_mesh(MESH))
    runner = FleetRunner(senv)
    final = runner.run_policy(state, _pd_policy, n_chunks=2, chunk_steps=4)
    assert runner.closed_loop_path == "sharded_closed_loop"
    whole = FleetRunner(env).run_policy(state, _pd_policy, n_chunks=2, chunk_steps=4)
    _equal_trees(final, whole)


def test_fleet_runner_closed_loop_policy_params():
    """run_policy threads a parameter tree through both the kernel path and
    the scan fallback (same tile contract)."""

    def pd_p(obs, t, p):
        return (-p["kp"] * (obs[0] - obs[2]) - p["kd"] * obs[1],)

    params = {"kp": torch.tensor(0.8, dtype=torch.float64), "kd": torch.tensor(0.3, dtype=torch.float64)}
    env, state = _tracking(seed=9)
    runner = FleetRunner(env)
    runner.run_policy(state, pd_p, n_chunks=1, chunk_steps=5, policy_params=params)
    assert runner.closed_loop_path == "closed_loop_fused"

    small = P.Pendulum(batch_size=24, control_state=["theta"], solver="implicit_euler", **F64)
    run, _, path = _select_closed_loop(small, pd_p)
    assert path == "closed_loop_scan"
    _, st = small.vmap_reset(_keys(9, 24))
    st.reference.theta = torch.linspace(-1, 1, 24, dtype=torch.float64)
    obs, last = run(st, 5, params)
    assert obs.shape == (24, 3) and bool(torch.isfinite(obs).all())


def test_fleet_sharded_paths_by_scope_alone():
    """The JAX package's CPU-backend guard (sharded lanes on its CPU mesh
    ride the scan) has no counterpart: on CPU tensors the split runs the
    kernels' plain versions per shard, so a ShardedEnv in scope reports the
    sharded kernel paths, open and closed loop."""
    env, state = _tracking(seed=12)
    senv = ShardedEnv(env, make_batch_mesh(MESH))
    runner = FleetRunner(senv)
    assert runner.rollout_path == "sharded_fused"
    state = runner.run(state, _actions(senv, 4), n_chunks=1, chunk_steps=4)
    assert runner.summary()["chunks"] == 1
    state = runner.run_policy(state, _pd_policy, n_chunks=1, chunk_steps=4)
    assert runner.closed_loop_path == "sharded_closed_loop"
    assert runner.summary()["chunks"] == 2


def test_fleet_elastic_recovery_retries_transient_failures():
    """A chunk that raises a transient runtime error is replayed from the
    last completed chunk's snapshot: the final state and statistics equal a
    failure-free run's exactly, nothing is double-counted."""
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state0 = env.vmap_reset(_keys(4, BATCH))
    src = _actions(env, 8)

    clean = FleetRunner(env)
    clean_final = clean.run(state0, src, n_chunks=3, chunk_steps=8)

    flaky = FleetRunner(env)
    orig = flaky._rollout
    calls = {"n": 0}

    def rollout(state, actions):
        calls["n"] += 1
        if calls["n"] == 2:  # fail the 2nd chunk once
            raise RuntimeError("injected device failure")
        return orig(state, actions)

    flaky._rollout = rollout
    flaky_final = flaky.run(state0, src, n_chunks=3, chunk_steps=8, max_retries=1)

    assert calls["n"] == 4  # 3 chunks + 1 replay
    _equal_trees(clean_final, flaky_final)
    cs, fs = clean.summary(), flaky.summary()
    assert fs["chunks"] == cs["chunks"] == 3
    assert fs["env_steps"] == cs["env_steps"]
    for key in ("obs_mean", "obs_std", "obs_min", "obs_max"):
        assert torch.equal(cs[key], fs[key])


def test_fleet_elastic_recovery_exhausts_and_raises():
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state0 = env.vmap_reset(_keys(4, BATCH))
    runner = FleetRunner(env)

    def always_fails(state, actions):
        raise RuntimeError("permanently down")

    runner._rollout = always_fails
    with pytest.raises(RuntimeError, match="permanently down"):
        runner.run(state0, _actions(env, 4), n_chunks=2, chunk_steps=4, max_retries=2)


def test_fleet_nan_gate_is_never_retried():
    """FloatingPointError from the NaN gate is deterministic; max_retries
    does not mask it by replaying the same chunk."""
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state0 = env.vmap_reset(_keys(4, BATCH))
    runner = FleetRunner(env)
    orig = runner._rollout
    calls = {"n": 0}

    def nan_rollout(state, actions):
        calls["n"] += 1
        obs, state = orig(state, actions)
        return torch.full_like(obs, float("nan")), state

    runner._rollout = nan_rollout
    with pytest.raises(FloatingPointError):
        runner.run(state0, _actions(env, 4), n_chunks=1, chunk_steps=4, max_retries=5)
    assert calls["n"] == 1  # not replayed


def test_fleet_elastic_recovery_run_policy():
    env, state0 = _tracking(seed=6)
    clean = FleetRunner(env)
    clean_final = clean.run_policy(state0, _pd_policy, n_chunks=3, chunk_steps=4)

    # pre-seed the closed-loop cache with a once-failing wrapper around the
    # real selected run_fn, so the failure fires inside _drive's chunk loop
    flaky = FleetRunner(env)
    run_fn = _select_closed_loop(env, _pd_policy)[0]
    calls = {"n": 0}

    def flaky_run(state, n_steps, params):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("injected")
        return run_fn(state, n_steps, params)

    flaky._closed_loop = (_pd_policy, flaky_run)
    flaky.closed_loop_path = "closed_loop_fused"
    flaky_final = flaky.run_policy(state0, _pd_policy, n_chunks=3, chunk_steps=4, max_retries=1)
    assert calls["n"] == 4
    _equal_trees(clean_final, flaky_final)


def test_fleet_retry_preserves_mesh_placement():
    """A retried chunk on a ShardedEnv comes back on the mesh's first
    device and runs the rest split: the restored snapshot goes back to the
    device it came from."""
    env, state = _tracking(seed=21)
    senv = ShardedEnv(env, make_batch_mesh(MESH))
    runner = FleetRunner(senv)
    run_fn = _select_closed_loop(senv, _pd_policy)[0]
    calls = {"n": 0}

    def flaky_run(state, n_steps, params):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected")
        return run_fn(state, n_steps, params)

    runner._closed_loop = (_pd_policy, flaky_run)
    runner.closed_loop_path = "sharded_closed_loop"
    final = runner.run_policy(state, _pd_policy, n_chunks=3, chunk_steps=4, max_retries=1)
    assert calls["n"] == 4
    for _, leaf in leaves_with_path(final):
        if isinstance(leaf, torch.Tensor):
            assert leaf.device == senv.mesh.devices[0]
    _equal_trees(final, FleetRunner(env).run_policy(state, _pd_policy, n_chunks=3, chunk_steps=4))


def test_fleet_deterministic_errors_are_not_retried():
    """ValueError/TypeError/IndexError from the rollout path or user hooks
    are deterministic: the retry loop surfaces them at once instead of
    burning max_retries replays."""
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state0 = env.vmap_reset(_keys(20, BATCH))
    runner = FleetRunner(env)
    attempts = []

    def bad_source(k):
        attempts.append(k)
        raise IndexError("user bug in the action source")

    with pytest.raises(IndexError, match="user bug"):
        runner.run(state0, bad_source, n_chunks=2, chunk_steps=4, max_retries=5)
    assert attempts == [0]  # exactly one attempt, zero replays


def test_fleet_summary_throughput_with_mixed_chunk_sizes():
    """env_steps_per_sec pairs the recent window's wall time with the SAME
    window's step counts."""
    env = P.Pendulum(batch_size=BATCH, **F64)
    _, state = env.vmap_reset(_keys(21, BATCH))
    runner = FleetRunner(env, window=4)
    state = runner.run(state, _actions(env, 32), n_chunks=2, chunk_steps=32)
    state = runner.run(state, _actions(env, 2, seed0=100), n_chunks=4, chunk_steps=2)
    s = runner.summary()
    # the window (len 4) holds only the 2-step chunks; the lifetime average
    # would be (2*32+4*2)/6 = 12 steps/chunk, 6x the window's true 2
    assert s["env_steps"] == BATCH * (2 * 32 + 4 * 2)
    win_steps = BATCH * 2
    assert abs(s["env_steps_per_sec"] * s["mean_chunk_seconds"] - win_steps) < 1e-3 * win_steps


def test_fleet_sharded_out_of_scope_closed_loop_rides_scan():
    """A ShardedEnv outside the closed-loop kernel's scope selects the scan
    closed loop instead of raising on every chunk."""
    env = P.Pendulum(batch_size=BATCH, control_state=["theta"], solver="implicit_euler", **F64)
    senv = ShardedEnv(env, make_batch_mesh(MESH))
    assert not senv.closed_loop_in_scope()
    _, state = senv.vmap_reset(_keys(22, BATCH))
    state.reference.theta = torch.linspace(-1, 1, BATCH, dtype=torch.float64)
    runner = FleetRunner(senv)
    assert runner.rollout_path == "sharded_scan"
    state = runner.run_policy(state, _pd_policy, n_chunks=1, chunk_steps=4)
    assert runner.closed_loop_path == "closed_loop_scan"
    assert runner.summary()["chunks"] == 1


# ---------------------------------------------------------------------------
# parity with the JAX package's FleetRunner
# ---------------------------------------------------------------------------


def _summaries_agree(port, jax_runner, steps):
    ps, js = port.summary(), jax_runner.summary()
    assert ps["chunks"] == js["chunks"] and ps["env_steps"] == js["env_steps"] == steps
    for key in ("obs_min", "obs_max"):
        np.testing.assert_array_equal(ps[key].numpy(), np.asarray(js[key]))
    for key in ("obs_mean", "obs_std"):
        np.testing.assert_allclose(ps[key].numpy(), np.asarray(js[key]), **STATS_TOL)
    assert torch.equal(port.obs_stats.count, torch.as_tensor(np.asarray(jax_runner.obs_stats.count)))


def _pendulum_runs(n_chunks=3, chunk_steps=8, seed=0):
    je = J.Pendulum(batch_size=BATCH)
    pe = P.Pendulum(batch_size=BATCH, **F64)
    jk = jax.random.split(jax.random.PRNGKey(seed), BATCH)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(torch.as_tensor(np.asarray(jk).astype(np.int64)))
    slabs = _slabs(seed, BATCH, chunk_steps, 1, n_chunks)
    return je, pe, js, ps, slabs


def test_pendulum_run_matches_jax():
    n_chunks, chunk_steps = 3, 8
    je, pe, js, ps, slabs = _pendulum_runs(n_chunks, chunk_steps)
    jr, pr = JFleetRunner(je), FleetRunner(pe)
    jfinal = jr.run(js, lambda k: jnp.asarray(slabs[k]), n_chunks, chunk_steps)
    pfinal = pr.run(ps, lambda k: torch.as_tensor(slabs[k]), n_chunks, chunk_steps)
    assert pr.rollout_path == "fused"
    for f in ("theta", "omega"):
        np.testing.assert_allclose(getattr(pfinal.physical_state, f).numpy(),
                                   np.asarray(getattr(jfinal.physical_state, f)), **TOL)
    _summaries_agree(pr, jr, n_chunks * BATCH * chunk_steps)


def test_brusa_run_matches_jax():
    n_chunks, chunk_steps, B = 2, 8, 32
    je = J.PMSM(batch_size=B, saturated=True, motor_variant=J.MotorVariant.BRUSA)
    pe = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    jk = jax.random.split(jax.random.PRNGKey(1), B)
    _, js = je.vmap_reset(jk)
    ps = state_from_numpy(pe, {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS},
                          keys=np.asarray(js.PRNGKey))
    slabs = _slabs(1, B, chunk_steps, 2, n_chunks)
    jr, pr = JFleetRunner(je), FleetRunner(pe)
    jfinal = jr.run(js, lambda k: jnp.asarray(slabs[k]), n_chunks, chunk_steps)
    pfinal = pr.run(ps, lambda k: torch.as_tensor(slabs[k]), n_chunks, chunk_steps)
    assert pr.rollout_path == "pmsm_fused"
    for f in PMSM_FIELDS:
        np.testing.assert_allclose(getattr(pfinal.physical_state, f).numpy(),
                                   np.asarray(getattr(jfinal.physical_state, f)), **PMSM_TOL)
    ps_, js_ = pr.summary(), jr.summary()
    assert ps_["env_steps"] == js_["env_steps"] == n_chunks * B * chunk_steps
    for key in ("obs_mean", "obs_min", "obs_max"):
        np.testing.assert_allclose(ps_[key].numpy(), np.asarray(js_[key]), rtol=1e-6, atol=1e-6)


def _jax_tracking(seed, batch=BATCH):
    je = J.Pendulum(batch_size=batch, control_state=["theta"])
    jk = jax.random.split(jax.random.PRNGKey(seed), batch)
    _, js = je.vmap_reset(jk)
    js = jstructures.replace(js, reference=jstructures.replace(js.reference, theta=jnp.linspace(-1, 1, batch)))
    pe = P.Pendulum(batch_size=batch, control_state=["theta"], **F64)
    _, ps = pe.vmap_reset(torch.as_tensor(np.asarray(jk).astype(np.int64)))
    ps.reference.theta = torch.linspace(-1, 1, batch, dtype=torch.float64)
    return je, pe, js, ps


def test_pd_run_policy_matches_jax():
    je, pe, js, ps = _jax_tracking(5)
    jr, pr = JFleetRunner(je), FleetRunner(pe)
    jfinal = jr.run_policy(js, _pd_policy, n_chunks=3, chunk_steps=6)
    pfinal = pr.run_policy(ps, _pd_policy, n_chunks=3, chunk_steps=6)
    assert pr.closed_loop_path == "closed_loop_fused"
    for f in ("theta", "omega"):
        np.testing.assert_allclose(getattr(pfinal.physical_state, f).numpy(),
                                   np.asarray(getattr(jfinal.physical_state, f)), **TOL)
    _summaries_agree(pr, jr, 3 * BATCH * 6)


def test_stateful_pi_run_policy_matches_jax():
    je, pe, js, ps = _jax_tracking(6)
    jr, pr = JFleetRunner(je), FleetRunner(pe)
    jfinal, jcarry = jr.run_policy(js, _pi_policy, n_chunks=4, chunk_steps=8, policy_carry=(jnp.zeros(BATCH),))
    pfinal, pcarry = pr.run_policy(ps, _pi_policy, n_chunks=4, chunk_steps=8,
                                   policy_carry=(torch.zeros(BATCH, dtype=torch.float64),))
    for f in ("theta", "omega"):
        np.testing.assert_allclose(getattr(pfinal.physical_state, f).numpy(),
                                   np.asarray(getattr(jfinal.physical_state, f)), **TOL)
    np.testing.assert_allclose(pcarry[0].numpy(), np.asarray(jcarry[0]), **TOL)
    _summaries_agree(pr, jr, 4 * BATCH * 8)


def test_a_jax_fleet_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    monkeypatch.setattr(jck, "ORBAX_AVAILABLE", False)  # the JAX package's writer without orbax: .npz
    je, pe, js, ps, slabs = _pendulum_runs(4, 8, seed=3)
    jr = JFleetRunner(je, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    jfinal = jr.run(js, lambda k: jnp.asarray(slabs[k]), 4, 8)
    path = FleetRunner.latest_checkpoint(str(tmp_path))
    assert path.endswith("fleet_000004.npz")
    pr = FleetRunner(pe, checkpoint_dir=str(tmp_path))
    restored, done = pr.resume(ps)
    assert done == 4 and pr.env_steps == jr.env_steps
    for f in ("theta", "omega"):
        np.testing.assert_array_equal(getattr(restored.physical_state, f).numpy(),
                                      np.asarray(getattr(jfinal.physical_state, f)))
    np.testing.assert_array_equal(restored.PRNGKey.numpy(), np.asarray(jfinal.PRNGKey).astype(np.int64))
    for name in ("count", "mean", "m2", "min", "max"):
        np.testing.assert_array_equal(getattr(pr.obs_stats, name).numpy(), np.asarray(getattr(jr.obs_stats, name)))
    # and runs on from there
    pr.run(restored, lambda k: torch.as_tensor(slabs[0]), 1, 8)
    assert pr.summary()["chunks"] == 5


def test_a_port_fleet_checkpoint_resumes_in_jax(tmp_path):
    je, pe, js, ps, slabs = _pendulum_runs(4, 8, seed=4)
    pr = FleetRunner(pe, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    pfinal = pr.run(ps, lambda k: torch.as_tensor(slabs[k]), 4, 8)
    jr = JFleetRunner(je, checkpoint_dir=str(tmp_path))
    restored, done = jr.resume(js)
    assert done == 4 and jr.env_steps == pr.env_steps
    for f in ("theta", "omega"):
        np.testing.assert_array_equal(np.asarray(getattr(restored.physical_state, f)),
                                      getattr(pfinal.physical_state, f).numpy())
    for name in ("count", "mean", "m2", "min", "max"):
        np.testing.assert_array_equal(np.asarray(getattr(jr.obs_stats, name)), getattr(pr.obs_stats, name).numpy())
