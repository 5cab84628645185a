"""The port's adaptive integration (``ops/adaptive.py`` and the PMSM's
``_adaptive_rollout``) against the JAX package's: the counterparts of
tests/test_adaptive.py, on CPU tensors in float64.

Where a case is held against a reference (the exact solution, a fixed-step
rollout), the port's run is also held against the JAX package's from the
same inputs: the ``AdaptiveStats`` counts (accepted, rejected, incomplete)
exactly, the states at rtol = atol = 1e-12 (XLA's CPU contracts the stages'
multiply-adds, PyTorch does not).  ``final_dt`` is not compared: it scales
with ``ratio ** (-1/5)`` of an error estimate that is itself a difference
of nearly equal sums, whose last bits differ.  The saturated drive's table
gather is only piecewise smooth: a last-bit difference moves an error
estimate across a cell edge and changes the controller's choices, so there
the counts are held within a stated share of JAX's and the states at the
integration tolerance's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_torch as P
import exciting_environments_tpu as J
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import adaptive as A
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.ops.rollout import solve_trajectory
from exciting_environments_torch.ops.solvers import Dopri5, Euler, Tsit5
from exciting_environments_torch.utils.convert import state_from_numpy
from exciting_environments_tpu.ops import adaptive as JA
from exciting_environments_tpu.ops import solvers as JS

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-12, atol=1e-12)
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def _decay(t, y, args):
    (lam,) = args
    return (-lam * y[0],)


def _oscillator(t, y, args):
    x, v = y
    return (v, -x)


def t64(*values):
    return tuple(torch.as_tensor(v, dtype=torch.float64) for v in values)


def _same_stats(stats, jstats):
    for name in ("accepted", "rejected", "incomplete"):
        np.testing.assert_array_equal(getattr(stats, name).numpy(), np.asarray(getattr(jstats, name)), err_msg=name)


def _same_solve(y, stats, jy, jstats):
    _same_stats(stats, jstats)
    for a, b in zip(y, jy):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("name", ["tsit5", "dopri5"])
def test_accuracy_tracks_tolerance(name):
    solver, jsolver = (Tsit5(), JS.Tsit5()) if name == "tsit5" else (Dopri5(), JS.Dopri5())
    for rtol in [1e-4, 1e-8]:
        y, stats = A.adaptive_solve(solver, _decay, t64(1.0), (2.0,), 0.0, 1.0, rtol=rtol, atol=rtol)
        assert abs(float(y[0]) - np.exp(-2.0)) < 50 * rtol
        jy, jstats = JA.adaptive_solve(jsolver, _decay, (1.0,), (2.0,), 0.0, 1.0, rtol=rtol, atol=rtol)
        _same_solve(y, stats, jy, jstats)


def test_fewer_steps_than_fixed_for_same_accuracy():
    _, y_fix = solve_trajectory(Tsit5(), _oscillator, t64(1.0, 0.0), (), 1000, 0.01)
    y, stats = A.adaptive_solve(Tsit5(), _oscillator, t64(1.0, 0.0), (), 0.0, 10.0, rtol=1e-8, atol=1e-10)
    assert abs(float(y[0]) - np.cos(10.0)) < 1e-6 and abs(float(y_fix[0]) - np.cos(10.0)) < 1e-8
    assert int(stats.accepted) < 300  # vs 1000 fixed steps
    jy, jstats = JA.adaptive_solve(JS.Tsit5(), _oscillator, (1.0, 0.0), (), 0.0, 10.0, rtol=1e-8, atol=1e-10)
    _same_solve(y, stats, jy, jstats)


def test_per_instance_step_counts():
    lams = np.array([0.1, 1.0, 10.0, 100.0])
    y, stats = A.adaptive_solve(Tsit5(), _decay, t64(np.ones(4)), t64(lams), 0.0, 1.0, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(y[0].numpy(), np.exp(-lams), rtol=1e-5, atol=1e-8)
    counts = stats.accepted.numpy()
    assert counts[3] > 3 * counts[0], counts
    jy, jstats = JA.adaptive_solve(JS.Tsit5(), _decay, (jnp.ones(4),), (jnp.asarray(lams),), 0.0, 1.0, rtol=1e-7,
                                   atol=1e-9)
    _same_solve(y, stats, jy, jstats)


def test_rejections_happen_and_converge():
    y, stats = A.adaptive_solve(Tsit5(), _decay, t64(1.0), (50.0,), 0.0, 1.0, dt0=1.0, rtol=1e-6, atol=1e-9)
    assert int(stats.rejected) >= 1
    assert abs(float(y[0]) - np.exp(-50.0)) < 1e-6
    jy, jstats = JA.adaptive_solve(JS.Tsit5(), _decay, (1.0,), (50.0,), 0.0, 1.0, dt0=1.0, rtol=1e-6, atol=1e-9)
    _same_solve(y, stats, jy, jstats)


def test_no_embedded_pair_rejected():
    with pytest.raises(ValueError, match="embedded"):
        A.adaptive_solve(Euler(), _decay, t64(1.0), (1.0,), 0.0, 1.0)


def test_overflowing_trial_step_recovers():
    """A trial step that overflows is rejected (dt shrinks by min_factor)
    instead of poisoning the controller."""
    f = lambda t, y, a: (-(y[0] ** 3) * 1e6,)
    y, stats = A.adaptive_solve(Tsit5(), f, t64(1.0), (), 0.0, 1.0, dt0=1.0)
    assert np.isfinite(float(y[0])) and np.isfinite(float(stats.final_dt)) and int(stats.accepted) > 0
    # y' = -1e6 y^3, y(0) = 1 -> y(1) = 1 / sqrt(1 + 2e6)
    np.testing.assert_allclose(float(y[0]), (1 + 2e6) ** -0.5, rtol=1e-3)
    jy, jstats = JA.adaptive_solve(JS.Tsit5(), f, (1.0,), (), 0.0, 1.0, dt0=1.0)
    _same_solve(y, stats, jy, jstats)


def test_mixed_scalar_and_batched_leaves():
    y, _ = A.adaptive_solve(Tsit5(), _oscillator, (1.0, torch.zeros(4, dtype=torch.float64)), (), 0.0, 3.0,
                            rtol=1e-7, atol=1e-9)
    assert y[0].shape == (4,) and y[0].dtype == torch.float64
    np.testing.assert_allclose(y[0].numpy(), np.full(4, np.cos(3.0)), rtol=1e-5)
    # all-scalar leaves take the device asked for and float64
    y, stats = A.adaptive_solve(Tsit5(), _decay, (1.0,), (1.0,), 0.0, 1.0, device="cpu")
    assert y[0].dtype == torch.float64 and stats.accepted.shape == ()


def test_fsal_reuse_matches_plain_stepping():
    y, _ = A.adaptive_solve(Tsit5(), _oscillator, t64(1.0, 0.0), (), 0.0, 10.0, rtol=1e-8, atol=1e-10)
    y2, _ = A.adaptive_solve(Dopri5(), _oscillator, t64(1.0, 0.0), (), 0.0, 10.0, rtol=1e-8, atol=1e-10)
    assert abs(float(y[0]) - np.cos(10.0)) < 1e-6 and abs(float(y2[0]) - np.cos(10.0)) < 1e-6


def test_condition_reads_are_sparse_and_the_bound_exact():
    """The loop reads its condition before iterations 0, 1, 2, 4, 8, 16 and
    then every CHECK_EVERY, and never runs past max_steps."""
    A.reset_counts()
    A.adaptive_solve(Tsit5(), _oscillator, t64(1.0, 0.0), (), 0.0, 100.0, rtol=1e-10, atol=1e-12, max_steps=37)
    assert A.COUNTS == {"iterations": 37, "syncs": 7}  # before 0, 1, 2, 4, 8, 16, 32
    A.reset_counts()
    _, stats = A.adaptive_solve(Tsit5(), _decay, t64(1.0), (1.0,), 0.0, 1.0)
    assert A.COUNTS["iterations"] >= int(stats.accepted) + int(stats.rejected)
    assert A.COUNTS["syncs"] <= 8


def test_adaptive_rollout_matches_fine_fixed_step_and_jax():
    """Env-level adaptive rollout against a 50x-oversampled fixed-step RK4
    rollout of the pendulum (same ZOH actions), and against JAX."""
    B, N = 16, 20
    env = P.Pendulum(batch_size=B, tau=2e-2, **F64)
    jenv = J.Pendulum(batch_size=B, tau=2e-2)
    jk, tk = _keys(0, B)
    _, state = env.vmap_reset(tk)
    _, jstate = jenv.vmap_reset(jk)
    ja = jax.random.uniform(jax.random.PRNGKey(1), (B, N, 1), minval=-0.8, maxval=0.8)
    actions = torch.as_tensor(np.array(ja))
    obs, last, stats = A.adaptive_rollout(env, state, actions, rtol=1e-8, atol=1e-10)
    sub = 50
    env_f = P.Pendulum(batch_size=B, tau=env.tau / sub, solver="rk4", **F64)
    _, state_f = env_f.vmap_reset(tk)
    _, last_f = env_f.vmap_rollout(state_f, torch.repeat_interleave(actions, sub, dim=1), N * sub)
    for name in ("theta", "omega"):
        np.testing.assert_allclose(getattr(last.physical_state, name).numpy(),
                                   getattr(last_f.physical_state, name).numpy(), atol=1e-5)
    assert obs.shape == (B, 2) and int(stats.accepted.min()) > 0
    jobs, jlast, jstats = JA.adaptive_rollout(jenv, jstate, ja, rtol=1e-8, atol=1e-10)
    _same_stats(stats, jstats)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    np.testing.assert_allclose(last.physical_state.omega.numpy(), np.asarray(jlast.physical_state.omega), **TOL)


def test_adaptive_rollout_resolves_stiff_heterogeneous_batch():
    """Per-batch stiffness (spring constants 1..1e6) resolved per instance:
    the fixed-step path diverges for the stiff entries at this tau, the
    adaptive one stays accurate, with more steps there."""
    ks = np.array([1.0, 100.0, 1e4, 1e6])
    B = 4
    env = P.MassSpringDamper(batch_size=B, tau=2e-2, static_params={"k": ks, "d": 0.0, "m": 1.0}, **F64)
    jenv = J.MassSpringDamper(batch_size=B, tau=2e-2, static_params={"k": jnp.asarray(ks), "d": 0.0, "m": 1.0})
    _, state = env.vmap_reset()
    state = structures.replace(state, physical_state=env.PhysicalState(
        deflection=torch.ones(B, dtype=torch.float64), velocity=torch.zeros(B, dtype=torch.float64)))
    obs, last, stats = A.adaptive_rollout(env, state, torch.zeros((B, 5, 1), dtype=torch.float64), rtol=1e-9,
                                          atol=1e-11, max_steps_per_interval=10_000)
    expected = np.cos(np.sqrt(ks) * 5 * env.tau)
    np.testing.assert_allclose(last.physical_state.deflection.numpy(), expected, atol=1e-4)
    counts = stats.accepted.numpy()
    assert counts[3] > 10 * counts[0], counts
    _, last_fixed = env.vmap_rollout(state, torch.zeros((B, 5, 1), dtype=torch.float64), 5)
    fixed = last_fixed.physical_state.deflection.numpy()
    assert not np.all(np.isfinite(fixed)) or np.max(np.abs(fixed)) > 10
    _, jstate = jenv.vmap_reset()
    jstate = J.core.structures.replace(jstate, physical_state=jenv.PhysicalState(deflection=jnp.ones(B),
                                                                                  velocity=jnp.zeros(B)))
    _, jlast, jstats = JA.adaptive_rollout(jenv, jstate, jnp.zeros((B, 5, 1)), rtol=1e-9, atol=1e-11,
                                           max_steps_per_interval=10_000)
    _same_stats(stats, jstats)
    np.testing.assert_allclose(last.physical_state.deflection.numpy(), np.asarray(jlast.physical_state.deflection),
                               rtol=1e-12, atol=1e-11)


def test_adaptive_rollout_applies_clip():
    """FluidTank's h >= 0 clip applies at interval boundaries."""
    env = P.FluidTank(batch_size=4, tau=5.0, **F64)  # long drain intervals
    _, state = env.vmap_reset()
    _, last, _ = A.adaptive_rollout(env, state, -torch.ones((4, 3, 1), dtype=torch.float64))
    h = last.physical_state.height.numpy()
    assert np.all(h >= 0.0) and np.all(np.isfinite(h))


def test_incomplete_flag_on_step_budget_exhaustion():
    _, stats = A.adaptive_solve(Tsit5(), _oscillator, t64(1.0, 0.0), (), 0.0, 100.0, rtol=1e-10, atol=1e-12,
                                max_steps=5)
    assert bool(stats.incomplete) and int(stats.accepted) + int(stats.rejected) == 5
    _, stats2 = A.adaptive_solve(Tsit5(), _decay, t64(1.0), (1.0,), 0.0, 1.0)
    assert not bool(stats2.incomplete)


def test_adaptive_rollout_rejects_derived_state_envs_without_hook():
    class PendulumWithDerived(P.Pendulum):
        _ode_state_fields = ("theta",)  # pretend omega is a derived field

    env = PendulumWithDerived(batch_size=4, **F64)
    _, state = env.vmap_reset()
    with pytest.raises(ValueError, match="derived fields"):
        A.adaptive_rollout(env, state, torch.zeros((4, 3, 1), dtype=torch.float64))


def test_pmsm_adaptive_per_batch_params_match_jax():
    """Per-batch r_s: heterogeneous electrical parameters integrate per
    instance, as in the JAX package (counts exactly, states at 1e-12)."""
    B = 8
    r_s = np.linspace(5e-3, 50e-3, B)
    params = {"p": 3, "r_s": r_s, "l_d": 0.37e-3, "l_q": 1.2e-3, "psi_p": 65.6e-3, "u_dc": 400, "deadtime": 1}
    env = P.PMSM(batch_size=B, tau=1e-4, static_params=params, **F64)
    jenv = J.PMSM(batch_size=B, tau=1e-4, static_params={**params, "r_s": jnp.asarray(r_s)})
    _, state = env.vmap_reset()
    _, jstate = jenv.vmap_reset()
    obs, last, stats = A.adaptive_rollout(env, state, torch.full((B, 6, 2), 0.3, dtype=torch.float64), rtol=1e-9,
                                          atol=1e-11)
    assert bool(torch.isfinite(obs).all()) and not bool(stats.incomplete.any())
    assert float(last.physical_state.i_d.std()) > 1e-6
    jobs, jlast, jstats = JA.adaptive_rollout(jenv, jstate, 0.3 * jnp.ones((B, 6, 2)), rtol=1e-9, atol=1e-11)
    _same_stats(stats, jstats)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), **TOL)
    for name in PMSM_FIELDS:
        np.testing.assert_allclose(getattr(last.physical_state, name).numpy(),
                                   np.asarray(getattr(jlast.physical_state, name)), rtol=1e-12, atol=1e-9,
                                   err_msg=name)
    # an env_properties override takes the place of the environment's own
    props = env.env_properties
    other = structures.replace(props, static_params=structures.replace(
        props.static_params, r_s=torch.full((B,), 20e-3, dtype=torch.float64)))
    _, last_o, _ = A.adaptive_rollout(env, state, torch.full((B, 6, 2), 0.3, dtype=torch.float64), rtol=1e-9,
                                      atol=1e-11, env_properties=other)
    assert float(last_o.physical_state.i_d.std()) < 1e-9


def test_warm_start_survives_interval_clipping():
    """The proposal carried across intervals does not collapse to each
    interval's remainder: a handful of steps per interval on average."""
    env = P.Pendulum(batch_size=2, tau=2e-2, **F64)
    _, state = env.vmap_reset(R.split(R.PRNGKey(0, "cpu"), 2))
    _, _, stats = A.adaptive_rollout(env, state, torch.full((2, 40, 1), 0.3, dtype=torch.float64), rtol=1e-6,
                                     atol=1e-8)
    assert float(stats.accepted.max()) / 40 < 6, stats.accepted
    assert not bool(stats.incomplete.any())


@pytest.mark.slow
def test_pmsm_adaptive_matches_fixed_tsit5_nonstiff():
    """At a benign operating point one Tsit5 step per tau is accurate, so the
    adaptive path (step()'s hexagon, deadtime and torque semantics) agrees
    with the fixed-step Tsit5 rollout, and with the JAX package."""
    B, N = 8, 12
    env = P.PMSM(batch_size=B, tau=1e-4, solver="tsit5", **F64)
    jenv = J.PMSM(batch_size=B, tau=1e-4, solver="tsit5")
    jk, _ = _keys(0, B)
    _, jstate = jenv.vmap_reset(jk)
    state = state_from_numpy(env, {n: np.asarray(getattr(jstate.physical_state, n)) for n in PMSM_FIELDS},
                             keys=np.asarray(jstate.PRNGKey))
    actions = torch.full((B, N, 2), 0.25, dtype=torch.float64)
    obs_a, last_a, stats = A.adaptive_rollout(env, state, actions, rtol=1e-10, atol=1e-12)
    obs_f, last_f = env.vmap_rollout(state, actions, N)
    assert not bool(stats.incomplete.any())
    for name, tol in (("i_d", dict(rtol=1e-6, atol=1e-4)), ("i_q", dict(rtol=1e-6, atol=1e-4)),
                      ("epsilon", dict(rtol=1e-6, atol=1e-6)), ("u_d_buffer", dict(rtol=1e-12)),
                      ("u_q_buffer", dict(rtol=1e-12))):
        np.testing.assert_allclose(getattr(last_a.physical_state, name).numpy(),
                                   getattr(last_f.physical_state, name).numpy(), err_msg=name, **tol)
    assert obs_a.shape == obs_f[:, -1].shape
    _, jlast, jstats = JA.adaptive_rollout(jenv, jstate, 0.25 * jnp.ones((B, N, 2)), rtol=1e-10, atol=1e-12)
    _same_stats(stats, jstats)
    for name in PMSM_FIELDS:
        np.testing.assert_allclose(getattr(last_a.physical_state, name).numpy(),
                                   np.asarray(getattr(jlast.physical_state, name)), rtol=1e-12, atol=1e-9)


@pytest.mark.slow
def test_pmsm_adaptive_saturated_lut():
    """Saturated-table magnetics integrate adaptively; the final torque is the
    table torque of the final currents."""
    B = 6
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    _, state = env.vmap_reset(R.split(R.PRNGKey(1, "cpu"), B))
    obs, last, stats = A.adaptive_rollout(env, state, torch.full((B, 5, 2), 0.3, dtype=torch.float64), rtol=1e-8,
                                          atol=1e-10)
    assert bool(torch.isfinite(obs).all()) and not bool(stats.incomplete.any())
    expected = env.currents_to_torque_saturated(last.physical_state.i_d, last.physical_state.i_q, env.env_properties)
    np.testing.assert_allclose(last.physical_state.torque.numpy(), expected.numpy(), rtol=1e-12)


def test_pmsm_adaptive_saturated_lut_matches_jax():
    """The saturated drive's interval loop (table gather, hexagon, deadtime)
    against the JAX package's from the carried-over state.  At rtol 1e-9 the
    currents and torque agree within 6.7e-5 (A, Nm) and the counts within
    6 accepted and 29 rejected steps of JAX's per instance (B = 8); held at
    1e-3 A and Nm, 15% of JAX's accepted and 25% of its rejected counts per
    instance, and 5% of each over the batch.  A wrong gather or constraint
    moves the currents by amperes."""
    B, N = 8, 6
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    jenv = J.PMSM(batch_size=B, saturated=True, motor_variant=J.MotorVariant.BRUSA)
    jk, _ = _keys(1, B)
    _, jstate = jenv.vmap_reset(jk)
    state = state_from_numpy(env, {n: np.asarray(getattr(jstate.physical_state, n)) for n in PMSM_FIELDS},
                             keys=np.asarray(jstate.PRNGKey))
    obs, last, stats = A.adaptive_rollout(env, state, torch.full((B, N, 2), 0.3, dtype=torch.float64), rtol=1e-9,
                                          atol=1e-11)
    jobs, jlast, jstats = JA.adaptive_rollout(jenv, jstate, 0.3 * jnp.ones((B, N, 2)), rtol=1e-9, atol=1e-11)
    assert not bool(stats.incomplete.any()) and not bool(jnp.any(jstats.incomplete))
    for name, share, total in (("accepted", 0.15, 0.05), ("rejected", 0.25, 0.05)):
        ours, theirs = getattr(stats, name).numpy(), np.asarray(getattr(jstats, name))
        assert np.all(np.abs(ours - theirs) <= share * theirs), (name, ours, theirs)
        assert abs(int(ours.sum()) - int(theirs.sum())) <= total * int(theirs.sum()), (name, ours, theirs)
    for name, tol in (("i_d", 1e-3), ("i_q", 1e-3), ("torque", 1e-3), ("epsilon", 1e-12),
                      ("u_d_buffer", 1e-12), ("u_q_buffer", 1e-12), ("omega_el", 0.0)):
        np.testing.assert_allclose(getattr(last.physical_state, name).numpy(),
                                   np.asarray(getattr(jlast.physical_state, name)), rtol=0, atol=tol, err_msg=name)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=1e-5)
