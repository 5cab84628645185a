"""The port's planners (``utils/mpc.py``) against the JAX package's, on CPU
tensors in float64, from the same keys.

Keys and uniforms are bit for bit with ``jax.random``; normals differ in
``erfinv``'s last bits (ROADMAP Queue 3), so plans agree to rtol 1e-9 of
each leaf's largest magnitude (``_close``), with the deviations measured on
an x86-64 CPU (PyTorch with MKL) beside each case. The port's fused backend
runs the kernels' plain versions on CPU tensors and is held against the JAX
fused backend in Pallas interpret mode (``tests/test_mpc.py:169,193``). The
Pendulum's keyed reset draws the JAX package's bits, so its states agree
from the key alone; the PMSM's reset draws its current disc with other bits,
so the PMSM cases carry the JAX state across (``state_from_numpy``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import episodes as jep
from exciting_environments_tpu.utils import mpc as jmpc
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes as pep
from exciting_environments_torch.utils import mpc as pmpc
from exciting_environments_torch.utils.convert import state_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
RTOL = 1e-9
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def _key(seed):
    k = jax.random.PRNGKey(seed)
    return k, torch.as_tensor(np.asarray(k).astype(np.int64))


def _close(port, ref, rtol=RTOL):
    """``|port - ref| <= rtol * max|ref|`` over the whole leaf."""
    p = port.detach().double().numpy()
    r = np.asarray(ref, dtype=np.float64)
    assert p.shape == r.shape, (p.shape, r.shape)
    dev = float(np.abs(p - r).max())
    assert dev <= rtol * max(float(np.abs(r).max()), 1e-300), (dev, float(np.abs(r).max()))
    return dev


def _configs(**kw):
    return jmpc.MPPIConfig(**kw), pmpc.MPPIConfig(**kw)


def _pendulums(batch=4):
    return (J.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"]),
            P.Pendulum(batch_size=batch, tau=2e-2, control_state=["theta"], **F64))


def _pendulum_states(je, pe, seed=0):
    jk, pk = _key(seed)
    _, js = jep.reset_with_references(je, jk)
    _, ps = pep.reset_with_references(pe, pk)
    return js, ps


def _pmsm_pair(batch=8, **kw):
    """A JAX and a port PMSM and one tracking state for both: the JAX
    package's ``reset_with_references`` carried across."""
    je = J.PMSM(batch_size=batch, control_state=["i_d", "i_q"], **kw)
    pkw = dict(kw)
    if "motor_variant" in pkw:
        pkw["motor_variant"] = P.MotorVariant[pkw["motor_variant"].name]
    pe = P.PMSM(batch_size=batch, control_state=["i_d", "i_q"], **pkw, **F64)
    _, js = jep.reset_with_references(je, jax.random.PRNGKey(0))
    ps = state_from_numpy(pe, {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS},
                          reference={n: np.asarray(getattr(js.reference, n)) for n in ("i_d", "i_q")},
                          keys=np.asarray(js.PRNGKey))
    return je, pe, js, ps


def test_smooth_noise_matches_jax_and_keeps_the_marginal_variance():
    eps = np.random.default_rng(0).standard_normal((64, 2, 24, 2))
    # measured 1.8e-15 / 4.4
    _close(pmpc._smooth_noise(torch.as_tensor(eps), 0.8), jmpc._smooth_noise(jnp.asarray(eps), 0.8))
    white = torch.as_tensor(eps)
    assert pmpc._smooth_noise(white, 0.0) is white
    sm = pmpc._smooth_noise(prng.normal(prng.PRNGKey(0, "cpu"), (4096, 2, 64, 1), torch.float64), 0.8)
    assert sm.shape == (4096, 2, 64, 1)
    assert 0.9 < float(torch.std(sm[:, :, 32:, :])) < 1.1
    assert float(torch.mean(sm[:, :, 40, 0] * sm[:, :, 41, 0])) > 0.5


def test_mppi_plan_scan_matches_jax_and_improves_the_default_cost():
    je, pe = _pendulums()
    js, ps = _pendulum_states(je, pe)
    cj, cp = _configs(horizon=10, n_samples=64, noise_sigma=0.4, n_iterations=2)
    jk, pk = _key(1)
    plan_j = jmpc.mppi_plan(je, js, jnp.zeros((4, 10, 1)), jk, cj, fused=False)
    plan0 = torch.zeros(4, 10, 1, dtype=torch.float64)
    plan_p = pmpc.mppi_plan(pe, ps, plan0, pk, cp, fused=False)
    _close(plan_p, plan_j)  # measured 4.6e-14 / 0.86
    assert bool((plan_p.abs() <= 1.0).all())
    c0 = pmpc._trajectory_cost(pe, ps, plan0, None)
    c1 = pmpc._trajectory_cost(pe, ps, plan_p, None)
    _close(c1, jmpc._trajectory_cost(je, js, plan_j, None))  # measured 1.9e-14 / 22.9
    assert float(c1.mean()) < float(c0.mean())


def test_run_mppi_scan_matches_jax():
    je, pe = _pendulums()
    js, ps = _pendulum_states(je, pe)
    cj, cp = _configs(horizon=8, n_samples=32, n_iterations=1, smoothing=0.3)
    jk, pk = _key(2)
    rj = jmpc.run_mppi(je, js, 6, jk, cj, fused=False)
    rp = pmpc.run_mppi(pe, ps, 6, pk, cp, fused=False)
    # measured: observations 4.4e-16 / 0.96, actions 2.6e-14 / 0.72, rewards 1.3e-15 / 3.7, plan 1.2e-14 / 0.56,
    # final theta 0.0
    for name in ("observations", "actions", "rewards", "plan"):
        _close(getattr(rp, name), getattr(rj, name))
    _close(rp.final_state.physical_state.theta, rj.final_state.physical_state.theta)
    assert rp.observations.shape == (4, 6, len(pe.obs_description))
    assert rp.actions.shape == (4, 6, 1) and rp.rewards.shape == (4, 6) and rp.plan.shape == (4, 8, 1)
    assert bool((rp.actions.abs() <= 1.0).all()) and bool((rp.rewards <= 0).all())


def test_fused_planning_on_the_pendulum_matches_jax_interpret_and_the_scan():
    """``tests/test_mpc.py:169``: the fused backend folds the samples into
    the kernel batch (B = 8 x 128 samples); on CPU tensors the stepper's
    plain version."""
    je, pe = _pendulums(batch=8)
    js, ps = _pendulum_states(je, pe)
    cj, cp = _configs(horizon=4, n_samples=128, noise_sigma=0.4, n_iterations=2)
    plan0 = torch.zeros(8, 4, 1, dtype=torch.float64)
    jk, pk = _key(1)
    p_jax = jmpc.mppi_plan(je, js, jnp.zeros((8, 4, 1)), jk, cj, fused=True, interpret=True)
    p_fused = pmpc.mppi_plan(pe, ps, plan0, pk, cp, fused=True)
    p_scan = pmpc.mppi_plan(pe, ps, plan0, pk, cp, fused=False)
    _close(p_fused, p_jax)  # measured 5.2e-15 / 0.14
    torch.testing.assert_close(p_fused, p_scan, rtol=0, atol=1e-14)
    jk, pk = _key(2)
    rj = jmpc.run_mppi(je, js, 3, jk, cj, fused=True, interpret=True)
    rf = pmpc.run_mppi(pe, ps, 3, pk, cp, fused=True)
    rs = pmpc.run_mppi(pe, ps, 3, pk, cp, fused=False)
    # measured: observations 3.9e-16 / 0.97, actions 6.0e-15 / 0.26, rewards 1.1e-15 / 3.7, plan 4.6e-15 / 0.15
    for name in ("observations", "actions", "rewards", "plan"):
        _close(getattr(rf, name), getattr(rj, name))
        torch.testing.assert_close(getattr(rf, name), getattr(rs, name), rtol=0, atol=1e-13)


def test_fused_planning_on_the_pmsm_matches_jax_interpret():
    """``tests/test_mpc.py:193``: PMSM candidates through the drive
    kernel's plain version (deadtime and hexagon inside), the auto backend."""
    je, pe, js, ps = _pmsm_pair()
    cj, cp = _configs(horizon=2, n_samples=128, noise_sigma=0.3, n_iterations=1)
    assert pmpc.planning_path(pe, cp) == "pmsm_fused"
    assert jmpc.planning_path(je, cj, interpret=True) == "pmsm_fused"
    plan0 = torch.zeros(8, 2, 2, dtype=torch.float64)
    jk, pk = _key(1)
    p_jax = jmpc.mppi_plan(je, js, jnp.zeros((8, 2, 2)), jk, cj, fused=True, interpret=True)
    p_auto = pmpc.mppi_plan(pe, ps, plan0, pk, cp)
    p_scan = pmpc.mppi_plan(pe, ps, plan0, pk, cp, fused=False)
    _close(p_auto, p_jax)  # measured 3.3e-16 / 0.41
    torch.testing.assert_close(p_auto, p_scan, rtol=0, atol=1e-14)


def test_mppi_tracks_pmsm_currents_like_jax():
    """``tests/test_mpc.py:210`` (saturated BRUSA, the auto backend, which
    is the drive kernel's plain version here): the port's run against the
    JAX package's scan from the same state and key, and its assertions."""
    je, pe, js, ps = _pmsm_pair(saturated=True, motor_variant=J.MotorVariant.BRUSA, tau=1e-4)
    cj, cp = _configs(horizon=8, n_samples=32, temperature=0.02, noise_sigma=0.3, n_iterations=1, smoothing=0.3)
    jk, pk = _key(8)
    rj = jmpc.run_mppi(je, js, 40, jk, cj, fused=False)
    rp = pmpc.run_mppi(pe, ps, 40, pk, cp)
    # measured: actions 1.5e-13 / 1.0, rewards 3.1e-15 / 0.47
    _close(rp.actions, rj.actions)
    _close(rp.rewards, rj.rewards)
    _, rew_zero, _ = pmpc._rollout(pe, ps, torch.zeros(8, 40, 2, dtype=torch.float64))
    assert float(rp.rewards[:, 20:].mean()) > -0.05
    assert float(rp.rewards.mean()) > float(rew_zero.mean()) + 1.0


def test_custom_cost_runs_on_both_backends():
    je, pe = _pendulums(batch=8)
    js, ps = _pendulum_states(je, pe)
    cj, cp = _configs(horizon=4, n_samples=16, n_iterations=1)
    cost_j = lambda obs, acts: jnp.sum(acts**2, axis=(1, 2)) + jnp.sum(obs[..., 0] ** 2, axis=1)
    cost_p = lambda obs, acts: torch.sum(acts**2, dim=(1, 2)) + torch.sum(obs[..., 0] ** 2, dim=1)
    jk, pk = _key(3)
    p_jax = jmpc.mppi_plan(je, js, jnp.zeros((8, 4, 1)), jk, cj, cost_fn=cost_j, fused=False)
    plan0 = torch.zeros(8, 4, 1, dtype=torch.float64)
    for fused in (False, True):  # measured 9.3e-16 / 0.17 each
        _close(pmpc.mppi_plan(pe, ps, plan0, pk, cp, cost_fn=cost_p, fused=fused), p_jax)


def test_optimize_actions_cost_curve_matches_jax():
    je, pe = _pendulums()
    js, ps = _pendulum_states(je, pe)
    rj = jmpc.optimize_actions(je, js, jnp.zeros((4, 10, 1)), iterations=30, learning_rate=0.2)
    rp = pmpc.optimize_actions(pe, ps, torch.zeros(4, 10, 1, dtype=torch.float64), iterations=30, learning_rate=0.2)
    assert rp.costs.shape == (31,)
    _close(rp.costs, rj.costs)  # measured 8.9e-15 / 13
    _close(rp.actions, rj.actions)  # measured 3.3e-16 / 1.0
    assert float(rp.costs[-1]) < float(rp.costs[0])
    assert bool((rp.actions.abs() <= 1.0).all())


def test_optimize_actions_with_a_custom_cost_reaches_its_optimum():
    je, pe = _pendulums()
    js, ps = _pendulum_states(je, pe)
    cost_j = lambda obs, acts: jnp.sum(acts**2, axis=(1, 2))
    cost_p = lambda obs, acts: torch.sum(acts**2, dim=(1, 2))
    rj = jmpc.optimize_actions(je, js, 0.5 * jnp.ones((4, 10, 1)), iterations=200, learning_rate=0.3, cost_fn=cost_j)
    rp = pmpc.optimize_actions(pe, ps, 0.5 * torch.ones(4, 10, 1, dtype=torch.float64), iterations=200,
                               learning_rate=0.3, cost_fn=cost_p)
    _close(rp.costs, rj.costs)  # measured 1.1e-15 / 2.5
    assert float(rp.actions.abs().max()) < 0.05


def test_planning_path_answers_by_scope_and_fused_true_refuses_out_of_it():
    """The JAX package answers ``"scan"`` on the CPU backend without
    interpret and when the folded batch is no multiple of 1,024
    (``tests/test_mpc.py:153``); the port has neither rule (ROADMAP Queue 3)."""
    je, pe = _pendulums(batch=8)
    _, ps = _pendulum_states(je, pe)
    assert pmpc.planning_path(pe, pmpc.MPPIConfig(horizon=4, n_samples=128)) == "fused"
    assert pmpc.planning_path(pe, pmpc.MPPIConfig(horizon=4, n_samples=100)) == "fused"
    assert jmpc.planning_path(je, jmpc.MPPIConfig(horizon=4, n_samples=128)) == "scan"
    assert jmpc.planning_path(je, jmpc.MPPIConfig(horizon=4, n_samples=100), interpret=True) == "scan"
    assert pmpc._resolve_fused(pe, pmpc.MPPIConfig(), None) is False  # auto: the kernel for the PMSM only
    assert pmpc._resolve_fused(pe, pmpc.MPPIConfig(), True) is True
    stiff = P.Pendulum(batch_size=8, tau=2e-2, control_state=["theta"], solver="implicit_euler", **F64)
    cfg = pmpc.MPPIConfig(horizon=4, n_samples=16)
    assert pmpc.planning_path(stiff, cfg) == "scan"
    with pytest.raises(ValueError, match="fused=True"):
        pmpc.mppi_plan(stiff, ps, torch.zeros(8, 4, 1, dtype=torch.float64), _key(0)[1], cfg, fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        pmpc.run_mppi(stiff, ps, 2, config=cfg, fused=True)
    params = dict(P.MotorVariant.DEFAULT.get_params().static_params.__dict__)
    params["deadtime"] = np.array([0.0, 1.0, 0.0, 1.0])
    fleet = P.PMSM(batch_size=4, static_params=params, control_state=["i_d", "i_q"], **F64)
    assert pmpc.planning_path(fleet, cfg) == "scan"
    assert pmpc._resolve_fused(fleet, cfg, None) is False


def test_fused_cost_path_is_strict(monkeypatch):
    """The fused backend calls the entry points with ``strict=True`` and the
    saved states, one rollout of all ``K * B`` candidates."""
    from exciting_environments_torch.ops.kernels import stepper

    calls = []
    real = stepper.env_fused_rollout

    def spy(env, state, actions, **kw):
        calls.append((env.batch_size, tuple(actions.shape), kw))
        return real(env, state, actions, **kw)

    monkeypatch.setattr(stepper, "env_fused_rollout", spy)
    je, pe = _pendulums()
    _, ps = _pendulum_states(je, pe)
    cfg = pmpc.MPPIConfig(horizon=3, n_samples=5, n_iterations=2)
    pmpc.mppi_plan(pe, ps, torch.zeros(4, 3, 1, dtype=torch.float64), _key(0)[1], cfg, fused=True)
    assert calls == [(20, (20, 3, 1), dict(obs_stride=1, return_traj_states=True, strict=True))] * 2


def test_tile_env_tiles_per_batch_leaves_sample_major():
    params = {"l": np.array([1.0, 1.1, 1.2]), "m": 1.0, "g": 9.81}
    env = P.Pendulum(batch_size=3, tau=2e-2, static_params=params, control_state=["theta"], **F64)
    big = pmpc._tile_env(env, 2)
    assert big.batch_size == 6 and env.batch_size == 3
    np.testing.assert_array_equal(big.env_properties.static_params.l.numpy(), [1.0, 1.1, 1.2] * 2)
    assert big.env_properties.static_params.m == 1.0
    _, st = env.vmap_reset(prng.split(prng.PRNGKey(0, "cpu"), 3))
    tiled = pmpc._tile_state(st, 2)
    np.testing.assert_array_equal(tiled.physical_state.theta.numpy(), np.tile(st.physical_state.theta.numpy(), 2))
    np.testing.assert_array_equal(tiled.PRNGKey.numpy(), np.tile(st.PRNGKey.numpy(), (2, 1)))


def test_validation_errors():
    je, pe = _pendulums()
    _, ps = _pendulum_states(je, pe)
    cfg = pmpc.MPPIConfig(horizon=10)
    key = _key(0)[1]
    with pytest.raises(ValueError, match="shape"):
        pmpc.mppi_plan(pe, ps, torch.zeros(4, 7, 1, dtype=torch.float64), key, cfg)
    with pytest.raises(ValueError, match="horizon"):
        pmpc.optimize_actions(pe, ps, torch.zeros(3, 10, 1, dtype=torch.float64), iterations=1)
    no_cs = P.Pendulum(batch_size=4, **F64)
    with pytest.raises(ValueError, match="control_state"):
        pmpc.mppi_plan(no_cs, ps, torch.zeros(4, 10, 1, dtype=torch.float64), key, cfg)
    _, bare = pe.vmap_reset(prng.split(key, 4))
    with pytest.raises(ValueError, match="reference"):
        pmpc.run_mppi(pe, bare, 2, config=cfg)
    res = pmpc.run_mppi(pe, bare, 2, config=pmpc.MPPIConfig(horizon=4, n_samples=8),
                        cost_fn=lambda obs, acts: torch.sum(acts**2, dim=(1, 2)))
    assert bool(torch.isfinite(res.actions).all())
    assert res.actions.device.type == "cpu" and res.plan.dtype == torch.float64
