"""Stochastic simulation in the port (process and sensor noise, both draw
modes) against the JAX package from the same keys, on CPU tensors.

The cases of tests/test_noise.py, each held
both within the port (loop against fused path, step against sim-ahead) and
against the JAX package.  Float64 throughout.  Tolerances: stochastic
trajectories agree with the JAX package at rtol 1e-10 (atol 1e-12 on
normalized observations, 1e-9 on physical PMSM leaves); the difference is
``erfinv``'s last bits (tests/test_torch_random.py) carried through the
dynamics.  Final and per-save keys agree bit for bit.  The injected-draw
hooks agree at 1e-12.  Within the port, the fused path's plain version and
the loop run the same operations and agree exactly (``array_equal``).
Gradients through the noisy fused paths follow ``jax.grad`` to 1e-9 of the
largest gradient, and the PMSM slab's cotangent follows autograd through
the plain loop to 1e-12.  The FluidTank's clipped stochastic sim-ahead
agrees with the JAX package at the same tolerance.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.utils.collect import tile_policy_scan as j_tile_policy_scan
from exciting_environments_tpu.utils.train import default_tracking_loss as j_default_tracking_loss
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as R
from exciting_environments_torch.ops.adaptive import adaptive_rollout
from exciting_environments_torch.ops.kernels import pmsm_stepper as PK
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.ops.kernels.closed_loop import env_fused_closed_loop
from exciting_environments_torch.ops.kernels.stepper import env_fused_rollout
from exciting_environments_torch.utils.collect import tile_policy_scan
from exciting_environments_torch.utils.convert import state_from_numpy, tree_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
TAU = 1e-2
TOL = dict(rtol=1e-10, atol=1e-12)
PHYS_TOL = dict(rtol=1e-10, atol=1e-9)
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def _keys(seed, n):
    jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.as_tensor(np.asarray(jk).astype(np.int64))


def _key_eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j).astype(np.int64))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _pendulum(batch, seed=0, **kw):
    """The JAX and port pendulums and their states reset from the same keys."""
    je = J.Pendulum(batch_size=batch, tau=TAU, **kw)
    pe = P.Pendulum(batch_size=batch, tau=TAU, **kw, **F64)
    jk, tk = _keys(seed, batch)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(tk)
    _key_eq(ps.PRNGKey, js.PRNGKey)
    _close(ps.physical_state.theta, js.physical_state.theta)
    return je, pe, js, ps


def _actions(seed, batch, n, dim=1, lim=1.0):
    a = np.random.default_rng(seed).uniform(-lim, lim, (batch, n, dim))
    return jnp.asarray(a), torch.as_tensor(a)


def _pmsm(batch, saturated=True, seed=0, deadtime=None, **kw):
    """The JAX and port drives and the JAX package's keyed reset, carried
    across with its keys (the port's keyed reset draws the current disc from
    the same law with other bits: only its keys and angle draws agree)."""
    params = None
    if deadtime is not None:
        params = dict(J.MotorVariant.BRUSA.get_params().static_params.__dict__, deadtime=deadtime)
        if saturated:
            params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
    je = J.PMSM(batch_size=batch, saturated=saturated, motor_variant=J.MotorVariant.BRUSA, static_params=params,
                **kw)
    pe = P.PMSM(batch_size=batch, saturated=saturated, motor_variant=P.MotorVariant.BRUSA, static_params=params,
                **kw, **F64)
    jk, tk = _keys(seed, batch)
    _, js = je.vmap_reset(jk)
    arrays = {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS}
    ps = state_from_numpy(pe, arrays, keys=np.asarray(js.PRNGKey))
    _, own = pe.vmap_reset(tk)
    assert torch.equal(own.PRNGKey, ps.PRNGKey)
    _close(own.physical_state.epsilon, js.physical_state.epsilon)
    _close(own.physical_state.omega_el, js.physical_state.omega_el)
    return je, pe, js, ps


# ---------------------------------------------------------------------------
# classic environments
# ---------------------------------------------------------------------------


def test_process_noise_statistics_and_key_threading():
    B = 4096
    je, env, js, st = _pendulum(B, process_noise={"omega": 0.5})
    det = P.Pendulum(batch_size=B, tau=TAU, **F64)
    _, sd = det.vmap_reset(_keys(0, B)[1])
    _, st1 = env.vmap_step(st, torch.zeros((B, 1), dtype=torch.float64))
    _, jst1 = je.vmap_step(js, jnp.zeros((B, 1)))
    _, sd1 = det.vmap_step(sd, torch.zeros((B, 1), dtype=torch.float64))
    _key_eq(st1.PRNGKey, jst1.PRNGKey)
    _close(st1.physical_state.omega, jst1.physical_state.omega)
    assert not torch.equal(st.PRNGKey, st1.PRNGKey)
    d = (st1.physical_state.omega - sd1.physical_state.omega).numpy()
    expected = 0.5 * np.sqrt(TAU)
    assert abs(d.std() / expected - 1.0) < 0.1
    assert abs(d.mean()) < 5 * expected / np.sqrt(B)
    assert np.abs((st1.physical_state.theta - sd1.physical_state.theta).numpy()).max() < 1e-12

    zeros = lambda n: torch.zeros((B, n, 1), dtype=torch.float64)
    _, f32 = env.vmap_rollout(st, zeros(32))
    _, f128 = env.vmap_rollout(st, zeros(128))
    _, d32 = det.vmap_rollout(sd, zeros(32))
    _, d128 = det.vmap_rollout(sd, zeros(128))
    v32 = np.var((f32.physical_state.omega - d32.physical_state.omega).numpy())
    v128 = np.var((f128.physical_state.omega - d128.physical_state.omega).numpy())
    assert 2.0 < v128 / v32 < 12.0
    _, jf128 = je.vmap_rollout(js, jnp.zeros((B, 128, 1)))
    _close(f128.physical_state.omega, jf128.physical_state.omega)
    _key_eq(f128.PRNGKey, jf128.PRNGKey)


def test_same_keys_reproduce_different_keys_differ():
    B = 512
    je, env, js, st = _pendulum(B, process_noise={"omega": 0.5})
    zeros = torch.zeros((B, 16, 1), dtype=torch.float64)
    _, a = env.vmap_rollout(st, zeros)
    _, b = env.vmap_rollout(st, zeros)
    assert torch.equal(a.physical_state.omega, b.physical_state.omega)
    other = structures.replace(st, PRNGKey=env.vmap_reset(_keys(1, B)[1])[1].PRNGKey)
    _, c = env.vmap_rollout(other, zeros)
    assert not torch.equal(a.physical_state.omega, c.physical_state.omega)
    js_other = jstructures.replace(js, PRNGKey=je.vmap_reset(_keys(1, B)[0])[1].PRNGKey)
    _, jc = je.vmap_rollout(js_other, jnp.zeros((B, 16, 1)))
    _close(c.physical_state.omega, jc.physical_state.omega)


def test_observation_noise_statistics_and_exact_state():
    B = 4096
    je, env, js, st = _pendulum(B, observation_noise={"theta": 0.05})
    obs, st1 = env.vmap_step(st, torch.zeros((B, 1), dtype=torch.float64))
    jobs, _ = je.vmap_step(js, jnp.zeros((B, 1)))
    _close(obs, jobs)
    d = (obs - env.generate_observation(st1, env.env_properties)).numpy()
    expected = 2 * 0.05 / (2 * np.pi)
    assert abs(d[:, 0].std() / expected - 1.0) < 0.1
    assert np.abs(d[:, 1]).max() < 1e-12
    det = P.Pendulum(batch_size=B, tau=TAU, **F64)
    _, sd1 = det.vmap_step(det.vmap_reset(_keys(0, B)[1])[1], torch.zeros((B, 1), dtype=torch.float64))
    assert torch.equal(st1.physical_state.theta, sd1.physical_state.theta)


def test_deterministic_paths_guard():
    B = 256
    _, env, _, st = _pendulum(B, process_noise={"omega": 0.5})
    # step mode takes the stepper kernel with the noise slab; the trajectory
    # solve is the Euler-Maruyama loop
    assert rollout_path(env) == "fused"
    assert rollout_path(env, obs_stepsize=TAU, action_stepsize=TAU) == "scan"
    with pytest.raises(ValueError, match="strict"):
        env.fused_sim_ahead(st, torch.zeros((B, 4, 1), dtype=torch.float64), TAU, TAU, strict=True)
    env_ms = P.Pendulum(batch_size=B, tau=TAU, process_noise={"omega": 0.5}, solver="tsit5", **F64)
    _, st_ms = env_ms.vmap_reset(_keys(0, B)[1])
    with pytest.raises(ValueError, match="one-stage"):
        env_ms.vmap_sim_ahead(st_ms, torch.zeros((B, 4, 1), dtype=torch.float64), TAU, TAU)
    # the adaptive controller integrates deterministic dynamics only
    with pytest.raises(ValueError, match="adaptive_rollout"):
        adaptive_rollout(env, st, torch.zeros((B, 4, 1), dtype=torch.float64))
    _, nokey = env.vmap_reset()
    with pytest.raises(ValueError, match="PRNG"):
        env.vmap_step(nokey, torch.zeros((B, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="PRNG"):
        env.fused_rollout(nokey, torch.zeros((B, 4, 1), dtype=torch.float64))
    with pytest.raises(ValueError, match="batch_size"):
        env.vmap_reset(_keys(0, B + 1)[1])


@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_stochastic_sim_ahead_matches_step_loop(noise_mode):
    B, T = 64, 20
    je, env, js, st = _pendulum(B, process_noise={"omega": 0.8}, observation_noise={"theta": 0.01},
                                noise_mode=noise_mode)
    ja, ta = _actions(1, B, T, lim=0.5)
    obs_sa, states, last = env.vmap_sim_ahead(st, ta, TAU, TAU)
    s, rows = st, []
    for t in range(T):
        o, s = env.vmap_step(s, ta[:, t])
        rows.append(o)
    np.testing.assert_allclose(obs_sa[:, 1:].numpy(), torch.stack(rows, dim=1).numpy(), rtol=1e-10, atol=1e-12)
    assert torch.equal(last.PRNGKey, s.PRNGKey)
    jobs, jstates, jlast = je.vmap_sim_ahead(js, ja, TAU, TAU)
    _close(obs_sa, jobs)
    _key_eq(states.PRNGKey, jstates.PRNGKey)
    # a finer observation grid integrates the SDE there; saves carry
    # advancing keys; the first row is the exact reset observation
    obs_f, states_f, _ = env.vmap_sim_ahead(st, ta, TAU / 4, TAU)
    assert obs_f.shape[1] == 4 * T + 1 and bool(torch.isfinite(obs_f).all())
    assert not torch.equal(states.PRNGKey[:, 4], states.PRNGKey[:, 5])
    assert torch.equal(obs_sa[:, 0], env.generate_observation(st, env.env_properties))


@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_fused_stochastic_rollout_matches_scan(noise_mode):
    B, T = 256, 16
    je, env, js, st = _pendulum(B, process_noise={"omega": 0.5, "theta": 0.05}, observation_noise={"theta": 0.02},
                                noise_mode=noise_mode)
    ja, ta = _actions(1, B, T)
    obs_s, fin_s = env.vmap_rollout(st, ta, obs_stride=4)
    obs_f, fin_f = env_fused_rollout(env, st, ta, obs_stride=4, strict=True)
    assert torch.equal(obs_f, obs_s) and torch.equal(fin_f.physical_state.omega, fin_s.physical_state.omega)
    assert torch.equal(fin_f.PRNGKey, fin_s.PRNGKey)
    jobs, jfin = je.vmap_rollout(js, ja, obs_stride=4)
    _close(obs_f, jobs)
    _close(fin_f.physical_state.omega, jfin.physical_state.omega)
    _key_eq(fin_f.PRNGKey, jfin.PRNGKey)
    # the final-observation mode carries the last step's sensor draw
    obs_1, _ = env_fused_rollout(env, st, ta, strict=True)
    assert torch.equal(obs_1, obs_s[:, -1])
    # the time-major slab gives the same
    obs_tm, _ = env_fused_rollout(env, st, ta.transpose(0, 1).contiguous(), obs_stride=4, time_major=True)
    assert torch.equal(obs_tm, obs_s)


@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_fused_stochastic_rollout_is_differentiable(noise_mode):
    """Reparameterized gradients through the noisy fused path (its
    checkpointed VJP) follow ``jax.grad`` of the JAX package's loop."""
    B, T = 64, 16
    je, env, js, st = _pendulum(B, process_noise={"omega": 0.5}, noise_mode=noise_mode)
    ja, ta = _actions(1, B, T)
    ta = ta.clone().requires_grad_(True)
    _, fin = env_fused_rollout(env, st, ta, strict=True)
    (g,) = torch.autograd.grad((fin.physical_state.omega ** 2).sum(), ta)
    gj = jax.grad(lambda a: jnp.sum(je.vmap_rollout(js, a)[1].physical_state.omega ** 2))(ja)
    assert float((g - torch.as_tensor(np.array(gj))).abs().max()) <= 1e-9 * float(np.abs(np.asarray(gj)).max())


@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_stochastic_closed_loop_kernel_matches_scan(noise_mode):
    B, T = 128, 16
    je, env, js, st = _pendulum(B, process_noise={"omega": 0.4}, observation_noise={"theta": 0.05, "omega": 0.02},
                                noise_mode=noise_mode)

    def pol(obs, t):
        return (-0.8 * obs[0] - 0.3 * obs[1],)

    obs_f, acts_f, traj_f, last_f = env_fused_closed_loop(env, st, pol, T, obs_stride=1, return_traj_states=True)
    obs_s, acts_s, traj_s, last_s = tile_policy_scan(env, st, T, pol, None, collect_trajectory=True)
    assert torch.equal(obs_f, obs_s) and torch.equal(acts_f, acts_s)
    assert torch.equal(last_f.physical_state.omega, last_s.physical_state.omega)
    assert torch.equal(last_f.PRNGKey, last_s.PRNGKey) and torch.equal(traj_f.PRNGKey, traj_s.PRNGKey)
    jobs, jacts, jtraj, jlast = j_tile_policy_scan(je, js, T, pol, None, True)
    _close(obs_f, jobs)
    _close(acts_f, jacts)
    _key_eq(last_f.PRNGKey, jlast.PRNGKey)
    _key_eq(traj_f.PRNGKey, jtraj.PRNGKey)
    obs_fin, _ = env_fused_closed_loop(env, st, pol, T)
    assert torch.equal(obs_fin, obs_s[:, -1])
    obs_4, _, traj_4, _ = env_fused_closed_loop(env, st, pol, T, obs_stride=4, return_traj_states=True)
    assert torch.equal(obs_4, obs_s[:, 3::4]) and torch.equal(traj_4.PRNGKey, traj_s.PRNGKey[:, 3::4])


def test_constructor_validation():
    with pytest.raises(ValueError, match="not one of"):
        P.Pendulum(batch_size=4, process_noise={"bogus": 0.1}, **F64)
    with pytest.raises(ValueError, match="non-negative scalar"):
        P.Pendulum(batch_size=4, process_noise={"omega": -1.0}, **F64)
    with pytest.raises(ValueError, match="non-negative scalar"):
        P.Pendulum(batch_size=4, observation_noise={"theta": np.ones(4)}, **F64)
    # all-zero sigmas collapse to the deterministic path
    assert not P.Pendulum(batch_size=4, process_noise={"omega": 0.0}, **F64)._has_noise
    for cls, field in ((P.MassSpringDamper, "deflection"), (P.CartPole, "velocity")):
        env = cls(batch_size=8, process_noise={field: 0.1}, observation_noise={field: 0.1}, noise_mode="fast", **F64)
        _, st = env.vmap_reset(_keys(2, 8)[1])
        obs, st1 = env.vmap_step(st, torch.zeros((8, env.action_dim), dtype=torch.float64))
        assert bool(torch.isfinite(obs).all()) and not torch.equal(st1.PRNGKey, st.PRNGKey)


@pytest.mark.parametrize("cls", ["MassSpringDamper", "CartPole"])
def test_other_classic_environments_match_jax(cls):
    fields_ = {"MassSpringDamper": ("deflection", "velocity"), "CartPole": ("velocity", "omega")}[cls]
    kw = dict(batch_size=32, process_noise={fields_[0]: 0.3, fields_[1]: 0.2}, observation_noise={fields_[0]: 0.05})
    je, pe = getattr(J, cls)(**kw), getattr(P, cls)(**kw, **F64)
    jk, tk = _keys(4, 32)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(tk)
    ja, ta = _actions(5, 32, 8, pe.action_dim)
    jo, jf = je.vmap_rollout(js, ja, obs_stride=2)
    po, pf = pe.fused_rollout(ps, ta, obs_stride=2)
    _close(po, jo)
    _key_eq(pf.PRNGKey, jf.PRNGKey)


def test_stochastic_sim_ahead_clipped_env_stays_physical():
    """The FluidTank's in-ODE clamp plus the clip of the saves keep the
    stochastic trajectory finite and non-negative under large disturbances
    (tests/test_noise.py:183), and it follows the JAX package from the same
    keys; the fused rollout streams the same draws as the step loop."""
    je = J.FluidTank(batch_size=32, process_noise={"height": 0.5})
    pe = P.FluidTank(batch_size=32, process_noise={"height": 0.5}, **F64)
    jk, tk = _keys(2, 32)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(tk)
    _close(ps.physical_state.height, js.physical_state.height)
    ja, ta = _actions(0, 32, 50, lim=0.0)
    obs, states, last = pe.vmap_sim_ahead(ps, ta, pe.tau, pe.tau)
    assert torch.isfinite(obs).all() and float(obs.min()) >= -1e-12
    jobs, _, jlast = je.vmap_sim_ahead(js, ja, je.tau, je.tau)
    _close(obs, jobs)
    _key_eq(last.PRNGKey, jlast.PRNGKey)
    obs_l, last_l = pe.vmap_rollout(ps, ta, 10)
    obs_f, last_f = env_fused_rollout(pe, ps, ta, obs_stride=10, strict=True)
    assert torch.equal(obs_f, obs_l) and torch.equal(last_f.physical_state.height, last_l.physical_state.height)
    assert float(last_f.physical_state.height.min()) >= 0.0


def test_fused_traj_states_carry_advanced_keys():
    B, T, stride = 128, 16, 4
    _, env, _, st = _pendulum(B, seed=2, process_noise={"omega": 0.5}, observation_noise={"theta": 0.05})
    _, ta = _actions(3, B, T)
    _, traj, final = env_fused_rollout(env, st, ta, obs_stride=stride, strict=True, return_traj_states=True)
    for s in range(T // stride):
        _, scan_state = env.vmap_rollout(st, ta[:, : (s + 1) * stride])
        assert torch.equal(traj.PRNGKey[:, s], scan_state.PRNGKey)
    assert torch.equal(final.PRNGKey, traj.PRNGKey[:, -1])


def test_fast_mode_key_contracts_and_statistics():
    B, T, stride = 1024, 16, 4
    je, env, js, st = _pendulum(B, seed=5, process_noise={"omega": 0.5}, observation_noise={"theta": 0.02},
                                noise_mode="fast")
    ja, ta = _actions(6, B, T)
    _, traj, final = env_fused_rollout(env, st, ta, obs_stride=stride, strict=True, return_traj_states=True)
    saves = torch.arange(1, T // stride + 1) * stride
    expect = R.fold_in(st.PRNGKey[:, None], saves[None])
    assert torch.equal(traj.PRNGKey, expect) and torch.equal(final.PRNGKey, expect[:, -1])
    # step() is the one-step rollout (draws and key)
    obs1, st1 = env.vmap_step(st, ta[:, 0])
    obs_r, fin_r = env.vmap_rollout(st, ta[:, :1])
    assert torch.equal(obs1, obs_r[:, 0]) and torch.equal(st1.PRNGKey, fin_r.PRNGKey)
    jobs1, jst1 = je.vmap_step(js, ja[:, 0])
    _close(obs1, jobs1)
    _key_eq(st1.PRNGKey, jst1.PRNGKey)
    det = P.Pendulum(batch_size=B, tau=TAU, **F64)
    _, st_d = det.vmap_reset(_keys(5, B)[1])
    _, sd1 = det.vmap_step(st_d, ta[:, 0])
    d = (st1.physical_state.omega - sd1.physical_state.omega).numpy()
    assert abs(d.std() / (0.5 * np.sqrt(TAU)) - 1.0) < 0.1
    zeros = lambda n: torch.zeros((B, n, 1), dtype=torch.float64)
    _, f32 = env.vmap_rollout(st, zeros(32))
    _, f128 = env.vmap_rollout(st, zeros(128))
    _, d32 = det.vmap_rollout(st_d, zeros(32))
    _, d128 = det.vmap_rollout(st_d, zeros(128))
    v32 = np.var((f32.physical_state.omega - d32.physical_state.omega).numpy())
    v128 = np.var((f128.physical_state.omega - d128.physical_state.omega).numpy())
    assert 2.0 < v128 / v32 < 12.0
    # a piece-wise draw (small chunks) is the same stream
    env._fast_chunk_elems = B * 3
    _, again = env.vmap_rollout(st, ta)
    del env._fast_chunk_elems
    _, once = env.vmap_rollout(st, ta)
    assert torch.equal(again.physical_state.omega, once.physical_state.omega)
    exact = P.Pendulum(batch_size=B, tau=TAU, process_noise={"omega": 0.5}, observation_noise={"theta": 0.02}, **F64)
    _, fin_exact = exact.vmap_rollout(st, ta)
    assert not torch.equal(fin_exact.physical_state.omega, once.physical_state.omega)


def test_injected_draw_hooks_match_jax():
    """The eps hooks with caller-supplied draws, per-batch spans included."""
    B = 16
    rng = np.random.default_rng(7)
    span = rng.uniform(1.0, 3.0, B)
    norms = {"theta": P.MinMaxNormalization(min=-np.pi, max=np.pi),
             "omega": P.MinMaxNormalization(min=-span, max=span)}
    jnorms = {"theta": J.MinMaxNormalization(min=-jnp.pi, max=jnp.pi),
              "omega": J.MinMaxNormalization(min=-jnp.asarray(span), max=jnp.asarray(span))}
    kw = dict(batch_size=B, tau=TAU, process_noise={"omega": 0.4, "theta": 0.1},
              observation_noise={"theta": 0.05, "omega": 0.3})
    je = J.Pendulum(physical_normalizations=jnorms, **kw)
    pe = P.Pendulum(physical_normalizations=norms, **kw, **F64)
    _, js = je.vmap_reset(_keys(0, B)[0])
    _, ps = pe.vmap_reset(_keys(0, B)[1])
    eps_p, eps_o = rng.standard_normal((B, 2)), rng.standard_normal((B, 2))
    jp = jax.vmap(je._apply_process_noise_eps, in_axes=(0, 0, je.in_axes_env_properties))(
        js, jnp.asarray(eps_p), je.env_properties)
    pp = pe._apply_process_noise_eps(ps, torch.as_tensor(eps_p), pe.env_properties)
    for name in ("theta", "omega"):
        _close(getattr(pp.physical_state, name), getattr(jp.physical_state, name), dict(rtol=1e-12, atol=1e-12))
    obs = pe.generate_observation(ps, pe.env_properties)
    jo = jax.vmap(lambda o, p, e: je._apply_observation_noise_eps(o, p, e), in_axes=(0, je.in_axes_env_properties, 0))(
        jnp.asarray(obs.numpy()), je.env_properties, jnp.asarray(eps_o))
    po = pe._apply_observation_noise_eps(obs, pe.env_properties, torch.as_tensor(eps_o))
    _close(po, jo, dict(rtol=1e-12, atol=1e-12))
    # the PMSM's hooks: the torque follows the perturbed currents
    jd, pd_, jsd, psd = _pmsm(8, process_noise={"i_d": 2.0, "i_q": 2.0}, observation_noise={"torque": 0.2})
    eps = rng.standard_normal((8, 2))
    jp = jax.vmap(jd._apply_process_noise_eps, in_axes=(0, 0, None))(jsd, jnp.asarray(eps), jd.env_properties)
    pp = pd_._apply_process_noise_eps(psd, torch.as_tensor(eps), pd_.env_properties)
    for name in ("i_d", "i_q", "torque"):
        _close(getattr(pp.physical_state, name), getattr(jp.physical_state, name), dict(rtol=1e-12, atol=1e-12))


def test_state_from_normalized_physical_and_action_hook_match_jax():
    """The core hooks the stochastic slice ports beside the noise: the state
    from normalized physical fields (classic and PMSM), and the
    state-independent action constraint on the eager paths (the kernels do
    not take it, so an environment with it is out of their scope)."""
    rng = np.random.default_rng(11)
    je = J.Pendulum(batch_size=4, control_state=["theta"])
    pe = P.Pendulum(batch_size=4, control_state=["theta"], **F64)
    x, r = rng.uniform(-1, 1, (4, 2)), rng.uniform(-1, 1, (4, 1))
    js = jax.vmap(je._state_from_normalized_physical, in_axes=(0, None, 0))(jnp.asarray(x), je.env_properties,
                                                                          jnp.asarray(r))
    ps = pe._state_from_normalized_physical(torch.as_tensor(x), pe.env_properties, torch.as_tensor(r))
    for name in ("theta", "omega"):
        _close(getattr(ps.physical_state, name), getattr(js.physical_state, name))
    _close(ps.reference.theta, js.reference.theta)
    jd = J.PMSM(batch_size=4, saturated=True, motor_variant=J.MotorVariant.BRUSA)
    pd_ = P.PMSM(batch_size=4, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    x = rng.uniform(-0.8, 0.8, (4, 7))
    js = jax.vmap(jd._state_from_normalized_physical, in_axes=(0, None))(jnp.asarray(x), jd.env_properties)
    ps = pd_._state_from_normalized_physical(torch.as_tensor(x), pd_.env_properties)
    for name in PMSM_FIELDS:
        _close(getattr(ps.physical_state, name), getattr(js.physical_state, name))

    class Clipped(P.Pendulum):
        def _constrain_action_tuple(self, comps):
            return (torch.clamp(comps[0], -5.0, 5.0),)

    class JClipped(J.Pendulum):
        def _constrain_action_tuple(self, comps):
            return (jnp.clip(comps[0], -5.0, 5.0),)

    kw = dict(batch_size=16, tau=TAU, process_noise={"omega": 0.3})
    pe, je = Clipped(**kw, **F64), JClipped(**kw)
    _, ps = pe.vmap_reset(_keys(0, 16)[1])
    _, js = je.vmap_reset(_keys(0, 16)[0])
    ja, ta = _actions(2, 16, 8)
    assert rollout_path(pe) == "scan"
    po, pf = pe.fused_rollout(ps, ta, obs_stride=4)
    jo, jf = je.vmap_rollout(js, ja, obs_stride=4)
    _close(po, jo)
    free = P.Pendulum(**kw, **F64)
    assert not torch.equal(free.vmap_rollout(ps, ta, obs_stride=4)[0], po)


# ---------------------------------------------------------------------------
# the PMSM drive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("saturated", [True, False])
def test_pmsm_stochastic_simulation(saturated):
    B = 256
    noise = dict(process_noise={"i_d": 2.0, "i_q": 2.0}, observation_noise={"i_d": 0.5, "i_q": 0.5, "torque": 0.2})
    je, env, js, st = _pmsm(B, saturated, **noise)
    det = P.PMSM(batch_size=B, saturated=saturated, motor_variant=P.MotorVariant.BRUSA, **F64)
    sd = structures.replace(st, PRNGKey=det.vmap_reset()[1].PRNGKey)
    a = 0.1 * torch.ones((B, 2), dtype=torch.float64)
    obs, st1 = env.vmap_step(st, a)
    _, sd1 = det.vmap_step(sd, a)
    jobs, jst1 = je.vmap_step(js, jnp.asarray(a.numpy()))
    _close(obs, jobs)
    for name in ("i_d", "i_q", "torque"):
        _close(getattr(st1.physical_state, name), getattr(jst1.physical_state, name), PHYS_TOL)
    _key_eq(st1.PRNGKey, jst1.PRNGKey)
    d = (st1.physical_state.i_d - sd1.physical_state.i_d).numpy()
    assert abs(d.std() / (2.0 * np.sqrt(env.tau)) - 1.0) < 0.2
    assert torch.equal(st1.physical_state.epsilon, sd1.physical_state.epsilon)
    assert torch.equal(st1.physical_state.torque, env._torque(st1.physical_state.i_d, st1.physical_state.i_q,
                                                              env.env_properties))
    dobs = (obs - env.generate_observation(st1, env.env_properties)).numpy()
    assert dobs[:, 0].std() > 0 and dobs[:, 1].std() > 0 and dobs[:, 3].std() > 0
    assert np.abs(dobs[:, [2, 4, 5, 6, 7]]).max() < 1e-12
    norm = env.env_properties.physical_normalizations.i_d
    assert abs(dobs[:, 0].std() / (2 * 0.5 / float(norm.max - norm.min)) - 1.0) < 0.2

    # the fused rollout takes the kernel's noise slab in step mode (any
    # batch size is in the port's scope) and matches the loop
    assert rollout_path(env) == "pmsm_fused"
    assert rollout_path(env, obs_stepsize=env.tau, action_stepsize=env.tau) == "scan"
    acts = 0.1 * torch.ones((B, 8, 2), dtype=torch.float64)
    obs_f, fin_f = env.fused_rollout(st, acts, obs_stride=8, strict=True)
    obs_r, fin_r = env.vmap_rollout(st, acts, obs_stride=8)
    assert torch.equal(obs_f, obs_r) and torch.equal(fin_f.PRNGKey, fin_r.PRNGKey)
    with pytest.raises(ValueError, match="strict"):
        env.fused_sim_ahead(st, acts, env.tau, env.tau, strict=True)
    obs_sa, _, _ = env.vmap_sim_ahead(st, torch.zeros((B, 4, 2), dtype=torch.float64), env.tau, env.tau)
    assert bool(torch.isfinite(obs_sa).all())
    env_ms = P.PMSM(batch_size=B, saturated=saturated, motor_variant=P.MotorVariant.BRUSA,
                    process_noise={"i_d": 2.0}, solver="tsit5", **F64)
    _, st_ms = env_ms.vmap_reset(_keys(0, B)[1])
    with pytest.raises(ValueError, match="one-stage"):
        env_ms.vmap_sim_ahead(st_ms, torch.zeros((B, 4, 2), dtype=torch.float64), env.tau, env.tau)
    for kw in ({"process_noise": {"epsilon": 0.1}}, {"observation_noise": {"epsilon": 0.1}}):
        with pytest.raises(ValueError, match="not one of"):
            P.PMSM(batch_size=4, saturated=saturated, motor_variant=P.MotorVariant.BRUSA, **kw, **F64)


@pytest.mark.parametrize("saturated,deadtime,noise_mode", [(True, 1, "exact"), (True, 0, "fast"),
                                                            (False, 0, "exact"), (False, 1, "fast")])
def test_pmsm_fused_stochastic_rollout_matches_jax(saturated, deadtime, noise_mode):
    """The drive kernel's plain version with the noise slab, end to end from
    the same keys: observations, leaves and keys as the JAX package's loop."""
    B, T = 64, 16
    je, env, js, st = _pmsm(B, saturated, deadtime=deadtime, noise_mode=noise_mode,
                            process_noise={"i_d": 2.0, "i_q": 1.0}, observation_noise={"i_d": 0.5, "torque": 0.2})
    ja, ta = _actions(8, B, T, 2, 0.5)
    obs, fin = env.fused_rollout(st, ta, obs_stride=4, strict=True)
    jobs, jfin = je.vmap_rollout(js, ja, obs_stride=4)
    _close(obs, jobs)
    for name in PMSM_FIELDS:
        _close(getattr(fin.physical_state, name), getattr(jfin.physical_state, name), PHYS_TOL)
    _key_eq(fin.PRNGKey, jfin.PRNGKey)
    _, traj, _ = PK.pmsm_fused_rollout(env, st, ta, obs_stride=4, strict=True, return_traj_states=True)
    for s in range(T // 4):
        _, part = env.vmap_rollout(st, ta[:, : 4 * (s + 1)])
        assert torch.equal(traj.PRNGKey[:, s], part.PRNGKey)
        assert torch.equal(traj.physical_state.i_d[:, s], part.physical_state.i_d)


@pytest.mark.parametrize("saturated", [True, False])
def test_pmsm_noise_slab_cotangent(saturated):
    """The slab's cotangent (and the others) through the checkpointed VJP
    follow autograd through the plain loop; the actions' gradient through
    the noisy fused rollout follows ``jax.grad`` of the JAX package's loop."""
    B, T = 32, 12
    je, env, js, st = _pmsm(B, saturated, deadtime=1, process_noise={"i_d": 2.0, "i_q": 2.0})
    ja, ta = _actions(9, B, T, 2, 0.5)
    state0, omega = PK._start(st)
    slab = torch.as_tensor(np.random.default_rng(3).standard_normal((T, B, 2))) * 0.05
    slab = slab.requires_grad_(True)
    acts = ta.transpose(0, 1).contiguous().requires_grad_(True)
    start = tuple(leaf.clone().requires_grad_(True) for leaf in state0)
    kw = dict(tau=env.tau, obs_stride=4, noise_tm=slab, noise_idx=(0, 1))
    w = torch.as_tensor(np.random.default_rng(4).uniform(0.5, 1.5, B))

    def loss(out):
        (i_d, i_q, torque, *_), _, traj = out
        return ((i_d ** 2 + torque) * w).sum() + (traj[1] * w).sum()

    inputs = [slab, acts, *start]
    g_vjp = torch.autograd.grad(loss(PK.pmsm_rollout_vjp(env, acts, start, omega, **kw)), inputs)
    g_ref = torch.autograd.grad(loss(PK.plain_pmsm_rollout(env, acts, start, omega, **kw)), inputs)
    for a, b in zip(g_vjp, g_ref):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    ta = ta.clone().requires_grad_(True)
    _, fin = env.fused_rollout(st, ta, strict=True)
    (g,) = torch.autograd.grad((fin.physical_state.i_d ** 2).sum(), ta)
    gj = jax.grad(lambda a: jnp.sum(je.vmap_rollout(js, a)[1].physical_state.i_d ** 2))(ja)
    assert float((g - torch.as_tensor(np.array(gj))).abs().max()) <= 1e-9 * float(np.abs(np.asarray(gj)).max())


def test_pmsm_fast_mode_step_realizes_one_step_rollout():
    B = 64
    je, env, js, st = _pmsm(B, True, seed=2, process_noise={"i_q": 2.0}, observation_noise={"i_d": 0.5},
                            noise_mode="fast")
    a = 0.1 * torch.ones((B, 2), dtype=torch.float64)
    o1, s1 = env.vmap_step(st, a)
    orr, fr = env.vmap_rollout(st, a[:, None, :])
    assert torch.equal(o1, orr[:, 0]) and torch.equal(s1.PRNGKey, fr.PRNGKey)
    assert torch.equal(s1.physical_state.i_q, fr.physical_state.i_q)
    assert torch.equal(s1.PRNGKey, R.fold_in(st.PRNGKey, 1))
    jo1, _ = je.vmap_step(js, jnp.asarray(a.numpy()))
    _close(o1, jo1)


@pytest.mark.parametrize("saturated", [False, True])
@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_pmsm_stochastic_sim_ahead_matches_step_loop(saturated, noise_mode):
    B, T = 64, 12
    je, env, js, st = _pmsm(B, saturated, process_noise={"i_d": 2.0, "i_q": 2.0},
                            observation_noise={"i_d": 0.5, "torque": 0.2}, noise_mode=noise_mode)
    ja, ta = _actions(1, B, T, 2, 0.4)
    obs_sa, states, last = env.vmap_sim_ahead(st, ta, env.tau, env.tau)
    assert obs_sa.shape == (B, T + 1, 8)
    s, rows = st, []
    for t in range(T):
        o, s = env.vmap_step(s, ta[:, t])
        rows.append(o)
    np.testing.assert_allclose(obs_sa[:, 1:].numpy(), torch.stack(rows, dim=1).numpy(), rtol=1e-8, atol=1e-8)
    assert torch.equal(last.PRNGKey, s.PRNGKey)
    assert not torch.equal(states.PRNGKey[:, 4], states.PRNGKey[:, 5])
    # the initial row is the reset state's observation (its torque recomputed)
    np.testing.assert_allclose(obs_sa[:, 0].numpy(), env.generate_observation(st, env.env_properties).numpy(),
                               rtol=1e-12, atol=1e-13)
    torque = env._torque(states.physical_state.i_d, states.physical_state.i_q, env.env_properties)
    assert torch.equal(torque, states.physical_state.torque)
    jobs, jstates, _ = je.vmap_sim_ahead(js, ja, je.tau, je.tau)
    _close(obs_sa, jobs)
    _key_eq(states.PRNGKey, jstates.PRNGKey)


@pytest.mark.parametrize("noise_mode", ["exact", "fast"])
def test_pmsm_stochastic_closed_loop_matches_scan(noise_mode):
    """The PMSM closed loop's plain version streams the drive's slabs (the
    open loop's current slab and the shifted sensor slab) and matches the
    collector's loop and the JAX package's."""
    B, T = 64, 16
    je, env, js, st = _pmsm(B, True, noise_mode=noise_mode, process_noise={"i_d": 2.0, "i_q": 2.0},
                            observation_noise={"i_d": 0.5, "i_q": 0.5, "torque": 0.2})

    def pol(obs, t):
        return (-0.5 * obs[0] - 0.2, -0.5 * obs[1] + 0.1)

    obs_f, acts_f, traj_f, last_f = env.fused_closed_loop(st, pol, T, obs_stride=2, return_traj_states=True)
    obs_s, acts_s, traj_s, last_s = tile_policy_scan(env, st, T, pol, None, collect_trajectory=True)
    np.testing.assert_allclose(obs_f.numpy(), obs_s[:, 1::2].numpy(), rtol=1e-12, atol=1e-12)
    assert torch.equal(traj_f.PRNGKey, traj_s.PRNGKey[:, 1::2]) and torch.equal(last_f.PRNGKey, last_s.PRNGKey)
    jobs, jacts, jtraj, jlast = j_tile_policy_scan(je, js, T, pol, None, True)
    _close(obs_s, jobs)
    _close(acts_s, jacts)
    _key_eq(last_s.PRNGKey, jlast.PRNGKey)


def test_pmsm_fast_entries_raise_on_a_noisy_drive():
    from exciting_environments_torch.ops.pmsm_fast import pmsm_fast_rollout

    env = P.PMSM(batch_size=8, saturated=True, motor_variant=P.MotorVariant.BRUSA, process_noise={"i_d": 1.0},
                 **F64)
    _, st = env.vmap_reset(_keys(0, 8)[1])
    acts = torch.zeros((8, 4, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="deterministically"):
        env.fast_rollout(st, acts)
    with pytest.raises(ValueError, match="deterministically"):
        pmsm_fast_rollout(env, st, acts)


# ---------------------------------------------------------------------------
# training and conversion
# ---------------------------------------------------------------------------


def _pd(obs, t, p):
    return (-p["kp"] * (obs[0] - obs[2]) - p["kd"] * obs[1],)


def test_train_policy_stochastic_env_noise_robust():
    """Training on a noisy pendulum (common random numbers: the draws are a
    function of the state's keys) against the JAX package's loop over its
    scan: optax.adam(0.1), the same keys; losses at rtol 1e-8."""
    from exciting_environments_torch.utils.train import train_policy

    B, n_steps, iterations = 64, 24, 4
    kw = dict(control_state=["theta"], process_noise={"omega": 0.2}, observation_noise={"theta": 0.03})
    je, env, js, st = _pendulum(B, **kw)
    ref = np.linspace(-1.2, 1.2, B)
    st = structures.replace(st, reference=structures.replace(st.reference, theta=torch.as_tensor(ref)))
    js = jstructures.replace(js, reference=jstructures.replace(js.reference, theta=jnp.asarray(ref)))
    res = train_policy(env, _pd, tree_from_numpy({"kp": 0.1, "kd": 0.0}, device="cpu"), st, n_steps=n_steps,
                       iterations=iterations)
    assert res.final_loss <= float(res.losses[0]) and bool(torch.isfinite(res.losses).all())
    assert float(res.params["kp"]) != 0.1

    loss_fn = j_default_tracking_loss(je)

    def loss(p):
        out = j_tile_policy_scan(je, js, n_steps, _pd, p, True)
        return loss_fn(out[0], out[1])

    params = {"kp": jnp.asarray(0.1), "kd": jnp.asarray(0.0)}
    optimizer = optax.adam(0.1)
    opt_state = optimizer.init(params)
    vg = jax.jit(jax.value_and_grad(loss))
    losses = []
    for _ in range(iterations):
        value, grads = vg(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(value))
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(losses), rtol=1e-8)


def test_tree_from_numpy_runs_on_the_card_by_default():
    tree = {"kp": 0.5, "w": [np.ones(3)]}
    assert tree_from_numpy(tree, device="cpu")["w"][0].device.type == "cpu"
    if torch.cuda.is_available():
        assert tree_from_numpy(tree)["kp"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tree_from_numpy(tree)


def test_noise_works_through_the_learning_stack():
    """step_with_flags and PPO consume vmap_step, so the stochastic env drops
    in: train_ppo on the noisy tracking Pendulum at B = 8 gives finite
    metrics, and the JAX package's within 1e-8 relative to each metric's
    largest entry from the same key and initial parameters (the draws
    follow the states' keys, which reset_with_references gives them)."""
    from exciting_environments_tpu.utils import rl as jrl
    from exciting_environments_torch.utils import rl as prl
    from exciting_environments_torch.utils.convert import agent_params_from_numpy

    kw = dict(batch_size=8, tau=2e-2, control_state=["theta"], process_noise={"omega": 0.2},
              observation_noise={"theta": 0.02})
    je, pe = J.Pendulum(**kw), P.Pendulum(**kw, **F64)
    cfg = dict(n_steps=16, n_epochs=2, n_minibatches=4, max_episode_steps=32)
    params = jrl.init_agent(je, jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(0)
    res_p = prl.train_ppo(pe, iterations=2, key=torch.as_tensor(np.asarray(key).astype(np.int64)),
                          config=prl.PPOConfig(**cfg),
                          params=agent_params_from_numpy(pe, jax.tree_util.tree_map(np.asarray, params)))
    res_j = jrl.train_ppo(je, iterations=2, key=key, config=jrl.PPOConfig(**cfg), params=params)
    for name, v in res_p.metrics.items():
        assert v.shape == (2,) and bool(torch.isfinite(v).all()), name
        ref = np.asarray(res_j.metrics[name])
        assert float(np.abs(v.numpy() - ref).max()) <= 1e-8 * float(np.abs(ref).max()), name


def test_stateful_pi_law_under_noise_matches_the_scan_and_jax():
    """A stateful PI law closes the loop over noisy measurements (sensor and
    process noise): the closed loop's carry and states equal the port's own
    ``tile_policy_scan`` draw for draw, and follow the JAX package's scan
    (JAX ``tests/test_noise.py:343-358``; normals agree to ``erfinv``'s last
    bits, ROADMAP Accepted)."""
    B, T = 64, 16
    kw = dict(tau=TAU, process_noise={"omega": 0.3}, observation_noise={"theta": 0.04})
    je, pe = J.Pendulum(batch_size=B, **kw), P.Pendulum(batch_size=B, **kw, **F64)
    jk, pk = _keys(0, B)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(pk)

    def pol_pi(obs, t, c):
        i = c[0] + 0.05 * obs[0]
        return (-0.8 * obs[0] - 0.1 * i,), (i,)

    carry0 = (torch.zeros(B, dtype=torch.float64),)
    obs_f, acts_f, _, last_f, fc_f = env_fused_closed_loop(pe, ps, pol_pi, T, obs_stride=1, return_traj_states=True,
                                                           policy_carry=carry0)
    obs_s, acts_s, _, last_s, fc_s = tile_policy_scan(pe, ps, T, pol_pi, None, collect_trajectory=True,
                                                      policy_carry=carry0)
    assert torch.equal(obs_f, obs_s) and torch.equal(acts_f, acts_s) and torch.equal(fc_f[0], fc_s[0])
    assert torch.equal(last_f.PRNGKey, last_s.PRNGKey)
    obs_j, acts_j, _, last_j, fc_j = j_tile_policy_scan(je, js, T, pol_pi, None, collect_trajectory=True,
                                                        policy_carry=(jnp.zeros(B),))
    np.testing.assert_allclose(obs_f.numpy(), np.asarray(obs_j), rtol=0, atol=1e-11)
    np.testing.assert_allclose(fc_f[0].numpy(), np.asarray(fc_j[0]), rtol=0, atol=1e-11)
    _key_eq(last_f.PRNGKey, last_j.PRNGKey)
