"""The port's fused rollout (stepper kernel's plain version on CPU tensors)
against the JAX package's Pallas stepper in interpret mode and its scan.

Same numpy inputs on both sides, float64 on the CPU, B = 1024, T = 16;
tolerance rtol = atol = 1e-12 (the figure tests/test_pallas_stepper.py uses:
XLA's CPU backend contracts FMAs, PyTorch eager does not).  The kernel itself
runs only on a CUDA card: tests/test_torch_gpu.py holds it against this
plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas import stepper as jstepper
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.ops.kernels import stepper as K
from exciting_environments_torch.utils.convert import state_from_numpy

TOL = dict(rtol=1e-12, atol=1e-12)
BATCH, T = 1024, 16
F64 = dict(device="cpu", dtype=torch.float64)


def _pair(name, solver, batch=BATCH, **kwargs):
    return (getattr(J, name)(batch_size=batch, solver=solver, **kwargs),
            getattr(P, name)(batch_size=batch, solver=solver, **F64, **kwargs))


def _states(je, pe, seed):
    rng = np.random.default_rng(seed)
    x0 = {n: rng.uniform(-2.0, 2.0, pe.batch_size) for n in pe._ode_state_fields}
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
    return js, state_from_numpy(pe, x0)


def _actions(seed, n=T, batch=BATCH):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (batch, n, 1))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), **TOL)


def _close_phys(pe, ps, js):
    for n in pe._ode_state_fields:
        _close(getattr(ps.physical_state, n), getattr(js.physical_state, n))


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_fused_rollout_matches_pallas_interpret(solver):
    je, pe = _pair("Pendulum", solver)
    js, ps = _states(je, pe, 0)
    acts = _actions(1)
    jo, jl = jstepper.env_fused_rollout(je, js, jnp.asarray(acts), interpret=True)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), strict=True)
    assert tuple(po.shape) == (BATCH, 2)
    _close(po, jo)
    _close_phys(pe, pl, jl)


def test_fused_rollout_obs_stride_matches_pallas_interpret():
    je, pe = _pair("Pendulum", "euler")
    js, ps = _states(je, pe, 2)
    acts = _actions(3)
    jo, jl = jstepper.env_fused_rollout(je, js, jnp.asarray(acts), obs_stride=4, interpret=True)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), obs_stride=4, strict=True)
    assert tuple(po.shape) == tuple(jo.shape) == (BATCH, T // 4, 2)
    _close(po, jo)
    _close_phys(pe, pl, jl)


def test_raw_noise_slab_matches_pallas_interpret():
    """Process-noise increments are added after wrap/clip, then wrap/clip again."""
    je, pe = _pair("Pendulum", "euler")
    js, _ = _states(je, pe, 4)
    rng = np.random.default_rng(5)
    acts = _actions(6)
    noise = 0.05 * rng.standard_normal((T, BATCH, 2))
    y0 = tuple(np.array(getattr(js.physical_state, n)) for n in pe._ode_state_fields)
    tile_ode, leaves = jstepper._batched_param_closure(je)
    acts_phys = jstepper._denormalize_action_slab(je, jnp.asarray(acts), False)
    j_final = jstepper.fused_rollout(
        tile_ode, je._solver, tuple(jnp.asarray(y) for y in y0), acts_phys, T, je.tau, (True, False),
        param_leaves=leaves, noise_tm=jnp.asarray(noise), noise_idx=(0, 1), interpret=True,
    )
    p_final, traj = K.fused_rollout(
        pe, tuple(torch.as_tensor(y) for y in y0), torch.as_tensor(acts), tau=pe.tau,
        noise_tm=torch.as_tensor(noise), noise_idx=(0, 1),
    )
    assert traj is None
    for p, j in zip(p_final, j_final):
        _close(p, j)


@pytest.mark.parametrize("name", ["Pendulum", "CartPole"])
def test_fused_tsit5_step_mode_matches_scan(name):
    """FSAL: the carry-only last stage is skipped and the final carry rebuilt."""
    je, pe = _pair(name, "tsit5")
    js, ps = _states(je, pe, 7)
    acts = _actions(8)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), T)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), strict=True)
    _close(po, jo[:, -1])
    _close_phys(pe, pl, jl)
    for k_p, k_j in zip(pl.additions.solver_state, jl.additions.solver_state):
        _close(k_p, k_j)


@pytest.mark.parametrize("name", ["MassSpringDamper", "CartPole"])
def test_fused_euler_other_envs_match_scan(name):
    je, pe = _pair(name, "euler")
    js, ps = _states(je, pe, 9)
    acts = _actions(10)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), T)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), strict=True)
    _close(po, jo[:, -1])
    _close_phys(pe, pl, jl)


def test_fused_per_batch_params_match_scan():
    rng = np.random.default_rng(11)
    lengths, tmax = 1.0 + rng.uniform(0, 1, BATCH), 10.0 + 10 * rng.uniform(0, 1, BATCH)
    je = J.Pendulum(batch_size=BATCH, static_params={"l": jnp.asarray(lengths), "g": 9.81, "m": 1},
                    action_normalizations={"torque": J.MinMaxNormalization(min=-20, max=jnp.asarray(tmax))})
    pe = P.Pendulum(batch_size=BATCH, static_params={"l": lengths, "g": 9.81, "m": 1},
                    action_normalizations={"torque": P.MinMaxNormalization(min=-20, max=tmax)}, **F64)
    js, ps = _states(je, pe, 12)
    acts = _actions(13)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), 4)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), obs_stride=4, strict=True)
    _close(po, jo)
    _close_phys(pe, pl, jl)


@pytest.mark.parametrize("name,solver,ratio", [
    ("Pendulum", "euler", 1),
    ("Pendulum", "rk4", 1),
    ("Pendulum", "rk4", 2),
    ("CartPole", "tsit5", 1),
    ("CartPole", "tsit5", 3),
])
def test_fused_sim_ahead_matches_scan(name, solver, ratio):
    """Unwrapped carry, c == 1 stages reading the next action, each action
    held for `ratio` solver steps, initial observation included."""
    je, pe = _pair(name, solver)
    js, ps = _states(je, pe, 14)
    acts = _actions(15, n=8)
    jo, _, jl = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau / ratio, je.tau)
    po, pl = pe.fused_sim_ahead(ps, torch.as_tensor(acts), pe.tau / ratio, pe.tau, strict=True)
    assert tuple(po.shape) == tuple(jo.shape) == (BATCH, 1 + 8 * ratio, pe.physical_state_dim)
    _close(po, jo)
    _close_phys(pe, pl, jl)
    po2, _ = pe.fused_sim_ahead(ps, torch.as_tensor(acts), pe.tau / ratio, pe.tau, obs_stride=2, strict=True)
    _close(po2, jo[:, ::2])


def test_time_major_equals_batch_major():
    pe = P.CartPole(batch_size=64, solver="rk4", **F64)
    _, ps = pe.vmap_reset(rng=torch.Generator().manual_seed(0))
    acts = torch.as_tensor(_actions(16, batch=64))
    po, pl = pe.fused_rollout(ps, acts, obs_stride=2, strict=True)
    po_tm, pl_tm = pe.fused_rollout(ps, acts.transpose(0, 1).contiguous(), obs_stride=2, time_major=True, strict=True)
    assert torch.equal(po, po_tm) and torch.equal(pl.physical_state.theta, pl_tm.physical_state.theta)


def test_plain_version_equals_vmap_rollout_exactly():
    """Same operations in the same order: the plain version IS the loop."""
    pe = P.Pendulum(batch_size=64, solver="tsit5", **F64)
    _, ps = pe.vmap_reset(rng=torch.Generator().manual_seed(1))
    acts = torch.as_tensor(_actions(17, batch=64))
    po, pl = pe.vmap_rollout(ps, acts, 4)
    fo, fl = pe.fused_rollout(ps, acts, obs_stride=4, strict=True)
    assert torch.equal(po, fo) and torch.equal(pl.physical_state.omega, fl.physical_state.omega)


def test_dispatch_scope_and_fallback():
    pe = P.Pendulum(batch_size=16, **F64)
    assert rollout_path(pe) == "fused"
    assert rollout_path(pe, pe.tau, pe.tau) == "fused"
    assert rollout_path(pe, pe.tau / 2.5, pe.tau) == "scan"
    _, ps = pe.vmap_reset()
    acts = 0.2 * torch.ones((16, 4, 1), dtype=torch.float64)
    obs_ref, _, _ = pe.vmap_sim_ahead(ps, acts, pe.tau / 2.5, pe.tau)
    obs, _ = pe.fused_sim_ahead(ps, acts, pe.tau / 2.5, pe.tau)
    assert torch.equal(obs, obs_ref)
    with pytest.raises(ValueError, match="strict"):
        pe.fused_sim_ahead(ps, acts, pe.tau / 2.5, pe.tau, strict=True)
    assert K.sim_ahead_ratio(1e-4, 3e-4) == 3 and K.sim_ahead_ratio(1e-4, 2.5e-4) is None


def test_cpu_tensors_take_the_plain_version_only():
    pe = P.Pendulum(batch_size=8, **F64)
    _, ps = pe.vmap_reset()
    acts = torch.zeros((8, 4, 1), dtype=torch.float64)
    K.KERNEL.reset_counts()
    pe.fused_rollout(ps, acts, strict=True)
    assert K.KERNEL.launches == {"step": 0, "sim_ahead": 0}
    y0 = (ps.physical_state.theta, ps.physical_state.omega)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.kernel_rollout(pe, y0, acts.transpose(0, 1), tau=pe.tau)


def test_plain_version_is_differentiable_on_cpu():
    pe = P.Pendulum(batch_size=8, solver="rk4", **F64)
    _, ps = pe.vmap_reset()
    acts = torch.full((8, 4, 1), 0.3, dtype=torch.float64, requires_grad=True)
    obs, _ = pe.fused_rollout(ps, acts, strict=True)
    obs[:, 1].sum().backward()
    assert acts.grad is not None and bool((acts.grad[:, -1] != 0).all())
