"""The port's iLQR planner (``utils/ilqr.py``) on CPU tensors in float64:
the JAX package's ``tests/test_ilqr.py`` at its sizes and gates, and parity
with the JAX ``ilqr_plan`` from the same state and plan.

Parity: the cost curves within rtol 1e-9 of the largest cost and the plans
within atol 1e-9, on the Pendulum, the mass-spring-damper and the linear
PMSM drive (measured deviations beside each case, x86-64 CPU).  The PMSM's
linearization at the zero plan meets the hexagon's lower edge, where
``apply_hex_constraint``'s clip splits the cotangent as ``jnp.clip`` does,
and a zero phasor's sign picks its sector as XLA's dot does
(``ops/transforms.py``); with both, the drive holds the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import episodes as jep
from exciting_environments_tpu.utils import ilqr as jilqr
from exciting_environments_torch.utils import ilqr, mpc
from exciting_environments_torch.utils.convert import state_from_numpy
from exciting_environments_torch.utils.episodes import reset_with_references

B = 4
F64 = dict(device="cpu", dtype=torch.float64)
PMSM_FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")


def _key(seed):
    return torch.as_tensor(np.asarray(jax.random.PRNGKey(seed)).astype(np.int64))


def _pendulum(tau=2e-2, **kw):
    return P.Pendulum(batch_size=B, tau=tau, control_state=["theta"], **kw, **F64)


def _state(env, seed=0):
    _, state = reset_with_references(env, _key(seed))
    return state


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.float64)


def test_ilqr_descends_and_stays_feasible():
    env = _pendulum()
    state = _state(env)
    res = ilqr.ilqr_plan(env, state, _zeros(B, 20, 1), iterations=8)
    assert res.actions.shape == (B, 20, 1)
    assert res.costs.shape == (9,)
    assert bool((res.actions.abs() <= 1.0).all())
    assert bool(torch.isfinite(res.costs).all())
    assert float(res.costs[-1]) < float(res.costs[0])
    # the line-search acceptance rule makes the mean curve non-increasing
    assert bool((torch.diff(res.costs) <= 1e-9).all())


def test_ilqr_final_cost_matches_shared_trajectory_cost():
    env = _pendulum()
    state = _state(env)
    res = ilqr.ilqr_plan(env, state, _zeros(B, 12, 1), iterations=5, action_cost=0.0)
    shared = mpc._trajectory_cost(env, state, res.actions, None)
    assert np.isclose(float(res.costs[-1]), float(shared.mean()), rtol=1e-6)


def test_ilqr_near_lqr_on_linear_msd_beats_adam():
    env = P.MassSpringDamper(batch_size=B, tau=2e-2, control_state=["deflection"], **F64)
    state = _state(env, seed=3)
    u0 = _zeros(B, 30, 1)
    res_i = ilqr.ilqr_plan(env, state, u0, iterations=6, action_cost=0.0)
    res_g = mpc.optimize_actions(env, state, u0, iterations=300, learning_rate=0.2)
    ci = mpc._trajectory_cost(env, state, res_i.actions, None).mean()
    cg = mpc._trajectory_cost(env, state, res_g.actions, None).mean()
    c0 = mpc._trajectory_cost(env, state, u0, None).mean()
    assert float(ci) < float(c0)
    assert float(ci) <= float(cg) * 1.02 + 1e-9, (float(ci), float(cg))


def test_ilqr_improves_pendulum_tracking_vs_zero_plan():
    env = _pendulum()
    state = _state(env, seed=1)
    u0 = _zeros(B, 25, 1)
    res = ilqr.ilqr_plan(env, state, u0, iterations=10)
    c0 = mpc._trajectory_cost(env, state, u0, None).mean()
    c1 = mpc._trajectory_cost(env, state, res.actions, None).mean()
    assert float(c1) < 0.83 * float(c0), (float(c1), float(c0))
    res_g = mpc.optimize_actions(env, state, u0, iterations=400, learning_rate=0.2)
    cg = mpc._trajectory_cost(env, state, res_g.actions, None).mean()
    assert float(c1) <= float(cg) * 1.001, (float(c1), float(cg))


def test_ilqr_custom_stage_cost_prefers_zero_actions():
    env = _pendulum()
    state = _state(env)
    # elementwise over leading axes, where the JAX package's is per instance
    cost = lambda x, u, ref, props: torch.sum(u**2, dim=-1)
    res = ilqr.ilqr_plan(env, state, 0.4 * torch.ones((B, 10, 1), dtype=torch.float64), iterations=12,
                         stage_cost=cost)
    assert float(res.actions.abs().max()) < 0.02
    assert float(res.costs[-1]) < 1e-3


def test_ilqr_validation_and_scope():
    env = _pendulum()
    state = _state(env)
    with pytest.raises(ValueError, match="batch_size, horizon, action_dim"):
        ilqr.ilqr_plan(env, state, _zeros(B, 10), iterations=1)

    class NotAnEnv:
        pass

    with pytest.raises(TypeError, match="CoreEnvironment"):
        ilqr.ilqr_plan(NotAnEnv(), state, _zeros(B, 10, 2), iterations=1)
    plain = P.Pendulum(batch_size=B, control_state=[], **F64)
    with pytest.raises(ValueError, match="control_state"):
        _, st = plain.vmap_reset()
        ilqr.ilqr_plan(plain, st, _zeros(B, 10, 1), iterations=1)


def test_ilqr_per_batch_heterogeneous_params():
    env = _pendulum(static_params={"g": 9.81, "l": torch.linspace(1.5, 2.5, B, dtype=torch.float64), "m": 1.0})
    state = _state(env, seed=5)
    res = ilqr.ilqr_plan(env, state, _zeros(B, 15, 1), iterations=6)
    assert bool(torch.isfinite(res.actions).all())
    assert float(res.costs[-1]) < float(res.costs[0])


def test_ilqr_pmsm_current_planning():
    env = P.PMSM(batch_size=4, control_state=["i_d", "i_q"], tau=1e-4, **F64)
    state = _state(env, seed=9)
    res = ilqr.ilqr_plan(env, state, _zeros(4, 12, 2), iterations=6)
    costs = res.costs.numpy()
    assert np.isfinite(costs).all()
    assert bool(torch.isfinite(res.actions).all())
    assert bool((res.actions.abs() <= 1.0).all())
    assert (np.diff(costs) <= 1e-9).all(), costs
    assert costs[-1] < 0.5 * costs[0], costs


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _classic_pair(name, control_state, seed, **kw):
    je = getattr(J, name)(batch_size=B, tau=2e-2, control_state=control_state, **kw)
    pe = getattr(P, name)(batch_size=B, tau=2e-2, control_state=control_state, **kw, **F64)
    _, js = jep.reset_with_references(je, jax.random.PRNGKey(seed))
    return je, pe, js, _state(pe, seed)


def _pmsm_pair(seed=9):
    je = J.PMSM(batch_size=4, control_state=["i_d", "i_q"], tau=1e-4)
    pe = P.PMSM(batch_size=4, control_state=["i_d", "i_q"], tau=1e-4, **F64)
    _, js = jep.reset_with_references(je, jax.random.PRNGKey(seed))
    ps = state_from_numpy(pe, {n: np.asarray(getattr(js.physical_state, n)) for n in PMSM_FIELDS},
                          reference={n: np.asarray(getattr(js.reference, n)) for n in ("i_d", "i_q")},
                          keys=np.asarray(js.PRNGKey))
    return je, pe, js, ps


@pytest.mark.parametrize("case", ["pendulum", "msd", "pmsm"])
def test_ilqr_plan_matches_jax(case):
    if case == "pmsm":
        je, pe, js, ps = _pmsm_pair()
        plan, iterations, kw = np.zeros((4, 12, 2)), 6, {}
    elif case == "msd":
        je, pe, js, ps = _classic_pair("MassSpringDamper", ["deflection"], 3)
        plan, iterations, kw = np.zeros((B, 30, 1)), 6, dict(action_cost=0.0)
    else:
        je, pe, js, ps = _classic_pair("Pendulum", ["theta"], 1)
        plan, iterations, kw = 0.1 * np.random.default_rng(0).standard_normal((B, 25, 1)), 10, {}
    rj = jilqr.ilqr_plan(je, js, jnp.asarray(plan), iterations=iterations, **kw)
    rp = ilqr.ilqr_plan(pe, ps, torch.as_tensor(plan), iterations=iterations, **kw)
    costs_j = np.asarray(rj.costs)
    # measured: cost curves 4.2e-16 (pendulum), 5.0e-16 (msd), 9.8e-16 (pmsm) of the largest cost;
    # plans 6.8e-14, 3.3e-15, 1.9e-14
    assert np.abs(rp.costs.numpy() - costs_j).max() <= 1e-9 * np.abs(costs_j).max()
    assert np.abs(rp.actions.numpy() - np.asarray(rj.actions)).max() <= 1e-9


def test_linearization_and_stage_hessian_match_jax():
    """``_linearize`` and ``_grad_hessian`` against ``jax.jacobian`` and
    ``jax.hessian`` of the JAX planner's own functions, on the PMSM drive at
    random points and on the hexagon's edge (the zero action)."""
    from exciting_environments_tpu.utils.estimate import _dynamics_fn as jdyn
    from exciting_environments_torch.utils.estimate import _dynamics_fn as pdyn

    je = J.PMSM(batch_size=1, control_state=["i_d", "i_q"], tau=1e-4)
    pe = P.PMSM(batch_size=1, control_state=["i_d", "i_q"], tau=1e-4, **F64)
    jf, pf = jdyn(je), pdyn(pe)
    jp, pp = je.env_properties, pe.env_properties
    jcost, pcost = jilqr._default_stage_cost(je, 1e-4), ilqr._default_stage_cost(pe, 1e-4)
    rng = np.random.default_rng(1)
    n = 7
    xs = rng.uniform(-0.5, 0.5, (5, n))
    us = np.concatenate([rng.uniform(-0.8, 0.8, (4, 2)), np.zeros((1, 2))])
    ref = np.array([0.1, -0.2])
    A_p, B_p = ilqr._linearize(lambda x, u: pf(x, u, pp), torch.as_tensor(xs), torch.as_tensor(us))
    zs = np.concatenate([xs, us], axis=-1)
    g_p, H_p = ilqr._grad_hessian(
        lambda z: pcost(pf(z[..., :n], z[..., n:], pp), z[..., n:], torch.as_tensor(ref).expand(z.shape[:-1] + (2,)),
                        pp),
        torch.as_tensor(zs))
    g_j = lambda z: jcost(jf(z[:n], z[n:], jp), z[n:], jnp.asarray(ref), jp)
    A_j, B_j = jax.vmap(jax.jacobian(lambda x, u: jf(x, u, jp), argnums=(0, 1)))(jnp.asarray(xs), jnp.asarray(us))
    # measured 3.5e-16 and 3.3e-16
    assert np.abs(A_p.numpy() - np.asarray(A_j)).max() <= 1e-12
    assert np.abs(B_p.numpy() - np.asarray(B_j)).max() <= 1e-12
    # measured 1.1e-16 (gradient) and 1.1e-16 (Hessian)
    assert np.abs(g_p.numpy() - np.asarray(jax.vmap(jax.grad(g_j))(jnp.asarray(zs)))).max() <= 1e-12
    assert np.abs(H_p.numpy() - np.asarray(jax.vmap(jax.hessian(g_j))(jnp.asarray(zs)))).max() <= 1e-12
