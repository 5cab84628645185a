"""The port's five later environments (VanDerPol, FluidTank, Acrobot,
InductionMachine, EESM) against the JAX package, on the CPU.

Same numpy inputs on both sides, float64.  Tolerances are those of the JAX
package's own tests: the golden fixtures at the fixture test's
``allclose(..., 1e-16)``; the scan and the plain fused versions against the
JAX scan and the Pallas kernels in interpret mode at rtol = atol = 1e-12
(1e-10 where the JAX test of the same path uses it); the physics checks at
their figures in tests/test_van_der_pol.py, tests/test_induction_machine.py
and tests/test_eesm.py.  The CUDA kernels themselves run only on a card:
tests/test_torch_gpu.py holds them against these plain versions there.
"""

import math
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas import stepper as jstepper
from exciting_environments_tpu.utils.collect import tile_policy_scan as j_tile_policy_scan
from exciting_environments_torch.core import structures
from exciting_environments_torch.core.classic import svm_circle
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.ops.kernels import stepper as K
from exciting_environments_torch.utils import load_sim_properties_from_json
from exciting_environments_torch.utils.collect import tile_policy_scan
from exciting_environments_torch.utils.convert import properties_from_numpy, state_from_numpy

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = dict(device="cpu", dtype=torch.float64)
NEW = ["VanDerPol", "FluidTank", "Acrobot", "InductionMachine", "EESM"]
ACTION_DIM = {"VanDerPol": 1, "FluidTank": 1, "Acrobot": 1, "InductionMachine": 2, "EESM": 3}
B, T = 8, 16


def _pair(name, solver="euler", batch=B, **kwargs):
    return (getattr(J, name)(batch_size=batch, solver=solver, **kwargs),
            getattr(P, name)(batch_size=batch, solver=solver, **F64, **kwargs))


def _x0(pe, seed):
    """Random physical states: heights in [0, 3) for the tank, else [-2, 2)."""
    rng = np.random.default_rng(seed)
    lo, hi = (0.0, 3.0) if type(pe).__name__ == "FluidTank" else (-2.0, 2.0)
    return {n: rng.uniform(lo, hi, pe.batch_size) for n in pe._ode_state_fields}


def _states(je, pe, seed, reference=None):
    """The same initial state (and tracking references) on both sides."""
    x0 = _x0(pe, seed)
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
        for n, v in (reference or {}).items():
            setattr(js.reference, n, jnp.asarray(v))
    return js, state_from_numpy(pe, x0, reference=reference)


def _actions(seed, name, batch=B, n=T, lim=0.95):
    return np.random.default_rng(seed).uniform(-lim, lim, (batch, n, ACTION_DIM[name]))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), **(tol or TOL))


def _close_phys(pe, ps, js, **tol):
    for n in pe._ode_state_fields:
        _close(getattr(ps.physical_state, n), getattr(js.physical_state, n), **tol)


# ---------------------------------------------------------------------------
# registry and scope
# ---------------------------------------------------------------------------

MEMBERS = ["PENDULUM", "CART_POLE", "ACROBOT", "MASS_SPRING_DAMPER", "FLUID_TANK", "PMSM", "VAN_DER_POL",
           "INDUCTION_MACHINE", "EESM"]


@pytest.mark.parametrize("member", MEMBERS)
def test_registry_builds_every_id_of_the_jax_package(member):
    value = J.EnvironmentRegistry[member].value
    assert P.EnvironmentRegistry[member].value == value
    by_member = P.EnvironmentRegistry[member].make(batch_size=3, device="cpu")
    by_id = P.core.registration.make(value, batch_size=3, device="cpu")
    assert type(by_member) is type(by_id)
    assert type(by_member).__name__ == type(J.EnvironmentRegistry[member].make(batch_size=3)).__name__
    assert list(by_member.obs_description) == list(J.EnvironmentRegistry[member].make(batch_size=3).obs_description)


SCOPE_CASES = [(name, None) for name in NEW] + [("InductionMachine", 400.0), ("EESM", 400.0)]


@pytest.mark.parametrize("name,u_dc", SCOPE_CASES, ids=[f"{n}-{'u_dc' if u else 'default'}" for n, u in SCOPE_CASES])
def test_new_environments_are_in_both_kernels_scope(name, u_dc):
    kwargs = {} if u_dc is None else {"u_dc": u_dc}
    env = getattr(P, name)(batch_size=4, **F64, **kwargs)
    assert K.supports_fused_rollout(env) and CL.supports_fused_closed_loop(env)
    assert rollout_path(env) == "fused"
    assert K.kernel_svm_limit(env) == (0.0 if u_dc is None else u_dc / math.sqrt(3.0))


def test_another_constraint_hook_is_out_of_the_kernels_scope_but_runs_on_the_cpu():
    """A hook the kernels do not compute: kernel_svm_limit is None, the open
    loop takes the loop, and on CPU tensors the plain versions run the hook
    and equal the loops."""
    env = P.InductionMachine(batch_size=B, **F64)
    env._constrain_action_tuple = lambda comps: (torch.clamp(comps[0], -100.0, 100.0), comps[1])
    assert K.kernel_svm_limit(env) is None
    assert not K.supports_fused_rollout(env) and rollout_path(env) == "scan"
    assert CL.supports_fused_closed_loop(env)
    ps = state_from_numpy(env, _x0(env, 0))
    acts = torch.as_tensor(_actions(1, "InductionMachine"))
    obs_l, last_l = env.vmap_rollout(ps, acts, 4)
    obs_f, last_f = env.fused_rollout(ps, acts, obs_stride=4)
    assert torch.equal(obs_l, obs_f) and torch.equal(last_l.physical_state.i_sd, last_f.physical_state.i_sd)
    y0 = tuple(getattr(ps.physical_state, n) for n in env._ode_state_fields)
    y_plain, _ = K.plain_rollout(env, y0, acts.transpose(0, 1), tau=env.tau)
    assert torch.equal(y_plain[0], last_l.physical_state.i_sd)
    policy = P.AffinePolicy([[0.0] * 4, [0.0] * 4], b=[0.9, -0.9])
    _, last_k = env.fused_closed_loop(ps, policy, T)
    _, last_s = tile_policy_scan(env, ps, T, policy, None, False)
    assert torch.equal(last_k.physical_state.psi_rd, last_s.physical_state.psi_rd)


def test_svm_circle_matches_the_jax_hook():
    lim = 400.0 / math.sqrt(3.0)
    rng = np.random.default_rng(3)
    u = rng.uniform(-400, 400, (3, 4096))
    u[:, :4] = 0.0  # a zero vector: the 1e-12 floor
    hook = svm_circle(400.0)
    assert hook.svm_limit == lim
    got = hook(tuple(torch.as_tensor(c) for c in u))
    ref = J.EESM(batch_size=1, u_dc=400.0)._constrain_action_tuple(tuple(jnp.asarray(c) for c in u))
    for g, r in zip(got, ref):
        _close(g, r, rtol=1e-15, atol=1e-12)
    mag = np.hypot(got[0].numpy(), got[1].numpy())
    assert mag.max() <= lim * (1 + 1e-15) and (mag > lim * 0.999).sum() > 100
    np.testing.assert_array_equal(got[2].numpy(), u[2])


# ---------------------------------------------------------------------------
# the scan and the plain fused versions against the JAX package
# ---------------------------------------------------------------------------

SCAN_CASES = [
    ("VanDerPol", "euler", {}),
    ("VanDerPol", "rk4", {}),
    ("FluidTank", "euler", {}),
    ("FluidTank", "heun", {}),
    ("Acrobot", "tsit5", {}),
    ("Acrobot", "euler", {"fast_math": True}),
    ("InductionMachine", "euler", {}),
    ("InductionMachine", "rk4", {"u_dc": 400.0}),
    ("EESM", "euler", {"u_dc": 400.0}),
    ("EESM", "rk4", {}),
]


@pytest.mark.parametrize("name,solver,kwargs", SCAN_CASES,
                         ids=[f"{n}-{s}{'-' + '-'.join(k) if k else ''}" for n, s, k in SCAN_CASES])
def test_vmap_rollout_and_fused_rollout_match_the_jax_scan(name, solver, kwargs):
    je, pe = _pair(name, solver, **kwargs)
    js, ps = _states(je, pe, 0)
    acts = _actions(1, name)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), 4)
    po, pl = pe.vmap_rollout(ps, torch.as_tensor(acts), 4)
    _close(po, jo)
    _close_phys(pe, pl, jl)
    fo, fl = pe.fused_rollout(ps, torch.as_tensor(acts), obs_stride=4, strict=True)
    assert torch.equal(fo, po)  # the plain version is the step loop, operation for operation
    for n in pe._ode_state_fields:
        assert torch.equal(getattr(fl.physical_state, n), getattr(pl.physical_state, n))
    if pe._solver.fsal:
        for k_p, k_j in zip(fl.additions.solver_state, jl.additions.solver_state):
            _close(k_p, k_j)


@pytest.mark.parametrize("name,kwargs", [("VanDerPol", {}), ("FluidTank", {}), ("Acrobot", {}),
                                         ("InductionMachine", {"u_dc": 400.0}), ("EESM", {"u_dc": 400.0})])
def test_fused_sim_ahead_matches_jax(name, kwargs):
    je, pe = _pair(name, "rk4", **kwargs)
    js, ps = _states(je, pe, 2)
    acts = _actions(3, name, n=8)
    jo, _, jl = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau / 2, je.tau)
    po, pl = pe.fused_sim_ahead(ps, torch.as_tensor(acts), pe.tau / 2, pe.tau, strict=True)
    assert tuple(po.shape) == tuple(jo.shape)
    _close(po, jo)
    _close_phys(pe, pl, jl)


# ---------------------------------------------------------------------------
# against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

BK, TK = 1024, 8
INTERPRET_CASES = [
    ("VanDerPol", "rk4", {}),
    ("FluidTank", "heun", {}),
    ("Acrobot", "euler", {"fast_math": True}),
    ("InductionMachine", "euler", {"u_dc": 400.0}),
    ("EESM", "rk4", {"u_dc": 400.0}),
]


@pytest.mark.parametrize("name,solver,kwargs", INTERPRET_CASES, ids=[c[0] for c in INTERPRET_CASES])
def test_fused_rollout_matches_the_pallas_kernel_in_interpret_mode(name, solver, kwargs):
    je, pe = _pair(name, solver, batch=BK, **kwargs)
    js, ps = _states(je, pe, 4)
    acts = _actions(5, name, batch=BK, n=TK)
    jo, jl = jstepper.env_fused_rollout(je, js, jnp.asarray(acts), obs_stride=4, interpret=True, strict=True)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), obs_stride=4, strict=True)
    _close(po, jo)
    _close_phys(pe, pl, jl)


@pytest.mark.parametrize("name", ["InductionMachine", "EESM"])
def test_fused_sim_ahead_with_u_dc_matches_the_pallas_kernel_in_interpret_mode(name):
    je, pe = _pair(name, "rk4", batch=BK, u_dc=400.0)
    js, ps = _states(je, pe, 6)
    acts = _actions(7, name, batch=BK, n=TK)
    jo, jl = jstepper.env_fused_sim_ahead(je, js, jnp.asarray(acts), je.tau, je.tau, interpret=True, strict=True)
    po, pl = pe.fused_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau, strict=True)
    _close(po, jo)
    _close_phys(pe, pl, jl)


CL_CASES = [
    # (name, solver, control field, gains K over [state..., ref], kwargs)
    ("Acrobot", "tsit5", "theta_1", [[-0.9, 0.0, -0.25, 0.0, 0.9]], {}),
    ("VanDerPol", "euler", "position", [[-0.8, -0.3, 0.8]], {}),
    ("InductionMachine", "rk4", "i_sd", [[-0.9, 0.0, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0, 0.0]], {"u_dc": 400.0}),
    ("EESM", "euler", "i_d", [[-0.9, 0.0, 0.0, 0.9], [0.0, -0.9, 0.0, 0.0], [0.0, 0.0, -0.5, 0.0]],
     {"u_dc": 400.0}),
]


def _affine_jax(K):
    K = np.asarray(K)

    def law(obs, t):
        return tuple(sum(K[j, i] * obs[i] for i in range(K.shape[1])) for j in range(K.shape[0]))

    return law


@pytest.mark.parametrize("name,solver,field,gains,kwargs", CL_CASES, ids=[c[0] for c in CL_CASES])
def test_closed_loop_matches_the_pallas_kernel_in_interpret_mode(name, solver, field, gains, kwargs):
    """The affine P/PD laws of chip_smoke.py's closed-loop cases, tracking
    one field, against the JAX kernel (rtol = atol = 1e-10, the figure of
    tests/test_torch_closed_loop.py: the sums run in another order)."""
    je, pe = _pair(name, solver, batch=BK, control_state=[field], **kwargs)
    refs = {field: np.random.default_rng(8).uniform(-1.0, 1.0, BK)}
    js, ps = _states(je, pe, 9, reference=refs)
    obs_j, acts_j, last_j = jstepper.env_fused_closed_loop(je, js, _affine_jax(gains), TK, obs_stride=1,
                                                          interpret=True)
    obs_p, acts_p, last_p = pe.fused_closed_loop(ps, P.AffinePolicy(gains), TK, obs_stride=1)
    tol = dict(rtol=1e-10, atol=1e-10)
    _close(obs_p, obs_j, **tol)
    _close(acts_p, acts_j, **tol)
    _close_phys(pe, last_p, last_j, **tol)


# ---------------------------------------------------------------------------
# the inverter limit on every path (tests/test_induction_machine.py:167,
# tests/test_eesm.py:268)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["InductionMachine", "EESM"])
def test_u_dc_inverter_realism_consistent_on_every_path(name):
    b, t = 256, 12
    je, pe = _pair(name, batch=b, u_dc=400.0)
    pe0 = getattr(P, name)(batch_size=b, **F64)
    js, ps = _states(je, pe, 10)
    a = [0.9, 0.9, 0.2][: pe.action_dim]
    acts = torch.as_tensor(np.broadcast_to(np.asarray(a), (b, t, pe.action_dim)).copy())
    first = pe._ode_state_fields[0]
    get = lambda s: getattr(s.physical_state, first)

    _, last_c = pe.vmap_rollout(ps, acts, t)
    _, last_u = pe0.vmap_rollout(ps, acts, t)
    # 0.9 of the +-325 V band (|u| ~ 414 V) exceeds the 231 V circle: it binds
    assert float((get(last_c) - get(last_u)).abs().max()) > 1e-3
    _, last_j = je.vmap_rollout(js, jnp.asarray(acts.numpy()), t)
    _close_phys(pe, last_c, last_j)

    s = ps
    for k in range(t):
        _, s = pe.vmap_step(s, acts[:, k])
    assert torch.equal(get(s), get(last_c))
    _, last_f = pe.fused_rollout(ps, acts, strict=True)
    assert torch.equal(get(last_f), get(last_c))
    _, _, last_sa = pe.vmap_sim_ahead(ps, acts, pe.tau, pe.tau)
    _close(get(last_sa), get(last_c), rtol=1e-10, atol=1e-10)
    _, last_fsa = pe.fused_sim_ahead(ps, acts, pe.tau, pe.tau, strict=True)
    _close(get(last_fsa), get(last_c), rtol=1e-10, atol=1e-10)

    policy = P.AffinePolicy([[0.0] * pe.physical_state_dim] * pe.action_dim, b=[0.95, 0.95, 0.1][: pe.action_dim])
    _, last_k = pe.fused_closed_loop(ps, policy, t)
    _, last_ks = tile_policy_scan(pe, ps, t, policy, None, False)
    assert torch.equal(get(last_k), get(last_ks))
    _, last_k0 = pe0.fused_closed_loop(ps, policy, t)
    assert float((get(last_k) - get(last_k0)).abs().max()) > 1e-3
    law = lambda obs, step: tuple(v + 0.0 * obs[0] for v in [0.95, 0.95, 0.1][: pe.action_dim])
    _, last_jk = j_tile_policy_scan(je, js, t, law, None, False)
    _close(get(last_k), getattr(last_jk.physical_state, first), rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# per-batch sweeps (tests/test_induction_machine.py:98, tests/test_eesm.py:192)
# ---------------------------------------------------------------------------


def test_per_batch_rotor_resistance_sweep():
    b = 8
    params = {**P.InductionMachine._default_static_params(), "omega": 0.0}
    r_r = np.linspace(1.8, 3.2, b)
    pe = P.InductionMachine(batch_size=b, static_params={**params, "r_r": r_r}, **F64)
    je = J.InductionMachine(batch_size=b, static_params={**params, "r_r": jnp.asarray(r_r)})
    _, ps = pe.vmap_reset()
    _, js = je.vmap_reset()
    acts = np.concatenate([0.05 * np.ones((b, 2000, 1)), np.zeros((b, 2000, 1))], -1)
    _, fin = pe.fused_rollout(ps, torch.as_tensor(acts), strict=True)
    psi = fin.physical_state.psi_rd.numpy()
    assert (np.diff(psi) > 0).all()  # hotter rotors magnetize faster
    _, jfin = je.vmap_rollout(js, jnp.asarray(acts[:, :64]), 64)
    _, pfin = pe.vmap_rollout(ps, torch.as_tensor(acts[:, :64]), 64)
    _close_phys(pe, pfin, jfin)


def test_per_batch_saliency_sweep():
    b = 8
    l_q = np.linspace(3.0e-3, 6.0e-3, b)
    params = {**P.EESM._default_static_params(), "l_q": l_q}
    pe = P.EESM(batch_size=b, static_params=params, **F64)
    je = J.EESM(batch_size=b, static_params={**params, "l_q": jnp.asarray(l_q)})
    x = {"i_d": np.full(b, 2.0), "i_q": np.full(b, 3.0), "i_f": np.zeros(b)}
    st = state_from_numpy(pe, x)
    tq = pe.torque(st).numpy()
    assert (np.diff(tq) < 0).all()  # larger l_q: less (more negative) torque
    _, jst = je.vmap_reset()
    with jstructures.copy_and_mutate(jst) as jst:
        for n, v in x.items():
            setattr(jst.physical_state, n, jnp.asarray(v))
    _close(pe.torque(st), je.torque(jst))
    acts = _actions(11, "EESM", batch=b, n=50)
    obs, fin = pe.fused_rollout(st, torch.as_tensor(acts), strict=True)
    assert torch.isfinite(obs).all()
    _, jfin = je.vmap_rollout(jst, jnp.asarray(acts), 50)
    _close_phys(pe, fin, jfin)


# ---------------------------------------------------------------------------
# golden fixtures through sim_ahead (tests/envs/test_golden_sim_ahead.py)
# ---------------------------------------------------------------------------

DATA_ROOT = Path(__file__).parent / "envs"
GOLDEN = [("PENDULUM", "pendulum"), ("CART_POLE", "cartpole"), ("ACROBOT", "acrobot"),
          ("MASS_SPRING_DAMPER", "mass_spring_damper"), ("FLUID_TANK", "fluid_tank")]


@pytest.mark.parametrize("member,fixture_dir", GOLDEN, ids=[g[1] for g in GOLDEN])
def test_sim_ahead_replays_golden(member, fixture_dir):
    data_dir = DATA_ROOT / fixture_dir / "data"
    params, action_norms, physical_norms, tau = load_sim_properties_from_json(
        os.path.join(data_dir, "sim_properties.json"))
    env = P.EnvironmentRegistry[member].make(tau=tau, solver="euler", static_params=params,
                                             physical_normalizations=physical_norms,
                                             action_normalizations=action_norms, **F64)
    stored = torch.as_tensor(np.load(data_dir / "observations.npy"))
    actions = torch.as_tensor(np.load(data_dir / "actions.npy"))
    state = env.generate_state_from_observation(stored[0], env.env_properties)
    obs, _, _ = env.sim_ahead(state, actions, env.env_properties, tau, tau)
    assert obs.shape == stored.shape
    # the trajectory wraps angles on every saved point, t0 included: compare
    # modulo the normalized period 2
    diff = obs - stored
    folded = diff - 2.0 * torch.round(diff / 2.0)
    assert torch.allclose(folded, torch.zeros_like(folded), 1e-16)
    exact = diff.abs() < 1.0
    assert torch.allclose(torch.where(exact, diff, torch.zeros_like(diff)), torch.zeros_like(diff), 1e-16)


# ---------------------------------------------------------------------------
# physics (tests/test_van_der_pol.py, tests/test_induction_machine.py,
# tests/test_eesm.py)
# ---------------------------------------------------------------------------


def _rollout(env, acts, state=None, obs_stride=None):
    if state is None:
        _, state = env.vmap_reset()
    return env.fused_rollout(state, torch.as_tensor(acts), obs_stride=obs_stride, strict=True)


def test_van_der_pol_limit_cycle_amplitude():
    env = P.VanDerPol(batch_size=4, tau=1e-3, static_params={"mu": 2.0}, **F64)
    obs, _ = _rollout(env, np.zeros((4, 30_000, 1)), obs_stride=10)  # 30 time units
    amp = (obs[:, 1_500:, 0].numpy() * 4.0).__abs__().max(axis=1)
    np.testing.assert_allclose(amp, 2.0, atol=0.1)


def test_van_der_pol_registry_and_defaults():
    env = P.EnvironmentRegistry.VAN_DER_POL.make(batch_size=8, **F64)
    assert isinstance(env, P.VanDerPol)
    assert list(env.obs_description) == ["position", "velocity"]
    assert float(env.env_properties.static_params.mu) == 5.0
    obs, _ = env.vmap_reset()
    np.testing.assert_allclose(obs[:, 0].numpy(), 0.25, atol=1e-7)


def test_van_der_pol_rk4_order_of_convergence():
    """Halving tau shrinks the RK4 global error ~16x (order 4); the
    reference runs at tau / 16."""
    errs = []
    for tau in (2e-3, 1e-3):
        env = P.VanDerPol(batch_size=2, tau=tau, solver="rk4", static_params={"mu": 1.0}, **F64)
        ref = P.VanDerPol(batch_size=2, tau=tau / 16, solver="rk4", static_params={"mu": 1.0}, **F64)
        n = int(round(1.0 / tau))
        _, state = env.vmap_reset()
        obs, _ = _rollout(env, np.zeros((2, n, 1)), state)
        obs_ref, _ = _rollout(ref, np.zeros((2, 16 * n, 1)), state)
        errs.append(float((obs - obs_ref).abs().max()))
    assert errs[1] < errs[0] / 8  # asymptotic 16, allow slack


IM_PARAMS = P.InductionMachine._default_static_params()
EESM_PARAMS = P.EESM._default_static_params()
ACT_SCALE = np.array([325.0, 325.0, 60.0])


def test_induction_machine_dc_magnetization_steady_state():
    env = P.InductionMachine(batch_size=4, static_params={**IM_PARAMS, "omega": 0.0}, **F64)
    u_norm = 0.05
    acts = np.concatenate([u_norm * np.ones((4, 20_000, 1)), np.zeros((4, 20_000, 1))], axis=-1)
    _, fin = _rollout(env, acts)
    p = env.env_properties.static_params
    i_sd = fin.physical_state.i_sd.numpy()
    np.testing.assert_allclose(i_sd, u_norm * 325.0 / p.r_s, rtol=1e-4)
    np.testing.assert_allclose(fin.physical_state.psi_rd.numpy(), p.l_m * i_sd, rtol=1e-4)
    assert float(fin.physical_state.psi_rq.abs().max()) < 1e-9
    assert float(fin.physical_state.i_sq.abs().max()) < 1e-9
    assert float(env.torque(fin).abs().max()) < 1e-9


def test_induction_machine_rotating_supply_produces_torque_and_stays_bounded():
    env = P.InductionMachine(batch_size=2, **F64)
    n = 20_000
    w_s = IM_PARAMS["omega"] / 0.96  # ~4% slip above rotor speed
    t = np.arange(n) * env.tau
    acts = 0.4 * np.stack([np.broadcast_to(np.cos(w_s * t), (2, n)), np.broadcast_to(np.sin(w_s * t), (2, n))],
                          axis=-1)
    obs, fin = _rollout(env, acts, obs_stride=100)
    assert torch.isfinite(obs).all() and float(obs.abs().max()) < 1.0
    assert float(env.torque(fin).mean()) > 0.5  # motoring torque


def test_eesm_standstill_dc_steady_state():
    env = P.EESM(batch_size=4, static_params={**EESM_PARAMS, "omega_el": 0.0}, **F64)
    u_norm = np.array([0.02, 0.01, 0.3])
    _, fin = _rollout(env, np.broadcast_to(u_norm, (4, 30_000, 3)).copy())
    p = env.env_properties.static_params
    u = u_norm * ACT_SCALE
    np.testing.assert_allclose(fin.physical_state.i_d.numpy(), u[0] / p.r_s, rtol=1e-4)
    np.testing.assert_allclose(fin.physical_state.i_q.numpy(), u[1] / p.r_s, rtol=1e-4)
    np.testing.assert_allclose(fin.physical_state.i_f.numpy(), u[2] / p.r_f, rtol=1e-4)


def test_eesm_matches_exact_linear_solution():
    """Frozen omega_el makes the EESM linear and time-invariant: RK4 against
    the matrix-exponential solution built from the same parameters."""
    import scipy.linalg as sla

    env = P.EESM(batch_size=2, tau=5e-5, solver="rk4", **F64)
    p = EESM_PARAMS
    det = p["l_d"] * p["l_f"] - p["l_m"] ** 2
    w = p["omega_el"]
    a_psi = np.array([[-p["r_s"], w * p["l_q"], 0.0], [-w * p["l_d"], -p["r_s"], -w * p["l_m"]],
                      [0.0, 0.0, -p["r_f"]]])
    l_inv = np.array([[p["l_f"] / det, 0.0, -p["l_m"] / det], [0.0, 1.0 / p["l_q"], 0.0],
                      [-p["l_m"] / det, 0.0, p["l_d"] / det]])
    a = l_inv @ a_psi
    u_norm = np.array([0.05, -0.03, 0.2])
    n = 2_000
    x_ss = -np.linalg.solve(a, l_inv @ (u_norm * ACT_SCALE))
    x_exact = x_ss + sla.expm(a * n * env.tau) @ (-x_ss)
    _, fin = _rollout(env, np.broadcast_to(u_norm, (2, n, 3)).copy())
    got = np.stack([fin.physical_state.i_d.numpy(), fin.physical_state.i_q.numpy(), fin.physical_state.i_f.numpy()],
                   axis=-1)
    np.testing.assert_allclose(got, np.broadcast_to(x_exact, (2, 3)), rtol=2e-5, atol=2e-5)


def test_eesm_field_step_induces_d_axis_transient():
    env = P.EESM(batch_size=1, static_params={**EESM_PARAMS, "omega_el": 0.0}, **F64)
    acts = np.broadcast_to(np.asarray([0.0, 0.0, 0.3]), (1, 30_000, 3)).copy()
    obs, fin = _rollout(env, acts, obs_stride=10)
    assert float(obs[0, :, 0].min()) * 20.0 < -0.05  # induced opposing current
    np.testing.assert_allclose(fin.physical_state.i_d.numpy(), 0.0, atol=2e-3)


def test_eesm_torque_components():
    env = P.EESM(batch_size=1, **F64)
    p = env.env_properties.static_params
    st = state_from_numpy(env, {"i_d": [2.0], "i_q": [3.0], "i_f": [5.0]})
    psi_d, psi_q = p.l_d * 2.0 + p.l_m * 5.0, p.l_q * 3.0
    np.testing.assert_allclose(env.torque(st).numpy(), 1.5 * p.p * (psi_d * 3.0 - psi_q * 2.0), rtol=1e-6)
    st0 = state_from_numpy(env, {"i_d": [2.0], "i_q": [3.0], "i_f": [0.0]})
    np.testing.assert_allclose(env.torque(st0).numpy(), 1.5 * p.p * (p.l_d - p.l_q) * 2.0 * 3.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# the tank's constants and the conversions
# ---------------------------------------------------------------------------


def test_fluid_tank_flags_descriptions_and_reset():
    je, pe = _pair("FluidTank", batch=4)
    assert list(pe.obs_description) == list(je.obs_description) == ["fluid height"]
    js, ps = _states(je, pe, 12)
    acts = _actions(13, "FluidTank", batch=4, n=6)
    jstates = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau, je.tau)[1]
    pstates = pe.vmap_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau)[1]
    jr, jt, jterm = je.vmap_generate_rew_trunc_term_ahead(jstates, jnp.asarray(acts))
    pr, pt, pterm = pe.vmap_generate_rew_trunc_term_ahead(pstates, torch.as_tensor(acts))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(pterm.numpy(), np.asarray(jterm))
    _close(pr, jr)
    _, st = pe.vmap_reset(rng=torch.Generator().manual_seed(0))
    assert float(st.physical_state.height.min()) >= 0.0  # draws in [0, 1] normalized


@pytest.mark.parametrize("name", NEW)
def test_convert_builds_state_and_properties_of_every_new_environment(name):
    """state_from_numpy and properties_from_numpy are generic: each new
    environment's state and properties from numpy values (a per-batch
    parameter among them) roll out as the environment made directly."""
    env = getattr(P, name)(batch_size=4, **F64)
    params = {k: v for k, v in env._default_static_params().items()}
    first = next(iter(params))
    params[first] = np.full(4, float(params[first]))
    props = properties_from_numpy(
        env, params,
        {f: (n.min, n.max) for f, n in env._default_physical_normalizations().items()},
        {f: (n.min, n.max) for f, n in env._default_action_normalizations().items()},
    )
    assert isinstance(getattr(props.static_params, first), torch.Tensor)
    made = getattr(P, name)(batch_size=4, static_params=params, **F64)
    x0 = _x0(env, 14)
    st = state_from_numpy(env, x0)
    assert tuple(structures.leaves(st.physical_state)[0].shape) == (4,)
    acts = torch.as_tensor(_actions(15, name, batch=4, n=4))
    env.env_properties = props
    o1, _ = env.vmap_rollout(st, acts, 4)
    o2, _ = made.vmap_rollout(state_from_numpy(made, x0), acts, 4)
    assert torch.equal(o1, o2)
