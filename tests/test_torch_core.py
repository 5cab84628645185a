"""Parity of the PyTorch port's core runtime and environments with the JAX package.

The same numpy inputs (made from a seed) go through the JAX package and the
port in float64 on the CPU.  Tolerance rtol = atol = 1e-12 (XLA's CPU backend
contracts FMAs, PyTorch eager does not); the golden fixtures replay with the
JAX test's own ``allclose(generated, stored, 1e-16)``.
"""

import json
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_torch.core import spaces, structures
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.utils import (
    MinMaxNormalization,
    dump_sim_properties_to_json,
    load_sim_properties_from_json,
)
from exciting_environments_torch.utils.convert import properties_from_numpy, state_from_numpy

TOL = dict(rtol=1e-12, atol=1e-12)
ENVS = ["Pendulum", "MassSpringDamper", "CartPole"]
B, T = 8, 8
F64 = dict(device="cpu", dtype=torch.float64)


def _pair(name, solver="euler", batch=B, jax_kwargs=None, torch_kwargs=None):
    je = getattr(J, name)(batch_size=batch, solver=solver, **(jax_kwargs or {}))
    pe = getattr(P, name)(batch_size=batch, solver=solver, **F64, **(torch_kwargs or {}))
    return je, pe


def _states(je, pe, seed):
    """The same random physical state on both sides."""
    rng = np.random.default_rng(seed)
    x0 = {n: rng.uniform(-2.0, 2.0, pe.batch_size) for n in pe._ode_state_fields}
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
    return js, state_from_numpy(pe, x0)


def _actions(seed, batch, n, dim=1):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, (batch, n, dim))


def _close(port, ref):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), **TOL)


def _close_phys(pe, ps, js):
    for n in pe._ode_state_fields:
        _close(getattr(ps.physical_state, n), getattr(js.physical_state, n))


# ---------------------------------------------------------------------------
# containers, spaces, normalization, registry
# ---------------------------------------------------------------------------


def test_structures_replace_and_copy_do_not_alias():
    env = P.Pendulum(batch_size=2, device="cpu")
    _, state = env.vmap_reset()
    new = structures.replace(state, PRNGKey=torch.zeros(2))
    assert torch.isnan(state.PRNGKey).all() and not torch.isnan(new.PRNGKey).any()
    with structures.copy_and_mutate(state) as copy:
        copy.physical_state.theta = torch.zeros(2)
    assert float(state.physical_state.theta[0]) == pytest.approx(math.pi)
    assert structures.structure(copy) == structures.structure(state)
    with pytest.raises(AttributeError, match="no field"):
        structures.replace(state, nope=1)
    assert len(structures.leaves(state.physical_state)) == 2


def test_box_space_samples_from_generator():
    box = spaces.Box(-2.0, 3.0, (64,), dtype=torch.float64)
    x = box.sample(torch.Generator().manual_seed(0))
    assert x.shape == (64,) and x.dtype == torch.float64 and box.contains(x)
    assert not box.contains(torch.tensor([4.0]))


def test_minmax_normalization_and_json_round_trip(tmp_path):
    n = MinMaxNormalization(min=-20, max=20)
    x = torch.tensor([-20.0, 0.0, 20.0], dtype=torch.float64)
    assert torch.equal(n.normalize(x), torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64))
    assert torch.equal(n.denormalize(n.normalize(x)), x)
    path = tmp_path / "props.json"
    dump_sim_properties_to_json({"g": 9.81}, {"torque": n}, {"theta": MinMaxNormalization(-1.0, 1.0)}, 1e-4, path)
    params, an, pn, tau = load_sim_properties_from_json(path)
    assert params == {"g": 9.81} and tau == 1e-4 and an["torque"].max == 20 and pn["theta"].min == -1.0
    assert json.loads(path.read_text())["action_normalizations"]["torque"] == {"min": -20, "max": 20}


@pytest.mark.parametrize("member", ["PENDULUM", "CART_POLE", "MASS_SPRING_DAMPER"])
def test_registry_ids_match_jax(member):
    assert P.EnvironmentRegistry[member].value == J.EnvironmentRegistry[member].value
    env = P.EnvironmentRegistry[member].make(batch_size=3, device="cpu")
    assert type(env).__name__ == type(J.EnvironmentRegistry[member].make(batch_size=3)).__name__
    with pytest.raises(ValueError, match="Unknown environment"):
        P.core.registration.make("Nope-v0")


# ---------------------------------------------------------------------------
# batched API against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ENVS)
@pytest.mark.parametrize("solver", ["euler", "rk4", "tsit5"])
def test_vmap_step_matches_jax(name, solver):
    je, pe = _pair(name, solver)
    js, ps = _states(je, pe, 0)
    act = _actions(1, B, 1)[:, 0]
    for _ in range(3):
        jo, js = je.vmap_step(js, jnp.asarray(act))
        po, ps = pe.vmap_step(ps, torch.as_tensor(act))
    _close(po, jo)
    _close_phys(pe, ps, js)
    if pe._solver.fsal:
        for k_p, k_j in zip(ps.additions.solver_state, js.additions.solver_state):
            _close(k_p, k_j)
    else:
        assert ps.additions.solver_state is None


@pytest.mark.parametrize("name", ENVS)
@pytest.mark.parametrize("obs_stride", [1, 4])
def test_vmap_rollout_matches_jax(name, obs_stride):
    je, pe = _pair(name, "rk4")
    js, ps = _states(je, pe, 2)
    acts = _actions(3, B, T)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), obs_stride)
    po, pl = pe.vmap_rollout(ps, torch.as_tensor(acts), obs_stride)
    assert tuple(po.shape) == tuple(jo.shape) == (B, T // obs_stride, pe.physical_state_dim)
    _close(po, jo)
    _close_phys(pe, pl, jl)


@pytest.mark.parametrize("name", ENVS)
@pytest.mark.parametrize("solver", ["euler", "rk4", "tsit5"])
@pytest.mark.parametrize("ratio", [1, 2])
def test_vmap_sim_ahead_matches_jax(name, solver, ratio):
    je, pe = _pair(name, solver)
    js, ps = _states(je, pe, 4)
    acts = _actions(5, B, T)
    h = pe.tau
    jo, jst, jl = je.vmap_sim_ahead(js, jnp.asarray(acts), h / ratio, h)
    po, pst, pl = pe.vmap_sim_ahead(ps, torch.as_tensor(acts), h / ratio, h)
    assert tuple(po.shape) == tuple(jo.shape) == (B, 1 + T * ratio, pe.physical_state_dim)
    _close(po, jo)
    _close_phys(pe, pst, jst)
    _close_phys(pe, pl, jl)
    if pe._solver.fsal:
        for k_p, k_j in zip(pst.additions.solver_state, jst.additions.solver_state):
            _close(k_p, k_j)


def test_per_batch_params_match_jax():
    """(B,) parameter and action-normalization leaves broadcast over the batch."""
    rng = np.random.default_rng(6)
    lengths, masses = 1.0 + rng.uniform(0, 1, B), 0.5 + rng.uniform(0, 1, B)
    tmax = 10.0 + 10 * rng.uniform(0, 1, B)
    je = J.Pendulum(batch_size=B, solver="rk4",
                    static_params={"l": jnp.asarray(lengths), "m": jnp.asarray(masses), "g": 9.81},
                    action_normalizations={"torque": J.MinMaxNormalization(min=-20, max=jnp.asarray(tmax))})
    pe = P.Pendulum(batch_size=B, solver="rk4", **F64,
                    static_params={"l": lengths, "m": masses, "g": 9.81},
                    action_normalizations={"torque": MinMaxNormalization(min=-20, max=tmax)})
    assert isinstance(pe.env_properties.static_params.l, torch.Tensor)
    assert pe.env_properties.static_params.g == 9.81
    js, ps = _states(je, pe, 7)
    acts = _actions(8, B, T)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), 2)
    po, pl = pe.vmap_rollout(ps, torch.as_tensor(acts), 2)
    _close(po, jo)
    _close_phys(pe, pl, jl)
    jo, _, _ = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau, je.tau)
    po, _, _ = pe.vmap_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau)
    _close(po, jo)


@pytest.mark.parametrize("name", ENVS)
def test_rewards_and_flags_ahead_match_jax(name):
    control = {"Pendulum": ["theta"], "MassSpringDamper": ["deflection"], "CartPole": ["theta", "deflection"]}[name]
    je, pe = _pair(name, "euler", jax_kwargs={"control_state": control}, torch_kwargs={"control_state": control})
    js, ps = _states(je, pe, 9)
    rng = np.random.default_rng(10)
    with jstructures.copy_and_mutate(js) as js:
        for n in control:
            setattr(js.reference, n, jnp.asarray(rng.uniform(-1, 1, B)))
    for n in control:
        setattr(ps.reference, n, torch.as_tensor(np.array(getattr(js.reference, n))))
    acts = _actions(11, B, T)
    jo, jst, _ = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau, je.tau)
    po, pst, _ = pe.vmap_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau)
    _close(po, jo)
    j_out = je.vmap_generate_rew_trunc_term_ahead(jst, jnp.asarray(acts))
    p_out = pe.vmap_generate_rew_trunc_term_ahead(pst, torch.as_tensor(acts))
    for p, j in zip(p_out, j_out):
        assert tuple(p.shape) == tuple(j.shape)
        np.testing.assert_allclose(p.numpy().astype(np.float64), np.asarray(j).astype(np.float64), **TOL)


@pytest.mark.parametrize("name", ENVS)
def test_observation_round_trip_and_soft_constraints_match_jax(name):
    je, pe = _pair(name)
    js, ps = _states(je, pe, 12)
    jo, po = je.vmap_reset(initial_state=js)[0], pe.vmap_reset(initial_state=ps)[0]
    _close(po, jo)
    back = pe.vmap_generate_state_from_observation(po)
    _close_phys(pe, back, js)
    act = torch.as_tensor(_actions(13, B, 1)[:, 0] * 1.5)
    j_soft = jax.vmap(je.soft_constraints, in_axes=(0, 0, None))(js, jnp.asarray(act.numpy()), je.env_properties)
    p_soft = pe.soft_constraints(ps, act, pe.env_properties)
    for n in pe._ode_state_fields:
        np.testing.assert_allclose(getattr(p_soft[0], n).numpy(), np.asarray(getattr(j_soft[0], n)), **TOL)
    _close(p_soft[1], j_soft[1])


@pytest.mark.parametrize("name", ENVS)
def test_default_and_generator_reset(name):
    je, pe = _pair(name)
    jo, _ = je.vmap_reset()
    po, ps = pe.vmap_reset()
    _close(po, jo)
    assert torch.isnan(ps.reference.__dict__[pe._ode_state_fields[0]]).all()
    po, _ = pe.vmap_reset(rng=torch.Generator().manual_seed(3))
    po2, _ = pe.vmap_reset(rng=torch.Generator().manual_seed(3))
    assert torch.equal(po, po2) and bool((po.abs() <= 1).all()) and po.shape == (B, pe.physical_state_dim)


def test_single_instance_step_and_sim_ahead_match_jax():
    je, pe = _pair("CartPole", "rk4")
    js, ps = _states(je, pe, 14)
    j1 = jax.tree_util.tree_map(lambda leaf: leaf[0], js)
    p1 = structures.map_leaves(lambda leaf: leaf[0] if isinstance(leaf, torch.Tensor) and leaf.ndim else leaf, ps)
    a = _actions(15, 1, T)[0]
    jo, _ = je.step(j1, jnp.asarray(a[0]), je.env_properties)
    po, _ = pe.step(p1, torch.as_tensor(a[0]), pe.env_properties)
    _close(po, jo)
    jo, _, _ = je.sim_ahead(j1, jnp.asarray(a), je.env_properties, je.tau, je.tau)
    po, _, _ = pe.sim_ahead(p1, torch.as_tensor(a), pe.env_properties, pe.tau, pe.tau)
    _close(po, jo)


# ---------------------------------------------------------------------------
# error paths and construction
# ---------------------------------------------------------------------------


def test_shape_assert_messages():
    env = P.Pendulum(batch_size=4, device="cpu")
    _, state = env.vmap_reset()
    with pytest.raises(AssertionError, match=r"The action needs to be of shape \(batch_size, action_dim\)"):
        env.vmap_step(state, torch.zeros((4, 2)))
    with pytest.raises(AssertionError, match=r"The action needs to be of shape \(action_dim,\)"):
        env.step(structures.map_leaves(lambda x: x[0] if isinstance(x, torch.Tensor) and x.ndim else x, state),
                 torch.zeros(3), env.env_properties)
    with pytest.raises(AssertionError, match="three dimensions"):
        env.vmap_sim_ahead(state, torch.zeros((4, 5)), env.tau, env.tau)
    with pytest.raises(AssertionError, match="divisible by obs_stride"):
        env.vmap_rollout(state, torch.zeros((4, 6, 1)), 4)


def test_property_validation_and_unported_options():
    with pytest.raises(ValueError, match="needs to be a tensor"):
        P.Pendulum(batch_size=4, device="cpu", static_params={"l": [1, 2, 3, 4], "m": 1, "g": 9.81})
    with pytest.raises(ValueError, match="shape"):
        P.Pendulum(batch_size=4, device="cpu", static_params={"l": np.ones(3), "m": 1, "g": 9.81})
    with pytest.raises(NotImplementedError, match="noise"):
        P.Pendulum(device="cpu", process_noise={"omega": 0.1})
    fast = P.Pendulum(device="cpu", fast_math=True)
    assert fast.fast_math and rollout_path(fast) == "fused"
    assert P.Pendulum(device="cpu", static_params={"l": np.float64(2.0), "m": 1, "g": 9.81}).env_properties.static_params.l == 2.0


def test_convert_helpers_build_state_and_properties():
    env = P.Pendulum(batch_size=3, **F64)
    lengths = np.array([1.0, 1.5, 2.0])
    props = properties_from_numpy(
        env, {"g": np.float64(9.81), "l": lengths, "m": 1},
        {"theta": (-math.pi, math.pi), "omega": (-10, 10)}, {"torque": (-20, np.array([10.0, 20.0, 30.0]))},
    )
    assert props.static_params.g == 9.81 and torch.equal(props.static_params.l, torch.as_tensor(lengths))
    assert isinstance(props.action_normalizations.torque.max, torch.Tensor)
    state = state_from_numpy(env, {"theta": [0.1, 0.2, 0.3], "omega": [0.0, 1.0, 2.0]}, reference={"theta": [0.0] * 3})
    assert state.physical_state.omega.dtype == torch.float64 and torch.equal(state.reference.theta, torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="missing"):
        state_from_numpy(env, {"theta": [0.0] * 3})


# ---------------------------------------------------------------------------
# golden fixtures (reference diffrax Euler, float64)
# ---------------------------------------------------------------------------

DATA_ROOT = Path(__file__).parent / "envs"
GOLDEN = [
    (P.EnvironmentRegistry.PENDULUM, "pendulum"),
    (P.EnvironmentRegistry.CART_POLE, "cartpole"),
    (P.EnvironmentRegistry.MASS_SPRING_DAMPER, "mass_spring_damper"),
]


@pytest.mark.parametrize("env_type,fixture_dir", GOLDEN, ids=[g[1] for g in GOLDEN])
def test_golden_replay_through_port(env_type, fixture_dir):
    data_dir = DATA_ROOT / fixture_dir / "data"
    params, action_norms, physical_norms, tau = load_sim_properties_from_json(
        os.path.join(data_dir, "sim_properties.json")
    )
    env = env_type.make(tau=tau, solver="euler", static_params=params, physical_normalizations=physical_norms,
                        action_normalizations=action_norms, **F64)
    stored = torch.as_tensor(np.load(data_dir / "observations.npy"))
    actions = torch.as_tensor(np.load(data_dir / "actions.npy"))
    state = env.generate_state_from_observation(stored[0], env.env_properties)
    generated = [stored[0]]
    for i in range(10000):
        obs, state = env.step(state, actions[i], env.env_properties)
        generated.append(obs)
    generated = torch.stack(generated)
    assert torch.allclose(generated, stored, 1e-16), (
        f"{fixture_dir}: replayed observations deviate from the reference fixture"
    )
