"""Parity of the PyTorch port's solvers and trajectory loop with the JAX package.

Inputs are made with numpy from a seed and fed to both sides in float64
(the conftest enables JAX x64).  Tolerance rtol = atol = 1e-12: the XLA CPU
backend contracts multiply-add chains into FMAs, PyTorch eager does not.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exciting_environments_tpu.ops import rollout as jrollout
from exciting_environments_tpu.ops import solvers as jsolvers
from exciting_environments_torch.ops import rollout as prollout
from exciting_environments_torch.ops import solvers as psolvers

TOL = dict(rtol=1e-12, atol=1e-12)
EXPLICIT = ["euler", "midpoint", "heun", "rk4", "tsit5", "dopri5"]


def _field(lib):
    sin = jnp.sin if lib == "jax" else torch.sin

    def f(t, y, args):
        theta, omega = y
        return omega, -args * sin(theta) + 0.1 * omega * omega

    return f


def _y0(seed, n=16):
    rng = np.random.default_rng(seed)
    return rng.uniform(-2, 2, n), rng.uniform(-1, 1, n)


@pytest.mark.parametrize("name", EXPLICIT)
def test_explicit_step_matches_jax(name):
    th, om = _y0(1)
    js, ps = jsolvers.make_solver(name), psolvers.make_solver(name)
    assert type(ps).__name__ == type(js).__name__ and ps.fsal == js.fsal
    y_j = (jnp.asarray(th), jnp.asarray(om))
    y_p = (torch.as_tensor(th), torch.as_tensor(om))
    carry_j = js.init(_field("jax"), 0.0, 0.05, y_j, 2.5)
    carry_p = ps.init(_field("torch"), 0.0, 0.05, y_p, 2.5)
    for _ in range(5):
        y_j, carry_j = js.step(_field("jax"), 0.0, 0.05, y_j, 2.5, carry_j)
        y_p, carry_p = ps.step(_field("torch"), 0.0, 0.05, y_p, 2.5, carry_p)
    for a, b in zip(y_j, y_p):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    if js.fsal:
        for a, b in zip(carry_j, carry_p):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    else:
        assert carry_p is None


def test_weighted_increment_is_exact_euler():
    """Skip zeros, no multiply for unit coefficients: Euler is exactly y + h*f."""
    y = (torch.tensor([0.3, -1.7], dtype=torch.float64),)
    k = (torch.tensor([0.123456789, 9.87654321], dtype=torch.float64),)
    out = psolvers._weighted_increment(y, 1e-4, [k, k], [1.0, 0.0])
    assert torch.equal(out[0], y[0] + 1e-4 * k[0])
    assert psolvers._weighted_increment(y, 1e-4, [k], [0.0]) is y


@pytest.mark.parametrize("name", ["euler", "rk4", "tsit5"])
@pytest.mark.parametrize("ratio", [1, 2])
def test_solve_trajectory_matches_jax(name, ratio):
    rng = np.random.default_rng(7)
    acts = rng.uniform(-1, 1, (12, 1))
    th, om = _y0(3)
    h_obs = 0.02 / ratio

    def make_f(lib, action):
        sin = jnp.sin if lib == "jax" else torch.sin
        return lambda t, y, args: (y[1], -args * sin(y[0]) + action(t)[0])

    ys_j, last_j = jrollout.solve_trajectory(
        jsolvers.make_solver(name), make_f("jax", jrollout.zoh_action(jnp.asarray(acts), 0.02)),
        (jnp.asarray(th), jnp.asarray(om)), 9.81, 12 * ratio, h_obs)
    ys_p, last_p = prollout.solve_trajectory(
        psolvers.make_solver(name), make_f("torch", prollout.zoh_action(torch.as_tensor(acts), 0.02)),
        (torch.as_tensor(th), torch.as_tensor(om)), 9.81, 12 * ratio, h_obs)
    for a, b in zip(ys_j, ys_p):
        assert tuple(b.shape) == tuple(a.shape) == (12 * ratio + 1, 16)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    for a, b in zip(last_j, last_p):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_zoh_action_index_matches_jax(dtype):
    """The guarded floor and the clamped end pick the same rows as JAX."""
    acts = np.arange(40, dtype=np.float64).reshape(40, 1)
    step = 3e-3
    ts = (np.arange(200, dtype=np.float64) * (step / 5)).astype(dtype)
    ts = np.concatenate([ts, np.asarray([40 * step, 41 * step], dtype=dtype)])
    pa = prollout.zoh_action(torch.as_tensor(acts), step)
    ja = jrollout.zoh_action(jnp.asarray(acts), step)
    got = [float(pa(t)[0]) for t in ts]
    want = [float(ja(jnp.asarray(t))[0]) for t in ts]
    assert got == want


def test_step_loop_matches_jax():
    th, om = _y0(5)
    ys_j, _ = jrollout.step_loop(jsolvers.RK4(), _field("jax"), (jnp.asarray(th), jnp.asarray(om)), 1.5, 6, 0.01)
    ys_p, _ = prollout.step_loop(psolvers.RK4(), _field("torch"), (torch.as_tensor(th), torch.as_tensor(om)), 1.5, 6, 0.01)
    for a, b in zip(ys_j, ys_p):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_make_solver_names_and_limits():
    assert isinstance(psolvers.make_solver("Tsit5"), psolvers.Tsit5)
    assert isinstance(psolvers.make_solver(jsolvers.Dopri5()), psolvers.Dopri5)
    solver = psolvers.RK4()
    assert psolvers.make_solver(solver) is solver
    assert psolvers.Euler().one_stage and not psolvers.Heun().one_stage
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        psolvers.make_solver("implicit_euler")
    with pytest.raises(ValueError, match="unknown solver"):
        psolvers.make_solver("leapfrog")
