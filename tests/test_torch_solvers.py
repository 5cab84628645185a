"""Parity of the PyTorch port's solvers and trajectory loop with the JAX package.

Inputs are made with numpy from a seed and fed to both sides in float64
(the conftest enables JAX x64).  Tolerance rtol = atol = 1e-12: the XLA CPU
backend contracts multiply-add chains into FMAs, PyTorch eager does not.
The embedded pairs' ``step_with_error`` (solution, error estimate, last
stage) agree at 1e-14.
"""

import jax
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
    assert isinstance(psolvers.make_solver("implicit_euler"), psolvers.ImplicitEuler)
    with pytest.raises(ValueError, match="unknown solver"):
        psolvers.make_solver("leapfrog")


def _decay(lib):
    return lambda t, y, args: (-args[0] * y[0],)


@pytest.mark.parametrize("name", ["tsit5", "dopri5"])
@pytest.mark.parametrize("with_k0", [False, True], ids=["fresh", "k0"])
def test_step_with_error_matches_jax(name, with_k0):
    th, om = _y0(2)
    js, ps = jsolvers.make_solver(name), psolvers.make_solver(name)
    y_j = (jnp.asarray(th), jnp.asarray(om))
    y_p = (torch.as_tensor(th), torch.as_tensor(om))
    k_j = _field("jax")(0.0, y_j, 2.5) if with_k0 else None
    k_p = _field("torch")(0.0, y_p, 2.5) if with_k0 else None
    want = js.step_with_error(_field("jax"), 0.0, 0.05, y_j, 2.5, k0=k_j)
    got = ps.step_with_error(_field("torch"), 0.0, 0.05, y_p, 2.5, k0=k_p)
    for part_j, part_p in zip(want, got):
        for a, b in zip(part_j, part_p):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14, atol=1e-14)
    # the error estimate is the difference to the embedded 4th-order solution
    assert float(max(e.abs().max() for e in got[1])) > 0.0


@pytest.mark.parametrize("name", ["euler", "midpoint", "heun", "rk4"])
def test_step_with_error_needs_an_embedded_pair(name):
    y = (torch.ones(3, dtype=torch.float64),)
    with pytest.raises(ValueError, match="embedded"):
        psolvers.make_solver(name).step_with_error(_decay("torch"), 0.0, 0.1, y, (1.0,))


def test_implicit_euler_stiff_stability():
    """Backward Euler stays stable on a stiff decay where explicit Euler blows up."""
    y0 = (torch.ones((), dtype=torch.float64),)
    h = 1e-3  # explicit Euler unstable: |1 - lam h| = 9 > 1
    _, y_last = prollout.solve_trajectory(psolvers.ImplicitEuler(), _decay("torch"), y0, (1e4,), 50, h)
    assert abs(float(y_last[0])) < 1.0
    _, y_exp = prollout.solve_trajectory(psolvers.Euler(), _decay("torch"), y0, (1e4,), 50, h)
    assert abs(float(y_exp[0])) > 1.0
    _, y_jax = jrollout.solve_trajectory(jsolvers.ImplicitEuler(), _decay("jax"), (1.0,), (1e4,), 50, h)
    np.testing.assert_allclose(float(y_last[0]), float(y_jax[0]), **TOL)


def test_implicit_euler_registry_takes_diffrax_spelling():
    class ImplicitEuler:  # diffrax spells it without the underscore
        pass

    assert isinstance(psolvers.make_solver(ImplicitEuler()), psolvers.ImplicitEuler)
    assert psolvers.make_solver("implicit_euler").newton_iters == 4
    assert isinstance(psolvers.make_solver(jsolvers.ImplicitEuler()), psolvers.ImplicitEuler)


def test_implicit_euler_inside_environment_matches_jax():
    """The batched Newton step (one (2, 2) Jacobian per instance) inside a
    MassSpringDamper step, against the JAX package's vmapped one."""
    import exciting_environments_torch as P
    import exciting_environments_tpu as J

    je = J.MassSpringDamper(batch_size=4, solver="implicit_euler", tau=1e-2)
    pe = P.MassSpringDamper(batch_size=4, solver="implicit_euler", tau=1e-2, device="cpu", dtype=torch.float64)
    jk = jax.random.split(jax.random.PRNGKey(0), 4)
    _, js = je.vmap_reset(jk)
    _, ps = pe.vmap_reset(torch.as_tensor(np.asarray(jk).astype(np.int64)))
    for _ in range(20):
        jo, js = je.vmap_step(js, 0.3 * jnp.ones((4, 1)))
        po, ps = pe.vmap_step(ps, torch.full((4, 1), 0.3, dtype=torch.float64))
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), **TOL)
    for name in ("deflection", "velocity"):
        np.testing.assert_allclose(getattr(ps.physical_state, name).numpy(),
                                   np.asarray(getattr(js.physical_state, name)), **TOL)
    assert float(ps.physical_state.deflection.abs().max()) < 10.0
