"""The port's fast-math layer (``ops/fastmath.py``) and ``fast_math=True`` on
the classic environments against the JAX package.

Same numpy inputs on both sides, on the CPU.  The elementwise functions are
``array_equal`` to JAX in float32 and float64 (observed: 0 ulp over 10^5
points in +-9 rad and the wrap boundaries), except on subnormal inputs,
which XLA's CPU backend flushes to zero and PyTorch does not.
Rollouts in float64: ``vmap_rollout`` at rtol 1e-12 (B = 16, T = 100), the
plain fused rollout against the Pallas stepper in interpret mode at the JAX
test's 1e-12 (tests/test_pallas_stepper.py::test_fused_matches_scan_fast_math),
and the plain closed loop against a loop of JAX ``_plain_cl_step`` at 1e-10
(the closed-loop tests' figure).  The kernels themselves run only on a CUDA
card: tests/test_torch_gpu.py holds them against these plain versions there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops import fastmath as JF
from exciting_environments_tpu.ops.pallas import stepper as jstepper
from exciting_environments_torch.ops import fastmath as PF
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.utils.convert import state_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
FUNCTIONS = ("poly_sin", "sin_wrapped", "poly_cos", "wrap_angle_fast", "fast_sign")


def test_coefficients_are_the_jax_fit():
    assert np.array_equal(np.asarray(PF.SIN_ODD_COEFFS, dtype=np.float32), JF._SIN_ODD_COEFFS)
    assert np.array_equal(np.asarray(PF.SIN_ODD_COEFFS), JF._SIN_ODD_COEFFS.astype(np.float64))
    assert PF.poly_sin_max_error() < 5e-7
    assert PF.poly_sin_max_error() == JF.poly_sin_max_error()


def _inputs(name):
    rng = np.random.default_rng(0)
    if name == "poly_sin":  # its domain
        return np.concatenate([rng.uniform(-math.pi, math.pi, 100_000), [-math.pi, 0.0, math.pi]])
    # +-9 rad, the wrap boundaries (odd multiples of pi) and the cosine's
    # shifted ones, and their neighbours (0's neighbours are subnormal: left out)
    boundaries = np.delete(np.arange(-3, 4) * math.pi, 3)
    return np.concatenate([rng.uniform(-9.0, 9.0, 100_000), boundaries, boundaries + math.pi / 2,
                           np.nextafter(boundaries, 10.0), np.nextafter(boundaries, -10.0),
                           [0.0, -0.0, math.pi / 2, -math.pi / 2, 9.0, -9.0, 1e-20, -1e-20, 1e-31, -1e-31]])


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_functions_match_jax_bitwise(name, dtype):
    x = _inputs(name).astype(dtype)
    ours = getattr(PF, name)(torch.as_tensor(x)).numpy()
    ref = np.asarray(getattr(JF, name)(jnp.asarray(x)))
    assert ours.dtype == ref.dtype == dtype
    np.testing.assert_array_equal(ours, ref)
    if name == "wrap_angle_fast":
        assert ours.min() >= -math.pi - 1e-6 and ours.max() <= math.pi + 1e-6


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_subnormals_and_nan(dtype):
    """fast_sign is sign for 0 and |x| >= 1e-30, and NaN stays NaN.  A
    subnormal input is kept here, where XLA's CPU backend flushes it to zero
    first: fast_sign gives x * 1e30 against JAX's 0, the wrap x against 0."""
    x = torch.tensor([-3.0, -1e-20, 0.0, 1e-20, 8.0, math.nan], dtype=torch.float64)
    out = PF.fast_sign(x)
    assert torch.equal(out[:5], torch.sign(x[:5])) and math.isnan(float(out[5]))
    sub = np.array([np.finfo(dtype).smallest_subnormal], dtype=dtype)
    assert float(PF.fast_sign(torch.as_tensor(sub))[0]) == float(sub[0] * dtype(1e30)) > 0.0
    assert float(PF.wrap_angle_fast(torch.as_tensor(sub))[0]) == float(sub[0])
    assert float(np.asarray(JF.fast_sign(jnp.asarray(sub)))[0]) == 0.0
    assert float(np.asarray(JF.wrap_angle_fast(jnp.asarray(sub)))[0]) == 0.0


def test_fast_math_constructs_and_routes_to_the_kernel():
    for cls in (P.Pendulum, P.CartPole):
        env = cls(batch_size=4, fast_math=True, **F64)
        assert env.fast_math and env._sin is PF.sin_wrapped and env._cos is PF.poly_cos
        assert rollout_path(env) == "fused" and CL.supports_fused_closed_loop(env)
    assert not P.Pendulum(batch_size=4, **F64).fast_math


def _pair(name, batch, solver="euler", **kwargs):
    return (getattr(J, name)(batch_size=batch, solver=solver, fast_math=True, **kwargs),
            getattr(P, name)(batch_size=batch, solver=solver, fast_math=True, **F64, **kwargs))


def _states(je, pe, seed, lim=2.0, refs=()):
    rng = np.random.default_rng(seed)
    x0 = {n: rng.uniform(-lim, lim, pe.batch_size) for n in pe._ode_state_fields}
    ref = {n: rng.uniform(-1.5, 1.5, pe.batch_size) for n in refs}
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
        for n, v in ref.items():
            setattr(js.reference, n, jnp.asarray(v))
    return js, state_from_numpy(pe, x0, reference=ref or None)


def _close(port, ref, tol):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", ["Pendulum", "CartPole"])
def test_vmap_rollout_with_fast_math_matches_jax(name):
    B, T = 16, 100
    je, pe = _pair(name, B)
    js, ps = _states(je, pe, 1)
    acts = np.random.default_rng(2).uniform(-0.8, 0.8, (B, T, 1))
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), T)
    po, pl = pe.vmap_rollout(ps, torch.as_tensor(acts), T)
    _close(po, jo, 1e-12)
    for n in pe._ode_state_fields:
        _close(getattr(pl.physical_state, n), getattr(jl.physical_state, n), 1e-12)


def test_fused_rollout_with_fast_math_matches_pallas_interpret():
    B, T = 256, 16
    je, pe = _pair("CartPole", B)
    js, ps = _states(je, pe, 3)
    acts = np.random.default_rng(4).uniform(-0.9, 0.9, (B, T, 1))
    jo, jl = jstepper.env_fused_rollout(je, js, jnp.asarray(acts), obs_stride=4, interpret=True)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), obs_stride=4, strict=True)
    _close(po, jo, 1e-12)
    for n in pe._ode_state_fields:
        _close(getattr(pl.physical_state, n), getattr(jl.physical_state, n), 1e-12)
    # sim-ahead mode wraps the saved trajectory on the host, with the fast wrap
    je4, pe4 = _pair("Pendulum", B, "rk4")
    js4, ps4 = _states(je4, pe4, 5, lim=3.0)
    jo, _ = jstepper.env_fused_sim_ahead(je4, js4, jnp.asarray(acts), je4.tau, je4.tau, interpret=True)
    po, _ = pe4.fused_sim_ahead(ps4, torch.as_tensor(acts), pe4.tau, pe4.tau, strict=True)
    _close(po, jo, 1e-12)


def test_closed_loop_with_fast_math_matches_jax_plain_cl_step():
    """The PD law through the plain closed loop with fast_wrap and the fast
    functors, against a loop of the JAX kernel's per-step computation."""
    B, T = 256, 12
    je, pe = _pair("Pendulum", B, "rk4", control_state=["theta"])
    js, _ = _states(je, pe, 6, lim=3.0, refs=("theta",))
    pd = lambda obs, t: (-0.9 * (obs[0] - obs[2]) - 0.25 * obs[1],)
    y0 = tuple(np.array(getattr(js.physical_state, n)) for n in pe._ode_state_fields)
    ref = np.array(je.env_properties.physical_normalizations.theta.normalize(js.reference.theta))
    tile_ode, leaves = jstepper._batched_param_closure(je)
    norms = lambda d, names: tuple((float(getattr(d, n).min), float(getattr(d, n).max)) for n in names)
    step = jstepper._plain_cl_step(
        tile_ode, je._solver, pd, je.tau, (True, False), None,
        norms(je.env_properties.physical_normalizations, ("theta", "omega")),
        norms(je.env_properties.action_normalizations, ("torque",)), True, False, leaves,
    )
    y, ys = tuple(jnp.asarray(v) for v in y0), []
    for t in range(T):
        y, _, _ = step(y, (), t, (jnp.asarray(ref),), None)
        ys.append(y)
    final, traj_state, _ = CL.fused_closed_loop(pe, tuple(torch.as_tensor(v) for v in y0), P.AffinePolicy(
        [[-0.9, -0.25, 0.9]]), T, ref_leaves=(torch.as_tensor(ref),), traj_stride=1)
    for i in range(2):
        _close(final[i], y[i], 1e-10)
        _close(traj_state[i], np.stack([s[i] for s in ys], axis=1), 1e-10)


@pytest.mark.parametrize("name", ["Pendulum", "CartPole"])
def test_fast_math_tracks_the_exact_path(name):
    """tests/test_pallas_stepper.py::test_env_fast_math_flag's envelope: fast
    vs exact within 1e-2 (angles modulo 2 pi) over 100 steps."""
    B, T = 64, 100
    exact = getattr(P, name)(batch_size=B, **F64)
    fast = getattr(P, name)(batch_size=B, fast_math=True, **F64)
    _, state = exact.vmap_reset(rng=torch.Generator().manual_seed(0))
    acts = torch.as_tensor(np.random.default_rng(1).uniform(-0.8, 0.8, (B, T, 1)))
    _, last_e = exact.vmap_rollout(state, acts, T)
    _, last_f = fast.fused_rollout(state, acts, strict=True)
    for n in exact._ode_state_fields:
        d = getattr(last_f.physical_state, n) - getattr(last_e.physical_state, n)
        if n in exact._angle_fields:
            d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
        assert float(d.abs().max()) < 1e-2, n
