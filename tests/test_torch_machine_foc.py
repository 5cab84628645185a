"""The port's field-oriented control of the induction machine and the EESM's
current tile (``exciting_environments_torch/utils/foc.py``) and the
stationary Kalman gain they need (``utils/estimate.py``) against the JAX
package, on the CPU.

Inputs are made from seeded numpy generators and handed to both sides.
Tolerances are those of the JAX package's own tests, float64 throughout:
the gain's matrices at rtol 1e-10, atol 1e-12 (``tests/test_estimate.py``:
the Jacobians differ by a few ulps between ``jax.jacobian`` and
``torch.func.jacrev``), the belief controller's actions and carries at rtol
1e-10, atol 1e-12, and the closed loops against the Pallas kernel in
interpret mode at B = 1,024 x T = 16 at rtol 1e-10, atol 1e-12 (atol 1e-11
on the noisy plant, as ``tests/test_foc.py:233`` holds its own kernel).
Gradients through ``ClosedLoopVJP`` are held against autograd through the
plain loop at 1e-12 of the largest gradient (``tests/test_torch_vjp.py``'s
figure), and against ``jax.grad`` of the JAX package's ``tile_policy_scan``
at rtol 1e-10, atol 1e-12.  The functors' flat layouts are
checked against the enums of ``csrc/foc_laws.cuh``.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas.stepper import env_fused_closed_loop as j_env_fused_closed_loop
from exciting_environments_tpu.utils import MinMaxNormalization as JNorm
from exciting_environments_tpu.utils import estimate as jestimate
from exciting_environments_tpu.utils import foc as jfoc
from exciting_environments_tpu.utils.collect import RolloutCollector as JCollector
from exciting_environments_tpu.utils.collect import tile_policy_scan as j_tile_policy_scan
from exciting_environments_torch.ops.kernels import closed_loop as CL
from exciting_environments_torch.utils import MinMaxNormalization as PNorm
from exciting_environments_torch.utils import estimate
from exciting_environments_torch.utils import foc
from exciting_environments_torch.utils.convert import state_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-10, atol=1e-12)
PSI_REF, TORQUE_REF = 0.7, 8.0
EESM_REFS = dict(i_d_ref=2.0, i_q_ref=5.0, i_f_ref=4.0)
BK, TK = 1024, 16
CSRC = Path(__file__).resolve().parents[1] / "exciting_environments_torch" / "csrc"


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else port),
                               np.asarray(ref), **(tol or TOL))


def _pair(name, batch, **kwargs):
    return (getattr(J, name)(batch_size=batch, **kwargs), getattr(P, name)(batch_size=batch, **F64, **kwargs))


def _states(je, pe, x0, seed=3, reference=None):
    """The same physical state (and references) on both sides, with the JAX
    reset's keys."""
    _, js = je.vmap_reset(jax.random.split(jax.random.PRNGKey(seed), je.batch_size))
    with jstructures.copy_and_mutate(js, validate=False) as js:
        for n, v in x0.items():
            setattr(js.physical_state, n, jnp.asarray(v))
        for n, v in (reference or {}).items():
            setattr(js.reference, n, jnp.asarray(v))
    return js, state_from_numpy(pe, x0, reference=reference, keys=np.asarray(js.PRNGKey))


def _cold(pe):
    return {n: np.zeros(pe.batch_size) for n in pe._ode_state_fields}


def _random_x0(pe, seed, lim=2.0):
    rng = np.random.default_rng(seed)
    return {n: rng.uniform(-lim, lim, pe.batch_size) for n in pe._ode_state_fields}


# ---------------------------------------------------------------------------
# the stationary Kalman gain (tests/test_estimate.py:269, :353)
# ---------------------------------------------------------------------------

GAIN_NOISE = dict(process_noise={"i_sd": 0.1, "i_sq": 0.1}, observation_noise={"i_sd": 0.3, "i_sq": 0.3})


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_stationary_kalman_gain_matches_jax_float64(solver):
    """A, B, c, K and P of the induction machine (the port's linearization
    through torch.func.jacrev in float64 from a float32 CUDA-less twin),
    rtol 1e-10, atol 1e-12; the port's own step equals A x + B u + c at a
    seeded point within 1e-12."""
    je = J.InductionMachine(batch_size=4, solver=solver, **GAIN_NOISE)
    pe = P.InductionMachine(batch_size=4, solver=solver, device="cpu", dtype=torch.float32, **GAIN_NOISE)
    jk = jestimate.stationary_kalman_gain(je, measured_fields=("i_sd", "i_sq"))
    pk = estimate.stationary_kalman_gain(pe, measured_fields=("i_sd", "i_sq"))
    assert pk.names == jk.names == ("i_sd", "i_sq", "psi_rd", "psi_rq")
    np.testing.assert_array_equal(pk.midx, jk.midx)
    np.testing.assert_array_equal(pk.zidx, jk.zidx)
    for name in ("A", "B", "c", "K", "P"):
        _close(getattr(pk, name), getattr(jk, name), rtol=1e-10, atol=1e-12)
        assert getattr(pk, name).dtype == np.float64
    rng = np.random.default_rng(0)
    x, u = rng.uniform(-0.5, 0.5, 4), rng.uniform(-0.8, 0.8, 2)
    f = estimate._make_dynamics(estimate._float64_twin(pe), pe.env_properties)
    _close(f(torch.as_tensor(x), torch.as_tensor(u)), pk.A @ x + pk.B @ u + pk.c, rtol=0, atol=1e-12)
    assert np.abs(pk.K[2:, :]).max() > 0  # the currents correct the unmeasured flux


def test_stationary_kalman_gain_defaults_to_the_environments_noise_float64():
    """No measured_fields: every measurable column, sensor levels from the
    environment's observation_noise (unmeasured fields floored), as in JAX."""
    je, pe = _pair("InductionMachine", 4, **GAIN_NOISE)
    jk, pk = jestimate.stationary_kalman_gain(je), estimate.stationary_kalman_gain(pe)
    np.testing.assert_array_equal(pk.midx, np.arange(4))
    for name in ("K", "P"):
        _close(getattr(pk, name), getattr(jk, name), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("make", [lambda m: m.VanDerPol(batch_size=4, device="cpu"),
                                  lambda m: m.Pendulum(batch_size=4, device="cpu", observation_noise={"theta": 0.05})],
                         ids=["van_der_pol", "pendulum_angle"])
def test_stationary_kalman_gain_refuses_nonlinear_envs(make):
    with pytest.raises(ValueError, match="linear"):
        estimate.stationary_kalman_gain(make(P))


def test_stationary_kalman_gain_refuses_per_batch_properties():
    sp = P.InductionMachine._default_static_params()
    sp["r_r"] = np.linspace(2.0, 2.6, 4)
    env = P.InductionMachine(batch_size=4, static_params=sp, **F64, **GAIN_NOISE)
    with pytest.raises(ValueError, match="scalar env properties"):
        estimate.stationary_kalman_gain(env)


# ---------------------------------------------------------------------------
# the belief-space controller (tests/test_foc.py:100, :312, :329, :362)
# ---------------------------------------------------------------------------


def _belief(pe, seed, lim):
    """Random belief states across the bands, a quarter with flux below the
    floor (the fallback frame)."""
    rng = np.random.default_rng(seed)
    b = pe.batch_size
    x0 = {n: rng.uniform(-lim, lim, b) for n in ("i_sd", "i_sq")}
    x0.update({n: rng.uniform(-1.2, 1.2, b) for n in ("psi_rd", "psi_rq")})
    weak = np.arange(b) % 4 == 0
    for n in ("psi_rd", "psi_rq"):
        x0[n] = np.where(weak, 0.02 * x0[n], x0[n])
    return x0


def _carry(pe, seed, flag_dtype=torch.bool):
    rng = np.random.default_rng(seed)
    b = pe.batch_size
    ints = [rng.normal(0.0, s, b) for s in (20.0, 20.0, 0.5)]
    free = rng.uniform(size=b) < 0.5
    pc = tuple(torch.as_tensor(v) for v in ints) + (torch.as_tensor(free).to(flag_dtype),)
    jc = tuple(jnp.asarray(v) for v in ints) + (jnp.asarray(free),)
    return jc, pc


def _per_batch_bands(lib, norm):
    u_max = np.array([250.0, 325.0, 400.0, 325.0, 300.0, 325.0, 350.0, 325.0])
    i_band = np.array([10.0, 20.0, 20.0, 5.0, 15.0, 20.0, 8.0, 20.0])
    arr = jnp.asarray if lib is J else (lambda v: torch.as_tensor(v))
    return dict(
        action_normalizations={"u_sd": norm(min=arr(-u_max), max=arr(u_max)),
                               "u_sq": norm(min=arr(-u_max), max=arr(u_max))},
        physical_normalizations={"i_sd": norm(min=arr(-i_band), max=arr(i_band)),
                                 "i_sq": norm(min=arr(-i_band), max=arr(i_band)),
                                 "psi_rd": norm(min=-1.5, max=1.5), "psi_rq": norm(min=-1.5, max=1.5)},
    )


BELIEF_CASES = {
    "default": ({}, dict(psi_ref=PSI_REF, torque_ref=TORQUE_REF)),
    "vector_limit": ({}, dict(psi_ref=PSI_REF, torque_ref=500.0, i_max=6.0)),
    "per_batch_bands": ("bands", dict(psi_ref=PSI_REF, torque_ref=500.0)),
    "field_weakening": ("fast", dict(psi_ref=PSI_REF, torque_ref=1.5, field_weakening=True, u_margin=0.8)),
    "per_batch_omega_weakening": ("omega", dict(psi_ref=PSI_REF, torque_ref=1.5, field_weakening=True)),
}


def _belief_pair(kind, b=8):
    if kind == "bands":
        return (J.InductionMachine(batch_size=b, **_per_batch_bands(J, JNorm)),
                P.InductionMachine(batch_size=b, **F64, **_per_batch_bands(P, PNorm)))
    sp = J.InductionMachine._default_static_params()
    if kind == "fast":
        sp["omega"] = 2 * np.pi * 100
    elif kind == "omega":
        sp["omega"] = np.linspace(200.0, 700.0, b)
    return (J.InductionMachine(batch_size=b, static_params={k: jnp.asarray(v) if np.ndim(v) else v
                                                           for k, v in sp.items()}),
            P.InductionMachine(batch_size=b, static_params=sp, **F64))


@pytest.mark.parametrize("case", list(BELIEF_CASES))
def test_belief_controller_matches_jax_float64(case):
    """make_sensorless_foc's controller on random belief states and carries
    (the steps 0 and 37, a quarter of the fleet below the flux floor):
    actions and all four carry leaves at rtol 1e-10, atol 1e-12; the voltage
    vector stays inside each instance's own band."""
    kind, kwargs = BELIEF_CASES[case]
    je, pe = _belief_pair(kind)
    jctl, jc0 = jfoc.make_sensorless_foc(je, **kwargs)
    pctl, pc0 = foc.make_sensorless_foc(pe, **kwargs)
    assert pc0[3].dtype == torch.bool and len(pc0) == len(jc0) == 4
    lim = 20.0
    js, ps = _states(je, pe, _belief(pe, 11, lim))
    for k, seed in ((0, 12), (37, 13)):
        jc, pc = _carry(pe, seed)
        ja, jn = jctl(js, jc, k)
        pa, pn = pctl(ps, pc, k)
        _close(pa, ja)
        for p_leaf, j_leaf in zip(pn, jn):
            _close(p_leaf.to(torch.float64), np.asarray(j_leaf, dtype=np.float64))
        assert bool(torch.isfinite(pa).all()) and bool((pa.abs() <= 1.0 + 1e-9).all())
        if case == "vector_limit":
            assert bool((torch.hypot(pa[:, 0], pa[:, 1]) * 325.0 <= 325.0 + 1e-6).all())


def test_belief_controller_refuses_an_asymmetric_action_band():
    for lib, norm, kw in ((J, JNorm, {}), (P, PNorm, F64)):
        model = lib.InductionMachine(batch_size=2, action_normalizations={
            "u_sd": norm(min=-300.0, max=350.0), "u_sq": norm(min=-325.0, max=325.0)}, **kw)
        maker = jfoc.make_sensorless_foc if lib is J else foc.make_sensorless_foc
        with pytest.raises(ValueError, match="symmetric"):
            maker(model, psi_ref=0.5, torque_ref=1.0)


def test_flux_integrator_antiwindup_over_2200_steps_float64():
    """An infeasible flux setpoint under i_max (tests/test_foc.py:362): over
    1,000 further steps int_psi moves by less than 0.2 and stays below 2.0,
    and the port's carry after 2,200 steps equals the JAX loop's at rtol
    1e-10, atol 1e-12."""
    je, pe = _pair("InductionMachine", 2)
    kwargs = dict(psi_ref=0.7, torque_ref=0.0, i_max=2.0)
    jctl, jc = jfoc.make_sensorless_foc(je, **kwargs)
    pctl, pc = foc.make_sensorless_foc(pe, **kwargs)
    x0 = {"i_sd": np.full(2, 1.9), "i_sq": np.zeros(2), "psi_rd": np.full(2, 0.4), "psi_rq": np.zeros(2)}
    js, ps = _states(je, pe, x0)

    @jax.jit
    def run(carry, k0, n):
        return jax.lax.fori_loop(0, n, lambda k, c: jctl(js, c, k0 + k)[1], carry)

    def run_port(carry, k0, n):
        for k in range(n):
            carry = pctl(ps, carry, k0 + k)[1]
        return carry

    p1200 = run_port(pc, 0, 1200)
    p2200 = run_port(p1200, 1200, 1000)
    assert float((p2200[2] - p1200[2]).abs().max()) < 0.2
    assert float(p2200[2].abs().max()) < 2.0
    j2200 = run(run(jc, 0, 1200), 1200, 1000)
    for p_leaf, j_leaf in zip(p2200, j2200):
        _close(p_leaf.to(torch.float64), np.asarray(j_leaf, dtype=np.float64))


# ---------------------------------------------------------------------------
# the tiles in the closed loop against the Pallas kernel in interpret mode
# (tests/test_foc.py:176, :233, tests/test_eesm.py:211)
# ---------------------------------------------------------------------------

TILE_CASES = {
    "foc": ("InductionMachine", {}, "cold"),
    "foc_rk4_u_dc": ("InductionMachine", dict(solver="rk4", u_dc=400.0), "random"),
    "sensorless_noisy": ("InductionMachine", dict(observation_noise={"i_sd": 0.3, "i_sq": 0.3}), "cold"),
    "eesm": ("EESM", {}, "random"),
    "eesm_u_dc": ("EESM", dict(u_dc=400.0), "random"),
}


def _tiles(case, je, pe):
    if case.startswith("foc"):
        return (jfoc.make_foc_tile(je, psi_ref=PSI_REF, torque_ref=TORQUE_REF),
                foc.make_foc_tile(pe, psi_ref=PSI_REF, torque_ref=TORQUE_REF))
    if case.startswith("sensorless"):
        return (jfoc.make_sensorless_foc_tile(je, psi_ref=PSI_REF, torque_ref=TORQUE_REF),
                foc.make_sensorless_foc_tile(pe, psi_ref=PSI_REF, torque_ref=TORQUE_REF))
    return jfoc.make_eesm_current_tile(je, **EESM_REFS), foc.make_eesm_current_tile(pe, **EESM_REFS)


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_tile_closed_loop_matches_the_pallas_kernel_in_interpret_mode_float64(case):
    """env.fused_closed_loop of each tile on the CPU (its plain version)
    against the JAX kernel in interpret mode, B = 1,024 x T = 16, cold start
    or a seeded random state: observations, actions, every carry plane and
    the final state at rtol 1e-10, atol 1e-12 (1e-11 on the noisy plant,
    whose sensor draws come from the same threefry keys)."""
    name, kwargs, start = TILE_CASES[case]
    je, pe = _pair(name, BK, **kwargs)
    (jt, jc0), (pt, pc0) = _tiles(case, je, pe)
    x0 = _cold(pe) if start == "cold" else _random_x0(pe, 21, lim=8.0 if name == "EESM" else 1.2)
    js, ps = _states(je, pe, x0)
    tol = dict(rtol=1e-10, atol=1e-11 if pe._has_noise else 1e-12)
    obs_j, acts_j, last_j, fc_j = j_env_fused_closed_loop(je, js, jt, TK, obs_stride=1, interpret=True,
                                                          policy_carry=jc0)
    obs_p, acts_p, last_p, fc_p = pe.fused_closed_loop(ps, pt, TK, obs_stride=1, policy_carry=pc0)
    assert len(fc_p) == len(fc_j) == pt.n_carry
    _close(obs_p, obs_j, **tol)
    _close(acts_p, acts_j, **tol)
    for p_leaf, j_leaf in zip(fc_p, fc_j):
        _close(p_leaf, j_leaf, **tol)
    for n in pe._ode_state_fields:
        _close(getattr(last_p.physical_state, n), getattr(last_j.physical_state, n), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sensorless_tile_never_reads_the_flux_columns(dtype):
    """NaN in the flux observation columns never reaches the action or the
    law's planes (tests/test_foc.py:252): the tile reads the measured
    current columns only, and the observer skips its exact-zero terms."""
    pe = P.InductionMachine(batch_size=64, device="cpu", dtype=dtype, observation_noise={"i_sd": 0.3, "i_sq": 0.3})
    tile, carry0 = foc.make_sensorless_foc_tile(pe, psi_ref=PSI_REF, torque_ref=TORQUE_REF)
    cols = tuple(torch.full((64,), float("nan"), dtype=dtype) if i in (2, 3) else torch.zeros(64, dtype=dtype)
                 for i in range(4))
    carry = carry0
    for k in range(3):
        acts, carry = tile(cols, k, carry)
        assert all(bool(torch.isfinite(a).all()) for a in acts)
        assert all(bool(torch.isfinite(c).all()) for c in carry)


def test_collect_policy_fused_with_the_eesm_tile_matches_jax_float64():
    """RolloutCollector.collect_policy_fused with the EESM's tile on the CPU
    against the JAX collector (its scan), B = 64, T = 16: observations,
    actions, rewards, flags and the final carry at rtol 1e-10, atol 1e-12."""
    je, pe = _pair("EESM", 64, control_state=["i_d"])
    (jt, jc0), (pt, pc0) = _tiles("eesm", je, pe)
    ref = {"i_d": np.random.default_rng(24).uniform(-5.0, 5.0, 64)}
    js, ps = _states(je, pe, _random_x0(pe, 23), reference=ref)
    jb, _, jfc = JCollector(je).collect_policy_fused(jt, js, TK, policy_carry=jc0)
    pb, _, pfc = P.RolloutCollector(pe).collect_policy_fused(pt, ps, TK, policy_carry=pc0)
    for name in ("observations", "actions", "rewards"):
        _close(getattr(pb, name), getattr(jb, name))
    for name in ("terminated", "truncated"):
        np.testing.assert_array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)))
    for p_leaf, j_leaf in zip(pfc, jfc):
        _close(p_leaf, j_leaf)


def test_foc_tile_settles_on_flux_and_torque_float64():
    """Control quality on the true state (tests/test_foc.py:218): from a cold
    start the fleet's flux is within 5% of 0.7 Vs and its torque within 5%
    of 8 Nm after 4,000 steps."""
    pe = P.InductionMachine(batch_size=8, **F64)
    tile, carry0 = foc.make_foc_tile(pe, psi_ref=PSI_REF, torque_ref=TORQUE_REF)
    state = state_from_numpy(pe, _cold(pe))
    _, last, _ = pe.fused_closed_loop(state, tile, 4000, policy_carry=carry0)
    phys = last.physical_state
    np.testing.assert_allclose(torch.hypot(phys.psi_rd, phys.psi_rq).numpy(), PSI_REF, rtol=0.05)
    np.testing.assert_allclose(pe.torque(last).numpy(), TORQUE_REF, rtol=0.05)


def test_eesm_tile_settles_on_its_setpoints_float64():
    """tests/test_eesm.py:247: all three currents within 2% after 6,000
    steps, every action within +-1, minimum torque above 1 Nm."""
    pe = P.EESM(batch_size=8, **F64)
    tile, carry0 = foc.make_eesm_current_tile(pe, **EESM_REFS)
    state = state_from_numpy(pe, _random_x0(pe, 25))
    _, acts, last, _ = pe.fused_closed_loop(state, tile, 6000, obs_stride=1, policy_carry=carry0)
    phys = last.physical_state
    for name in ("i_d", "i_q", "i_f"):
        np.testing.assert_allclose(getattr(phys, name).numpy(), EESM_REFS[f"{name}_ref"], rtol=2e-2)
    assert bool(torch.isfinite(acts).all()) and bool((acts.abs() <= 1.0 + 1e-9).all())
    assert float(pe.torque(last).min()) > 1.0


# ---------------------------------------------------------------------------
# gradients through ClosedLoopVJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["foc", "sensorless_noisy", "eesm"])
def test_gradient_of_the_initial_state_through_the_vjp_float64(case):
    """env.fused_closed_loop with an initial state that requires grad goes
    through ClosedLoopVJP (checkpointed forward, segment replay); the
    gradient of a seeded linear loss on the final state and carry, with
    respect to the initial state and the integrator planes, equals autograd
    through the plain loop on the same sensor slab within 1e-12 of the
    largest gradient (B = 16, T = 24, a seeded random state with the flux
    away from zero)."""
    name = "EESM" if case == "eesm" else "InductionMachine"
    kwargs = {"observation_noise": {"i_sd": 0.3, "i_sq": 0.3}} if case.startswith("sensorless") else {}
    pe = getattr(P, name)(batch_size=16, **F64, **kwargs)
    tile, carry0 = {"foc": lambda: foc.make_foc_tile(pe, psi_ref=PSI_REF, torque_ref=TORQUE_REF),
                    "sensorless_noisy": lambda: foc.make_sensorless_foc_tile(pe, psi_ref=PSI_REF,
                                                                             torque_ref=TORQUE_REF),
                    "eesm": lambda: foc.make_eesm_current_tile(pe, **EESM_REFS)}[case]()
    x0 = _random_x0(pe, 31, lim=1.0)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(33), 16))
    y0 = tuple(torch.as_tensor(x0[n]).requires_grad_(True) for n in pe._ode_state_fields)
    state = state_from_numpy(pe, x0, keys=keys)
    for n, leaf in zip(pe._ode_state_fields, y0):
        setattr(state.physical_state, n, leaf)
    # the integrator planes (the anti-windup flags have no derivative)
    n_int = {"foc": 3, "sensorless_noisy": 7, "eesm": 3}[case]
    c0 = tuple(c.clone().requires_grad_(i < n_int) for i, c in enumerate(carry0))
    grads_of = list(y0) + list(c0[:n_int])
    rng = np.random.default_rng(32)
    w_y = [torch.as_tensor(rng.uniform(size=16)) for _ in y0]
    w_c = [torch.as_tensor(rng.uniform(size=16)) for _ in c0[:n_int]]
    loss = lambda y, c: sum((a * w).sum() for a, w in zip(list(y) + list(c[:n_int]), w_y + w_c))

    calls = []
    orig = CL.ClosedLoopVJP.apply
    try:
        CL.ClosedLoopVJP.apply = lambda *a: calls.append(1) or orig(*a)
        _, last, final_c = pe.fused_closed_loop(state, tile, 24, policy_carry=c0)
        CL.ClosedLoopVJP.apply = orig
        noise = CL.closed_loop_noise(pe, state, 24, pe.env_properties)
        y_p, c_p, *_ = CL.plain_closed_loop(pe, y0, tile, 24, tau=pe.tau, solver=pe._solver,
                                            props=pe.env_properties, policy_carry=c0, **noise.slabs)
    finally:
        CL.ClosedLoopVJP.apply = orig
    assert calls == [1]
    g_v = torch.autograd.grad(loss([getattr(last.physical_state, n) for n in pe._ode_state_fields], final_c),
                              grads_of)
    g_p = torch.autograd.grad(loss(y_p, c_p), grads_of)
    for a, b in zip(g_v, g_p):
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-12 * scale


@pytest.mark.parametrize("case", ["foc", "sensorless_noisy", "eesm"])
def test_gradient_of_the_initial_state_matches_jax_grad_float64(case):
    """The port's gradient through ClosedLoopVJP against jax.grad of the JAX
    package's tile_policy_scan with the JAX tile, on the same state, carry
    and (sensorless) sensor keys: a seeded linear loss on the observation
    trajectory, the final state and the integrator planes of the final
    carry, differentiated in the initial state and those planes, at rtol
    1e-10, atol 1e-12 (B = 16, T = 16, a seeded random state with the flux
    away from zero, where both libraries' subgradients agree)."""
    name = "EESM" if case == "eesm" else "InductionMachine"
    kwargs = {"observation_noise": {"i_sd": 0.3, "i_sq": 0.3}} if case.startswith("sensorless") else {}
    je, pe = _pair(name, 16, **kwargs)
    (jt, jc0), (pt, pc0) = _tiles(case, je, pe)
    x0 = _random_x0(pe, 34, lim=1.0)
    js, ps = _states(je, pe, x0, seed=35)
    n_int = {"foc": 3, "sensorless_noisy": 7, "eesm": 3}[case]
    rng = np.random.default_rng(36)
    n_obs = len(pe._ode_state_fields) + len(pe.control_state)
    w_o = rng.uniform(size=(16, TK, n_obs))
    w_y = {n: rng.uniform(size=16) for n in pe._ode_state_fields}
    w_c = [rng.uniform(size=16) for _ in range(n_int)]

    def j_loss(x, c_int):
        with jstructures.copy_and_mutate(js, validate=False) as st:
            for n, v in x.items():
                setattr(st.physical_state, n, v)
        obs, _, _, last, fc = j_tile_policy_scan(je, st, TK, jt, None, True,
                                                 policy_carry=tuple(c_int) + tuple(jc0[n_int:]))
        return (jnp.sum(obs * w_o) + sum(jnp.sum(getattr(last.physical_state, n) * w) for n, w in w_y.items())
                + sum(jnp.sum(c * w) for c, w in zip(fc[:n_int], w_c)))

    g_jx, g_jc = jax.grad(j_loss, argnums=(0, 1))({n: jnp.asarray(v) for n, v in x0.items()},
                                                  tuple(jc0[:n_int]))
    x_t = {n: torch.as_tensor(v).requires_grad_(True) for n, v in x0.items()}
    for n, leaf in x_t.items():
        setattr(ps.physical_state, n, leaf)
    c_t = tuple(c.clone().requires_grad_(i < n_int) for i, c in enumerate(pc0))
    obs, _, last, fc = pe.fused_closed_loop(ps, pt, TK, obs_stride=1, policy_carry=c_t)
    loss = ((obs * torch.as_tensor(w_o)).sum()
            + sum((getattr(last.physical_state, n) * torch.as_tensor(w)).sum() for n, w in w_y.items())
            + sum((c * torch.as_tensor(w)).sum() for c, w in zip(fc[:n_int], w_c)))
    loss.backward()
    for n in x0:
        _close(x_t[n].grad, g_jx[n])
    for leaf, ref in zip(c_t[:n_int], g_jc):
        _close(leaf.grad, ref)


# ---------------------------------------------------------------------------
# the kernel's side: flat layouts, variants, refusals
# ---------------------------------------------------------------------------


def _enum_slots(header: str, struct: str) -> dict:
    """``{name: value}`` of the first ``enum { ... }`` of ``struct`` in a
    header (entries ``NAME`` or ``NAME = expression`` over earlier names and
    ``Other::NAME``)."""
    text = (CSRC / header).read_text()
    body = re.search(r"struct %s \{.*?enum \{(.*?)\};" % struct, text, re.S).group(1)
    values, nxt = {}, 0
    scope = {}
    for entry in (e.strip() for e in body.split(",") if e.strip()):
        name, _, expr = (p.strip() for p in entry.partition("="))
        if expr:
            expr = re.sub(r"(\w+)::(\w+)", lambda m: str(_enum_slots(header, m.group(1))[m.group(2)]), expr)
            nxt = eval(expr, {}, dict(scope))
        values[name] = nxt
        scope[name] = nxt
        nxt += 1
    return values


@pytest.mark.parametrize("struct,policy", [("FocLaw", foc.FocLaw), ("FocTile", foc.FocPolicy),
                                           ("SensorlessFocTile", foc.SensorlessFocPolicy),
                                           ("EesmCurrentTile", foc.EesmCurrentPolicy)])
def test_flat_layouts_match_the_functors_enums(struct, policy):
    """Every slot of the Python class sits where csrc/foc_laws.cuh's functor
    reads it, and the flat vector has the enum's N_SLOTS values."""
    enum = _enum_slots("foc_laws.cuh", struct)
    slots = policy.SLOTS
    assert enum["N_SLOTS"] == len(slots)
    for name, value in enum.items():
        if name != "N_SLOTS":
            # a block's base (K0, A0, ...) is its first entry (K00, A00, ...)
            assert slots[value] == (name if name in slots else name + "0"), (name, value, slots[value])
    if struct in ("FocTile", "SensorlessFocTile"):
        assert slots[: len(foc.FocLaw.SLOTS)] == foc.FocLaw.SLOTS


def test_kernel_specs_variants_and_per_batch_refusal():
    """Each tile's kernel_spec: its family id, the variant of
    csrc/closed_loop.cu (the functor's VARIANT), a flat vector of its SLOTS and (FOC) omega * tau
    in double; a tile built on a per-batch speed takes the per-drive variant
    with the law's planes, and a tile built on another per-batch static
    param runs on the CPU but refuses a kernel spec (the kernel folds the
    constants in)."""
    im = P.InductionMachine(batch_size=8, **F64, observation_noise={"i_sd": 0.3, "i_sq": 0.3})
    eesm = P.EESM(batch_size=8, **F64)
    for (tile, _), pid, variant, env in (
            (foc.make_foc_tile(im, psi_ref=PSI_REF, torque_ref=TORQUE_REF), 4, "foc", im),
            (foc.make_sensorless_foc_tile(im, psi_ref=PSI_REF, torque_ref=TORQUE_REF), 5, "sensorless_foc", im),
            (foc.make_eesm_current_tile(eesm, **EESM_REFS), 6, "eesm_current", eesm)):
        spec = tile.kernel_spec(torch.float32, "cpu")
        assert spec.policy_id == pid and spec.flat.dtype == torch.float32 and spec.flat.numel() == len(tile.SLOTS)
        assert CL.kernel_variant(len(env._ode_state_fields), spec) == variant and variant in CL.VARIANTS
        functor = {4: "FocTile", 5: "SensorlessFocTile", 6: "EesmCurrentTile"}[pid]
        declared = re.search(r"struct %s \{\s*static constexpr int VARIANT = (\d+)," % functor,
                             (CSRC / "foc_laws.cuh").read_text())
        assert int(declared.group(1)) == CL.VARIANTS.index(variant)
        assert tile.env_ids == (env._kernel_env_id,)
        assert spec.n_obs == len(env._ode_state_fields)
        if pid != 6:
            assert spec.options["frame_step"] == im.env_properties.static_params.omega * im.tau
    sp = P.InductionMachine._default_static_params()
    sp["omega"] = np.linspace(200.0, 400.0, 8)
    fleet = P.InductionMachine(batch_size=8, static_params=sp, **F64)
    tile, carry0 = foc.make_foc_tile(fleet, psi_ref=PSI_REF, torque_ref=TORQUE_REF)
    out = fleet.fused_closed_loop(state_from_numpy(fleet, _cold(fleet)), tile, 4, policy_carry=carry0)
    assert bool(torch.isfinite(out[0]).all())
    spec = tile.kernel_spec(torch.float32, "cpu")
    assert CL.kernel_variant(4, spec) == "foc_per_drive" and spec.options["frame_step"] == 0.0
    omega = fleet.env_properties.static_params.omega
    assert [p.dtype for p in spec.planes] == [torch.float32] * 3
    assert torch.equal(spec.planes[0], omega.float()) and bool((spec.planes[1] == TORQUE_REF).all())
    assert torch.equal(spec.planes[2], (omega * fleet.tau).float())
    sp["r_r"] = np.linspace(2.0, 2.6, 8)
    tile, carry0 = foc.make_foc_tile(P.InductionMachine(batch_size=8, static_params=sp, **F64), psi_ref=PSI_REF,
                                     torque_ref=TORQUE_REF)
    with pytest.raises(ValueError, match="per-batch"):
        tile.kernel_spec(torch.float32, "cpu")
    sp_e = P.EESM._default_static_params()
    sp_e["l_q"] = np.linspace(3e-3, 6e-3, 8)
    with pytest.raises(ValueError, match="scalar static params"):
        foc.make_eesm_current_tile(P.EESM(batch_size=8, static_params=sp_e, **F64), **EESM_REFS)


# ---------------------------------------------------------------------------
# per-drive operating points: each drive's speed and torque setpoint, and one
# stationary Kalman filter per drive at its speed
# ---------------------------------------------------------------------------

#: gym-electric-motor's default squirrel-cage machine with a 560 V DC link
GEM_PARAMS = dict(r_s=2.9338, r_r=1.355, l_m=0.14375, l_s=0.14962, l_r=0.14962, p=2.0)
GEM_SENSOR = {"i_sd": 0.055, "i_sq": 0.055}
DRIVE_OMEGA = (-600.0, -120.0, 45.0, 610.0)
DRIVE_TORQUE = (3.9, -1.2, 2.5, -4.2)
DRIVE_LAW = dict(psi_ref=0.4, i_max=5.5, kp_psi=40.0, ki_psi=800.0)


def _gem(batch, omega, **kw):
    return P.InductionMachine(batch_size=batch, static_params={**P.InductionMachine._default_static_params(),
                                                               **GEM_PARAMS, "omega": omega}, u_dc=560.0,
                              **F64, **kw)


def _drive_tile(kind, env, torque, **kw):
    if kind == "foc":
        return foc.make_foc_tile(env, torque_ref=torque, **DRIVE_LAW, **kw)
    return foc.make_sensorless_foc_tile(env, torque_ref=torque, measurement_std=GEM_SENSOR, **DRIVE_LAW, **kw)


def test_stationary_kalman_gains_equal_the_scalar_gain_at_each_drives_speed_float64():
    """The batched doubling solve against stationary_kalman_gain at each
    drive's speed: A, B, c at rtol 1e-10, atol 1e-12 (one linearization, so
    they agree bit for bit here), K and P to 1e-10 of their largest entry
    once the scalar fixed point is iterated to convergence (its default
    tolerance, 1e-13 absolute, stops within ~1e-7 of it at these sensor
    levels); with the inverter circle the gains are finite (the linearization
    sits off the circle's zero-action kink)."""
    omega = np.asarray(DRIVE_OMEGA)
    fleet = _gem(4, omega)
    meas = dict(measured_fields=("i_sd", "i_sq"), measurement_std=GEM_SENSOR)
    sk = estimate.stationary_kalman_gains(fleet, **meas)
    assert sk.A.shape == (4, 4, 4) and sk.B.shape == (4, 4, 2) and sk.K.shape == (4, 4, 2)
    for b, w in enumerate(omega):
        one = estimate.stationary_kalman_gain(_gem(1, float(w)), **meas, tol=1e-22, max_iters=10**7)
        for name in ("A", "B", "c"):
            _close(getattr(sk, name)[b], getattr(one, name))
        for name in ("K", "P"):
            ref = getattr(one, name)
            assert np.abs(getattr(sk, name)[b] - ref).max() <= 1e-10 * np.abs(ref).max()
        assert np.isfinite(one.K).all() and tuple(one.midx) == tuple(sk.midx)
    varies = np.argwhere((sk.A != sk.A[:1]).any(axis=0))
    assert sorted(map(tuple, varies)) == sorted(foc.SensorlessFocPolicy.DRIVE_A)


@pytest.mark.parametrize("kind", ["foc", "sensorless"])
def test_per_drive_tile_equals_a_scalar_tile_per_drive_float64(kind):
    """A fleet of four drives, each at its own speed and torque setpoint,
    under the per-drive tile, against four one-drive fleets under the scalar
    tile built at that drive's speed and setpoint (the sensorless one with
    the scalar gain iterated to convergence): observation and carry after
    300 steps from a cold start (the fallback frame and the magnetizing
    transient) at rtol 1e-10, atol 1e-12."""
    fleet = _gem(4, np.asarray(DRIVE_OMEGA))
    tile, carry0 = _drive_tile(kind, fleet, torch.tensor(DRIVE_TORQUE, dtype=torch.float64))
    assert tile.law.per_drive() and len(tile.kernel_spec(torch.float64, "cpu").planes) == len(tile.PLANES)
    obs, _, carry = fleet.fused_closed_loop(state_from_numpy(fleet, _cold(fleet)), tile, 300, policy_carry=carry0)
    for b, (w, t_ref) in enumerate(zip(DRIVE_OMEGA, DRIVE_TORQUE)):
        one = _gem(1, w)
        one_tile, one_carry = _drive_tile(kind, one, t_ref)
        assert not one_tile.law.per_drive()
        if kind == "sensorless":
            sk = estimate.stationary_kalman_gain(one, measured_fields=("i_sd", "i_sq"), measurement_std=GEM_SENSOR,
                                                 tol=1e-22, max_iters=10**7)
            one_tile.K = [[float(v) for v in row] for row in sk.K]
        one_obs, _, one_c = one.fused_closed_loop(state_from_numpy(one, _cold(one)), one_tile, 300,
                                                  policy_carry=one_carry)
        _close(obs[b], one_obs[0])
        for leaf, one_leaf in zip(carry, one_c):
            _close(leaf[b], one_leaf[0])


def test_per_drive_law_matches_jax_float64():
    """The per-drive tile's law (speed and torque setpoint per drive) against
    the JAX package's make_sensorless_foc controller, which broadcasts
    per-batch constants, on random belief states and carries at the steps 0
    and 37: actions and carries at rtol 1e-10, atol 1e-12."""
    b = 8
    omega, torque = np.linspace(-628.3, 628.3, b), np.linspace(-4.38, 4.38, b)
    sp = {**J.InductionMachine._default_static_params(), **GEM_PARAMS}
    je = J.InductionMachine(batch_size=b, static_params={**sp, "omega": jnp.asarray(omega)})
    pe = P.InductionMachine(batch_size=b, static_params={**sp, "omega": omega}, **F64)
    jctl, _ = jfoc.make_sensorless_foc(je, torque_ref=jnp.asarray(torque), **DRIVE_LAW)
    tile, _ = foc.make_foc_tile(pe, torque_ref=torch.as_tensor(torque), **DRIVE_LAW)
    js, ps = _states(je, pe, _belief(pe, 21, 20.0))
    for k, seed in ((0, 22), (37, 23)):
        jc, pc = _carry(pe, seed)
        ja, jn = jctl(js, jc, k)
        phys = ps.physical_state
        pa, pn = tile.law(phys.i_sd, phys.i_sq, phys.psi_rd, phys.psi_rq, pc, k)
        _close(torch.stack(pa, dim=-1), ja)
        for p_leaf, j_leaf in zip(pn, jn):
            _close(p_leaf.to(torch.float64), np.asarray(j_leaf, dtype=np.float64))


def test_per_drive_tiles_refuse_what_the_kernel_folds():
    """A per-drive psi_ref, field weakening at per-drive speeds, a per-batch
    action band or a per-batch machine parameter: the plain tile runs on CPU
    tensors (where the closed loop's scope holds: scalar bands), the kernel
    spec refuses and names them; a per-batch state band, and one filter per
    drive under RK4, refuse when the tile is built."""
    omega = np.asarray(DRIVE_OMEGA)
    torque = torch.tensor(DRIVE_TORQUE, dtype=torch.float64)
    fleet = _gem(4, omega)
    cases = [
        dict(env=fleet, kw=dict(psi_ref=torch.full((4,), 0.4, dtype=torch.float64))),
        dict(env=fleet, kw=dict(psi_ref=0.4, field_weakening=True)),
        dict(env=_gem(4, omega, action_normalizations={
            "u_sd": PNorm(min=-torch.linspace(300.0, 323.0, 4), max=torch.linspace(300.0, 323.0, 4)),
            "u_sq": PNorm(min=-323.0, max=323.0)}), kw=dict(psi_ref=0.4)),
    ]
    sp = {**P.InductionMachine._default_static_params(), **GEM_PARAMS, "omega": omega, "r_r": np.linspace(1.3, 1.4, 4)}
    cases.append(dict(env=P.InductionMachine(batch_size=4, static_params=sp, u_dc=560.0, **F64), kw=dict(psi_ref=0.4)))
    for case in cases:
        tile, carry0 = foc.make_foc_tile(case["env"], torque_ref=torque, i_max=5.5, **case["kw"])
        env = case["env"]
        if CL.supports_fused_closed_loop(env):
            out = env.fused_closed_loop(state_from_numpy(env, _cold(env)), tile, 3, policy_carry=carry0)
            assert bool(torch.isfinite(out[0]).all())
        with pytest.raises(ValueError, match="per-batch psi_ref, field weakening at per-drive speeds"):
            tile.kernel_spec(torch.float32, "cpu")
    with pytest.raises(ValueError, match="scalar physical normalizations"):
        foc.make_sensorless_foc_tile(_gem(4, omega, physical_normalizations={
            "i_sd": PNorm(min=-torch.linspace(19.0, 20.0, 4), max=torch.linspace(19.0, 20.0, 4)),
            "i_sq": PNorm(min=-20.0, max=20.0), "psi_rd": PNorm(min=-1.5, max=1.5),
            "psi_rq": PNorm(min=-1.5, max=1.5)}), torque_ref=torque, measurement_std=GEM_SENSOR, psi_ref=0.4)
    # one filter per drive needs explicit Euler: RK4's transition moves every entry of A with the speed
    with pytest.raises(ValueError, match="only explicit Euler"):
        foc.make_sensorless_foc_tile(_gem(4, omega, solver="rk4"), torque_ref=torque, measurement_std=GEM_SENSOR,
                                     psi_ref=0.4)


@pytest.mark.parametrize("struct,policy", [("FocDriveTile", foc.FocPolicy),
                                           ("SensorlessFocDriveTile", foc.SensorlessFocPolicy)])
def test_per_drive_planes_match_the_functors_enums(struct, policy):
    """The per-drive functor's planes enum is the Python class's PLANES in
    order, its VARIANT is the per-drive variant's index, and its flat vector
    is the folded tile's (the per-drive class is the folded class with
    planes)."""
    enum = _enum_slots("foc_laws.cuh", struct)
    planes = foc.FocLaw.PLANES if policy is foc.FocPolicy else policy.PLANES
    assert enum["N_PLANES"] == len(planes)
    assert [name for name, _ in sorted(enum.items(), key=lambda kv: kv[1]) if name != "N_PLANES"] == list(planes)
    variant = {"FocDriveTile": "foc_per_drive", "SensorlessFocDriveTile": "sensorless_foc_per_drive"}[struct]
    declared = re.search(r"struct %s \{\s*static constexpr int VARIANT = (\d+)," % struct,
                         (CSRC / "foc_laws.cuh").read_text())
    assert int(declared.group(1)) == CL.VARIANTS.index(variant)
    assert len(planes) <= CL.MAX_POLICY_PLANES
    fleet = _gem(4, np.asarray(DRIVE_OMEGA))
    tile, _ = _drive_tile("foc" if policy is foc.FocPolicy else "sensorless", fleet,
                          torch.tensor(DRIVE_TORQUE, dtype=torch.float64))
    spec = tile.kernel_spec(torch.float64, "cpu")
    assert CL.kernel_variant(4, spec) == variant and spec.flat.numel() == len(policy.SLOTS)
    if policy is foc.SensorlessFocPolicy:
        names = policy.PLANES
        for i in range(4):
            for k in range(2):
                assert torch.equal(spec.planes[names.index(f"K{i}{k}")], tile.K[i][k])
        for i, j in policy.DRIVE_A:
            assert torch.equal(spec.planes[names.index(f"A{i}{j}")], tile.A[i][j])
        flat = dict(zip(policy.SLOTS, spec.flat.tolist()))
        assert all(flat[f"K{i}{k}"] == 0.0 for i in range(4) for k in range(4))
        assert flat["OMEGA"] == flat["TORQUE_REF"] == 0.0 and flat["A_MASK"] == float(
            sum(1 << (4 * i + j) for i in range(4) for j in range(4) if tile.a_nz[i][j]))


def test_gain_solves_once_per_tile_and_packs_once():
    """One sensorless tile costs one gain solve (of every drive), however
    many chunks the fleet loop runs it for, and its kernel spec is packed
    once while its constants stay as they are: every later launch gets the
    same flat vector and planes."""
    from exciting_environments_torch.utils.fleet import FleetRunner

    fleet = _gem(4, np.asarray(DRIVE_OMEGA))
    before = dict(foc.GAIN_SOLVES)
    tile, carry0 = _drive_tile("sensorless", fleet, torch.tensor(DRIVE_TORQUE, dtype=torch.float64))
    assert foc.GAIN_SOLVES == {"solves": before["solves"] + 1, "drives": before["drives"] + 4}
    packs = []
    planes = tile._planes
    tile._planes = lambda: packs.append(1) or planes()
    runner = FleetRunner(fleet)
    runner.run_policy(state_from_numpy(fleet, _cold(fleet)), tile, 3, 16, policy_carry=carry0)
    specs = [tile.kernel_spec(torch.float64, "cpu") for _ in range(3)]
    assert all(s is specs[0] for s in specs) and len(packs) == 1
    assert foc.GAIN_SOLVES == {"solves": before["solves"] + 1, "drives": before["drives"] + 4}
    one, _ = _drive_tile("sensorless", _gem(1, 300.0), 2.0)
    assert foc.GAIN_SOLVES == {"solves": before["solves"] + 2, "drives": before["drives"] + 5}


@pytest.mark.parametrize("kind", ["foc", "sensorless"])
def test_kernel_spec_repacks_after_a_constant_changes(kind):
    """A tile's packed spec follows its constants: a per-drive torque
    setpoint written in place, a plane replaced by another tensor, a folded
    constant changed, and (scalar tile) a changed setpoint each give a
    spec that holds the new values; nothing changed gives the same spec."""
    fleet = _gem(4, np.asarray(DRIVE_OMEGA))
    tile, _ = _drive_tile(kind, fleet, torch.tensor(DRIVE_TORQUE, dtype=torch.float64))
    first = tile.kernel_spec(torch.float32, "cpu")
    assert tile.kernel_spec(torch.float32, "cpu") is first
    tile.law.torque_ref.mul_(-0.5)
    spec = tile.kernel_spec(torch.float32, "cpu")
    assert spec is not first and torch.equal(spec.planes[1], (-0.5 * torch.tensor(DRIVE_TORQUE)).float())
    assert tile.kernel_spec(torch.float32, "cpu") is spec
    tile.law.torque_ref = torch.full((4,), 1.25, dtype=torch.float64)
    spec = tile.kernel_spec(torch.float32, "cpu")
    assert bool((spec.planes[1] == 1.25).all())
    tile.law.psi_star = 0.45
    spec = tile.kernel_spec(torch.float32, "cpu")
    assert float(spec.flat[tile.SLOTS.index("PSI_STAR")]) == np.float32(0.45)
    one, _ = _drive_tile(kind, _gem(1, 300.0), 2.0)
    assert one.kernel_spec(torch.float64, "cpu").flat[one.SLOTS.index("TORQUE_REF")] == 2.0
    one.law.torque_ref = -3.0
    assert one.kernel_spec(torch.float64, "cpu").flat[one.SLOTS.index("TORQUE_REF")] == -3.0
    assert one.kernel_spec(torch.float32, "cpu").flat.dtype == torch.float32
