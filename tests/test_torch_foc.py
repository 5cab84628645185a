"""The port's sensorless PMSM tiles (``utils/foc.py``) against the JAX
package's tile factories and tiles.

Float64 on the CPU; the gains and maps of both factories agree at 1e-10 (the
same Riccati iteration in numpy over Jacobians from two autodiff systems),
and each tile's ``forward`` follows the JAX ``policy_tile`` on random columns
at 1e-12.  Both factories read the observer's levels from a noisy drive's
``process_noise``/``observation_noise``, each field overridable by
``process_std``/``measurement_std`` as in the JAX package.  The saturated
tile's settling test reuses the bounds of
tests/test_foc.py::test_pmsm_saturated_sensorless_tile_settles with a numpy
sensor slab, and the noisy drive's own closed loop streams its draws.
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.utils import foc as jfoc
from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
from exciting_environments_torch.utils import foc

F64 = dict(device="cpu", dtype=torch.float64)
TOL = dict(rtol=1e-10, atol=1e-10)
SOURCE = Path(__file__).resolve().parents[1] / "exciting_environments_torch" / "csrc" / "pmsm_closed_loop.cu"


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **(tol or TOL))


def _linear_pair(deadtime, solver="euler"):
    params = dict(J.MotorVariant.DEFAULT.get_params().static_params.__dict__, deadtime=deadtime)
    je = J.PMSM(batch_size=8, motor_variant=J.MotorVariant.DEFAULT, static_params=params, solver=solver)
    pe = P.PMSM(batch_size=8, motor_variant=P.MotorVariant.DEFAULT, static_params=params, solver=solver, **F64)
    return je, pe


def _saturated_pair(deadtime, variant="BRUSA", batch=8):
    params = dict(J.MotorVariant[variant].get_params().static_params.__dict__, deadtime=deadtime,
                  l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
    je = J.PMSM(batch_size=batch, saturated=True, motor_variant=J.MotorVariant[variant], static_params=params)
    pe = P.PMSM(batch_size=batch, saturated=True, motor_variant=P.MotorVariant[variant], static_params=params, **F64)
    return je, pe


SENSORS = {"i_d": 5.0, "i_q": 5.0}
LINEAR = dict(i_d_ref=-30.0, i_q_ref=60.0, omega_el=1200.0, measurement_std=SENSORS, process_std={"i_d": 2.0})
SATURATED = dict(i_d_ref=-100.0, i_q_ref=150.0, omega_el=1200.0, measurement_std={"i_d": 3.0, "i_q": 3.0})


@pytest.mark.parametrize("deadtime,solver", [(0, "euler"), (1, "euler"), (1, "rk4")])
def test_linear_tile_factory_matches_jax(deadtime, solver):
    je, pe = _linear_pair(deadtime, solver)
    j_tile, j_c0 = jfoc.make_pmsm_sensorless_current_tile(je, **LINEAR)
    p_tile, p_c0 = foc.make_pmsm_sensorless_current_tile(pe, **LINEAR)
    ref = inspect.getclosurevars(j_tile).nonlocals
    for name, key in (("K", "K"), ("A", "A_l"), ("B", "B_l"), ("c", "c_l")):
        _close(p_tile.consts[name], ref[key])
    for name in ("kp_d", "kp_q", "ki_d", "ki_q", "u_lim", "omega_el", "tau"):
        assert p_tile.consts[name] == pytest.approx(ref[name], rel=1e-15)
    assert len(p_c0) == len(j_c0) == (6 if deadtime else 4) == p_tile.n_carry
    for a, b in zip(p_c0, j_c0):
        _close(a, b)


@pytest.mark.parametrize("deadtime", [0, 1])
def test_saturated_tile_factory_matches_jax(deadtime):
    je, pe = _saturated_pair(deadtime)
    _, j_c0, j_sched = jfoc.make_pmsm_saturated_sensorless_current_tile(je, **SATURATED)
    p_tile, p_c0, p_sched = foc.make_pmsm_saturated_sensorless_current_tile(pe, **SATURATED)
    assert p_sched.values.shape == np.asarray(j_sched.values).shape == (10, pe._lut.nx, pe._lut.ny)
    assert p_sched.carry_idx == j_sched.carry_idx == (0, 1)
    _close(p_sched.values, j_sched.values)
    assert p_tile.n_obs == 18 and p_tile.n_carry == (6 if deadtime else 4)
    for a, b in zip(p_c0, j_c0):
        _close(a, b)


@pytest.mark.parametrize("family", ["linear", "saturated"])
def test_factories_read_the_environment_noise_levels(family):
    """A drive built with noise: its levels feed the observer as the JAX
    factories read them, an explicit argument overrides a field, and the
    drive's own closed loop runs the tile on its sensor draws."""
    noise = dict(process_noise={"i_d": 2.0}, observation_noise={"i_d": 5.0, "i_q": 4.0})
    override = {"measurement_std": {"i_q": 3.0}}
    if family == "linear":
        params = dict(J.MotorVariant.DEFAULT.get_params().static_params.__dict__, deadtime=1)
        je = J.PMSM(batch_size=8, motor_variant=J.MotorVariant.DEFAULT, static_params=params, **noise)
        pe = P.PMSM(batch_size=8, motor_variant=P.MotorVariant.DEFAULT, static_params=params, **noise, **F64)
        refs = dict(i_d_ref=-30.0, i_q_ref=60.0, omega_el=1200.0)
        for extra in ({}, override):
            j_tile, _ = jfoc.make_pmsm_sensorless_current_tile(je, **refs, **extra)
            p_tile, _ = foc.make_pmsm_sensorless_current_tile(pe, **refs, **extra)
            _close(p_tile.consts["K"], inspect.getclosurevars(j_tile).nonlocals["K"])
        maker = foc.make_pmsm_sensorless_current_tile
    else:
        params = dict(J.MotorVariant.BRUSA.get_params().static_params.__dict__, deadtime=1,
                      l_d=float("nan"), l_q=float("nan"), psi_p=float("nan"))
        je = J.PMSM(batch_size=8, saturated=True, motor_variant=J.MotorVariant.BRUSA, static_params=params, **noise)
        pe = P.PMSM(batch_size=8, saturated=True, motor_variant=P.MotorVariant.BRUSA, static_params=params, **noise,
                    **F64)
        refs = dict(i_d_ref=-100.0, i_q_ref=150.0, omega_el=1200.0)
        for extra in ({}, override):
            _, _, j_sched = jfoc.make_pmsm_saturated_sensorless_current_tile(je, **refs, **extra)
            _, _, p_sched = foc.make_pmsm_saturated_sensorless_current_tile(pe, **refs, **extra)
            _close(p_sched.values, j_sched.values)
        maker = foc.make_pmsm_saturated_sensorless_current_tile
    out = maker(pe, **refs)
    tile, c0, sched = out if len(out) == 3 else (*out, None)
    keys = torch.as_tensor(np.asarray(jax.random.split(jax.random.PRNGKey(3), 8)).astype(np.int64))
    _, st = pe.vmap_reset(keys)
    st.physical_state.omega_el = torch.full((8,), 1200.0, dtype=torch.float64)
    obs, last, carry = pe.fused_closed_loop(st, tile, 16, policy_carry=c0, sched_lut=sched)
    assert bool(torch.isfinite(obs).all()) and not torch.equal(last.PRNGKey, st.PRNGKey)


def _random_columns(rng, n_obs, n, carry_n, sched=None):
    obs = [rng.uniform(-1, 1, n) for _ in range(n_obs)]
    if sched is not None:  # plausible gathered magnetics and gains
        lut = sched.values.reshape(10, -1)
        pick = rng.integers(0, lut.shape[1], n)
        obs[n_obs - 10 :] = list(lut[:, pick])
    carry = [rng.uniform(-1, 1, n) for _ in range(carry_n)]
    carry[2], carry[3] = rng.uniform(-50, 50, n), rng.uniform(-50, 50, n)
    return obs, carry


@pytest.mark.parametrize("family", ["linear", "saturated"])
@pytest.mark.parametrize("deadtime", [0, 1])
def test_forward_matches_jax_policy_tile(family, deadtime):
    rng = np.random.default_rng(deadtime)
    if family == "linear":
        je, pe = _linear_pair(deadtime)
        j_tile, _ = jfoc.make_pmsm_sensorless_current_tile(je, **LINEAR)
        p_tile, _ = foc.make_pmsm_sensorless_current_tile(pe, **LINEAR)
        obs, carry = _random_columns(rng, 8, 512, p_tile.n_carry)
    else:
        je, pe = _saturated_pair(deadtime)
        j_tile, _, j_sched = jfoc.make_pmsm_saturated_sensorless_current_tile(je, **SATURATED)
        p_tile, _, p_sched = foc.make_pmsm_saturated_sensorless_current_tile(pe, **SATURATED)
        obs, carry = _random_columns(rng, 18, 512, p_tile.n_carry, p_sched)
    j_a, j_c = j_tile(tuple(jnp.asarray(o) for o in obs), 3, tuple(jnp.asarray(c) for c in carry))
    p_a, p_c = p_tile(tuple(torch.as_tensor(o) for o in obs), 3, tuple(torch.as_tensor(c) for c in carry))
    assert len(p_c) == len(j_c) == p_tile.n_carry
    for a, b in zip(tuple(p_a) + tuple(p_c), tuple(j_a) + tuple(j_c)):
        _close(a, b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cls", [foc.SensorlessPolicy, foc.ScheduledSensorlessPolicy])
def test_kernel_slots_follow_the_functor(cls):
    """The flat vector's slot order is the functor's enum in the kernel
    source, and each family has a compiled functor."""
    functor = {2: "SensorlessLaw", 3: "ScheduledLaw"}[cls.policy_id]
    src = SOURCE.read_text()
    body = src[src.index(f"struct {functor} {{"):]
    enum = re.search(r"enum \{([^}]*)\}", body).group(1)
    names = tuple(n.strip() for n in enum.replace("\n", " ").split(",") if n.strip())
    assert names == cls.SLOTS + ("N_SLOTS",)
    assert PCL.FAMILIES[cls.policy_id] == cls.__name__
    assert f"case {cls.policy_id}:" in src


def test_kernel_spec_folds_python_constants():
    """The flat vector carries the tile's Python-float products folded in
    double (then rounded to the working type), never re-derived."""
    _, pe = _linear_pair(1)
    tile, _ = foc.make_pmsm_sensorless_current_tile(pe, **LINEAR)
    spec = tile.kernel_spec(torch.float32, "cpu")
    c = tile.consts
    slot = dict(zip(foc.SensorlessPolicy.SLOTS, spec.flat.tolist()))
    assert slot["AW_D"] == float(np.float32(c["tau"] * c["ki_d"] / c["kp_d"]))
    assert slot["AINV_D"] == float(np.float32(1.0 / (c["amx_d"] - c["amn_d"])))
    assert spec.options == {"delayed": 1} and spec.n_obs == 8 and spec.flat.dtype == torch.float32
    with pytest.raises(ValueError, match="no policy_params"):
        tile.kernel_spec(torch.float32, "cpu", torch.zeros(3))


REFUSALS = {
    "linear tile on the saturated drive": (
        lambda: foc.make_pmsm_sensorless_current_tile(_saturated_pair(1)[1], **LINEAR), "gain SCHEDULE"),
    "scheduled tile on the linear drive": (
        lambda: foc.make_pmsm_saturated_sensorless_current_tile(_linear_pair(1)[1], **SATURATED), "LUT-magnetics"),
    "scheduled tile with a multistage solver": (
        lambda: foc.make_pmsm_saturated_sensorless_current_tile(
            P.PMSM(batch_size=8, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver="tsit5", **F64),
            **SATURATED), "one-stage"),
    "linear tile without sensor levels": (
        lambda: foc.make_pmsm_sensorless_current_tile(_linear_pair(1)[1], i_d_ref=0.0, i_q_ref=10.0), "sensor"),
    "scheduled tile without sensor levels": (
        lambda: foc.make_pmsm_saturated_sensorless_current_tile(_saturated_pair(1)[1], i_d_ref=-10.0, i_q_ref=10.0),
        "sensor"),
    "per-batch resistance": (
        lambda: foc.make_pmsm_sensorless_current_tile(
            P.PMSM(batch_size=8, motor_variant=P.MotorVariant.DEFAULT,
                   static_params=dict(P.MotorVariant.DEFAULT.get_params().static_params.__dict__,
                                      r_s=np.full(8, 0.015)), **F64), **LINEAR), "scalar static params"),
    "deadtime 2": (
        lambda: foc.make_pmsm_sensorless_current_tile(_linear_pair(2)[1], **LINEAR), "deadtime must be 0 or 1"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_tile_factories_refuse(case):
    fn, match = REFUSALS[case]
    with pytest.raises(ValueError, match=match):
        fn()


def test_saturated_tile_settles():
    """Gain-scheduled sensorless control of the saturated BRUSA drive,
    B = 64 x T = 1,200 at omega_el = 1200 rad/s with a 3 A current-sensor
    slab: the fleet settles on setpoints it never measures directly, and the
    belief beats the sensor (bounds of tests/test_foc.py:569-577)."""
    B, T = 64, 1200
    pe = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    tile, c0, sched = foc.make_pmsm_saturated_sensorless_current_tile(pe, **SATURATED)
    _, st = pe.vmap_reset(rng=torch.Generator().manual_seed(1))
    phys = st.physical_state
    phys.omega_el = torch.full((B,), 1200.0, dtype=torch.float64)
    pn = pe.env_properties.physical_normalizations
    sigma = np.array([2 * 3.0 / (pn.i_d.max - pn.i_d.min), 2 * 3.0 / (pn.i_q.max - pn.i_q.min)])
    slab = np.random.default_rng(2).standard_normal((T, B, 2)) * sigma
    slab[0] = 0.0
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    final, _, fc, _, _ = PCL.pmsm_closed_loop(pe, state0, phys.omega_el, tile, T, policy_carry=c0, sched_lut=sched,
                                              obs_noise_tm=torch.as_tensor(slab), obs_noise_cols=(0, 1))
    i_d, i_q = final[0].numpy(), final[1].numpy()
    assert abs(i_d.mean() + 100.0) < 1.0, i_d.mean()
    assert abs(i_q.mean() - 150.0) < 1.5, i_q.mean()
    b_d = (fc[0].numpy() + 1) / 2 * (pn.i_d.max - pn.i_d.min) + pn.i_d.min
    b_q = (fc[1].numpy() + 1) / 2 * (pn.i_q.max - pn.i_q.min) + pn.i_q.min
    rmse_d = float(np.sqrt(((b_d - i_d) ** 2).mean()))
    rmse_q = float(np.sqrt(((b_q - i_q) ** 2).mean()))
    assert rmse_d < 1.5 and rmse_q < 1.5, (rmse_d, rmse_q)
