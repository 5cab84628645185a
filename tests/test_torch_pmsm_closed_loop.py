"""The port's PMSM closed loop (the PMSM closed-loop kernel's plain version on
CPU tensors) against the JAX package.

Same numpy inputs on both sides, float64 on the CPU.  The JAX references are
the kernel's own pieces: ``_hex_constrain`` (at 1e-12), a loop of
``_plain_pmsm_cl_step`` (B = 16, T = 32, at 1e-10), the Pallas kernel itself
in interpret mode (B = 1,024, T = 8) and ``collect_policy_fused``.  The
port's ``PMSM.fused_closed_loop`` is also held against its own
``tile_policy_scan`` (a loop of ``vmap_step``) at 1e-9, the figure of
tests/test_pallas_pmsm.py:511-513: the closed loop's hexagon takes the sector
from a linear test where ``env.step`` takes ``atan2``.  The kernel itself
runs only on a CUDA card: tests/test_torch_gpu.py holds it against this
plain version there.  The PPO actor (family 1) is held here by its
registration and budget and by its VJP against autograd through the plain
loop at 1e-12; tests/test_torch_rl_fused.py holds it against the Pallas
kernel in interpret mode.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas import pmsm_stepper as jpk
from exciting_environments_tpu.utils import foc as jfoc
from exciting_environments_tpu.utils.collect import RolloutCollector as JCollector
from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.kernels import pmsm_closed_loop as PCL
from exciting_environments_torch.ops.kernels import closed_loop_path
from exciting_environments_torch.utils.collect import tile_policy_scan
from exciting_environments_torch.utils.convert import scheduled_lut_from_numpy, state_from_numpy

F64 = dict(device="cpu", dtype=torch.float64)
B, T = 16, 32
TOL = dict(rtol=1e-10, atol=1e-10)
FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")
K_P = [[-0.6, 0, 0, 0, 0, 0, 0, 0, 0.6, 0], [0, -0.6, 0, 0, 0, 0, 0, 0, 0, 0.6]]
K_I = [[-0.01, 0, 0, 0, 0, 0, 0, 0, 0.01, 0], [0, -0.01, 0, 0, 0, 0, 0, 0, 0, 0.01]]


def p_law(obs, t):
    """The P law of benchmarks/r03/pmsm_closed_loop_device.py (JAX or torch)."""
    return (-0.6 * (obs[0] - obs[8]), -0.6 * (obs[1] - obs[9]))


def pi_law(obs, t, carry):
    """The PI law of benchmarks/r03/pmsm_stateful_closed_loop_device.py."""
    e_d, e_q = obs[8] - obs[0], obs[9] - obs[1]
    int_d, int_q = carry[0] + 0.01 * e_d, carry[1] + 0.01 * e_q
    return (0.6 * e_d + int_d, 0.6 * e_q + int_q), (int_d, int_q)


def _close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else port),
                               np.asarray(ref), **(tol or TOL))


def _static(variant, saturated, **overrides):
    params = dict(J.MotorVariant[variant].get_params().static_params.__dict__)
    if saturated:
        params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
    params.update(overrides)
    return params


def _pair(variant="BRUSA", saturated=True, solver="euler", batch=B, control=("i_d", "i_q"), static=None,
          jax_static=None):
    """The same drive in both packages (``static`` numpy values, converted
    for JAX unless ``jax_static`` is given)."""
    static = static or {}
    if jax_static is None:
        jax_static = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in static.items()}
    je = J.PMSM(batch_size=batch, saturated=saturated, motor_variant=J.MotorVariant[variant], solver=solver,
                static_params=_static(variant, saturated, **jax_static) if static else None,
                control_state=list(control))
    pe = P.PMSM(batch_size=batch, saturated=saturated, motor_variant=P.MotorVariant[variant], solver=solver,
                static_params=_static(variant, saturated, **static) if static else None, control_state=list(control),
                **F64)
    return je, pe


def _states(je, pe, seed, omega=None):
    """The same drive state and (i_d, i_q) references in both packages; the
    torque is the state's own, as reset and step store it."""
    rng = np.random.default_rng(seed)
    norms = pe.env_properties.physical_normalizations
    n = pe.batch_size
    x0 = {
        "u_d_buffer": rng.uniform(-100, 100, n),
        "u_q_buffer": rng.uniform(-100, 100, n),
        "epsilon": rng.uniform(-math.pi, math.pi, n),
        "i_d": rng.uniform(0.8 * norms.i_d.min, 0, n),
        "i_q": rng.uniform(0.8 * norms.i_q.min, 0.8 * norms.i_q.max, n),
        "omega_el": np.full(n, omega) if omega is not None else rng.uniform(0, 0.5 * norms.omega_el.max, n),
    }
    x0["torque"] = pe._torque(torch.as_tensor(x0["i_d"]), torch.as_tensor(x0["i_q"]), pe.env_properties).numpy()
    refs = {n_: rng.uniform(0.9 * getattr(norms, n_).min, 0.9 * getattr(norms, n_).max, n) for n_ in pe.control_state}
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for name, v in x0.items():
            setattr(js.physical_state, name, jnp.asarray(v))
        for name, v in refs.items():
            setattr(js.reference, name, jnp.asarray(v))
    return js, state_from_numpy(pe, x0, reference=refs)


def _jax_step(je, policy, has_carry, **kw):
    """The JAX kernel's per-step computation with the drive's effective
    parameters and bands."""
    props = je.env_properties
    params = props.static_params
    saturated = bool(props.saturated)
    r_s, p15, lin, _, geom, pb_names, pb = jpk._pmsm_scalar_config(je, params, saturated, jnp.float64, "take")
    r_s, lin, p15 = jpk._eff_params(r_s, lin, p15, pb_names, pb)
    pn, an = props.physical_normalizations, props.action_normalizations
    obs_norms = tuple((getattr(pn, n).min, getattr(pn, n).max) for n in PCL.OBS_BAND_FIELDS)
    act_norms = ((an.u_d.min, an.u_d.max), (an.u_q.min, an.u_q.max))
    lut_vals = jnp.asarray(je._lut.values) if saturated else jnp.zeros((0,))
    return jpk._plain_pmsm_cl_step(saturated, je._solver, je.tau, r_s, lin, p15, geom, lut_vals, policy, False,
                                   int(params.deadtime), obs_norms, act_norms, params.u_dc, has_carry=has_carry, **kw)


# ---------------------------------------------------------------------------
# the hexagon
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deadtime", [0, 1])
@pytest.mark.parametrize("per_batch", [False, True], ids=["scalar", "per-batch"])
def test_hex_constrain_matches_jax(deadtime, per_batch):
    """Random actions and angles, plus actions placed next to the sector
    boundaries (the phasor within a few ulp of a 60-degree axis)."""
    rng = np.random.default_rng(deadtime + 2 * per_batch)
    n = 4096
    eps = rng.uniform(-math.pi, math.pi, n)
    omega = rng.uniform(0, 3400, n)
    tau = 1e-4
    adv = np.mod(eps + omega * tau * (deadtime + 0.5), 2 * np.pi)
    # half of the actions point along a sector boundary at the advanced angle
    phi = rng.integers(0, 6, n) * np.pi / 3 + rng.choice([-1, 0, 1], n) * 1e-15
    mag = rng.uniform(0.05, 1.2, n)
    a_bd = mag * np.cos(phi + adv) * 0.75, mag * np.sin(phi + adv) * 0.75
    a = rng.uniform(-1.2, 1.2, (2, n))
    a[:, : n // 2] = np.stack(a_bd)[:, : n // 2]
    if per_batch:
        u_dc = rng.uniform(350, 450, n)
        act = ((rng.uniform(-300, -200, n), 266.6), (-266.6, rng.uniform(200, 300, n)))
    else:
        u_dc, act = 400.0, ((-266.6, 266.6), (-266.6, 266.6))
    to_j = lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v
    to_t = lambda v: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
    j_act = tuple(tuple(to_j(v) for v in pair) for pair in act)
    t_act = tuple(tuple(to_t(v) for v in pair) for pair in act)
    jd, jq = jpk._hex_constrain(jnp.asarray(a[0]), jnp.asarray(a[1]), jnp.asarray(eps), jnp.asarray(omega), tau,
                                j_act, to_j(u_dc), deadtime)
    td, tq = PCL.hex_constrain(torch.as_tensor(a[0]), torch.as_tensor(a[1]), torch.as_tensor(eps),
                               torch.as_tensor(omega), tau, t_act, to_t(u_dc), deadtime)
    _close(td, jd, rtol=1e-12, atol=1e-12)
    _close(tq, jq, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# the plain loop against the JAX kernel's per-step computation
# ---------------------------------------------------------------------------


def _plain_vs_jax_step(je, pe, js, ps, j_policy, p_policy, carry0=None, eo=None, ep=None, obs_cols=(),
                       noise_idx=(), sched=None, sched_vals=None, p_sched=None):
    has_carry = carry0 is not None
    step = _jax_step(je, j_policy, has_carry, obs_cols=obs_cols, noise_idx=noise_idx, sched=sched,
                     sched_vals=sched_vals)
    phys = js.physical_state
    y = tuple(phys.__dict__[n] for n in ("i_d", "i_q", "epsilon", "u_d_buffer", "u_q_buffer"))
    pn = je.env_properties.physical_normalizations
    refs = tuple(getattr(pn, n).normalize(getattr(js.reference, n)) for n in je.control_state)
    c = tuple(jnp.asarray(v) for v in carry0) if has_carry else ()
    saves = []
    for t in range(T):
        extra = (jnp.asarray(eo[t]), jnp.asarray(ep[t])) if obs_cols else ()
        y, c, out = step(y, c, t, refs, None, phys.omega_el, *extra)
        saves.append((y[0], y[1]) + tuple(out))
    pphys = ps.physical_state
    p_state0 = tuple(pphys.__dict__[n] for n in ("i_d", "i_q", "epsilon", "u_d_buffer", "u_q_buffer"))
    p_refs = tuple(getattr(pe.env_properties.physical_normalizations, n).normalize(getattr(ps.reference, n))
                   for n in pe.control_state)
    kw = dict(obs_noise_tm=torch.as_tensor(eo), obs_noise_cols=obs_cols, proc_noise_tm=torch.as_tensor(ep),
              proc_noise_idx=noise_idx) if obs_cols else {}
    final, u_last, carry, traj, traj_carry = PCL.pmsm_closed_loop(
        pe, p_state0, pphys.omega_el, p_policy, T, ref_leaves=p_refs, traj_stride=1,
        policy_carry=tuple(torch.as_tensor(np.array(v)) for v in carry0) if has_carry else None,
        sched_lut=p_sched, **kw)
    for i in range(5):
        _close(final[i], y[i])
    # saves: i_d, i_q, then (a_d, a_q, u_con_d, u_con_q) against traj 5, 6, 3, 4
    for j_idx, p_idx in ((0, 0), (1, 1), (2, 5), (3, 6), (4, 3), (5, 4)):
        _close(traj[p_idx], np.stack([s[j_idx] for s in saves]))
    for p_leaf, j_leaf in zip(carry, c):
        _close(p_leaf, j_leaf)


PLAIN_CASES = [
    ("BRUSA", True, "euler", 1, "P"),
    ("BRUSA", True, "rk4", 0, "PI"),
    ("BRUSA", True, "tsit5", 1, "PI"),
    ("DEFAULT", False, "rk4", 1, "P"),
    ("DEFAULT", False, "euler", 0, "PI"),
    ("SEW", True, "euler", 1, "PI"),
]


@pytest.mark.parametrize("variant,saturated,solver,deadtime,law", PLAIN_CASES)
def test_plain_loop_matches_jax_plain_step(variant, saturated, solver, deadtime, law):
    je, pe = _pair(variant, saturated, solver, static={"deadtime": deadtime})
    js, ps = _states(je, pe, 11)
    if law == "P":
        _plain_vs_jax_step(je, pe, js, ps, p_law, P.AffinePolicy(K_P))
    else:
        _plain_vs_jax_step(je, pe, js, ps, pi_law, P.AffinePolicy(K_P, Ki=K_I), carry0=(np.zeros(B), np.zeros(B)))


def test_plain_loop_per_batch_parameters_and_bands_match_jax():
    """Per-batch r_s, u_dc and a per-batch action band (the _PB_FIELDS and
    _PBN_FIELDS planes)."""
    rng = np.random.default_rng(12)
    static = {"r_s": rng.uniform(15e-3, 21e-3, B), "u_dc": rng.uniform(350.0, 450.0, B)}
    je, pe = _pair(static=static)
    hi = rng.uniform(200.0, 300.0, B)
    an_j = dict(je.env_properties.action_normalizations.__dict__)
    an_j["u_d"] = J.utils.MinMaxNormalization(min=an_j["u_d"].min, max=jnp.asarray(hi))
    je = J.PMSM(batch_size=B, saturated=True, motor_variant=J.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                static_params=_static("BRUSA", True, **{k: jnp.asarray(v) for k, v in static.items()}),
                action_normalizations=an_j)
    an_p = dict(pe.env_properties.action_normalizations.__dict__)
    an_p["u_d"] = P.MinMaxNormalization(min=an_p["u_d"].min, max=hi)
    pe = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                static_params=_static("BRUSA", True, **static), action_normalizations=an_p, **F64)
    assert PCL.supports_pmsm_fused_closed_loop(pe)
    bands = PCL.cl_bands(pe.env_properties)
    assert tuple(bands) == PCL.PBN_FIELDS
    assert [n for n, v in bands.items() if isinstance(v, torch.Tensor)] == ["u_dc", "a_d_mx"]
    js, ps = _states(je, pe, 13)
    _plain_vs_jax_step(je, pe, js, ps, pi_law, P.AffinePolicy(K_P, Ki=K_I), carry0=(np.zeros(B), np.zeros(B)))


@pytest.mark.parametrize("solver", ["euler", "rk4"])
def test_plain_loop_noise_slabs_match_jax(solver):
    je, pe = _pair(solver=solver)
    js, ps = _states(je, pe, 14)
    rng = np.random.default_rng(15)
    eo = 0.02 * rng.standard_normal((T, B, 2))
    ep = 0.5 * rng.standard_normal((T, B, 2))
    _plain_vs_jax_step(je, pe, js, ps, pi_law, pi_law, carry0=(np.zeros(B), np.zeros(B)), eo=eo, ep=ep,
                       obs_cols=(0, 9), noise_idx=(0, 1))


@pytest.mark.parametrize("deadtime", [0, 1])
def test_plain_loop_scheduled_lut_matches_jax(deadtime):
    """The gain-scheduled sensorless tile of the JAX package on both sides
    (its gain maps carried across), with a sensor slab on the current
    columns: the scheduled gather at the belief currents."""
    je, pe = _pair(static={"deadtime": deadtime}, control=())
    js, ps = _states(je, pe, 16, omega=1200.0)
    tile, c0, sched = jfoc.make_pmsm_saturated_sensorless_current_tile(
        je, i_d_ref=-100.0, i_q_ref=150.0, omega_el=1200.0, measurement_std={"i_d": 3.0, "i_q": 3.0})
    rng = np.random.default_rng(17)
    eo = rng.standard_normal((T, B, 2)) * np.array([6 / 250, 6 / 500])
    ep = np.zeros((T, B, 1))
    p_sched = scheduled_lut_from_numpy(pe, np.asarray(sched.values), sched.carry_idx)
    torch_tile = lambda obs, t, carry: tuple(
        tuple(torch.as_tensor(np.array(v)) for v in part)
        for part in tile(tuple(jnp.asarray(o.numpy()) for o in obs), t, tuple(jnp.asarray(v.numpy()) for v in carry)))
    _plain_vs_jax_step(je, pe, js, ps, tile, torch_tile, carry0=tuple(np.asarray(v) for v in c0), eo=eo, ep=ep,
                       obs_cols=(0, 1), noise_idx=(0,), sched=(10,) + sched.carry_idx,
                       sched_vals=jnp.asarray(sched.values), p_sched=p_sched)


def test_matches_the_pallas_kernel_in_interpret_mode():
    """The TPU kernel itself (Pallas interpret mode, B = 1,024, T = 8) with
    the PI law and its carry, trajectory mode, against the port."""
    je, pe = _pair(solver="rk4", batch=1024)
    js, ps = _states(je, pe, 18)
    c0 = (jnp.zeros(1024), jnp.zeros(1024))
    obs_j, acts_j, last_j, fc_j = jpk.pmsm_fused_closed_loop(je, js, pi_law, 8, obs_stride=1, interpret=True,
                                                             gather="take", policy_carry=c0)
    pc0 = (torch.zeros(1024, dtype=torch.float64), torch.zeros(1024, dtype=torch.float64))
    obs_p, acts_p, last_p, fc_p = pe.fused_closed_loop(ps, P.AffinePolicy(K_P, Ki=K_I), 8, obs_stride=1,
                                                       policy_carry=pc0)
    _close(obs_p, obs_j)
    _close(acts_p, acts_j)
    for name in FIELDS:
        _close(getattr(last_p.physical_state, name), getattr(last_j.physical_state, name))
    for p_leaf, j_leaf in zip(fc_p, fc_j):
        _close(p_leaf, j_leaf)


# ---------------------------------------------------------------------------
# PMSM.fused_closed_loop in every return shape against tile_policy_scan
# ---------------------------------------------------------------------------

SCAN_TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("solver", ["euler", "tsit5"])
@pytest.mark.parametrize("stateful", [False, True], ids=["P", "PI"])
def test_fused_closed_loop_matches_tile_policy_scan(solver, stateful):
    je, pe = _pair(solver=solver)
    _, ps = _states(je, pe, 19)
    law = pi_law if stateful else p_law
    c0 = (torch.zeros(B, dtype=torch.float64), torch.zeros(B, dtype=torch.float64)) if stateful else None
    tail = (c0,) if stateful else ()
    scan = tile_policy_scan(pe, ps, T, law, None, True, policy_carry=c0)
    obs_s, acts_s, traj_s, last_s = scan[:4]
    close = lambda a, b: _close(a, b.numpy(), **SCAN_TOL)

    out = pe.fused_closed_loop(ps, law, T, obs_stride=1, return_traj_states=True, policy_carry=c0)
    assert len(out) == 4 + len(tail)
    obs_f, acts_f, traj_f, last_f = out[:4]
    assert tuple(obs_f.shape) == (B, T, 10) and tuple(acts_f.shape) == (B, T, 2)
    close(obs_f, obs_s)
    close(acts_f, acts_s)
    for name in FIELDS:
        close(getattr(traj_f.physical_state, name), getattr(traj_s.physical_state, name))
        close(getattr(last_f.physical_state, name), getattr(last_s.physical_state, name))
    if stateful:
        for a, b in zip(out[4], scan[4]):
            close(a, b)
    # FSAL: the final solver carry is f(y1) under the last applied voltage
    if pe._solver.fsal:
        for k_p, k_s in zip(last_f.additions.solver_state, last_s.additions.solver_state):
            close(k_p, k_s)
    else:
        assert last_f.additions.solver_state is None
    _, reset_state = pe.vmap_reset()
    assert structures.structure(last_f) == structures.structure(reset_state)

    out3 = pe.fused_closed_loop(ps, law, T, obs_stride=4, policy_carry=c0)
    assert len(out3) == 3 + len(tail)
    close(out3[0], obs_s[:, 3::4])
    close(out3[1], acts_s[:, 3::4])
    fin = pe.fused_closed_loop(ps, law, T, policy_carry=c0)
    assert len(fin) == 2 + len(tail)
    close(fin[0], obs_s[:, -1])
    close(fin[1].physical_state.i_q, last_s.physical_state.i_q)
    if pe._solver.fsal:
        for k_p, k_s in zip(fin[1].additions.solver_state, last_s.additions.solver_state):
            close(k_p, k_s)


def test_scheduled_tile_fused_matches_tile_policy_scan():
    """The port's own gain-scheduled tile through fused_closed_loop and
    through tile_policy_scan with the same sched_lut."""
    je, pe = _pair(control=())
    _, ps = _states(je, pe, 20, omega=1200.0)
    tile, c0, sched = P.make_pmsm_saturated_sensorless_current_tile(
        pe, i_d_ref=-100.0, i_q_ref=150.0, omega_el=1200.0, measurement_std={"i_d": 3.0, "i_q": 3.0})
    obs_s, last_s, fc_s = tile_policy_scan(pe, ps, T, tile, None, False, policy_carry=c0, sched_lut=sched)
    obs_f, last_f, fc_f = pe.fused_closed_loop(ps, tile, T, policy_carry=c0, sched_lut=sched)
    _close(obs_f, obs_s.numpy(), **SCAN_TOL)
    for a, b in zip(fc_f, fc_s):
        _close(a, b.numpy(), **SCAN_TOL)


def test_plain_version_tracks_the_step_loop_to_rounding():
    """With the same operations in the same order except the hexagon's
    sector test, the plain loop and the step loop agree to rounding."""
    pe = P.PMSM(batch_size=64, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                **F64)
    _, ps = pe.vmap_reset(rng=torch.Generator().manual_seed(21))
    ps.reference.i_d = torch.linspace(-200.0, -10.0, 64, dtype=torch.float64)
    ps.reference.i_q = torch.linspace(-150.0, 150.0, 64, dtype=torch.float64)
    obs_s, _, _, last_s = tile_policy_scan(pe, ps, 12, p_law, None, True)
    obs_f, _, last_f = pe.fused_closed_loop(ps, p_law, 12, obs_stride=1)
    _close(obs_f, obs_s.numpy(), rtol=1e-12, atol=1e-12)
    _close(last_f.physical_state.i_d, last_s.physical_state.i_d.numpy(), rtol=1e-12, atol=1e-10)


def test_collect_policy_fused_on_the_pmsm_matches_jax():
    je, pe = _pair()
    js, ps = _states(je, pe, 22)
    assert closed_loop_path(pe) == "pmsm_closed_loop_fused"
    c0 = (np.zeros(B), np.zeros(B))
    jb, jl, jc = JCollector(je).collect_policy_fused(pi_law, js, T, policy_carry=tuple(jnp.asarray(v) for v in c0))
    pb, pl, pc = P.RolloutCollector(pe).collect_policy_fused(
        P.AffinePolicy(K_P, Ki=K_I), ps, T, policy_carry=tuple(torch.as_tensor(v) for v in c0))
    for name in ("observations", "actions", "rewards"):
        _close(getattr(pb, name), getattr(jb, name), **SCAN_TOL)
    for name in ("terminated", "truncated"):
        assert np.array_equal(getattr(pb, name).numpy(), np.asarray(getattr(jb, name)))
    _close(pl.physical_state.i_d, jl.physical_state.i_d, **SCAN_TOL)
    for a, b in zip(pc, jc):
        _close(a, b, **SCAN_TOL)


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


def _cpu_call(pe, ps, policy, **kw):
    phys = ps.physical_state
    state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
    refs = tuple(getattr(pe.env_properties.physical_normalizations, n).normalize(getattr(ps.reference, n))
                 for n in pe.control_state)
    return PCL.kernel_pmsm_closed_loop(pe, state0, phys.omega_el, policy, 4, tau=pe.tau, solver=pe._solver,
                                       props=pe.env_properties, ref_leaves=refs, **kw)


def _foc_tile():
    """The induction machine's FOC tile (family 4), which the PMSM kernel is
    not built with."""
    from exciting_environments_torch.utils.foc import make_foc_tile

    im = P.InductionMachine(batch_size=8, **F64)
    return make_foc_tile(im, psi_ref=0.7, torque_ref=8.0)[0]


def _err_env(**kw):
    pe = P.PMSM(batch_size=8, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                **F64, **kw)
    _, ps = pe.vmap_reset()
    ps.reference.i_d = torch.full((8,), -50.0, dtype=torch.float64)
    ps.reference.i_q = torch.full((8,), 20.0, dtype=torch.float64)
    return pe, ps


ERRORS = {
    "traj states need obs_stride": (lambda pe, ps: pe.fused_closed_loop(ps, p_law, 4, return_traj_states=True),
                                    ValueError, "requires obs_stride"),
    "indivisible stride": (lambda pe, ps: pe.fused_closed_loop(ps, p_law, 6, obs_stride=4), ValueError, "divisible"),
    "sched_lut without carry": (lambda pe, ps: pe.fused_closed_loop(
        ps, p_law, 4, sched_lut=P.ScheduledLUT(np.zeros((10, pe._lut.nx, pe._lut.ny)))), ValueError, "policy_carry"),
    "sched_lut off the grid": (lambda pe, ps: pe.fused_closed_loop(
        ps, pi_law, 4, policy_carry=(ps.physical_state.i_d,) * 2, sched_lut=P.ScheduledLUT(np.zeros((10, 3, 3)))),
        ValueError, "grid"),
    "kernel wants CUDA tensors": (lambda pe, ps: _cpu_call(pe, ps, P.AffinePolicy(K_P)), ValueError, "CUDA tensors"),
    "plain callable on the kernel": (lambda pe, ps: _cpu_call(pe, ps, p_law), ValueError,
                                     "plain callable runs the loop on the CPU only"),
    "family not built": (lambda pe, ps: _cpu_call(pe, ps, _foc_tile()), ValueError, "built with"),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors(case):
    fn, exc, match = ERRORS[case]
    pe, ps = _err_env()
    PCL.PMSM_CL_KERNEL.reset_counts()
    with pytest.raises(exc, match=match):
        fn(pe, ps)
    assert PCL.PMSM_CL_KERNEL.launches == {"pmsm_closed_loop": 0}


def test_out_of_scope_raises_and_select_returns_none():
    pe = P.PMSM(batch_size=8, saturated=True, motor_variant=P.MotorVariant.BRUSA,
                control_state=["i_d", "i_q", "torque", "omega_el", "epsilon"], **F64)
    _, ps = pe.vmap_reset()
    assert not PCL.supports_pmsm_fused_closed_loop(pe)
    assert closed_loop_path(pe) is None
    with pytest.raises(ValueError, match="scope"):
        pe.fused_closed_loop(ps, p_law, 4)
    with pytest.raises(ValueError, match="scope"):
        P.RolloutCollector(pe).collect_policy_fused(p_law, ps, 4)


# ---------------------------------------------------------------------------
# the PPO actor as a compiled family of the PMSM kernel
# ---------------------------------------------------------------------------

CSRC = Path(__file__).resolve().parents[1] / "exciting_environments_torch" / "csrc"


def test_actor_family_is_registered_and_budgeted():
    """Family 1 is the actor (ActorReg<16, 16> and ActorLaw in
    csrc/pmsm_closed_loop/actor.cu); its budget is the JAX gate's 2,048
    parameters and the seed; the argument struct carries its options."""
    from exciting_environments_torch.utils.rl_fused import MAX_ACTOR_PARAMS

    assert PCL.FAMILIES[1] == "ActorPolicy" == P.make_actor_tile(P.Pendulum(batch_size=2, **F64))[0].__class__.__name__
    assert PCL.MAX_POLICY_PARAMS == MAX_ACTOR_PARAMS + 1
    header = (CSRC / "pmsm_closed_loop.cuh").read_text()
    assert f"#define MAX_POLICY_PARAMS ({MAX_ACTOR_PARAMS} + 1)" in header
    names = [f[0] for f in PCL.PmsmClArgs._fields_]
    struct = header[header.index("struct PmsmClArgs {"):header.index("};", header.index("struct PmsmClArgs {"))]
    for field in ("deterministic", "n_layers", "widths"):
        assert field in names and re.search(rf"\b{field}\b", struct)
    unit = (CSRC / "pmsm_closed_loop" / "actor.cu").read_text()
    assert "ActorReg<16, 16>" in unit and "ActorLaw" in unit
    assert "case 1:" in (CSRC / "pmsm_closed_loop.cu").read_text()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_actor_budget_fits_one_block_on_the_saturated_table(dtype):
    """BRUSA's interleaved table plus 2,049 parameters and the 16 rotations
    fit the 227 KB of one block, and the parameters start on a 16-byte
    boundary after the table (ActorReg's 16-byte weight reads)."""
    pe = P.PMSM(batch_size=8, saturated=True, motor_variant=P.MotorVariant.BRUSA, device="cpu", dtype=dtype)
    table = pe._lut.interleaved()
    table_bytes = table.numel() * table.element_size()
    assert table_bytes % 16 == 0
    assert table_bytes + (PCL.MAX_POLICY_PARAMS + 16) * table.element_size() <= PCL.MAX_DYNAMIC_SMEM


def test_actor_vjp_matches_autograd_through_the_plain_loop():
    """PmsmClosedLoopVJP replays the deterministic actor's plain forward: its
    gradient in the weights, log_std and the initial currents equals autograd
    through the plain loop (float64, saturated BRUSA, saves every 4 steps)."""
    from exciting_environments_torch.utils.convert import actor_params_from_numpy

    pe = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, control_state=["i_d", "i_q"],
                **F64)
    rng = np.random.default_rng(8)
    sizes = (10, 16, 16, 2)
    layers = [{"w": rng.normal(0.0, 1.0 / np.sqrt(m), (m, n)), "b": rng.normal(0.0, 0.1, n)}
              for m, n in zip(sizes[:-1], sizes[1:])]
    _, ps = pe.vmap_reset(torch.Generator().manual_seed(3))
    phys = ps.physical_state
    refs = tuple(torch.as_tensor(rng.uniform(-0.9, 0.9, B)) for _ in range(2))
    policy, ids = P.make_actor_tile(pe, deterministic=True)

    def grads(run):
        params = actor_params_from_numpy(pe, {"actor": layers, "log_std": np.full(2, -1.0), "seed": 5.0})
        leaves = [params["actor"][0]["w"], params["actor"][2]["b"], params["log_std"]]
        for leaf in leaves:
            leaf.requires_grad_(True)
        i_d = phys.i_d.clone().requires_grad_(True)
        state0 = (i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
        out = run(pe, state0, phys.omega_el, policy, 8, tau=pe.tau, solver=pe._solver, props=pe.env_properties,
                  ref_leaves=refs, traj_stride=4, policy_params=params, policy_carry=ids)
        loss = sum((t ** 2).sum() for part in out if part is not None for t in part)
        return torch.autograd.grad(loss, leaves + [i_d], allow_unused=True)

    got = grads(PCL.pmsm_closed_loop)
    want = grads(PCL.plain_pmsm_closed_loop)
    # no draw: log_std has no effect (autograd through the plain loop leaves it unused)
    assert want[2] is None and (got[2] is None or float(got[2].abs().max()) == 0.0)
    for a, b in (got[0], want[0]), (got[1], want[1]), (got[3], want[3]):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * max(scale, 1e-300)


# ---------------------------------------------------------------------------
# the affine law's instantiations, chosen on the host from its gains
# ---------------------------------------------------------------------------


def _with(gains, col, value=0.3):
    """``gains`` with ``value`` at ``(0, col)``."""
    out = [list(row) for row in gains]
    out[0][col] = value
    return out


NEG_ZERO = [[-0.0 if g == 0 else g for g in row] for row in K_I]
SKIPPED = range(3, 8)  # torque, cos eps, sin eps, the two buffers
CHOICE_CASES = {
    "PI law on the currents and references": (dict(K=K_P, Ki=K_I), None, "affine_currents"),
    "P law (no Ki)": (dict(K=K_P), None, "affine_currents"),
    "P law with a clamp and a speed gain": (dict(K=_with(K_P, 2), clip=1.0), None, "affine_currents"),
    "negative zeros on the skipped columns": (dict(K=NEG_ZERO, Ki=NEG_ZERO), None, "affine_currents"),
    **{f"K nonzero in column {c}": (dict(K=_with(K_P, c), Ki=K_I), None, "affine_all") for c in SKIPPED},
    **{f"Ki nonzero in column {c}": (dict(K=K_P, Ki=_with(K_I, c)), None, "affine_all") for c in SKIPPED},
    "P law with a torque gain": (dict(K=_with(K_P, 3)), None, "affine_all"),
    "a NaN gain on a skipped column": (dict(K=_with(K_P, 6, float("nan"))), None, "affine_all"),
    "gains given at call time (policy_params)": (dict(K=K_P, Ki=K_I), "flat", "affine_all"),
}


@pytest.mark.parametrize("case", list(CHOICE_CASES))
def test_the_affine_launch_builds_only_the_columns_its_gains_read(case):
    """The host picks ``affine_currents`` exactly where every gain of K and
    Ki on the torque, cos/sin eps and the buffers is zero, and the gains are
    its own: then the plain law is blind to what those columns hold (any
    finite values give its actions and carry under ``torch.equal``), which
    is why the pruned launch that builds none of them equals it."""
    gains, params, want = CHOICE_CASES[case]
    policy = P.AffinePolicy(gains["K"], Ki=gains.get("Ki"), clip=gains.get("clip"))
    params = policy.flat_params() if params == "flat" else None
    assert PCL.kernel_variant(policy, params) == want
    assert PCL.VARIANTS.index(want) in (0, 1) and policy.policy_id == 0
    if want != "affine_currents":
        return
    gen = torch.Generator().manual_seed(12)
    obs = [torch.randn(64, generator=gen, dtype=torch.float32) for _ in range(10)]
    filled = [torch.randn(64, generator=gen, dtype=torch.float32) * 1e3 if i in SKIPPED else x
              for i, x in enumerate(obs)]
    zeroed = [torch.zeros(64) if i in SKIPPED else x for i, x in enumerate(obs)]
    carry = (torch.randn(64, generator=gen),) * 2 if policy.n_carry else ()
    outs = [policy(o, 0, carry) if carry else policy(o, 0) for o in (filled, zeroed)]
    flat = lambda out: [t for part in (out if carry else (out,)) for t in part]
    for a, b in zip(*map(flat, outs)):
        assert torch.equal(a, b)


def test_the_other_families_keep_one_instantiation_each_and_the_struct_ends_with_the_column_set():
    """The actor and the two sensorless tiles are not pruned; the argument
    struct carries the affine law's column set last, as the header declares
    it, and the header's rule reads every column but 3-7 when pruned."""
    tile = lambda policy_id: type("Tile", (), {"policy_id": policy_id})()
    assert PCL.kernel_variant(P.make_actor_tile(P.Pendulum(batch_size=2, **F64))[0]) == "actor"
    assert PCL.kernel_variant(tile(2)) == "sensorless" and PCL.kernel_variant(tile(3)) == "scheduled"
    assert set(PCL.VARIANT_LAUNCHES) == set(PCL.VARIANTS)
    assert PCL.PmsmClArgs._fields_[-1][0] == "affine_columns"
    header = (CSRC / "pmsm_closed_loop.cuh").read_text()
    struct = header[header.index("struct PmsmClArgs {"):header.index("};", header.index("struct PmsmClArgs {"))]
    assert struct.rstrip().splitlines()[-1].split()[:2] == ["int", "affine_columns;"]
    assert "return cols == COLS_ALL || i < 3 || i >= N_BASE_OBS;" in header
    assert PCL.SKIPPED_COLUMNS == slice(3, PCL.N_BASE_OBS)
