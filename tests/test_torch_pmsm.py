"""Parity of the PyTorch port's PMSM modules (transforms, LUT, motor presets,
environment) with the JAX package.

The same numpy inputs (made from a seed) go through both in float64 on the
CPU.  Tolerance rtol = 1e-11, atol = 1e-9: the JAX package's own
interpret-mode figure for the PMSM (tests/test_pallas_pmsm.py), since XLA's
CPU backend contracts FMAs and PyTorch eager does not.  The golden fixture
replays with the JAX test's own ``allclose(generated, stored, 1e-8)``.
"""

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
from exciting_environments_tpu.ops import lut as jlut
from exciting_environments_tpu.ops import transforms as jtr
from exciting_environments_torch.ops import lut as plut
from exciting_environments_torch.ops import transforms as ptr
from exciting_environments_torch.utils import load_sim_properties_from_json
from exciting_environments_torch.utils.convert import lut_values, properties_from_numpy, state_from_numpy

TOL = dict(rtol=1e-11, atol=1e-9)
F64 = dict(device="cpu", dtype=torch.float64)
FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")
B, T = 16, 12
# (variant, saturated)
DRIVES = [("BRUSA", True), ("SEW", True), ("DEFAULT", False)]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port.detach().cpu().numpy(), np.float64),
                               np.asarray(ref, np.float64), **tol)


def _static(variant, saturated, **overrides):
    params = dict(J.MotorVariant[variant].get_params().static_params.__dict__)
    if saturated:
        params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
    params.update(overrides)
    return params


def _pair(variant, saturated, solver="euler", batch=B, static=None, **kwargs):
    je = J.PMSM(batch_size=batch, saturated=saturated, motor_variant=J.MotorVariant[variant], solver=solver,
                static_params=static, **kwargs)
    pe = P.PMSM(batch_size=batch, saturated=saturated, motor_variant=P.MotorVariant[variant], solver=solver,
                static_params=static, **kwargs, **F64)
    return je, pe


def _states(je, pe, seed):
    """The same random physical state on both sides, buffers included."""
    rng = np.random.default_rng(seed)
    norms = pe.env_properties.physical_normalizations
    n = pe.batch_size
    x0 = {
        "u_d_buffer": rng.uniform(-100, 100, n),
        "u_q_buffer": rng.uniform(-100, 100, n),
        "epsilon": rng.uniform(-math.pi, math.pi, n),
        "i_d": rng.uniform(0.8 * norms.i_d.min, 0, n),
        "i_q": rng.uniform(0.8 * norms.i_q.min, 0.8 * norms.i_q.max, n),
        "torque": np.zeros(n),
        "omega_el": rng.uniform(0, norms.omega_el.max, n),
    }
    _, js = je.vmap_reset()
    with jstructures.copy_and_mutate(js) as js:
        for name, v in x0.items():
            setattr(js.physical_state, name, jnp.asarray(v))
    return js, state_from_numpy(pe, x0)


def _actions(seed, n=T, batch=B, lim=0.6):
    return np.random.default_rng(seed).uniform(-lim, lim, (batch, n, 2))


def _close_phys(ps, js, tol=TOL):
    for name in FIELDS:
        _close(getattr(ps.physical_state, name), getattr(js.physical_state, name), tol)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def test_transforms_match_jax_at_random_angles():
    rng = np.random.default_rng(0)
    n = 256
    u = rng.uniform(-2, 2, (n, 2))
    eps = rng.uniform(-4, 4, n)
    omega = rng.uniform(0, 3000, n)
    ut, et, wt = (torch.as_tensor(a) for a in (u, eps, omega))
    _close(ptr.t_dq_alpha_beta(et), jax.vmap(jtr.t_dq_alpha_beta)(eps))
    _close(ptr.dq2albet(ut, et), jax.vmap(jtr.dq2albet)(u, eps))
    _close(ptr.albet2dq(ut, et), jax.vmap(jtr.albet2dq)(u, eps))
    _close(ptr.dq2abc(ut, et), jax.vmap(jtr.dq2abc)(u, eps))
    u_abc = rng.uniform(-2, 2, (n, 3))
    _close(ptr.abc2dq(torch.as_tensor(u_abc), et), jax.vmap(jtr.abc2dq)(u_abc, eps).reshape(n, 2))
    for scale in (1.0, 1.5):
        _close(ptr.step_eps(et, wt, 1e-4, scale), jtr.step_eps(jnp.asarray(eps), omega, 1e-4, scale))
    _close(ptr.apply_hex_constraint(ut), jax.vmap(jtr.apply_hex_constraint)(u).reshape(n, 2))
    _close(ptr.clip_in_abc_coordinates(ut, 400.0, wt, et, 1e-4),
           jax.vmap(jtr.clip_in_abc_coordinates, in_axes=(0, None, 0, 0, None))(u, 400.0, omega, eps, 1e-4))
    assert ptr.ROTATION_RE.dtype == np.float32
    assert np.array_equal(ptr.ROTATION_RE, jtr.ROTATION_RE) and np.array_equal(ptr.ROTATION_IM, jtr.ROTATION_IM)


@pytest.mark.parametrize("magnitude", [0.5, 1.0, 3.0])
def test_hex_constraint_matches_jax_at_sector_boundaries(magnitude):
    """Phasors exactly on the sector boundaries (multiples of 60 degrees),
    inside and outside the hexagon, and the angle wrap at pi."""
    k = np.arange(-6, 7)
    angle = k * np.pi / 3
    u = magnitude * np.stack([np.cos(angle), np.sin(angle)], axis=-1)
    out = ptr.apply_hex_constraint(torch.as_tensor(u))
    _close(out, jax.vmap(jtr.apply_hex_constraint)(u).reshape(len(k), 2))
    assert bool((out.norm(dim=-1) <= 4 / 3 + 1e-12).all())
    eps = torch.as_tensor(angle)
    _close(ptr.step_eps(eps, torch.zeros_like(eps), 1e-4), jtr.step_eps(jnp.asarray(angle), 0.0, 1e-4))


# ---------------------------------------------------------------------------
# lookup tables and presets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["BRUSA", "SEW"])
def test_build_pmsm_lut_equals_jax(variant):
    raw = J.MotorVariant[variant].get_params().pmsm_lut
    j_lut, j_proc = jlut.build_pmsm_lut(raw)
    p_lut, p_proc = plut.build_pmsm_lut(P.MotorVariant[variant].get_params().pmsm_lut, dtype=torch.float64)
    assert np.array_equal(p_lut.values.numpy(), np.asarray(j_lut.values))
    assert (p_lut.x0, p_lut.dx, p_lut.y0, p_lut.dy, p_lut.nx, p_lut.ny) == (
        j_lut.x0, j_lut.dx, j_lut.y0, j_lut.dy, j_lut.nx, j_lut.ny)
    for q in plut.SATURATED_QUANTITIES:
        assert np.array_equal(p_proc[q], j_proc[q])
    je, pe = _pair(variant, True, batch=2)
    assert np.array_equal(lut_values(pe), np.asarray(je._lut.values))


@pytest.mark.parametrize("variant", ["BRUSA", "SEW"])
def test_bilinear_gather_matches_jax_inside_and_beyond_the_grid(variant):
    je, pe = _pair(variant, True, batch=2)
    lut = je._lut
    rng = np.random.default_rng(1)
    span_x, span_y = lut.dx * (lut.nx - 1), lut.dy * (lut.ny - 1)
    px = rng.uniform(lut.x0 - 0.3 * span_x, lut.x0 + 1.3 * span_x, 512)
    py = rng.uniform(lut.y0 - 0.3 * span_y, lut.y0 + 1.3 * span_y, 512)
    ref = jlut.bilinear_gather(lut.values, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny,
                               jnp.asarray(px), jnp.asarray(py))
    _close(pe._lut.interpolate_all(torch.as_tensor(px), torch.as_tensor(py)), ref)
    point = np.array([-100.0, 50.0])
    _close(pe.LUT_interpolators["Psi_d"](torch.as_tensor(point)), je.LUT_interpolators["Psi_d"](jnp.asarray(point)))


@pytest.mark.parametrize("variant", ["DEFAULT", "BRUSA", "SEW"])
def test_motor_presets_equal_jax(variant):
    jp, pp = J.MotorVariant[variant].get_params(), P.MotorVariant[variant].get_params()
    assert pp.static_params.__dict__ == jp.static_params.__dict__
    for group in ("physical_normalizations", "action_normalizations"):
        for name, norm in getattr(jp, group).__dict__.items():
            port = getattr(getattr(pp, group), name)
            assert (port.min, port.max) == (norm.min, norm.max), (group, name)
    with pytest.raises(ValueError, match="DEFAULT is only valid"):
        P.PMSM(saturated=True, **F64)


# ---------------------------------------------------------------------------
# the environment against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,saturated", DRIVES)
@pytest.mark.parametrize("deadtime", [0, 1])
def test_vmap_rollout_matches_jax(variant, saturated, deadtime):
    je, pe = _pair(variant, saturated, "euler", static=_static(variant, saturated, deadtime=deadtime))
    js, ps = _states(je, pe, 2)
    acts = _actions(3)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), 3)
    po, pl = pe.vmap_rollout(ps, torch.as_tensor(acts), 3)
    assert tuple(po.shape) == tuple(jo.shape) == (B, T // 3, 8)
    _close(po, jo)
    _close_phys(pl, jl)


@pytest.mark.parametrize("variant,saturated", DRIVES)
@pytest.mark.parametrize("deadtime", [0, 1])
def test_vmap_sim_ahead_matches_jax(variant, saturated, deadtime):
    je, pe = _pair(variant, saturated, "euler", static=_static(variant, saturated, deadtime=deadtime))
    js, ps = _states(je, pe, 4)
    acts = _actions(5)
    jo, jst, jl = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau, je.tau)
    po, pst, pl = pe.vmap_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau)
    assert tuple(po.shape) == tuple(jo.shape) == (B, T + 1, 8)
    _close(po, jo)
    _close_phys(pst, jst)
    _close_phys(pl, jl)


def test_sim_ahead_tsit5_carry_and_inverted_ratio_quirk_match_jax():
    je, pe = _pair("DEFAULT", False, "tsit5")
    js, ps = _states(je, pe, 6)
    acts = _actions(7)
    jo, jst, jl = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau, je.tau)
    po, pst, pl = pe.vmap_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau)
    _close(po, jo)
    for k_p, k_j in zip(pl.additions.solver_state, jl.additions.solver_state):
        _close(k_p, k_j)
    # a finer observation grid breaks the buffer patch, as in the reference
    with pytest.raises(RuntimeError):
        pe.vmap_sim_ahead(ps, torch.as_tensor(acts), pe.tau / 2, pe.tau)


def test_rewards_and_flags_ahead_match_jax():
    control = ["i_d", "i_q", "torque"]
    je, pe = _pair("BRUSA", True, control_state=control)
    js, ps = _states(je, pe, 8)
    rng = np.random.default_rng(9)
    refs = {"i_d": rng.uniform(-200, 0, B), "i_q": rng.uniform(-200, 200, B), "torque": rng.uniform(-100, 100, B)}
    with jstructures.copy_and_mutate(js) as js:
        for name, v in refs.items():
            setattr(js.reference, name, jnp.asarray(v))
    for name, v in refs.items():
        setattr(ps.reference, name, torch.as_tensor(v))
    acts = _actions(10)
    jo, jst, _ = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau, je.tau)
    po, pst, _ = pe.vmap_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau)
    _close(po, jo)
    j_out = je.vmap_generate_rew_trunc_term_ahead(jst, jnp.asarray(acts))
    p_out = pe.vmap_generate_rew_trunc_term_ahead(pst, torch.as_tensor(acts))
    for p, j in zip(p_out, j_out):
        assert tuple(p.shape) == tuple(j.shape)
        _close(p, j)
    # the step-mode reward on tracked references
    jr = jax.vmap(je.generate_reward, in_axes=(0, None, None))(js, None, je.env_properties)
    _close(pe.generate_reward(ps, None, pe.env_properties), jr)


@pytest.mark.parametrize("variant,saturated", DRIVES)
def test_default_reset_round_trip_and_soft_constraints_match_jax(variant, saturated):
    je, pe = _pair(variant, saturated, "tsit5")
    jo, js0 = je.vmap_reset()
    po, ps0 = pe.vmap_reset()
    _close(po, jo)
    js, ps = _states(je, pe, 11)
    jo, po = je.vmap_reset(initial_state=js)[0], pe.vmap_reset(initial_state=ps)[0]
    _close(po, jo)
    back = pe.vmap_generate_state_from_observation(po)
    j_back = je.vmap_generate_state_from_observation(jo)
    _close_phys(back, j_back)
    assert len(back.additions.solver_state) == 3 and bool(torch.isnan(back.additions.solver_state[0]).all())
    j_soft = jax.vmap(je.soft_constraints, in_axes=(0, None, None))(js, None, je.env_properties)
    p_soft = pe.soft_constraints(ps, None, pe.env_properties)
    for name in FIELDS:
        _close(getattr(p_soft[0], name), getattr(j_soft[0], name))
    j_trunc = jax.vmap(je.generate_truncated, in_axes=(0, None))(js, je.env_properties)
    _close(pe.generate_truncated(ps, pe.env_properties), j_trunc)


@pytest.mark.parametrize("variant,saturated", DRIVES)
def test_generator_reset_draws_the_admissible_disc(variant, saturated):
    _, pe = _pair(variant, saturated)
    pe.batch_size = 4096
    _, state = pe.vmap_reset(rng=torch.Generator().manual_seed(3))
    _, again = pe.vmap_reset(rng=torch.Generator().manual_seed(3))
    phys, norms = state.physical_state, pe.env_properties.physical_normalizations
    assert torch.equal(phys.i_d, again.physical_state.i_d)
    assert bool((phys.i_d <= norms.i_d.max).all() and (phys.i_d >= norms.i_d.min).all())
    assert bool((phys.i_q.abs() <= norms.i_q.max).all())
    assert bool((phys.omega_el >= 0).all() and (phys.omega_el <= norms.omega_el.max).all())
    _close(phys.torque, pe._torque(phys.i_d, phys.i_q, pe.env_properties), dict(rtol=0, atol=0))
    i_max = max(abs(norms.i_d.min), abs(norms.i_q.max))
    # the unfolded draw is uniform in the disc: the mean squared radius of
    # the folded currents stays i_max**2 / 2 (folding preserves the radius)
    r2 = (phys.i_d**2 + phys.i_q**2) / i_max**2
    assert abs(float(r2.mean()) - 0.5) < 0.03


def test_single_instance_step_and_sim_ahead_match_jax():
    je, pe = _pair("BRUSA", True, "rk4")
    js, ps = _states(je, pe, 12)
    j1 = jax.tree_util.tree_map(lambda leaf: leaf[0], js)
    p1 = P.core.structures.map_leaves(
        lambda leaf: leaf[0] if isinstance(leaf, torch.Tensor) and leaf.ndim else leaf, ps)
    a = _actions(13, batch=1)[0]
    jo, js1 = je.step(j1, jnp.asarray(a[0]), je.env_properties)
    po, ps1 = pe.step(p1, torch.as_tensor(a[0]), pe.env_properties)
    _close(po, jo)
    _close_phys(ps1, js1)
    jo, _, _ = je.sim_ahead(j1, jnp.asarray(a), je.env_properties, je.tau, je.tau)
    po, _, _ = pe.sim_ahead(p1, torch.as_tensor(a), pe.env_properties, pe.tau, pe.tau)
    _close(po, jo)


def test_per_batch_parameters_match_jax():
    rng = np.random.default_rng(14)
    r_s, l_d = rng.uniform(15e-3, 21e-3, B), rng.uniform(0.3e-3, 0.45e-3, B)
    for variant, saturated, extra in (("BRUSA", True, {"r_s": r_s}), ("DEFAULT", False, {"l_d": l_d, "r_s": r_s})):
        je = J.PMSM(batch_size=B, saturated=saturated, motor_variant=J.MotorVariant[variant],
                    static_params=_static(variant, saturated, **{k: jnp.asarray(v) for k, v in extra.items()}))
        pe = P.PMSM(batch_size=B, saturated=saturated, motor_variant=P.MotorVariant[variant],
                    static_params=_static(variant, saturated, **extra), **F64)
        js, ps = _states(je, pe, 15)
        acts = _actions(16)
        jo, jl = je.vmap_rollout(js, jnp.asarray(acts), 4)
        po, pl = pe.vmap_rollout(ps, torch.as_tensor(acts), 4)
        _close(po, jo)
        _close_phys(pl, jl)


def test_registry_convert_and_unported_options():
    assert P.EnvironmentRegistry.PMSM.value == J.EnvironmentRegistry.PMSM.value == "PMSM-v0"
    env = P.EnvironmentRegistry.PMSM.make(batch_size=3, **F64)
    assert type(env).__name__ == "PMSM" and env.obs_description.tolist()[:4] == ["i_d", "i_q", "omega_el", "torque"]
    # the noise options are validated as in the JAX package: currents only
    # take process noise, the measured columns sensor noise
    for kwargs in ({"process_noise": {"i_d": 1.0}}, {"observation_noise": {"torque": 1.0}}, {"noise_mode": "fast"}):
        assert P.PMSM(**kwargs, **F64)._noise_mode in ("exact", "fast")
    for kwargs, match in (({"process_noise": {"epsilon": 1.0}}, "not one of"),
                          ({"observation_noise": {"epsilon": 1.0}}, "not one of"),
                          ({"noise_mode": "bogus"}, "noise_mode")):
        with pytest.raises(ValueError, match=match):
            P.PMSM(**kwargs, **F64)
    pe = P.PMSM(batch_size=3, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver="tsit5", **F64)
    norms = {f: (-1.0, 1.0) for f in FIELDS}
    props = properties_from_numpy(pe, _static("BRUSA", True, r_s=np.array([0.01, 0.02, 0.03])), norms,
                                  {"u_d": (-200, 200), "u_q": (-200, 200)})
    assert props.saturated is True and isinstance(props.static_params.r_s, torch.Tensor)
    assert properties_from_numpy(pe, _static("BRUSA", True), norms, {"u_d": (-1, 1), "u_q": (-1, 1)},
                                 saturated=False).saturated is False
    with pytest.raises(ValueError, match="no saturated flag"):
        properties_from_numpy(P.Pendulum(batch_size=1, **F64), {"g": 9.81, "l": 1, "m": 1},
                              {"theta": (-1, 1), "omega": (-1, 1)}, {"torque": (-1, 1)}, saturated=True)
    state = state_from_numpy(pe, {f: np.zeros(3) for f in FIELDS})
    assert len(state.additions.solver_state) == 3 and state.additions.active_solver_state is False
    with pytest.raises(ValueError, match="no magnetics table"):
        lut_values(P.PMSM(batch_size=1, **F64))


# ---------------------------------------------------------------------------
# golden fixture (reference diffrax Euler, float64)
# ---------------------------------------------------------------------------


def test_golden_pmsm_replay_through_port():
    data_dir = Path(__file__).parent / "envs" / "pmsm" / "data"
    params, action_norms, physical_norms, tau = load_sim_properties_from_json(
        os.path.join(data_dir, "sim_properties.json")
    )
    env = P.EnvironmentRegistry.PMSM.make(tau=tau, solver="euler", static_params=params,
                                          physical_normalizations=physical_norms,
                                          action_normalizations=action_norms, **F64)
    stored = torch.as_tensor(np.load(data_dir / "observations.npy"))
    actions = torch.as_tensor(np.load(data_dir / "actions.npy"))
    state = env.generate_state_from_observation(stored[0], env.env_properties)
    generated = [stored[0]]
    for i in range(1000):
        obs, state = env.step(state, actions[i], env.env_properties)
        generated.append(obs)
    generated = torch.stack(generated)
    assert torch.allclose(generated, stored, 1e-8), "pmsm: replayed observations deviate from the reference fixture"
