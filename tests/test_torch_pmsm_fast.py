"""The port's trig-free PMSM rollout (``ops/pmsm_fast.py``, and the fast
kernel's entry point on CPU tensors, where it runs the plain version)
against the JAX package's XLA fast path and its Pallas kernel in interpret
mode.

Same numpy inputs on both sides, float64 on the CPU.  Tolerances: the
hexagon clip at rtol = atol = 1e-12; rollouts at rtol = 1e-10, atol = 1e-9
(XLA's CPU backend contracts multiply-add chains into FMAs, PyTorch eager
does not, and the rotation carry and the Euler step carry such ulps over 32
steps).  The kernel itself runs only on a CUDA card: tests/test_torch_gpu.py
holds it against this plain version there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops import pmsm_fast as jfast
from exciting_environments_tpu.ops.pallas.pmsm_fast_kernel import pmsm_fast_fused_rollout as j_fused
from exciting_environments_torch.ops import pmsm_fast as PF
from exciting_environments_torch.ops.kernels.pmsm_fast_kernel import pmsm_fast_fused_rollout
from exciting_environments_torch.ops.kernels.pmsm_stepper import _eps_trajectory
from exciting_environments_torch.utils.convert import state_from_numpy

TOL = dict(rtol=1e-10, atol=1e-9)
F64 = dict(device="cpu", dtype=torch.float64)
FIELDS = ("i_d", "i_q", "epsilon", "torque", "u_d_buffer", "u_q_buffer")


def _pair(variant="BRUSA", saturated=True, batch=256, **overrides):
    static = None
    if overrides:
        static = dict(J.MotorVariant[variant].get_params().static_params.__dict__)
        if saturated:
            static.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
        static.update(overrides)
    je = J.PMSM(batch_size=batch, saturated=saturated, motor_variant=J.MotorVariant[variant], static_params=static)
    pe = P.PMSM(batch_size=batch, saturated=saturated, motor_variant=P.MotorVariant[variant], static_params=static,
                **F64)
    return je, pe


def _states(je, pe, seed):
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


def _actions(seed, batch, n, lim=0.4):
    return np.random.default_rng(seed).uniform(-lim, lim, (batch, n, 2))


def _close_fields(ps, js, tol=TOL):
    for name in FIELDS:
        np.testing.assert_allclose(getattr(ps.physical_state, name).numpy(),
                                   np.asarray(getattr(js.physical_state, name)), err_msg=name, **tol)


def test_hex_clip_fast_matches_jax_on_every_sector_boundary():
    rng = np.random.default_rng(0)
    # the six sector boundaries and their neighbours, inside, on and outside
    # the hexagon, plus random phasors and the origin
    angles = np.concatenate([np.arange(12) * np.pi / 6, np.arange(6) * np.pi / 3 + 1e-9,
                             np.arange(6) * np.pi / 3 - 1e-9, rng.uniform(-np.pi, np.pi, 200)])
    radii = np.array([0.0, 0.3, 2 / 3, 1.0, 1.5])
    r, a = np.meshgrid(radii, angles)
    alpha, beta = (r * np.cos(a)).ravel(), (r * np.sin(a)).ravel()
    oa, ob = PF.hex_clip_fast(torch.as_tensor(alpha), torch.as_tensor(beta))
    ja, jb = jfast.hex_clip_fast(jnp.asarray(alpha), jnp.asarray(beta))
    np.testing.assert_allclose(oa.numpy(), np.asarray(ja), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ob.numpy(), np.asarray(jb), rtol=1e-12, atol=1e-12)
    # the direct table index and JAX's multilinear combination agree for bits in {0, 1}
    for bits in np.ndindex(2, 2, 2):
        b = [jnp.asarray(float(x)) for x in bits]
        for table in (P.ops.transforms.ROTATION_RE, P.ops.transforms.ROTATION_IM):
            assert float(jfast._multilinear_table(table, *b)) == float(table[bits])


@pytest.mark.parametrize("variant,saturated", [("DEFAULT", False), ("BRUSA", True)])
@pytest.mark.parametrize("deadtime", [0, 1])
def test_pmsm_fast_rollout_matches_jax_fast_path(variant, saturated, deadtime):
    B, T = 256, 32
    je, pe = _pair(variant, saturated, B, deadtime=deadtime)
    js, ps = _states(je, pe, 1)
    acts = _actions(2, B, T)
    jl = jfast.pmsm_fast_rollout(je, js, jnp.asarray(acts))
    pl = PF.pmsm_fast_rollout(pe, ps, torch.as_tensor(acts))
    _close_fields(pl, jl)
    # the fused entry point on CPU tensors runs the same plain version
    fl = pmsm_fast_fused_rollout(pe, ps, torch.as_tensor(acts))
    for name in FIELDS:
        assert torch.equal(getattr(fl.physical_state, name), getattr(pl.physical_state, name)), name


def test_fused_entry_matches_jax_pallas_kernel_in_interpret_mode():
    B, T = 1024, 8
    je, pe = _pair("BRUSA", True, B)
    js, ps = _states(je, pe, 3)
    acts = _actions(4, B, T)
    jl = j_fused(je, js, jnp.asarray(acts), gather="take", interpret=True)
    pl = pmsm_fast_fused_rollout(pe, ps, torch.as_tensor(acts))
    _close_fields(pl, jl)
    np.testing.assert_array_equal(pl.physical_state.omega_el.numpy(), np.asarray(jl.physical_state.omega_el))


def test_fast_rollout_returns_the_jax_state_structure_and_layouts_agree():
    B, T = 64, 16
    je, pe = _pair("SEW", True, B)
    js, ps = _states(je, pe, 5)
    acts = _actions(6, B, T)
    jl = jfast.pmsm_fast_rollout(je, js, jnp.asarray(acts))
    pl = pe.fast_rollout(ps, torch.as_tensor(acts))
    tm = pe.fast_rollout(ps, torch.as_tensor(acts).transpose(0, 1), time_major=True)
    assert pl.additions.solver_state is None and jl.additions.solver_state is None
    assert tuple(pl.additions.active_solver_state.shape) == tuple(jl.additions.active_solver_state.shape) == (B,)
    assert bool(pl.additions.active_solver_state.all())
    for name in P.PMSM.PhysicalState.__dataclass_fields__:
        leaf = getattr(pl.physical_state, name)
        assert tuple(leaf.shape) == tuple(np.shape(getattr(jl.physical_state, name))) == (B,), name
        assert leaf.dtype == torch.float64
        assert torch.equal(leaf, getattr(tm.physical_state, name)), name
    _close_fields(pl, jl)


def test_fast_path_tracks_the_exact_path_on_brusa():
    """The JAX test's envelope (tests/test_pmsm_fast_kernel.py): fast vs exact
    within 1e-4 of the current scale over 32 steps."""
    B, T = 256, 32
    _, pe = _pair("BRUSA", True, B)
    _, state = pe.vmap_reset(rng=torch.Generator().manual_seed(0))
    acts = torch.as_tensor(_actions(7, B, T))
    _, exact = pe.vmap_rollout(state, acts, T)
    fast = pe.fast_rollout(state, acts)
    for name in ("i_d", "i_q"):
        ref, got = getattr(exact.physical_state, name), getattr(fast.physical_state, name)
        scale = max(1.0, float(ref.abs().max()))
        assert float((ref - got).abs().max()) / scale < 1e-4, name


def test_fast_path_tracks_the_exact_path_over_256_float32_steps_inside_the_bands():
    """A BRUSA fleet held at its start currents (spread over the inner 80% of
    the bands, so the gathers cover the table) by the steady-state voltages
    plus a dither: fast vs exact within 1e-3 of the current scale over 256
    float32 steps, and no drive leaves its bands."""
    B, T = 512, 256
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, tau=1e-4, device="cpu")
    pn = env.env_properties.physical_normalizations
    rng = np.random.default_rng(8)
    i_d = rng.uniform(0.1, 0.9, B) * pn.i_d.min
    i_q = rng.uniform(-0.8, 0.8, B) * pn.i_q.max
    omega = rng.uniform(0, 0.3, B) * pn.omega_el.max
    lut = env._lut
    vals = P.ops.lut.bilinear_gather(lut.values.double(), lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny,
                                     torch.as_tensor(i_d), torch.as_tensor(i_q))
    r_s = float(env.env_properties.static_params.r_s)
    u_d = r_s * i_d - omega * vals[5].numpy()
    u_q = r_s * i_q + omega * vals[4].numpy()
    u_max = env.env_properties.action_normalizations.u_d.max
    hold = np.stack([u_d, u_q], -1) / u_max
    acts = torch.as_tensor(hold[:, None, :] + rng.uniform(-0.005, 0.005, (B, T, 2)), dtype=torch.float32)
    state = state_from_numpy(env, {"i_d": i_d, "i_q": i_q, "omega_el": omega, "u_d_buffer": u_d, "u_q_buffer": u_q,
                                   "epsilon": rng.uniform(-math.pi, math.pi, B), "torque": np.zeros(B)})
    _, exact = env.fused_rollout(state, acts)
    fast = env.fast_rollout(state, acts)
    e, f = exact.physical_state, fast.physical_state
    assert bool(((e.i_d >= pn.i_d.min) & (e.i_d <= pn.i_d.max) & (e.i_q.abs() <= pn.i_q.max)).all())
    scale = max(1.0, float(e.i_d.abs().max()), float(e.i_q.abs().max()))
    for name in ("i_d", "i_q"):
        assert float((getattr(e, name) - getattr(f, name)).abs().max()) / scale < 1e-3, name


def test_rotation_carry_float32_drift_stays_within_the_exact_angle_recurrence():
    """Over 256 float32 steps the carried rotation's angle strays from its
    float64 twin by no more than the exact path's angle recurrence
    (``_eps_trajectory``) strays from its own: the carry adds no float32
    error beyond the exact path's, so a float32 fast-vs-exact gap on a fleet
    that runs away is rounding that the runaway grows."""
    B, T = 1024, 256
    env = P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA, tau=1e-4, device="cpu")
    consts = PF.fast_constants(env)
    rng = np.random.default_rng(9)
    eps32 = torch.as_tensor(rng.uniform(-math.pi, math.pi, B), dtype=torch.float32)
    omega32 = torch.as_tensor(rng.uniform(0, env.env_properties.physical_normalizations.omega_el.max, B),
                              dtype=torch.float32)
    carry, seq = {}, {}
    for dtype in (torch.float32, torch.float64):
        eps, omega = eps32.to(dtype), omega32.to(dtype)
        cA, sA, c_delta, s_delta = PF.fast_start(eps, omega, consts)
        angles = []
        for _ in range(T):
            angles.append(torch.atan2(sA.double(), cA.double()))
            cA, sA = PF.advance_rotation(cA, sA, c_delta, s_delta)
        carry[dtype] = torch.stack(angles)
        seq[dtype] = _eps_trajectory(eps, omega, env.tau, T, env._solver)[0].double()
    wrapped = lambda d: float(torch.remainder(d + math.pi, 2 * math.pi).sub(math.pi).abs().max())
    carry_err = wrapped(carry[torch.float32] - carry[torch.float64])
    seq_err = wrapped(seq[torch.float32] - seq[torch.float64])
    assert 0.0 < carry_err <= seq_err, (carry_err, seq_err)


def test_out_of_scope_drives_raise():
    acts = torch.zeros((16, 4, 2), dtype=torch.float64)

    def run(env):
        _, state = env.vmap_reset()
        return env.fast_rollout(state, acts)

    with pytest.raises(ValueError):
        run(P.PMSM(batch_size=16, motor_variant=P.MotorVariant.DEFAULT, solver="tsit5", **F64))
    static = dict(P.MotorVariant.DEFAULT.get_params().static_params.__dict__, r_s=np.linspace(0.01, 0.02, 16))
    with pytest.raises(ValueError, match="per-batch"):
        run(P.PMSM(batch_size=16, static_params=static, **F64))
    static = dict(P.MotorVariant.DEFAULT.get_params().static_params.__dict__, deadtime=2)
    with pytest.raises(ValueError):
        run(P.PMSM(batch_size=16, static_params=static, **F64))
    env = P.PMSM(batch_size=16, saturated=True, motor_variant=P.MotorVariant.BRUSA, **F64)
    _, state = env.vmap_reset()
    with pytest.raises(ValueError, match="fused kernels' scope"):
        pmsm_fast_fused_rollout(P.PMSM(batch_size=16, static_params=static, **F64), state, acts)


@pytest.mark.parametrize("time_major", [False, True])
def test_linear_fast_rollout_alias_matches_jax_and_refuses_saturation(time_major):
    """``pmsm_linear_fast_rollout`` is ``PMSM.fast_rollout`` (the kernel on the
    card, its plain version here) for linear magnetics, and raises for a
    saturated drive, as the JAX package's alias does."""
    B, T = 256, 16
    je, pe = _pair("DEFAULT", False, B, deadtime=1)
    js, ps = _states(je, pe, 5)
    acts = _actions(6, B, T)
    jacts = jnp.asarray(acts.transpose(1, 0, 2) if time_major else acts)
    tacts = torch.as_tensor(acts).transpose(0, 1).contiguous() if time_major else torch.as_tensor(acts)
    jl = jfast.pmsm_linear_fast_rollout(je, js, jacts, time_major=time_major)
    pl = PF.pmsm_linear_fast_rollout(pe, ps, tacts, time_major=time_major)
    _close_fields(pl, jl)
    fl = pe.fast_rollout(ps, tacts, time_major=time_major)
    for name in FIELDS:
        assert torch.equal(getattr(fl.physical_state, name), getattr(pl.physical_state, name)), name
    je_s, pe_s = _pair("BRUSA", True, B)
    _, ps_s = _states(je_s, pe_s, 5)
    with pytest.raises(ValueError, match="linear magnetics only"):
        PF.pmsm_linear_fast_rollout(pe_s, ps_s, torch.as_tensor(acts))
    with pytest.raises(ValueError, match="linear magnetics only"):
        jfast.pmsm_linear_fast_rollout(je_s, _states(je_s, pe_s, 5)[0], jnp.asarray(acts))
