"""The port's fused PMSM path (the pre-pass, and the kernel's plain version on
CPU tensors) against the JAX package: its scan, its pre-pass helpers, and
its Pallas PMSM kernel in interpret mode.

Same numpy inputs on both sides, float64 on the CPU; tolerance rtol = 1e-11,
atol = 1e-9, the JAX package's own interpret-mode figure
(tests/test_pallas_pmsm.py).  The kernel itself runs only on a CUDA card:
tests/test_torch_gpu.py holds it against this plain version there.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exciting_environments_tpu as J
import exciting_environments_torch as P
from exciting_environments_tpu.core import structures as jstructures
from exciting_environments_tpu.ops.pallas import pmsm_stepper as jpk
from exciting_environments_torch.core import structures as pstructures
from exciting_environments_torch.models.pmsm.pmsm_env import extrapolated_angles
from exciting_environments_torch.ops.kernels import pmsm_stepper as PK
from exciting_environments_torch.ops.kernels import rollout_path
from exciting_environments_torch.utils.convert import state_from_numpy

TOL = dict(rtol=1e-11, atol=1e-9)
F64 = dict(device="cpu", dtype=torch.float64)
FIELDS = ("u_d_buffer", "u_q_buffer", "epsilon", "i_d", "i_q", "torque", "omega_el")
B, T = 32, 8


def _close(port, ref):
    np.testing.assert_allclose(port.detach().cpu().numpy(), np.asarray(ref), **TOL)


def _static(variant, saturated, **overrides):
    params = dict(J.MotorVariant[variant].get_params().static_params.__dict__)
    if saturated:
        params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
    params.update(overrides)
    return params


def _pair(variant="BRUSA", saturated=True, solver="euler", batch=B, jax_static=None, torch_static=None):
    je = J.PMSM(batch_size=batch, saturated=saturated, motor_variant=J.MotorVariant[variant], solver=solver,
                static_params=jax_static)
    pe = P.PMSM(batch_size=batch, saturated=saturated, motor_variant=P.MotorVariant[variant], solver=solver,
                static_params=torch_static if torch_static is not None else jax_static, **F64)
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


def _actions(seed, n=T, batch=B, lim=0.6):
    return np.random.default_rng(seed).uniform(-lim, lim, (batch, n, 2))


def _close_phys(ps, js):
    for name in FIELDS:
        _close(getattr(ps.physical_state, name), getattr(js.physical_state, name))


# ---------------------------------------------------------------------------
# the pre-pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("solver", ["euler", "rk4", "tsit5"])
def test_constraint_prepass_matches_jax(solver):
    je, pe = _pair(solver=solver)
    js, ps = _states(je, pe, 0)
    acts_tm = _actions(1).transpose(1, 0, 2)
    eps0, omega = np.array(js.physical_state.epsilon), np.array(js.physical_state.omega_el)
    j_seq, j_final = jpk._eps_trajectory(jnp.asarray(eps0), jnp.asarray(omega), je.tau, T, je._solver)
    p_seq, p_final = PK._eps_trajectory(torch.as_tensor(eps0), torch.as_tensor(omega), pe.tau, T, pe._solver)
    _close(p_seq, j_seq)
    _close(p_final, j_final)
    j_con = jpk._constraint_denorm_batched(je, je.env_properties, jnp.asarray(acts_tm), j_seq, jnp.asarray(omega)[None])
    p_con = PK._constraint_denorm_batched(pe, pe.env_properties, torch.as_tensor(acts_tm), p_seq,
                                          torch.as_tensor(omega))
    _close(p_con, j_con)
    # the environment's own method, one step at a time
    js_t = jax.tree_util.tree_map(lambda leaf: leaf, js)
    with jstructures.copy_and_mutate(js_t) as js_t:
        js_t.physical_state.epsilon = j_seq[3]
    j_one = jax.vmap(je.constraint_denormalization, in_axes=(0, 0, None))(
        jnp.asarray(acts_tm[3]), js_t, je.env_properties)
    _close(p_con[3], j_one)
    u_con, eps_seq, eps_final = PK._constrained_voltages(pe, ps, torch.as_tensor(acts_tm), pe.env_properties)
    assert torch.equal(u_con, p_con) and torch.equal(eps_seq, p_seq) and torch.equal(eps_final, p_final)


def test_sim_ahead_angle_extrapolation_is_jnp_linspace():
    """The helper evaluates jnp.linspace's own formula op by op, bit for bit;
    XLA's compiled linspace rounds some entries by up to one ulp."""
    for n in (1, 2, 7, 256):
        for dtype, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
            zero = torch.zeros(1, dtype=dtype)
            ours = extrapolated_angles(zero, torch.ones(1, dtype=dtype), 1e-4, n)[:, 0].numpy()
            with jax.disable_jit():
                ref = np.asarray(jnp.linspace(0, 1e-4 * (n - 1), n, dtype=jdt))
            assert np.array_equal(ours, ref), (n, dtype)
            compiled = np.asarray(jnp.linspace(0, 1e-4 * (n - 1), n, dtype=jdt))
            assert np.abs(ours - compiled).max() <= np.spacing(ours[-1]), (n, dtype)


# ---------------------------------------------------------------------------
# fused rollout and sim-ahead against the JAX scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,saturated,solver", [
    ("BRUSA", True, "euler"),
    ("BRUSA", True, "rk4"),
    ("SEW", True, "euler"),
    ("DEFAULT", False, "tsit5"),
])
@pytest.mark.parametrize("deadtime", [0, 1])
def test_fused_rollout_matches_jax_scan(variant, saturated, solver, deadtime):
    je, pe = _pair(variant, saturated, solver, jax_static=_static(variant, saturated, deadtime=deadtime))
    js, ps = _states(je, pe, 2)
    acts = _actions(3)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), T)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), strict=True)
    assert tuple(po.shape) == (B, 8)
    _close(po, jo[:, -1])
    _close_phys(pl, jl)
    if pe._solver.fsal:
        for k_p, k_j in zip(pl.additions.solver_state, jl.additions.solver_state):
            _close(k_p, k_j)
    else:
        assert pl.additions.solver_state is None


@pytest.mark.parametrize("time_major", [False, True])
def test_fused_rollout_obs_stride_and_layout_match_jax_scan(time_major):
    je, pe = _pair(solver="rk4")
    js, ps = _states(je, pe, 4)
    acts = _actions(5)
    jo, jl = je.vmap_rollout(js, jnp.asarray(acts), 2)
    p_acts = torch.as_tensor(acts)
    if time_major:
        p_acts = p_acts.transpose(0, 1).contiguous()
    po, pl = pe.fused_rollout(ps, p_acts, obs_stride=2, time_major=time_major, strict=True)
    assert tuple(po.shape) == tuple(jo.shape) == (B, T // 2, 8)
    _close(po, jo)
    _close_phys(pl, jl)


def test_fused_rollout_per_batch_r_s_and_l_d_match_jax_scan():
    rng = np.random.default_rng(6)
    r_s, l_d = rng.uniform(15e-3, 21e-3, B), rng.uniform(0.3e-3, 0.45e-3, B)
    for variant, saturated, extra in (("BRUSA", True, {"r_s": r_s}), ("DEFAULT", False, {"l_d": l_d})):
        je, pe = _pair(variant, saturated, "euler",
                       jax_static=_static(variant, saturated, **{k: jnp.asarray(v) for k, v in extra.items()}),
                       torch_static=_static(variant, saturated, **extra))
        assert rollout_path(pe) == "pmsm_fused"
        js, ps = _states(je, pe, 7)
        acts = _actions(8)
        jo, jl = je.vmap_rollout(js, jnp.asarray(acts), 4)
        po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), obs_stride=4, strict=True)
        _close(po, jo)
        _close_phys(pl, jl)


@pytest.mark.parametrize("variant,saturated,solver", [
    ("BRUSA", True, "euler"),
    ("BRUSA", True, "rk4"),
    ("SEW", True, "rk4"),
    ("DEFAULT", False, "tsit5"),
])
@pytest.mark.parametrize("deadtime", [0, 1])
def test_fused_sim_ahead_matches_jax_scan(variant, saturated, solver, deadtime):
    je, pe = _pair(variant, saturated, solver, jax_static=_static(variant, saturated, deadtime=deadtime))
    js, ps = _states(je, pe, 9)
    acts = _actions(10)
    jo, _, jl = je.vmap_sim_ahead(js, jnp.asarray(acts), je.tau, je.tau)
    po, pl = pe.fused_sim_ahead(ps, torch.as_tensor(acts), pe.tau, pe.tau, strict=True)
    assert tuple(po.shape) == tuple(jo.shape) == (B, T + 1, 8)
    _close(po, jo)
    _close_phys(pl, jl)
    if pe._solver.fsal:
        for k_p, k_j in zip(pl.additions.solver_state, jl.additions.solver_state):
            _close(k_p, k_j)
    po2, _ = pe.fused_sim_ahead(ps, torch.as_tensor(acts).transpose(0, 1), pe.tau, pe.tau, obs_stride=2,
                                time_major=True, strict=True)
    _close(po2, jo[:, ::2])


def test_fused_rollout_matches_jax_pallas_kernel_in_interpret_mode():
    batch, n = jpk.TILE, 8
    je, pe = _pair(batch=batch)
    js, ps = _states(je, pe, 11)
    acts = _actions(12, n=n, batch=batch)
    jo, jl = jpk.pmsm_fused_rollout(je, js, jnp.asarray(acts), obs_stride=4, gather="take", interpret=True)
    po, pl = pe.fused_rollout(ps, torch.as_tensor(acts), obs_stride=4, strict=True)
    _close(po, jo)
    _close_phys(pl, jl)


# ---------------------------------------------------------------------------
# dispatch, scope and the plain version
# ---------------------------------------------------------------------------


def test_dispatch_scope_fallback_and_strict():
    _, pe = _pair()
    assert rollout_path(pe) == "pmsm_fused"
    assert rollout_path(pe, pe.tau, pe.tau) == "pmsm_fused"
    assert rollout_path(pe, pe.tau / 2, pe.tau) == "scan"
    assert rollout_path(P.Pendulum(batch_size=2, **F64)) == "fused"
    out_of_scope = [
        P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA,
               static_params=_static("BRUSA", True, deadtime=2), **F64),
        P.PMSM(batch_size=B, saturated=True, motor_variant=P.MotorVariant.BRUSA,
               static_params=_static("BRUSA", True, deadtime=np.ones(B)), **F64),
        P.PMSM(batch_size=B, motor_variant=P.MotorVariant.DEFAULT,
               static_params=_static("DEFAULT", False, l_d=math.nan), **F64),
    ]
    acts = torch.as_tensor(_actions(13))
    for env in out_of_scope:
        assert rollout_path(env) == "scan"
        _, state = env.vmap_reset(rng=torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="strict"):
            env.fused_rollout(state, acts, strict=True)
        with pytest.raises(ValueError, match="strict"):
            env.fused_sim_ahead(state, acts, env.tau, env.tau, strict=True)
        obs, last = env.fused_rollout(state, acts, obs_stride=4)
        ref, ref_last = env.vmap_rollout(state, acts, 4)
        torch.testing.assert_close(obs, ref, rtol=0, atol=0, equal_nan=True)
    # the loop fallback of sim-ahead on a finer observation grid is the scan
    _, state = pe.vmap_reset()
    with pytest.raises(ValueError, match="strict"):
        pe.fused_sim_ahead(state, acts, pe.tau / 2, pe.tau, strict=True)


def test_plain_version_equals_the_port_scan_exactly():
    """Same operations in the same order: the fused path IS the loop."""
    for solver in ("euler", "tsit5"):
        _, pe = _pair(solver=solver, batch=64)
        _, ps = pe.vmap_reset(rng=torch.Generator().manual_seed(1))
        acts = torch.as_tensor(_actions(14, batch=64))
        po, pl = pe.vmap_rollout(ps, acts, 4)
        fo, fl = pe.fused_rollout(ps, acts, obs_stride=4, strict=True)
        assert torch.equal(po, fo)
        for name in FIELDS:
            assert torch.equal(getattr(pl.physical_state, name), getattr(fl.physical_state, name)), name
        so, _, sl = pe.vmap_sim_ahead(ps, acts, pe.tau, pe.tau)
        fso, fsl = pe.fused_sim_ahead(ps, acts, pe.tau, pe.tau, strict=True)
        assert torch.equal(so, fso)


def test_cpu_tensors_take_the_plain_version_only():
    _, pe = _pair(batch=8)
    _, ps = pe.vmap_reset()
    acts = torch.zeros((8, 4, 2), dtype=torch.float64)
    PK.KERNEL.reset_counts()
    pe.fused_rollout(ps, acts, strict=True)
    pe.fused_sim_ahead(ps, acts, pe.tau, pe.tau, strict=True)
    assert PK.KERNEL.launches == {"pmsm_step": 0, "pmsm_sim_ahead": 0}
    state0, omega = PK._start(ps)
    with pytest.raises(ValueError, match="CUDA tensors"):
        PK.pmsm_kernel_rollout(pe, acts, state0, omega, tau=pe.tau, batch_major=True)


def test_plain_version_is_differentiable_on_cpu():
    _, pe = _pair(solver="rk4", batch=8)
    _, ps = pe.vmap_reset()
    acts = torch.full((8, 4, 2), 0.3, dtype=torch.float64, requires_grad=True)
    obs, _ = pe.fused_rollout(ps, acts, strict=True)
    obs[:, 0].sum().backward()
    assert acts.grad is not None and bool((acts.grad[:, -2] != 0).any())


# ---------------------------------------------------------------------------
# the plain version's by-products: what the kernel writes in place of the slab
# ---------------------------------------------------------------------------


def _derived_from_the_slab(pe, ps, acts_tm, tau, obs_stride, sim_ahead):
    """The angles, buffers and last voltage as the fused path derived them
    from the materialized pre-pass (``u_con``, ``eps_seq``) before the kernel
    took the pre-pass over: ``(final eps, final buffers, u_last, saved eps,
    saved buffers)``."""
    phys = ps.physical_state
    props = pe.env_properties
    deadtime = int(props.static_params.deadtime)
    n = acts_tm.shape[0]
    if sim_ahead:
        eps_ext = extrapolated_angles(phys.epsilon, phys.omega_el, pe.tau, n)
        u_con = PK._constraint_denorm_batched(pe, props, acts_tm, eps_ext, phys.omega_el)
        rate = PK._eps_rate(pe._solver, phys.omega_el)
        eps = [phys.epsilon]
        for _ in range(n):
            eps.append(eps[-1] + tau * rate)
        eps_post = PK.wrap_angle(torch.stack(eps))[1:]
    else:
        u_con, eps_seq, eps_final = PK._constrained_voltages(pe, ps, acts_tm, props)
        eps_post = torch.cat([eps_seq[1:], eps_final[None]], dim=0)
    buf0 = torch.stack((phys.u_d_buffer, phys.u_q_buffer), dim=-1)
    buf_final = (u_con[-1, :, 0], u_con[-1, :, 1]) if deadtime else (phys.u_d_buffer, phys.u_q_buffer)
    u_last = buf0 if (deadtime and n == 1) else u_con[n - 1 - deadtime]
    saves = None
    if obs_stride is not None:
        bufs = u_con[obs_stride - 1 :: obs_stride] if deadtime else None
        saves = (eps_post[obs_stride - 1 :: obs_stride], None if bufs is None else bufs[..., 0],
                 None if bufs is None else bufs[..., 1])
    return eps_post[-1], buf_final, (u_last[:, 0], u_last[:, 1]), saves


def _banded_pmsm(dtype, solver, deadtime, per_batch, batch=8):
    """A saturated BRUSA drive; with ``per_batch`` a (B,) DC link and a (B,)
    u_d action band."""
    rng = np.random.default_rng(21)
    static = _static("BRUSA", True, deadtime=deadtime)
    kw = {}
    if per_batch:
        static["u_dc"] = rng.uniform(350.0, 450.0, batch)
        an = dict(P.MotorVariant.BRUSA.get_params().action_normalizations.__dict__)
        an["u_d"] = P.MinMaxNormalization(min=an["u_d"].min, max=rng.uniform(200.0, 300.0, batch))
        kw["action_normalizations"] = an
    return P.PMSM(batch_size=batch, saturated=True, motor_variant=P.MotorVariant.BRUSA, solver=solver,
                  static_params=static, device="cpu", dtype=dtype, **kw)


BY_PRODUCT_MODES = [("step", 1), ("step", 16), ("sim_ahead", 1)]


@pytest.mark.parametrize("mode,obs_stride", BY_PRODUCT_MODES)
@pytest.mark.parametrize("solver", ["euler", "rk4"])
@pytest.mark.parametrize("deadtime", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_by_products_equal_the_slab_derivation(dtype, deadtime, solver, mode, obs_stride):
    """plain_pmsm_rollout returns the angles, buffers and last voltage the
    kernel writes; they equal, bit for bit, what the fused path used to
    derive from the materialized u_con and eps_seq."""
    pe = _banded_pmsm(dtype, solver, deadtime, per_batch=False)
    _, ps = pe.vmap_reset(rng=torch.Generator().manual_seed(3))
    sim_ahead = mode == "sim_ahead"
    n = 32
    acts_tm = torch.as_tensor(_actions(22, n=n, batch=pe.batch_size, lim=0.9).transpose(1, 0, 2), dtype=dtype)
    state0, omega = PK._start(ps)
    final, u_last, traj = PK.plain_pmsm_rollout(pe, acts_tm, state0, omega, tau=pe.tau, obs_stride=obs_stride,
                                                sim_ahead=sim_ahead)
    eps_final, buf_final, u_last_want, saves = _derived_from_the_slab(pe, ps, acts_tm, pe.tau, obs_stride, sim_ahead)
    assert torch.equal(final[3], eps_final)
    assert all(torch.equal(a, b) for a, b in zip(final[4:], buf_final))
    assert all(torch.equal(a, b) for a, b in zip(u_last, u_last_want))
    assert len(traj) == 6 and all(t.shape == (n // obs_stride, pe.batch_size) for t in traj[:4])
    assert torch.equal(traj[3], saves[0])
    for got, want in zip(traj[4:], saves[1:]):
        assert (got is None) == (want is None) == (deadtime == 0)
        assert got is None or torch.equal(got, want)
    # the batch-major slab gives the same results
    final_bm, _, traj_bm = PK.plain_pmsm_rollout(pe, acts_tm.transpose(0, 1), state0, omega, tau=pe.tau,
                                                 obs_stride=obs_stride, sim_ahead=sim_ahead, batch_major=True)
    assert all(torch.equal(a, b) for a, b in zip(final + traj[:4], final_bm + traj_bm[:4]))


@pytest.mark.parametrize("mode,obs_stride", [("step", 16), ("sim_ahead", 1)])
@pytest.mark.parametrize("deadtime", [0, 1])
def test_plain_by_products_with_per_batch_dc_link_and_band(deadtime, mode, obs_stride):
    pe = _banded_pmsm(torch.float32, "euler", deadtime, per_batch=True)
    bands = PK.kernel_bands(pe.env_properties, pe.batch_size)
    assert [k for k, v in bands.items() if isinstance(v, torch.Tensor)] == ["u_dc", "a_d_mx"]
    assert PK.supports_pmsm_fused(pe)
    _, ps = pe.vmap_reset(rng=torch.Generator().manual_seed(4))
    sim_ahead = mode == "sim_ahead"
    acts_tm = torch.as_tensor(_actions(23, n=32, batch=pe.batch_size, lim=0.9).transpose(1, 0, 2),
                              dtype=torch.float32)
    state0, omega = PK._start(ps)
    final, u_last, traj = PK.plain_pmsm_rollout(pe, acts_tm, state0, omega, tau=pe.tau, obs_stride=obs_stride,
                                                sim_ahead=sim_ahead)
    eps_final, buf_final, u_last_want, saves = _derived_from_the_slab(pe, ps, acts_tm, pe.tau, obs_stride, sim_ahead)
    assert torch.equal(final[3], eps_final)
    assert all(torch.equal(a, b) for a, b in zip(final[4:] + u_last, buf_final + u_last_want))
    assert torch.equal(traj[3], saves[0])
    assert all(a is b is None or torch.equal(a, b) for a, b in zip(traj[4:], saves[1:]))


def test_band_scope_of_the_kernel():
    """Scalar and (B,) DC links and bands are in the kernel's scope (a 0-d
    tensor expands to (B,)); any other shape sends the entry points to the
    loop."""
    pe = _banded_pmsm(torch.float64, "euler", 1, per_batch=False)
    props = pe.env_properties
    assert all(isinstance(v, float) for v in PK.kernel_bands(props, pe.batch_size).values())
    with_u_dc = lambda u_dc: pstructures.replace(props, static_params=pstructures.replace(props.static_params,
                                                                                          u_dc=u_dc))
    assert PK.kernel_bands(with_u_dc(torch.tensor(400.0, dtype=torch.float64)), pe.batch_size)["u_dc"].shape == (
        pe.batch_size,)
    assert PK.kernel_bands(with_u_dc(torch.full((2, pe.batch_size), 400.0)), pe.batch_size) is None
