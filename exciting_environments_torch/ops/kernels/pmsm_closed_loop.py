"""Fused closed-loop PMSM drive: the counterpart of the closed-loop part of
``exciting_environments_tpu/ops/pallas/pmsm_stepper.py``.

The policy runs inside the drive loop.  Every step builds the observation
from the drive state (:meth:`PMSM.generate_observation`'s columns, then the
normalized tracked references), adds the sensor-noise row, appends the
scheduled gather of a :class:`~exciting_environments_torch.ops.lut.ScheduledLUT`
at the policy's belief currents, evaluates the policy, constrains its action
into the inverter hexagon at the deadtime-advanced angle
(:func:`hex_constrain`), swaps the deadtime buffer, takes the RK step of the
currents over the magnetics and advances the angle.  For CUDA tensors the
whole horizon is one launch of the kernel in ``csrc/pmsm_closed_loop.cu``;
beside it lives the plain PyTorch version, :func:`plain_pmsm_closed_loop`, a
Python loop of :func:`plain_pmsm_cl_step` that performs the kernel's
arithmetic operation for operation.  :func:`pmsm_closed_loop` takes the plain
version only for CPU tensors.

On CUDA tensors the policy is one of the families compiled into the kernel:
:class:`~exciting_environments_torch.ops.policies.AffinePolicy` (P and PI
laws), the PPO actor of ``utils/rl_fused.py`` (``ActorPolicy``, exploring or
deterministic, the instance id in its carry) and the two sensorless tiles of
``utils/foc.py``.  Any other callable raises before a launch; on CPU tensors
any callable with the tile contract runs.

Scalar bands and DC-link voltages fold into the arithmetic as Python numbers;
per-batch ``(B,)`` leaves (:data:`PBN_FIELDS`, and the drive parameters of
``PMSM_PARAMS``) reach the kernel as pointers.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import with_env_properties
from exciting_environments_torch.ops.kernels import checkpoint as ck
from exciting_environments_torch.ops.kernels.closed_loop import (
    LAUNCH_PLANS,
    MAX_LAYERS,
    MAX_WIDTH,
    closed_loop_noise,
    policy_spec,
)
from exciting_environments_torch.models.pmsm.pmsm_env import wrap_angle
from exciting_environments_torch.ops.kernels.plans import Key, PlanCache, Pointers
from exciting_environments_torch.ops.kernels.pmsm_angles import angle_trajectory
from exciting_environments_torch.ops.kernels.pmsm_stepper import (
    N_CHANNELS,
    PMSM_PARAMS,
    _eps_rate,
    _eps_trajectory,
    _pmsm_final_solver_state,
    plain_pmsm_step,
    supports_pmsm_fused,
)
from exciting_environments_torch.ops.kernels.stepper import MAX_STAGES, KernelLibrary, _check_leaf, _stage_rows
from exciting_environments_torch.ops.policies import KernelPolicy
from exciting_environments_torch.ops.transforms import ROTATION_IM, ROTATION_RE, _rotation_tables
from exciting_environments_torch.utils.profiling import annotate

#: observation bands of the closed loop, in the order of the observation
OBS_BAND_FIELDS = ("i_d", "i_q", "omega_el", "torque", "u_d_buffer", "u_q_buffer")
#: per-batch-capable constraint and normalization leaves, in the kernel's
#: band-slot order: the DC-link voltage, the action bands and the
#: observation bands
PBN_FIELDS = ("u_dc", "a_d_mn", "a_d_mx", "a_q_mn", "a_q_mx") + tuple(
    f"o{i}_{s}" for i in range(len(OBS_BAND_FIELDS)) for s in ("mn", "mx")
)
N_BASE_OBS = 8
MAX_REFS = 4
MAX_OBS = N_BASE_OBS + MAX_REFS
MAX_CARRY = 6
MAX_SCHED = 10
#: the actor's budget (``utils/rl_fused.py::MAX_ACTOR_PARAMS``) and its seed
MAX_POLICY_PARAMS = 2048 + 1
#: dynamic shared memory of one block on the H100 (227 KB): the table, the
#: flat parameters and the 16 sector rotations
MAX_DYNAMIC_SMEM = 227 * 1024
#: stage counts the kernel is instantiated for (FSAL last stage skipped)
KERNEL_STAGES = (1, 2, 4, 6)
#: policy families compiled into the kernel, by ``KernelSpec.policy_id``
FAMILIES = {0: "AffinePolicy", 1: "ActorPolicy", 2: "SensorlessPolicy", 3: "ScheduledSensorlessPolicy"}
#: the kernel's instantiations by family (:func:`kernel_variant`): the affine
#: law reading every observation column, or the currents' columns only
#: (``csrc/pmsm_closed_loop/affine.cu``), the actor, the sensorless tiles, and
#: the scheduled tile whose drives each hold their own operating point
VARIANTS = ("affine_all", "affine_currents", "actor", "sensorless", "scheduled", "scheduled_drive")
#: launches of each instantiation
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
#: the instantiation of each family but the affine law's
_FAMILY_VARIANTS = {1: "actor", 2: "sensorless", 3: "scheduled"}
#: per-drive planes of the per-drive scheduled tile
#: (``ScheduledSensorlessPolicy.PLANES``, ``csrc/pmsm_closed_loop.cu::ScheduledDriveLaw``)
MAX_POLICY_PLANES = 5
#: the observation columns that ``"affine_currents"`` builds no value for:
#: the torque, cos/sin eps and the two buffers
SKIPPED_COLUMNS = slice(3, N_BASE_OBS)
#: threads of a block on the kernel's global path (its ``THREADS``)
THREADS = 128
#: slices of the schedule a block stages in shared memory at most (each
#: drive looks its slice up among them once)
MAX_STAGED = 4
#: threads of a block on the staged path at most, by dtype (the kernel's
#: ``BlockShape``): float32 one block of 16 warps an SM, as the global
#: path's four of 128 threads; float64 the global path's 128
STAGED_THREADS = {torch.float32: 512, torch.float64: 128}
#: the per-drive scheduled tile's launches (``"scheduled_drive"``): through
#: the staged path (the drives ordered by slice, each block's slices in
#: shared memory) or the global path (every slice read from device memory);
#: over all of them the blocks, the drives whose slice was staged, all
#: drives, and the idle lanes in the last warp of each block's range
SLICE_STAGING = dict.fromkeys(("staged_launches", "global_launches", "blocks", "staged_drives", "drives",
                               "idle_lanes"), 0)
#: the backwards of :class:`PmsmClosedLoopVJP`: ``"adjoint"`` counts those that
#: launched ``csrc/pmsm_closed_loop_adjoint.cu``, ``"replay"`` those that
#: replayed the plain step, by the reason
#: (:func:`~.pmsm_closed_loop_adjoint.adjoint_scope`)
BACKWARD_PATHS = {"adjoint": 0, "replay": {}}

_c_double = ctypes.c_double
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


class PmsmClArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct PmsmClArgs`` in ``csrc/pmsm_closed_loop.cu``."""

    _fields_ = [
        ("tau", _c_double),
        ("a", (_c_double * MAX_STAGES) * MAX_STAGES),
        ("b", _c_double * MAX_STAGES),
        ("rate_b", _c_double * MAX_STAGES),
        ("param_value", _c_double * len(PMSM_PARAMS)),
        ("x0", _c_double),
        ("dx", _c_double),
        ("y0", _c_double),
        ("dy", _c_double),
        ("band_value", _c_double * len(PBN_FIELDS)),
        ("adv_scale", _c_double),
        ("rot_re", _c_double * 8),
        ("rot_im", _c_double * 8),
        ("clip", _c_double),
        ("param_ptr", _c_void_p * len(PMSM_PARAMS)),
        ("band_ptr", _c_void_p * len(PBN_FIELDS)),
        ("lut", _c_void_p),
        ("sched", _c_void_p),
        ("state0", _c_void_p * 5),
        ("omega", _c_void_p),
        ("carry0", _c_void_p * MAX_CARRY),
        ("refs", _c_void_p * MAX_REFS),
        ("policy_params", _c_void_p),
        ("obs_noise", _c_void_p),
        ("proc_noise", _c_void_p),
        ("out", _c_void_p * 6),
        ("u_last", _c_void_p * 2),
        ("carry_out", _c_void_p * MAX_CARRY),
        ("traj", _c_void_p * 7),
        ("traj_carry", _c_void_p * MAX_CARRY),
        ("batch", ctypes.c_longlong),
        ("nx", _c_int),
        ("ny", _c_int),
        ("n_steps", _c_int),
        ("n_stages", _c_int),
        ("n_rate", _c_int),
        ("saturated", _c_int),
        ("deadtime", _c_int),
        ("n_refs", _c_int),
        ("n_carry", _c_int),
        ("n_pp", _c_int),
        ("n_sched", _c_int),
        ("sched_c0", _c_int),
        ("sched_c1", _c_int),
        ("policy_id", _c_int),
        ("has_integral", _c_int),
        ("has_clip", _c_int),
        ("delayed", _c_int),
        ("obs_cols", _c_int * MAX_OBS),
        ("n_obs_noise", _c_int),
        ("noise_idx", _c_int * 2),
        ("n_proc_noise", _c_int),
        ("traj_stride", _c_int),
        ("deterministic", _c_int),
        ("n_layers", _c_int),
        ("widths", _c_int * (MAX_LAYERS + 1)),
        ("policy_planes", _c_void_p * MAX_POLICY_PLANES),
        ("sched_slices", _c_void_p),
        ("slice_elems", ctypes.c_longlong),
        ("n_planes", _c_int),
        ("n_slices", _c_int),
        ("perm", _c_void_p),
        ("block_slices", _c_void_p),
        ("n_staged", _c_int),
        ("block_threads", _c_int),
        ("affine_columns", _c_int),
    ]


PMSM_CL_KERNEL = KernelLibrary("pmsm_closed_loop", "pmsm_closed_loop", PmsmClArgs, ("pmsm_closed_loop",))
#: the launch plans of :func:`kernel_pmsm_closed_loop`, counted in
#: ``LAUNCH_PLANS["pmsm_closed_loop"]`` (``ops/kernels/plans.py``)
PLANS = PlanCache(LAUNCH_PLANS["pmsm_closed_loop"])

_PLAIN_CALLABLE_ON_CUDA = (
    "on CUDA tensors the PMSM closed loop runs inside the kernel, which compiles in the policy "
    "families AffinePolicy (ops/policies.py), the PPO actor of utils/rl_fused.py and the sensorless "
    "tiles of utils/foc.py; a plain callable runs the loop on the CPU only (an environment made with "
    "device='cpu')"
)


# ---------------------------------------------------------------------------
# bands and the hexagon
# ---------------------------------------------------------------------------


def _is_batched(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.ndim >= 1


def cl_bands(props) -> dict:
    """The closed loop's bands of ``props`` by :data:`PBN_FIELDS` name: a
    Python number for a scalar leaf (it folds as Python folds it), the
    ``(B,)`` tensor for a per-batch one."""
    pn, an = props.physical_normalizations, props.action_normalizations
    leaves = [props.static_params.u_dc]
    leaves += [getattr(getattr(an, n), bound) for n in ("u_d", "u_q") for bound in ("min", "max")]
    leaves += [getattr(getattr(pn, n), bound) for n in OBS_BAND_FIELDS for bound in ("min", "max")]
    return {name: leaf if _is_batched(leaf) else float(leaf) for name, leaf in zip(PBN_FIELDS, leaves)}


def eff_cl_norms(bands: dict):
    """The effective ``(obs_norms, act_norms, u_dc)`` of a :func:`cl_bands`
    dict: ``(min, max)`` pairs of the six observation bands and the two
    action bands, scalars and ``(B,)`` leaves mixed (every consumer is
    elementwise)."""
    obs = tuple((bands[f"o{i}_mn"], bands[f"o{i}_mx"]) for i in range(len(OBS_BAND_FIELDS)))
    act = ((bands["a_d_mn"], bands["a_d_mx"]), (bands["a_q_mn"], bands["a_q_mx"]))
    return obs, act, bands["u_dc"]


def hex_constrain(a_d, a_q, eps, omega, tau, act_norms, u_dc, deadtime):
    """The closed loop's inverter constraint over same-shape tensors, the
    counterpart of the JAX kernel's ``_hex_constrain``: denormalize the
    policy's action, rotate it to alpha/beta at the deadtime-advanced angle,
    clip it into the voltage hexagon, rotate back.  Not the environment's
    ``apply_hex_constraint``: the sector comes from a linear test in place
    of ``atan2``, the angle from a floored ``%`` and a shift above pi, and
    the sector rotation from a direct index of the float32 table (equal to
    the JAX package's multilinear combination for bits in {0, 1}, up to the
    sign of a zero)."""
    (mnd, mxd), (mnq, mxq) = act_norms
    u_d = (a_d + 1) / 2 * (mxd - mnd) + mnd
    u_q = (a_q + 1) / 2 * (mxq - mnq) + mnq
    scale = 1 / (u_dc / 2)
    nd = u_d * scale
    nq = u_q * scale

    adv = eps + omega * tau * (deadtime + 0.5)
    adv = adv % (2 * math.pi)
    adv = adv + (adv > math.pi).to(adv.dtype) * (-2 * math.pi)

    ca = torch.cos(-adv)
    sa = torch.sin(-adv)
    alpha = ca * nd + sa * nq
    beta = -sa * nd + ca * nq

    s120 = float(np.sqrt(3.0) / 2)
    b0 = (beta >= 0).long()
    b1 = (-0.5 * beta - s120 * alpha >= 0).long()
    b2 = (-0.5 * beta + s120 * alpha >= 0).long()
    table_re, table_im = _rotation_tables(alpha.device)
    rot_re = table_re[b0, b1, b2].to(alpha.dtype)
    rot_im = table_im[b0, b1, b2].to(alpha.dtype)
    ra = alpha * rot_re - beta * rot_im
    rb = alpha * rot_im + beta * rot_re
    ra = torch.clamp(ra, -2 / 3, 2 / 3)
    rb = torch.clamp(rb, 0, float(2 / 3 * np.sqrt(3.0)))
    oa = ra * rot_re + rb * rot_im
    ob = rb * rot_re - ra * rot_im

    cb = torch.cos(adv)
    sb = torch.sin(adv)
    half_dc = u_dc / 2
    u_con_d = (cb * oa + sb * ob) * half_dc
    u_con_q = (-sb * oa + cb * ob) * half_dc
    return u_con_d, u_con_q


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def plain_pmsm_cl_step(env, policy, state, carry, t, refs, pparams=None, *, tau, solver, props, omega, bands,
                       deadtime, has_carry, eo=None, ep=None, obs_cols=(), noise_idx=(), sched=None):
    """One step of the kernel's computation in plain PyTorch over ``(B,)``
    leaves.  ``state`` is ``(i_d, i_q, eps, u_d_buffer, u_q_buffer)``,
    ``bands`` the effective ``(obs_norms, act_norms, u_dc)``
    (:func:`eff_cl_norms`), ``eo``/``ep`` the step's noise rows ``(B, n)``
    and ``sched`` the :class:`~exciting_environments_torch.ops.lut.ScheduledLUT`
    gathered at the belief currents, or ``None``.  Returns
    ``(state1, carry1, (a_d, a_q, u_con_d, u_con_q), u_applied)`` with
    ``carry1 = ()`` for a stateless policy."""
    i_d, i_q, eps, bd, bq = state
    obs_norms, act_norms, u_dc = bands

    def norm(leaf, idx):
        mn, mx = obs_norms[idx]
        return 2 * (leaf - mn) / (mx - mn) - 1

    torque = env._torque(i_d, i_q, props)
    obs = (
        norm(i_d, 0), norm(i_q, 1), norm(omega, 2), norm(torque, 3),
        torch.cos(eps), torch.sin(eps), norm(bd, 4), norm(bq, 5),
    ) + tuple(refs)
    if obs_cols:
        obs = list(obs)
        for j, col in enumerate(obs_cols):
            obs[col] = obs[col] + eo[..., j]
        obs = tuple(obs)
    if sched is not None:
        c0, c1 = sched.carry_idx
        (mn0, mx0), (mn1, mx1) = obs_norms[0], obs_norms[1]
        bi_d = (carry[c0] + 1) / 2 * (mx0 - mn0) + mn0
        bi_q = (carry[c1] + 1) / 2 * (mx1 - mn1) + mn1
        obs = obs + tuple(sched.gather(bi_d.dtype, bi_d.device, env._lut, bi_d, bi_q).unbind(0))
    args = (obs, t) + ((carry,) if has_carry else ()) + ((pparams,) if pparams is not None else ())
    out = policy(*args)
    a, carry1 = (tuple(out[0]), tuple(out[1])) if has_carry else (tuple(out), ())
    a_d, a_q = a[0], a[1]
    u_con_d, u_con_q = hex_constrain(a_d, a_q, eps, omega, tau, act_norms, u_dc, deadtime)
    if deadtime:
        u_app, bd1, bq1 = (bd, bq), u_con_d, u_con_q
    else:
        u_app, bd1, bq1 = (u_con_d, u_con_q), bd, bq
    i_d1, i_q1 = plain_pmsm_step(env, solver, tau, props, omega, (i_d, i_q), torch.stack(u_app, dim=-1))
    if noise_idx:
        y1 = [i_d1, i_q1]
        for j, idx in enumerate(noise_idx):
            y1[idx] = y1[idx] + ep[..., j]
        i_d1, i_q1 = y1
    eps1 = wrap_angle(eps + tau * _eps_rate(solver, omega))
    return (i_d1, i_q1, eps1, bd1, bq1), carry1, (a_d, a_q, u_con_d, u_con_q), u_app


def plain_pmsm_closed_loop(env, state0, omega, policy, n_steps, *, tau, solver, props, ref_leaves=(),
                           traj_stride=None, policy_params=None, policy_carry=None, obs_noise_tm=None,
                           proc_noise_tm=None, obs_noise_cols=(), proc_noise_idx=(), sched_lut=None):
    """The kernel's loop as a Python loop of :func:`plain_pmsm_cl_step`
    (argument contract: :func:`pmsm_closed_loop`).  Runs on any device and
    is differentiable by autograd."""
    has_carry = policy_carry is not None
    state, carry = tuple(state0), tuple(policy_carry) if has_carry else ()
    deadtime = int(props.static_params.deadtime)
    bands = eff_cl_norms(cl_bands(props))
    u_app = (state[3], state[4])
    saves = []
    for t in range(n_steps):
        state, carry, (a_d, a_q, u_con_d, u_con_q), u_app = plain_pmsm_cl_step(
            env, policy, state, carry, t, ref_leaves, policy_params, tau=tau, solver=solver, props=props,
            omega=omega, bands=bands, deadtime=deadtime, has_carry=has_carry,
            eo=None if obs_noise_tm is None else obs_noise_tm[t],
            ep=None if proc_noise_tm is None else proc_noise_tm[t],
            obs_cols=obs_noise_cols, noise_idx=proc_noise_idx, sched=sched_lut,
        )
        if traj_stride is not None and (t + 1) % traj_stride == 0:
            i_d, i_q = state[0], state[1]
            saves.append(((i_d, i_q, env._torque(i_d, i_q, props), u_con_d, u_con_q, a_d, a_q), carry))
    final = state + (env._torque(state[0], state[1], props),)
    if traj_stride is None:
        return final, u_app, carry, None, None
    stack = lambda group: tuple(torch.stack(leaf, dim=0) for leaf in zip(*group))
    trajs, carries = zip(*saves)
    return final, u_app, carry, stack(trajs), (stack(carries) if has_carry else ())


# ---------------------------------------------------------------------------
# the hand-derived reverse sweep (the adjoint kernel's plain version)
# ---------------------------------------------------------------------------


class AdjointCotangents(NamedTuple):
    """The cotangents of :class:`PmsmClosedLoopVJP`'s outputs that the reverse
    sweep takes, ``None`` for zero: ``traj`` the seven per-step saves ``(T,
    B)`` (``i_d, i_q, torque, u_con_d, u_con_q, a_d, a_q``), ``traj_carry``
    the carry's saves, ``final`` the six final leaves ``(B,)`` (``i_d, i_q,
    eps, u_d_buffer, u_q_buffer, torque``), ``u_last`` the two applied
    voltages of the last step and ``carry`` the final carry."""

    traj: tuple
    traj_carry: tuple
    final: tuple
    u_last: tuple
    carry: tuple


def _gather_with_slopes(lut, px, py):
    """:func:`~exciting_environments_torch.ops.lut.bilinear_gather` of every
    channel at ``(px, py)`` with its slopes along both coordinates: ``(v,
    dv/dpx, dv/dpy)``, ``(C, B)`` each.  The cell index carries no gradient,
    as in autograd through the gather."""
    fx = (px - lut.x0) / lut.dx
    fy = (py - lut.y0) / lut.dy
    ix = torch.clamp(torch.floor(fx), 0, lut.nx - 2).long()
    iy = torch.clamp(torch.floor(fy), 0, lut.ny - 2).long()
    wx, wy = fx - ix, fy - iy
    v = lut.values
    v00, v01, v10, v11 = v[:, ix, iy], v[:, ix, iy + 1], v[:, ix + 1, iy], v[:, ix + 1, iy + 1]
    vals = v00 * (1 - wx) * (1 - wy) + v01 * (1 - wx) * wy + v10 * wx * (1 - wy) + v11 * wx * wy
    slope_x = ((v10 - v00) * (1 - wy) + (v11 - v01) * wy) / lut.dx
    slope_y = ((v01 - v00) * (1 - wx) + (v11 - v10) * wx) / lut.dy
    return vals, slope_x, slope_y


def plain_pmsm_cl_adjoint(env, policy, flat, state0, omega, ref_leaves, carry0, traj, eps_starts,
                          cot: AdjointCotangents, *, tau, props):
    """The reverse sweep of :func:`plain_pmsm_closed_loop` under
    :class:`~exciting_environments_torch.ops.policies.AffinePolicy` (gains
    ``flat``, no clip) and explicit Euler, without noise or schedule, by hand
    and without autograd: the plain version of ``csrc/pmsm_closed_loop_adjoint.cu``,
    operation for operation in its order.

    ``traj`` holds the forward's saves of every step ``(T, B)`` (``i_d, i_q,
    torque, u_con_d, u_con_q, a_d, a_q``) and ``eps_starts`` the pre-step
    angles ``(T, B)`` (:func:`_eps_starts` with 1-step segments).  Each step
    is taken backwards from its start (the saved currents of the step
    before, the angle, with deadtime the saved constrained voltages as
    buffers): it recomputes the gather and its slopes, the torque, the
    observation and the hexagon, then pulls the cotangents back through the
    Euler step (the 2x2 inverse of the differential inductances, the gathers'
    slopes), the deadtime buffers, the hexagon (clamp ties pass, as
    ``torch.clamp``'s gradient does; the sector and the table's cell carry
    none), the observation's normalization and the affine law with its
    integrator.  The parameters' gradient is summed per drive over the steps,
    then over the drives in float64.

    Returns ``(g_state0, g_carry0, g_flat)``: the cotangents of the five
    start leaves, of the carry and of ``flat`` (in the working dtype)."""
    with torch.no_grad():
        return _plain_adjoint(env, policy, flat, state0, omega, ref_leaves, carry0, traj, eps_starts, cot, tau,
                              props)


def _plain_adjoint(env, policy, flat, state0, omega, ref_leaves, carry0, traj, eps_starts, cot, tau, props):
    n_steps = traj[0].shape[0]
    params = props.static_params
    saturated = bool(props.saturated)
    deadtime = int(params.deadtime)
    obs_norms, act_norms, u_dc = eff_cl_norms(cl_bands(props))
    n_obs = N_BASE_OBS + len(ref_leaves)
    integral = policy.Ki is not None
    K = flat[: 2 * n_obs].reshape(2, n_obs)
    Ki = flat[2 * n_obs + 2 :].reshape(2, n_obs) if integral else None
    zero = torch.zeros_like(omega)
    z = lambda g: zero if g is None else g
    at = lambda seq, t: zero if seq is None else seq[t]
    p15 = 1.5 * params.p
    slope = lambda i: 2 / (obs_norms[i][1] - obs_norms[i][0])  # d normalize / dx
    (mnd, mxd), (mnq, mxq) = act_norms
    half_dc = u_dc / 2
    scale = 1 / half_dc
    table_re, table_im = _rotation_tables(omega.device)
    s120 = float(np.sqrt(3.0) / 2)

    def torque_vjp(i_d, i_q, l_tau):
        """The torque's cotangent ``l_tau`` pulled back onto the currents,
        its gather included."""
        if saturated:
            vals, sx, sy = _gather_with_slopes(env._lut, i_d, i_q)
            l_pd, l_pq = p15 * i_q * l_tau, -(p15 * i_d * l_tau)
            return (-(p15 * vals[5] * l_tau) + l_pd * sx[4] + l_pq * sx[5],
                    p15 * vals[4] * l_tau + l_pd * sy[4] + l_pq * sy[5])
        dl = params.l_d - params.l_q
        return p15 * dl * i_q * l_tau, p15 * (params.psi_p + dl * i_d) * l_tau

    l_id, l_iq, l_eps, l_bd, l_bq = (z(g) for g in cot.final[:5])
    l_c = [z(g) for g in cot.carry] if integral else []
    # the final torque and the last save's torque both read the final state
    l_tau = z(cot.final[5]) + at(cot.traj[2], n_steps - 1)
    d_id, d_iq = torque_vjp(traj[0][-1], traj[1][-1], l_tau)
    l_id, l_iq = l_id + d_id, l_iq + d_iq
    g_K = [[zero] * n_obs for _ in range(2)]
    g_b = [zero, zero]
    g_Ki = [[zero] * n_obs for _ in range(2)]
    for t in reversed(range(n_steps)):
        # the saves of step t are its post-step currents, voltages, actions, carry
        l_id, l_iq = l_id + at(cot.traj[0], t), l_iq + at(cot.traj[1], t)
        l_c = [c + at(cot.traj_carry[j], t) for j, c in enumerate(l_c)]
        i_d, i_q = (state0[0], state0[1]) if t == 0 else (traj[0][t - 1], traj[1][t - 1])
        bd, bq = (state0[3], state0[4]) if (t == 0 or not deadtime) else (traj[3][t - 1], traj[4][t - 1])
        u_app = (bd, bq) if deadtime else (traj[3][t], traj[4][t])
        eps = eps_starts[t]
        a = (traj[5][t], traj[6][t])

        # the step's values again: the gather, the torque, the observation
        if saturated:
            vals, sx, sy = _gather_with_slopes(env._lut, i_d, i_q)
            torque = p15 * (vals[4] * i_q - vals[5] * i_d)
        else:
            torque = p15 * (params.psi_p + (params.l_d - params.l_q) * i_d) * i_q
        obs = [2 * (x - obs_norms[i][0]) / (obs_norms[i][1] - obs_norms[i][0]) - 1
               for i, x in ((0, i_d), (1, i_q), (2, omega), (3, torque))]
        obs += [torch.cos(eps), torch.sin(eps)]
        obs += [2 * (x - obs_norms[i][0]) / (obs_norms[i][1] - obs_norms[i][0]) - 1 for i, x in ((4, bd), (5, bq))]
        obs += list(ref_leaves)

        # the Euler step: i1 = i + tau f(i, u_app)
        l_fd, l_fq = tau * l_id, tau * l_iq
        if saturated:
            l_dd, l_dq, l_qd, l_qq, psi_d, psi_q = vals
            det = l_dd * l_qq - l_dq * l_qd
            inv_dd, inv_dq, inv_qd, inv_qq = l_qq / det, -l_dq / det, -l_qd / det, l_dd / det
            rhs_d = u_app[0] - params.r_s * i_d + omega * psi_q
            rhs_q = u_app[1] - params.r_s * i_q - omega * psi_d
            l_rd = inv_dd * l_fd + inv_qd * l_fq
            l_rq = inv_dq * l_fd + inv_qq * l_fq
            # the inverse's entries, then the determinant (d (1/det) = -1/det^2)
            e_dd, e_dq, e_qd, e_qq = rhs_d * l_fd, rhs_q * l_fd, rhs_d * l_fq, rhs_q * l_fq
            l_det = -(e_dd * inv_dd + e_dq * inv_dq + e_qd * inv_qd + e_qq * inv_qq) / det
            l_vals = [e_qq / det + l_det * l_qq, -(e_dq / det) - l_det * l_qd, -(e_qd / det) - l_det * l_dq,
                      e_dd / det + l_det * l_dd, -(omega * l_rq), omega * l_rd]
            l_id = l_id - params.r_s * l_rd
            l_iq = l_iq - params.r_s * l_rq
            l_ud, l_uq = l_rd, l_rq
        else:
            l_ud, l_uq = l_fd / params.l_d, l_fq / params.l_q
            l_id = l_id - params.r_s * l_ud - omega * params.l_d * l_uq
            l_iq = l_iq + omega * params.l_q * l_ud - params.r_s * l_uq
        if t == n_steps - 1:
            l_ud, l_uq = l_ud + z(cot.u_last[0]), l_uq + z(cot.u_last[1])

        # the deadtime buffers: with deadtime the buffers drive the step and
        # take the constrained voltages; without, the voltages drive it
        if deadtime:
            l_ucd, l_ucq = at(cot.traj[3], t) + l_bd, at(cot.traj[4], t) + l_bq
            l_bd, l_bq = l_ud, l_uq
        else:
            l_ucd, l_ucq = at(cot.traj[3], t) + l_ud, at(cot.traj[4], t) + l_uq

        # the hexagon at the deadtime-advanced angle, recomputed
        nd = ((a[0] + 1) / 2 * (mxd - mnd) + mnd) * scale
        nq = ((a[1] + 1) / 2 * (mxq - mnq) + mnq) * scale
        adv = (eps + omega * tau * (deadtime + 0.5)) % (2 * math.pi)
        adv = adv + (adv > math.pi).to(adv.dtype) * (-2 * math.pi)
        ca, sa, cb, sb = torch.cos(-adv), torch.sin(-adv), torch.cos(adv), torch.sin(adv)
        alpha = ca * nd + sa * nq
        beta = -sa * nd + ca * nq
        b0 = (beta >= 0).long()
        b1 = (-0.5 * beta - s120 * alpha >= 0).long()
        b2 = (-0.5 * beta + s120 * alpha >= 0).long()
        re, im = table_re[b0, b1, b2].to(alpha.dtype), table_im[b0, b1, b2].to(alpha.dtype)
        ra = alpha * re - beta * im
        rb = alpha * im + beta * re
        pass_a = (ra >= -2 / 3) & (ra <= 2 / 3)
        pass_b = (rb >= 0) & (rb <= float(2 / 3 * np.sqrt(3.0)))
        oa = torch.clamp(ra, -2 / 3, 2 / 3) * re + torch.clamp(rb, 0, float(2 / 3 * np.sqrt(3.0))) * im
        ob = torch.clamp(rb, 0, float(2 / 3 * np.sqrt(3.0))) * re - torch.clamp(ra, -2 / 3, 2 / 3) * im
        l_oa = half_dc * (cb * l_ucd - sb * l_ucq)
        l_ob = half_dc * (sb * l_ucd + cb * l_ucq)
        l_adv = -sb * (half_dc * (oa * l_ucd + ob * l_ucq)) + cb * (half_dc * (ob * l_ucd - oa * l_ucq))
        l_ra = torch.where(pass_a, re * l_oa - im * l_ob, zero)
        l_rb = torch.where(pass_b, im * l_oa + re * l_ob, zero)
        l_alpha = re * l_ra + im * l_rb
        l_beta = -im * l_ra + re * l_rb
        l_nd, l_nq = ca * l_alpha - sa * l_beta, sa * l_alpha + ca * l_beta
        l_adv = l_adv + sa * (nd * l_alpha + nq * l_beta) - ca * (nq * l_alpha - nd * l_beta)
        l_a = [at(cot.traj[5], t) + l_nd * scale * ((mxd - mnd) / 2),
               at(cot.traj[6], t) + l_nq * scale * ((mxq - mnq) / 2)]

        # the affine law: a = b + K obs (+ c1), c1 = c + Ki obs
        l_obs = [K[0, i] * l_a[0] + K[1, i] * l_a[1] for i in range(n_obs)]
        if integral:
            l_c = [c + la for c, la in zip(l_c, l_a)]
            l_obs = [lo + Ki[0, i] * l_c[0] + Ki[1, i] * l_c[1] for i, lo in enumerate(l_obs)]
        for j in range(2):
            g_b[j] = g_b[j] + l_a[j]
            for i in range(n_obs):
                g_K[j][i] = g_K[j][i] + l_a[j] * obs[i]
                if integral:
                    g_Ki[j][i] = g_Ki[j][i] + l_c[j] * obs[i]

        # the observation: normalized currents, torque and buffers, cos/sin eps
        l_id = l_id + l_obs[0] * slope(0)
        l_iq = l_iq + l_obs[1] * slope(1)
        l_eps = l_eps + l_adv - torch.sin(eps) * l_obs[4] + torch.cos(eps) * l_obs[5]
        l_bd = l_bd + l_obs[6] * slope(4)
        l_bq = l_bq + l_obs[7] * slope(5)
        # the torque of this state: the observation's, and the save of the step before
        l_tau = l_obs[3] * slope(3) + (at(cot.traj[2], t - 1) if t else zero)
        if saturated:
            l_vals[4] = l_vals[4] + p15 * i_q * l_tau
            l_vals[5] = l_vals[5] - p15 * i_d * l_tau
            l_id = l_id - p15 * vals[5] * l_tau + sum(lv * s for lv, s in zip(l_vals, sx))
            l_iq = l_iq + p15 * vals[4] * l_tau + sum(lv * s for lv, s in zip(l_vals, sy))
        else:
            d_id, d_iq = torque_vjp(i_d, i_q, l_tau)
            l_id, l_iq = l_id + d_id, l_iq + d_iq

    per_drive = [*g_K[0], *g_K[1], *g_b] + ([*g_Ki[0], *g_Ki[1]] if integral else [])
    g_flat = torch.stack([p.to(torch.float64).sum() for p in per_drive]).to(flat.dtype)
    return (l_id, l_iq, l_eps, l_bd, l_bq), tuple(l_c), g_flat


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


class SliceTiling(NamedTuple):
    """The staged path's launch shape (:func:`slice_tiling`)."""

    perm: torch.Tensor  #: ``(B,)`` int32: thread position ``p`` serves drive ``perm[p]``
    block_slices: torch.Tensor  #: ``(blocks, n_staged)`` int32: the slices each block stages, -1 for none
    threads: int  #: threads of a block
    staged: int  #: drives whose slice their block stages

    @property
    def blocks(self) -> int:
        return self.block_slices.shape[0]

    @property
    def n_staged(self) -> int:
        return self.block_slices.shape[1]


def slice_tiling(slices, n_slices, slice_bytes, free_bytes, n_sm, max_threads=STAGED_THREADS[torch.float32]):
    """How the per-drive scheduled tile's launch stages its schedule:
    ``slices`` ``(B,)`` holds each drive's slice of ``n_slices`` of
    ``slice_bytes`` each, ``free_bytes`` is the shared memory a block has
    after the magnetics table, the flat parameters and the rotations, and
    ``n_sm`` the card's SMs.

    The drives are sorted by slice, stably (``perm``).  Blocks of
    ``threads`` (whole warps, at most ``max_threads``: the fewest that make
    the fleet one wave over ``n_sm``) cover contiguous ranges of that order,
    with no range padded to a slice's end.  Each block stages the slices
    that hold most of its drives (the lower slice first on a tie), as many
    as fit ``free_bytes`` (at most :data:`MAX_STAGED`) and no more than a
    block spans; a drive of any other slice reads it from device memory.
    ``None`` where not one slice fits: the launch takes the global path.
    Computed on the slices' device, with two reads back to the host."""
    batch = slices.shape[0]
    fit = min(MAX_STAGED, free_bytes // slice_bytes) if slice_bytes > 0 else 0
    if fit <= 0 or batch == 0:
        return None
    per_sm = -(-batch // n_sm)
    threads = min(max_threads, max(32, -(-per_sm // 32) * 32))
    blocks = -(-batch // threads)
    device = slices.device
    by_slice, order = torch.sort(slices, stable=True)
    block = torch.arange(batch, device=device) // threads
    counts = torch.bincount(block * n_slices + by_slice.long(), minlength=blocks * n_slices).view(blocks, n_slices)
    n_staged = min(fit, int((counts > 0).sum(1).max()))
    # most drives first, then the lower slice: every score of a row differs
    score = counts * n_slices + (n_slices - 1 - torch.arange(n_slices, device=device))
    top = score.topk(n_staged, dim=1).indices
    held = counts.gather(1, top)
    block_slices = torch.where(held > 0, top, -1).to(torch.int32).contiguous()
    return SliceTiling(order.to(torch.int32), block_slices, threads, int(held.sum()))


def _count_staging(tiling: SliceTiling | None, batch: int):
    """Count one launch of the per-drive scheduled tile in
    :data:`SLICE_STAGING`: ``tiling`` ``None`` for the global path.  Either
    path's blocks are whole warps over contiguous ranges, so only the last
    block's last warp has idle lanes."""
    if tiling is None:
        SLICE_STAGING["global_launches"] += 1
        SLICE_STAGING["blocks"] += -(-batch // THREADS)
    else:
        SLICE_STAGING["staged_launches"] += 1
        SLICE_STAGING["blocks"] += tiling.blocks
        SLICE_STAGING["staged_drives"] += tiling.staged
    SLICE_STAGING["drives"] += batch
    SLICE_STAGING["idle_lanes"] += -batch % 32


def kernel_variant(policy, policy_params=None) -> str:
    """The instantiation a launch of ``policy`` (a family of :data:`FAMILIES`)
    takes (:data:`VARIANTS`).  An :class:`~exciting_environments_torch.ops.policies.AffinePolicy`
    takes ``"affine_currents"`` where its own gains ``K`` and ``Ki``, held on
    the CPU, are zero in every column of :data:`SKIPPED_COLUMNS`: a skipped
    term is ``0 * x`` with ``x`` finite wherever the currents are, and adding
    it changes no nonzero sum, so the launch equals the plain version.  Gains
    given at call time (``policy_params``) or held on a card take
    ``"affine_all"``: reading them would wait on the card.  A launch plan
    keeps the answer, so it is asked once a spec, not once a chunk."""
    if policy.policy_id == 3 and getattr(policy, "per_drive", False):
        return "scheduled_drive"
    if policy.policy_id != 0:
        return _FAMILY_VARIANTS[policy.policy_id]
    gains = [g for g in (policy.K, policy.Ki) if g is not None]
    if policy_params is not None or any(g.device.type != "cpu" for g in gains):
        return "affine_all"
    read_only_currents = not any(bool(g[:, SKIPPED_COLUMNS].ne(0).any()) for g in gains)
    return "affine_currents" if read_only_currents else "affine_all"


def pack_drive(args, props, dtype, device, batch, ptr) -> list:
    """Write the drive's fields of a :class:`PmsmClArgs` (its parameters and
    bands, scalar or ``(B,)``, each ``(B,)`` leaf checked; the hexagon's
    advance of the angle; the sector rotations) into ``args``, the pointers
    through ``ptr`` (:class:`~.plans.Pointers`).  Returns the ``(B,)``
    leaves, in field order."""
    params = props.static_params
    per_batch = []
    for i, name in enumerate(PMSM_PARAMS):
        leaf = getattr(params, name)
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"parameter {name}", leaf, dtype, device, (batch,))
            per_batch.append(leaf)
            args.param_ptr[i] = ptr(leaf)
        else:
            args.param_value[i] = float(leaf)
    for i, (name, leaf) in enumerate(cl_bands(props).items()):
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"band {name}", leaf, dtype, device, (batch,))
            per_batch.append(leaf)
            args.band_ptr[i] = ptr(leaf)
        else:
            args.band_value[i] = leaf
    args.adv_scale = int(params.deadtime) + 0.5
    for i, (re, im) in enumerate(zip(ROTATION_RE.reshape(-1), ROTATION_IM.reshape(-1))):
        args.rot_re[i], args.rot_im[i] = float(re), float(im)
    return per_batch


def _chunk_args(args, state0, omega, carry0, ref_leaves, obs_noise_tm, proc_noise_tm, n_steps, traj_stride):
    """Write one launch's per-chunk pointers into ``args``: the start leaves,
    ``omega``, the references, the carry, the noise slabs and the outputs,
    allocated here.  Returns the wrapper's outputs and the tensors the
    launch reads."""
    dtype, device, batch = omega.dtype, omega.device, omega.shape[0]
    ptr = Pointers()
    new = lambda: torch.empty(batch, dtype=dtype, device=device)
    out = [new() for _ in range(6)]
    u_last = [new(), new()]
    c_out = [new() for _ in carry0]
    # each field read of a ctypes array makes a new view: one per field
    for field, tensors in ((args.out, out), (args.u_last, u_last), (args.carry_out, c_out)):
        for i, t in enumerate(tensors):
            field[i] = t.data_ptr()
    traj = traj_carry = None
    if traj_stride is not None:
        n_saves = n_steps // traj_stride
        new_traj = lambda: torch.empty((n_saves, batch), dtype=dtype, device=device)
        traj = [new_traj() for _ in range(7)]
        traj_carry = [new_traj() for _ in carry0]
        for field, tensors in ((args.traj, traj), (args.traj_carry, traj_carry)):
            for i, t in enumerate(tensors):
                field[i] = t.data_ptr()
    for field, leaves in ((args.state0, state0), (args.carry0, carry0), (args.refs, ref_leaves)):
        for i, leaf in enumerate(leaves):
            field[i] = ptr(leaf)
    args.omega = ptr(omega)
    args.obs_noise = None if obs_noise_tm is None else ptr(obs_noise_tm)
    args.proc_noise = None if proc_noise_tm is None else ptr(proc_noise_tm)
    if traj_stride is None:
        return (tuple(out), tuple(u_last), tuple(c_out), None, None), ptr.keep
    return (tuple(out), tuple(u_last), tuple(c_out), tuple(traj), tuple(traj_carry)), ptr.keep


def _plan_key(env, props, solver, policy, policy_params, sched_lut, tau, n_steps, traj_stride, dtype, device, batch,
              n_refs, n_carry, obs_noise_cols, proc_noise_idx, has_obs_noise, has_proc_noise) -> Key:
    """What :func:`kernel_pmsm_closed_loop`'s checks and static fields read."""
    key = Key().env(env, props, solver)
    lut = getattr(env, "_lut", None)
    key.leaf(None if lut is None else lut.values)
    key.obj(policy)
    key.leaf(policy_params)
    key.obj(sched_lut)
    key.leaf(None if sched_lut is None else sched_lut.slice_plane(device))
    key.leaf(tau)
    key.values(n_steps, traj_stride, dtype, device, batch, n_refs, n_carry, tuple(obs_noise_cols),
               tuple(proc_noise_idx), has_obs_noise, has_proc_noise)
    return key


def kernel_pmsm_closed_loop(env, state0, omega, policy, n_steps, *, tau, solver, props, ref_leaves=(),
                            traj_stride=None, policy_params=None, policy_carry=None, obs_noise_tm=None,
                            proc_noise_tm=None, obs_noise_cols=(), proc_noise_idx=(), sched_lut=None):
    """Launch the CUDA PMSM closed-loop kernel (argument contract:
    :func:`pmsm_closed_loop`; returns as :func:`plain_pmsm_closed_loop`).
    Every check runs before the launch; outputs are allocated here and the
    launch is asynchronous on the current stream.  Where autograd records
    the call (grad mode on and an input that requires grad), the launch is
    the forward of the checkpointed VJP (:class:`PmsmClosedLoopVJP`).

    A launch whose static inputs (everything but the start leaves, the
    references, the carry and the noise slabs) are those of a kept launch
    plan (:data:`PLANS`) checks only its per-chunk leaves and the policy's
    spec, and writes only the per-chunk pointers into a copy of the plan's
    struct: the kernel gets the same bytes as from the full path, and the
    same instantiation (:func:`kernel_variant`, counted in
    :data:`VARIANT_LAUNCHES`).  The per-drive scheduled tile's plan also
    keeps its slice tiling (:func:`slice_tiling`, counted in
    :data:`SLICE_STAGING`), so the drives are sorted by slice once a plan."""
    state0 = tuple(state0)
    dtype, device = state0[0].dtype, state0[0].device
    batch = state0[0].shape[0]
    carry0 = tuple(policy_carry) if policy_carry is not None else ()
    n_refs = len(ref_leaves)
    n_carry = len(carry0)
    key = None  # no plan for a policy that packs a new spec every launch, or no kernel policy
    if getattr(policy, "spec_packs", None) is not None:
        key = _plan_key(env, props, solver, policy, policy_params, sched_lut, tau, n_steps, traj_stride, dtype,
                        device, batch, n_refs, n_carry, obs_noise_cols, proc_noise_idx, obs_noise_tm is not None,
                        proc_noise_tm is not None)
    leaves = (*state0, omega, *ref_leaves, *carry0)

    def launch(args, extra):
        variant, detail, *tiling = extra  # the per-drive scheduled tile's slice tiling, or None
        PMSM_CL_KERNEL.launch(args, dtype, device, "pmsm_closed_loop", detail=f" ({variant} instantiation){detail}")
        VARIANT_LAUNCHES[variant] += 1
        if variant == "scheduled_drive":
            _count_staging(tiling[0], batch)

    outputs, spec = PLANS.launch(
        key, leaves, ((obs_noise_tm, (n_steps, batch, len(obs_noise_cols))),
                      (proc_noise_tm, (n_steps, batch, len(proc_noise_idx)))),
        policy, lambda: policy_spec(policy, dtype, device, policy_params), PmsmClArgs,
        lambda args: _chunk_args(args, state0, omega, carry0, ref_leaves, obs_noise_tm, proc_noise_tm, n_steps,
                                 traj_stride),
        launch)
    if outputs is not None:
        return outputs

    params = props.static_params
    saturated = bool(props.saturated)
    a_rows, b = _stage_rows(solver)
    if not isinstance(policy, KernelPolicy):
        raise ValueError(_PLAIN_CALLABLE_ON_CUDA)
    if policy.policy_id not in FAMILIES:
        raise ValueError(f"the PMSM closed-loop kernel is built with the families {sorted(FAMILIES.values())}, "
                         f"not {type(policy).__name__}")
    if device.type != "cuda":
        raise ValueError(f"the PMSM closed-loop kernel runs on CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the PMSM closed-loop kernel takes float32 or float64, got {dtype}")
    if len(b) not in KERNEL_STAGES or n_refs > MAX_REFS or n_carry > MAX_CARRY:
        raise ValueError("configuration exceeds the PMSM closed-loop kernel's stage/reference/carry limits")
    if isinstance(params.deadtime, torch.Tensor) or int(params.deadtime) not in (0, 1):
        raise ValueError("the PMSM closed-loop kernel takes a scalar deadtime of 0 or 1")
    if saturated and env._lut is None:
        raise ValueError("a saturated drive needs the motor variant's tables")
    if n_carry != policy.n_carry:
        raise ValueError(f"{type(policy).__name__} carries {policy.n_carry} leaves, policy_carry has {n_carry}")
    if policy.policy_id == 2 and saturated:
        raise ValueError("the kernel's SensorlessPolicy is built for linear magnetics")
    if policy.policy_id == 3 and (not saturated or len(b) != 1 or sched_lut is None):
        raise ValueError("the kernel's ScheduledSensorlessPolicy is built for the saturated drive with a "
                         "one-stage solver and its sched_lut")
    n_sched = 0
    if sched_lut is not None:
        if policy.policy_id != 3:
            raise ValueError("the kernel's scheduled gather feeds the ScheduledSensorlessPolicy family only")
        if sched_lut.values.shape[-3:] != (MAX_SCHED, env._lut.nx, env._lut.ny):
            raise ValueError(f"the kernel gathers {MAX_SCHED} scheduled channels on the drive's grid, got "
                             f"{sched_lut.values.shape}")
        if bool(sched_lut.n_slices) != getattr(policy, "per_drive", False):
            raise ValueError("a per-drive ScheduledSensorlessPolicy takes the per-drive ScheduledLUT of its "
                             "factory (a slice per speed and each drive's slice), and a scalar one a single table")
        if not all(0 <= c < n_carry for c in sched_lut.carry_idx):
            raise ValueError(f"sched_lut carry_idx {sched_lut.carry_idx} out of the {n_carry} carry leaves")
        n_sched = MAX_SCHED
    names = ("i_d0", "i_q0", "eps0", "u_d_buffer0", "u_q_buffer0")
    for name, leaf in zip(names + ("omega",), state0 + (omega,)):
        _check_leaf(name, leaf, dtype, device, (batch,))
    for i, leaf in enumerate(ref_leaves):
        _check_leaf(f"reference {i}", leaf, dtype, device, (batch,))
    for i, leaf in enumerate(carry0):
        _check_leaf(f"policy carry leaf {i}", leaf, dtype, device, (batch,))
    if spec is None:
        spec = policy_spec(policy, dtype, device, policy_params)
    if spec.planes and policy.policy_id != 3:
        raise ValueError(f"{type(policy).__name__} reads per-drive planes, which the PMSM closed-loop kernel "
                         "takes for the per-drive ScheduledSensorlessPolicy (make_pmsm_saturated_sensorless_"
                         "current_tile) only")
    if len(spec.planes) not in (0, MAX_POLICY_PLANES):
        raise ValueError(f"the per-drive scheduled tile reads {MAX_POLICY_PLANES} planes, got {len(spec.planes)}")
    for i, plane in enumerate(spec.planes):
        _check_leaf(f"policy plane {i}", plane, dtype, device, (batch,))
    flat = spec.flat
    static_grads = []  # the static tensors autograd could record
    n_obs = N_BASE_OBS + n_refs + n_sched
    if flat.numel() > MAX_POLICY_PARAMS:
        raise ValueError(f"{flat.numel()} policy parameters exceed the kernel's {MAX_POLICY_PARAMS}")
    if spec.n_obs != n_obs:
        raise ValueError(f"the policy reads {spec.n_obs} observation columns, the drive gives {n_obs}")
    widths = spec.options.get("widths", ())
    if widths and (len(widths) > MAX_LAYERS + 1 or max(widths) > MAX_WIDTH or widths[-1] != 2):
        raise ValueError(f"actor widths {widths}: at most {MAX_LAYERS} layers of at most {MAX_WIDTH}, two actions")

    args = PmsmClArgs()
    ptr = Pointers()  # the static fields' tensors, alive until the launch

    args.tau = float(tau)
    for s, row in enumerate(a_rows, start=1):
        for j, coef in enumerate(row):
            args.a[s][j] = float(coef)
    for j, coef in enumerate(b):
        args.b[j] = float(coef)
    for j, coef in enumerate(solver.b):
        args.rate_b[j] = float(coef)
    args.n_rate = len(solver.b)
    static_grads += pack_drive(args, props, dtype, device, batch, ptr)
    if (obs_noise_tm is not None) != bool(obs_noise_cols) or (proc_noise_tm is not None) != bool(proc_noise_idx):
        raise ValueError("each noise slab and its columns must be set together")
    if obs_noise_tm is not None:
        base = N_BASE_OBS + n_refs
        if len(obs_noise_cols) > MAX_OBS or not all(0 <= col < base for col in obs_noise_cols):
            raise ValueError(f"obs_noise_cols {obs_noise_cols} out of the {base} observation columns")
        _check_leaf("obs_noise_tm", obs_noise_tm, dtype, device, (n_steps, batch, len(obs_noise_cols)))
        for j, col in enumerate(obs_noise_cols):
            args.obs_cols[j] = col
        args.n_obs_noise = len(obs_noise_cols)
    if proc_noise_tm is not None:
        if len(proc_noise_idx) > 2 or not all(i in (0, 1) for i in proc_noise_idx):
            raise ValueError(f"proc_noise_idx {proc_noise_idx} must index the currents (0 = i_d, 1 = i_q)")
        _check_leaf("proc_noise_tm", proc_noise_tm, dtype, device, (n_steps, batch, len(proc_noise_idx)))
        for j, idx in enumerate(proc_noise_idx):
            args.noise_idx[j] = idx
        args.n_proc_noise = len(proc_noise_idx)
    grads = [*leaves, flat, *static_grads] + [t for t in (obs_noise_tm, proc_noise_tm) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        return pmsm_closed_loop_vjp(env, state0, omega, policy, n_steps, tau=tau, solver=solver, props=props,
                                    ref_leaves=ref_leaves, traj_stride=traj_stride, policy_params=policy_params,
                                    policy_carry=policy_carry, obs_noise_tm=obs_noise_tm,
                                    proc_noise_tm=proc_noise_tm, obs_noise_cols=obs_noise_cols,
                                    proc_noise_idx=proc_noise_idx, sched_lut=sched_lut)
    smem_bytes = (flat.numel() + 16) * flat.element_size()
    tables = []
    if saturated:
        lut = env._lut
        _check_leaf("LUT", lut.values, dtype, device, (N_CHANNELS, lut.nx, lut.ny))
        tables.append(lut.interleaved())
        args.lut = ptr(tables[-1])
        args.x0, args.dx, args.y0, args.dy = lut.x0, lut.dx, lut.y0, lut.dy
        args.nx, args.ny = lut.nx, lut.ny
        smem_bytes += tables[-1].numel() * tables[-1].element_size()
    if smem_bytes > MAX_DYNAMIC_SMEM:
        raise ValueError(f"the table and {flat.numel()} policy parameters need {smem_bytes} B of shared memory, "
                         f"above the {MAX_DYNAMIC_SMEM} B of one block")
    if n_sched:
        sched_table = sched_lut.interleaved(dtype, device)
        tables.append(sched_table)
        args.sched = ptr(sched_table)
        args.n_sched = n_sched
        args.sched_c0, args.sched_c1 = sched_lut.carry_idx
    if sched_lut is not None and sched_lut.n_slices:
        slices = sched_lut.slice_plane(device)
        _check_leaf("sched_lut slices", slices, torch.int32, device, (batch,))
        if not 0 <= int(slices.min()) <= int(slices.max()) < sched_lut.n_slices:
            raise ValueError(f"sched_lut slices out of its {sched_lut.n_slices} slices")
        tables.append(slices)
        args.sched_slices = ptr(slices)
        args.n_slices = sched_lut.n_slices
        args.slice_elems = sched_table[0].numel()
    variant = kernel_variant(policy, policy_params)
    tiling = None
    if variant == "scheduled_drive":
        # the staged path: the drives ordered by slice, each block's slices
        # after the rotations (16-byte aligned), where one fits (the global
        # path where none does)
        card = torch.cuda.get_device_properties(device)
        limit = min(MAX_DYNAMIC_SMEM, getattr(card, "shared_memory_per_block_optin", MAX_DYNAMIC_SMEM))
        slice_bytes = sched_table[0].numel() * sched_table.element_size()
        staged_at = -(-smem_bytes // 16) * 16
        tiling = slice_tiling(slices, sched_lut.n_slices, slice_bytes, limit - staged_at, card.multi_processor_count,
                              STAGED_THREADS[dtype])
    if tiling is not None:
        tables += [tiling.perm, tiling.block_slices]
        args.perm, args.block_slices = ptr(tiling.perm), ptr(tiling.block_slices)
        args.n_staged, args.block_threads = tiling.n_staged, tiling.threads
        smem_bytes = staged_at + tiling.n_staged * slice_bytes
    for i, plane in enumerate(spec.planes):
        args.policy_planes[i] = ptr(plane)
    args.n_planes = len(spec.planes)
    args.policy_params = ptr(flat) if flat.numel() else None
    args.batch = batch
    args.n_steps = n_steps
    args.n_stages = len(b)
    args.saturated = int(saturated)
    args.deadtime = int(params.deadtime)
    args.n_refs = n_refs
    args.n_carry = n_carry
    args.n_pp = flat.numel()
    args.policy_id = spec.policy_id
    for name, value in spec.options.items():
        if name == "widths":
            for l, w in enumerate(value):
                args.widths[l] = w
        else:
            setattr(args, name, value)
    args.traj_stride = traj_stride or 0
    args.affine_columns = int(variant == "affine_currents")
    static = PmsmClArgs.from_buffer_copy(args)

    outputs, chunk_keep = _chunk_args(args, state0, omega, carry0, ref_leaves, obs_noise_tm, proc_noise_tm, n_steps,
                                      traj_stride)
    detail = f" (dynamic shared memory asked: {smem_bytes} B)"
    if tiling is not None:
        detail += f" (staged: {tiling.blocks} blocks of {tiling.threads} threads, {tiling.n_staged} slices a block)"
    extra = (variant, detail, tiling)
    launch(args, extra)
    PLANS.missed(key, static, policy, ptr, grads=static_grads, hold=tables, extra=extra)
    return outputs


def kernel_sincos(x: torch.Tensor):
    """The kernel's float32 ``sincos_pair`` (``csrc/pmsm_closed_loop.cu``) over
    a contiguous float32 CUDA tensor: ``(sin, cos)``, for holding the kernel's
    trigonometry against ``torch.sin``/``torch.cos`` on the card."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("kernel_sincos takes a contiguous float32 CUDA tensor")
    fn = PMSM_CL_KERNEL.lib().pmsm_closed_loop_sincos
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    s, c = torch.empty_like(x), torch.empty_like(x)
    rc = fn(x.data_ptr(), s.data_ptr(), c.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pmsm_closed_loop sincos launch failed with CUDA error {rc}")
    return s, c


def sincos_mismatches(limit: float = 2.0 ** 7, chunk: int = 1 << 27) -> dict:
    """Every float32 ``x`` with ``|x| < limit`` through :func:`kernel_sincos`,
    held bit for bit against PyTorch's CUDA ``torch.sin``/``torch.cos`` of
    ``x`` and of ``-x`` (the kernel takes ``sin(-x)`` as ``-sin(x)`` and
    ``cos(-x)`` as ``cos(x)``).  Returns the count of mismatches per identity
    and the count of inputs."""
    end = int(np.array(limit, dtype=np.float32).view(np.int32))
    counts = {"sin": 0, "cos": 0, "sin(-x)": 0, "cos(-x)": 0, "inputs": 0}
    bits = lambda t: t.view(torch.int32)
    for start in range(0, end, chunk):
        pattern = torch.arange(start, min(start + chunk, end), dtype=torch.int32, device="cuda")
        for x in (pattern.view(torch.float32), -pattern.view(torch.float32)):
            s, c = kernel_sincos(x)
            counts["sin"] += int((bits(s) != bits(torch.sin(x))).sum())
            counts["cos"] += int((bits(c) != bits(torch.cos(x))).sum())
            counts["sin(-x)"] += int((bits(-s) != bits(torch.sin(-x))).sum())
            counts["cos(-x)"] += int((bits(c) != bits(torch.cos(-x))).sum())
            counts["inputs"] += x.numel()
    return counts


# ---------------------------------------------------------------------------
# the VJP: the kernel's forward with checkpoint saves, a segment replay back
# ---------------------------------------------------------------------------


def _eps_starts(eps0, omega, tau, solver, n_steps, ckpt):
    """The pre-step angle at every segment start ``(n_seg, B)``, the
    state-independent recurrence of :func:`_eps_trajectory`."""
    rate = _eps_rate(solver, omega)
    eps, out = eps0, []
    for t in range(n_steps):
        if t % ckpt == 0:
            out.append(eps)
        eps = wrap_angle(eps + tau * rate)
    return torch.stack(out)


class PmsmClosedLoopVJP(torch.autograd.Function):
    """The PMSM closed loop as one differentiable operation, the counterpart of
    the JAX package's ``_pmsm_cl_core`` ``custom_vjp``.

    Forward: the kernel on CUDA tensors, :func:`plain_pmsm_closed_loop` on
    CPU tensors, both on detached inputs and with saves every
    :func:`~.checkpoint.ckpt_stride` steps; the user's saves are a slice of
    them.  Its span is ``ee.vjp.forward``, the backward's ``ee.vjp.backward``.

    Backward, where the forward ran the kernel with a save every step and the
    rest is in the adjoint's scope
    (:func:`~.pmsm_closed_loop_adjoint.adjoint_scope`: ``AffinePolicy``
    without clip, explicit Euler, no noise slab or schedule, no cotangent
    wanted for ``omega``, the references or the properties' tensors): one
    launch of ``csrc/pmsm_closed_loop_adjoint.cu``, whose plain version is
    :func:`plain_pmsm_cl_adjoint`; ``None`` cotangents go to it as null
    pointers.  Otherwise: the segments in reverse, each replayed through
    :func:`plain_pmsm_cl_step` from its checkpoint (``_pmsm_cl_core_bwd``).
    :data:`BACKWARD_PATHS` counts both, the replay by its reason.
    A segment starts from the saved currents, the angle of the
    state-independent recurrence and, with deadtime, the saved constrained
    voltages as buffers (the initial buffers without).  The saved torque and
    voltages and the last applied voltage are outputs whose cotangents enter
    the replay.  The table and the scheduled maps are constants: they get no
    cotangent, as in the reference.  Inputs, after the configuration: the
    five state leaves, ``omega``, the references, the carry, the flat vector
    of the policy's ``KernelSpec``, the floating tensor leaves of ``props``
    and the two noise slabs (or ``None``)."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        with annotate("ee.vjp.forward"):
            ctx.set_materialize_grads(False)
            state0, (omega,), refs, carry0, pp, pt, (on,), (pn,) = cfg.split(tensors)
            ckpt = ck.ckpt_stride(cfg.n_steps, cfg.traj_stride)
            kwargs = dict(tau=cfg.tau, solver=cfg.solver, props=ck.props_with(cfg.props, pt), ref_leaves=refs,
                          traj_stride=ckpt, policy_params=cfg.rebuild(pp),
                          policy_carry=carry0 if cfg.n_carry else None, obs_noise_tm=on, proc_noise_tm=pn,
                          obs_noise_cols=cfg.obs_cols, proc_noise_idx=cfg.noise_idx, sched_lut=cfg.sched_lut)
            run = kernel_pmsm_closed_loop if omega.device.type == "cuda" else plain_pmsm_closed_loop
            final, u_last, final_c, traj, tc = run(cfg.env, state0, omega, cfg.policy, cfg.n_steps, **kwargs)
            ctx.cfg = cfg
            ctx.save_for_backward(*tensors[: cfg.n_in], *traj, *tc)
            out = tuple(final) + tuple(u_last) + tuple(final_c)
            if cfg.traj_stride is not None:
                at = slice(cfg.traj_stride // ckpt - 1, None, cfg.traj_stride // ckpt)
                out += tuple(leaf[at] for leaf in (*traj, *tc))
            return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        with annotate("ee.vjp.backward"):
            return PmsmClosedLoopVJP._backward(ctx, grads)

    @staticmethod
    def _backward(ctx, grads):
        from exciting_environments_torch.ops.kernels.pmsm_closed_loop_adjoint import adjoint_scope, \
            kernel_pmsm_cl_adjoint

        cfg = ctx.cfg
        saved = ctx.saved_tensors
        state0, (omega,), refs, carry0, pp, pt, (on,), (pn,) = cfg.split(saved[: cfg.n_in])
        traj, tc = saved[cfg.n_in : cfg.n_in + 7], saved[cfg.n_in + 7 :]
        env, nc = cfg.env, cfg.n_carry
        needs = ctx.needs_input_grad[1:]
        n_refs = len(refs)
        # the speed, the references and the properties' tensors
        side = (needs[5], *needs[6 : 6 + n_refs], *needs[6 + n_refs + nc + 1 : 6 + n_refs + nc + 1 + len(pt)])
        reason = adjoint_scope(omega.device, cfg.policy, cfg.solver, cfg.n_steps, cfg.traj_stride,
                               on is not None or pn is not None, cfg.sched_lut, any(side))
        if not reason:
            BACKWARD_PATHS["adjoint"] += 1
            saves = grads[8 + nc :] if cfg.traj_stride is not None else (None,) * (7 + nc)
            cot = AdjointCotangents(tuple(saves[:7]), tuple(saves[7:]), tuple(grads[:6]), tuple(grads[6:8]),
                                    tuple(grads[8 : 8 + nc]))
            g_state, g_c, g_flat = kernel_pmsm_cl_adjoint(env, cfg.policy, pp[0], state0, omega, refs, carry0, traj,
                                                          cot, tau=cfg.tau, props=ck.props_with(cfg.props, pt))
            return (None, *g_state, None, *(None,) * n_refs, *g_c, g_flat, *(None,) * len(pt), None, None)
        BACKWARD_PATHS["replay"][reason] = BACKWARD_PATHS["replay"].get(reason, 0) + 1
        deadtime = int(cfg.props.static_params.deadtime)
        ckpt = ck.ckpt_stride(cfg.n_steps, cfg.traj_stride)
        n_seg = cfg.n_steps // ckpt
        # outputs: final (i_d, i_q, eps, buf_d, buf_q, torque), u_last (2), carry, saves
        g_state, g_tq_f, g_ul = list(grads[:5]), grads[5], grads[6:8]
        g_c = list(grads[8 : 8 + nc])
        if cfg.traj_stride is not None:
            skip = cfg.traj_stride // ckpt
            g_tr = ck.inject(grads[8 + nc : 15 + nc], skip, n_seg)  # i_d, i_q, torque, u_con_d, u_con_q, a_d, a_q
            g_tc = ck.inject(grads[15 + nc :], skip, n_seg)
        else:
            g_tr, g_tc = (None,) * 7, (None,) * nc
        i_starts = ck.starts(state0[:2], traj[:2])
        e_starts = _eps_starts(state0[2], omega, cfg.tau, cfg.solver, cfg.n_steps, ckpt)
        if deadtime:
            b_starts = ck.starts(state0[3:5], traj[3:5])
        else:
            b_starts = tuple(leaf[None].expand((n_seg,) + tuple(leaf.shape)) for leaf in state0[3:5])
        c_starts = ck.starts(carry0, tc)
        i_refs = 6
        i_pp = i_refs + len(refs) + nc
        i_pt = i_pp + len(pp)
        i_on = i_pt + len(pt)
        need_om, need_refs = needs[5], needs[i_refs : i_refs + len(refs)]
        need_pp, need_pt, need_on, need_pn = needs[i_pp:i_pt], needs[i_pt:i_on], needs[i_on], needs[i_on + 1]
        g_om = None
        g_refs, g_pp, g_pt = [None] * len(refs), [None] * len(pp), [None] * len(pt)
        g_on = torch.zeros_like(on) if need_on else None
        g_pn = torch.zeros_like(pn) if need_pn else None
        at_seg = lambda g, s: None if g is None else g[s]
        # the saves of the carried state: the currents, and with deadtime the
        # constrained voltages, which are the next step's buffers
        g_sv = (g_tr[0], g_tr[1], None) + ((g_tr[3], g_tr[4]) if deadtime else (None, None))
        i_carry = 6 + len(refs)
        for s in reversed(range(n_seg)):
            t0, last = s * ckpt, s == n_seg - 1
            if last:
                g_state = [ck.add(g, at_seg(gs, s)) for g, gs in zip(g_state, g_sv)]
                g_c = [ck.add(g, at_seg(gs, s)) for g, gs in zip(g_c, g_tc)]
            # the saves at the segment's start enter as seeds of its start leaves
            seeds = ([(j, at_seg(gs, s - 1)) for j, gs in enumerate(g_sv)]
                     + [(i_carry + j, at_seg(gs, s - 1)) for j, gs in enumerate(g_tc)]) if s else []
            # a save's torque and the final torque are separate outputs, made in
            # the plain loop's order
            g_tqs = [g for g in (at_seg(g_tr[2], s), (g_tq_f if last else None)) if g is not None]
            # the saved voltages are outputs of the segment's last step; with
            # deadtime they are also the carried buffers (seeded above)
            g_aux = [None if deadtime and j < 2 else at_seg(g, s) for j, g in enumerate(g_tr[3:])]
            g_u = g_ul if last else (None, None)
            if all(g is None for g in (*g_state, *g_c, *g_tqs, *g_aux, *g_u, *(g for _, g in seeds))):
                if seeds:
                    g_state = [ck.add(g, gs) for g, (_, gs) in zip(g_state, seeds[:5])]
                    g_c = [ck.add(g, gs) for g, (_, gs) in zip(g_c, seeds[5:])]
                continue
            rows = slice(t0, t0 + ckpt)

            def replay(*leaves, t0=t0, g_state=list(g_state), g_c=g_c, g_tqs=g_tqs, g_aux=g_aux, g_u=g_u):
                state, (om,), rf, c, p, q, (eo,), (ep,) = cfg.split(leaves)
                props = ck.props_with(cfg.props, q)
                bands = eff_cl_norms(cl_bands(props))
                pparams = cfg.rebuild(p)
                for k in range(ckpt):
                    state, c, (a_d, a_q, ucd, ucq), u_app = plain_pmsm_cl_step(
                        env, cfg.policy, state, c, t0 + k, rf, pparams, tau=cfg.tau, solver=cfg.solver, props=props,
                        omega=om, bands=bands, deadtime=deadtime, has_carry=nc > 0,
                        eo=None if eo is None else eo[k], ep=None if ep is None else ep[k], obs_cols=cfg.obs_cols,
                        noise_idx=cfg.noise_idx, sched=cfg.sched_lut)
                pairs = [*zip(state, g_state), *zip(c, g_c), *zip((ucd, ucq, a_d, a_q), g_aux), *zip(u_app, g_u)]
                return pairs + [(env._torque(state[0], state[1], props), g) for g in g_tqs]

            seg_state = (i_starts[0][s], i_starts[1][s], e_starts[s], b_starts[0][s], b_starts[1][s])
            seg_inputs = [*seg_state, omega, *refs, *(leaf[s] for leaf in c_starts), *pp, *pt,
                          None if on is None else on[rows], None if pn is None else pn[rows]]
            seg_needs = [True] * 5 + [need_om, *need_refs] + [True] * nc + [*need_pp, *need_pt, need_on, need_pn]
            got = ck.segment_vjp(replay, seg_inputs, seg_needs, seeds)
            gs, (gom,), grf, gc, gp, gq, (gon,), (gpn,) = cfg.split(got)
            g_state, g_c = list(gs), list(gc)
            g_om = ck.add(g_om, gom)
            g_refs = [ck.add(a, b) for a, b in zip(g_refs, grf)]
            g_pp = [ck.add(a, b) for a, b in zip(g_pp, gp)]
            g_pt = [ck.add(a, b) for a, b in zip(g_pt, gq)]
            if gon is not None:
                g_on[rows] = gon
            if gpn is not None:
                g_pn[rows] = gpn
        return (None, *g_state, g_om, *g_refs, *g_c, *g_pp, *g_pt, g_on, g_pn)


def pmsm_closed_loop_vjp(env, state0, omega, policy, n_steps, *, tau, solver, props, ref_leaves=(),
                         traj_stride=None, policy_params=None, policy_carry=None, obs_noise_tm=None,
                         proc_noise_tm=None, obs_noise_cols=(), proc_noise_idx=(), sched_lut=None):
    """The closed loop through :class:`PmsmClosedLoopVJP` (arguments and
    returns as :func:`plain_pmsm_closed_loop`, on any device) of a compiled
    policy family."""
    state0 = tuple(state0)
    if traj_stride is not None and n_steps % traj_stride:
        raise ValueError("n_steps must be divisible by traj_stride")
    carry0 = tuple(policy_carry) if policy_carry is not None else ()
    flat = policy.kernel_spec(omega.dtype, omega.device, policy_params).flat
    pt = ck.prop_tensors(props)
    refs = tuple(ref_leaves)
    cfg = ck.VJPConfig((5, 1, len(refs), len(carry0), 1, len(pt), 1, 1), env=env, policy=policy,
                       n_steps=n_steps, tau=tau, solver=solver, props=props, traj_stride=traj_stride,
                       rebuild=lambda p: policy.params_from_flat(p[0], policy_params), n_carry=len(carry0),
                       obs_cols=tuple(obs_noise_cols), noise_idx=tuple(proc_noise_idx), sched_lut=sched_lut)
    out = PmsmClosedLoopVJP.apply(cfg, *state0, omega, *refs, *carry0, flat, *pt, obs_noise_tm, proc_noise_tm)
    nc = len(carry0)
    final, u_last, final_c = out[:6], out[6:8], out[8 : 8 + nc]
    if traj_stride is None:
        return final, u_last, final_c, None, None
    return final, u_last, final_c, out[8 + nc : 15 + nc], out[15 + nc :]


def pmsm_closed_loop(env, state0, omega, policy, n_steps, *, tau=None, solver=None, props=None, ref_leaves=(),
                     traj_stride=None, policy_params=None, policy_carry=None, obs_noise_tm=None, obs_noise_cols=(),
                     proc_noise_tm=None, proc_noise_idx=(), sched_lut=None):
    """Closed loop of the PMSM drive with ``policy`` inside: the kernel for
    CUDA tensors, :func:`plain_pmsm_closed_loop` for CPU tensors.

    Args:
        env: a :class:`~exciting_environments_torch.models.pmsm.PMSM` in
            :func:`supports_pmsm_fused` scope.
        state0: ``(i_d, i_q, epsilon, u_d_buffer, u_q_buffer)``, ``(B,)`` each.
        omega: ``(B,)`` frozen electrical speed.
        policy: the tile contract ``policy(obs, step[, carry][, params])``
            returning ``(a_d, a_q)`` (and the carry); on CUDA a family the
            kernel is built with (:data:`FAMILIES`).
        n_steps: horizon.
        tau, solver, props: step size, explicit RK solver and
            ``EnvProperties`` (default: the environment's).
        ref_leaves: normalized tracked references, ``(B,)`` each.
        traj_stride: also save every ``traj_stride``-th step.
        policy_params: passed to the policy as its last argument.
        policy_carry: tuple of ``(B,)`` carry leaves (a stateful policy).
        obs_noise_tm, obs_noise_cols: sensor-noise slab ``(n_steps, B,
            len(obs_noise_cols))`` added to those observation columns
            before the policy (row ``i`` is what the policy sees at step
            ``i``).
        proc_noise_tm, proc_noise_idx: process-noise slab ``(n_steps, B,
            len(proc_noise_idx))`` added to the currents (0 = ``i_d``,
            1 = ``i_q``) after each step.
        sched_lut: a :class:`~exciting_environments_torch.ops.lut.ScheduledLUT`
            gathered at the belief currents in the carry and appended to
            the observation.

    Returns:
        ``(final, u_last, final_carry, traj, traj_carry)``: ``final`` the
        ``(B,)`` leaves ``(i_d, i_q, epsilon, u_d_buffer, u_q_buffer,
        torque)``, ``u_last`` the voltage applied in the last step,
        ``final_carry`` a tuple (empty without a carry); with
        ``traj_stride`` the time-major ``(n_saves, B)`` saves ``(i_d, i_q,
        torque, u_con_d, u_con_q, a_d, a_q)`` and carry, else ``None``.
    """
    if traj_stride is not None and n_steps % traj_stride:
        raise ValueError("n_steps must be divisible by traj_stride")
    kwargs = dict(
        tau=env.tau if tau is None else tau, solver=env._solver if solver is None else solver,
        props=env.env_properties if props is None else props, ref_leaves=tuple(ref_leaves),
        traj_stride=traj_stride, policy_params=policy_params,
        policy_carry=None if policy_carry is None else tuple(policy_carry), obs_noise_tm=obs_noise_tm,
        proc_noise_tm=proc_noise_tm, obs_noise_cols=tuple(obs_noise_cols), proc_noise_idx=tuple(proc_noise_idx),
        sched_lut=sched_lut,
    )
    if state0[0].device.type == "cuda":
        return kernel_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kwargs)
    if isinstance(policy, KernelPolicy) and ck.records_grad(state0, omega, policy, kwargs):
        return pmsm_closed_loop_vjp(env, state0, omega, policy, n_steps, **kwargs)
    return plain_pmsm_closed_loop(env, state0, omega, policy, n_steps, **kwargs)


# ---------------------------------------------------------------------------
# scope and the environment-level entry point
# ---------------------------------------------------------------------------


def supports_pmsm_fused_closed_loop(env) -> bool:
    """Scope of the PMSM closed-loop kernel: :func:`supports_pmsm_fused`
    with a stage count the kernel is built for, scalar-or-``(B,)``
    observation and action bands and DC-link voltage, and at most
    ``MAX_REFS`` tracked references.  Any batch size is in scope."""
    if not supports_pmsm_fused(env):
        return False
    props = env.env_properties
    leaves = (structures.leaves(props.physical_normalizations) + structures.leaves(props.action_normalizations)
              + [props.static_params.u_dc])
    return (
        len(_stage_rows(env._solver)[1]) in KERNEL_STAGES
        and all(not isinstance(v, torch.Tensor) or tuple(v.shape) in ((), (env.batch_size,)) for v in leaves)
        and len(env.control_state) <= MAX_REFS
    )


def pmsm_fused_closed_loop(env, init_state, policy, n_steps: int, obs_stride: int = None,
                           return_traj_states: bool = False, policy_params=None, policy_carry=None,
                           sched_lut=None, env_properties=None):
    """Closed-loop PMSM rollout with the policy inside the drive kernel
    (:meth:`PMSM.fused_closed_loop`).

    The policy sees :meth:`PMSM.generate_observation`'s columns (normalized
    ``i_d, i_q, omega_el, torque``, raw ``cos/sin eps``, normalized buffers),
    then the normalized tracked references and, with ``sched_lut``, the
    scheduled channels (without it, the schedule the policy holds, as
    :func:`~exciting_environments_torch.utils.foc.make_pmsm_saturated_sensorless_current_tile`'s
    tile does).  Its action is constrained into the hexagon and applied with
    :meth:`PMSM.step`'s deadtime semantics.

    Returns ``(obs, final_state)``, or with ``obs_stride`` ``(obs_traj,
    actions_traj, final_state)`` with ``obs_traj`` ``(B, n_saves, obs_dim)``
    and ``actions_traj`` ``(B, n_saves, 2)`` (the policy's normalized
    actions); ``return_traj_states`` adds the per-save states before
    ``final_state``.  With ``policy_carry`` each gains the final carry tuple
    as its last element.  Raises out of scope: a closed loop has no
    open-loop fallback.

    A stochastic drive streams its draws as the classic closed loop does
    (:func:`~exciting_environments_torch.ops.kernels.closed_loop.closed_loop_noise`):
    the process half is the open loop's current slab, the sensor half the
    noisy columns' slab shifted one step (a per-batch span's sigma as ``(B,)``).
    ``env_properties`` replaces ``env.env_properties`` for this launch (a
    shard's property slices).
    """
    env = with_env_properties(env, env_properties)
    if return_traj_states and obs_stride is None:
        raise ValueError("return_traj_states requires obs_stride")
    if sched_lut is None:
        sched_lut = getattr(policy, "sched_lut", None)
    with annotate("ee.rollout.prepare"):
        scope = Key().env(env, env.env_properties, env._solver)
        if not PLANS.in_scope(scope, lambda: supports_pmsm_fused_closed_loop(env)):
            raise ValueError(
                "pmsm_fused_closed_loop out of kernel scope (supports_pmsm_fused, a kernel stage count, "
                "scalar-or-(batch,) bands and at most 4 tracked references are required)"
            )
        if sched_lut is not None:
            if not bool(env.env_properties.saturated) or env._lut is None:
                raise ValueError("sched_lut rides the saturated drive's LUT grid: construct the env with "
                                 "saturated=True and a motor variant with tables")
            lut = env._lut
            if sched_lut.values.shape[-2:] != (lut.nx, lut.ny):
                raise ValueError(f"sched_lut values {sched_lut.values.shape[-2:]} must live on the env LUT grid "
                                 f"({lut.nx}, {lut.ny})")
            if sched_lut.n_slices and tuple(sched_lut.slices.shape) != (env.batch_size,):
                raise ValueError(f"sched_lut slices {tuple(sched_lut.slices.shape)} must hold one slice per drive "
                                 f"({env.batch_size},)")
            if policy_carry is None:
                raise ValueError("sched_lut indexes the gather by belief planes in the policy carry: pass policy_carry")
        props = env.env_properties
        pn = props.physical_normalizations
        phys = init_state.physical_state
        state0 = (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer)
        omega = phys.omega_el
        # normalized tracked references, constant along the rollout
        ref_leaves = tuple(getattr(pn, name).normalize(getattr(init_state.reference, name))
                           for name in env.control_state)
        has_carry = policy_carry is not None
        noise = closed_loop_noise(env, init_state, n_steps, props)
        final, u_last, final_carry, traj, _ = pmsm_closed_loop(
            env, state0, omega, policy, n_steps, props=props, ref_leaves=ref_leaves, traj_stride=obs_stride,
            policy_params=policy_params, policy_carry=policy_carry, sched_lut=sched_lut, **noise.slabs,
        )
    with annotate("ee.rollout.rebuild"):
        i_d, i_q, eps_final, buf_d, buf_q, torque = final
        batch = env.batch_size
        device = i_d.device
        final_state = structures.replace(
            init_state,
            physical_state=env.PhysicalState(u_d_buffer=buf_d, u_q_buffer=buf_q, epsilon=eps_final, i_d=i_d, i_q=i_q,
                                             torque=torque, omega_el=omega),
            PRNGKey=noise.final_key(init_state),
            additions=env.Additions(
                solver_state=_pmsm_final_solver_state(env, props, i_d, i_q, eps_final, torch.stack(u_last, dim=-1),
                                                      omega),
                active_solver_state=torch.ones(batch, dtype=torch.bool, device=device),
            ),
        )
        tail = (tuple(final_carry),) if has_carry else ()
        if obs_stride is None:
            return (noise.final_obs(env.generate_observation(final_state, props)), final_state) + tail

        i_d_t, i_q_t, torque_t, ucd_t, ucq_t, a_d_t, a_q_t = (leaf.transpose(0, 1) for leaf in traj)
        n_saves = n_steps // obs_stride
        # the saved post-step angles: the state-independent replay of the open
        # loop, one launch on the card
        eps_pre, eps_last = angle_trajectory(phys.epsilon, omega, env.tau, n_steps, env._solver)
        eps_post = torch.cat([eps_pre[1:], eps_last[None]], dim=0)
        eps_saves = eps_post[obs_stride - 1 :: obs_stride].transpose(0, 1)
        expand = lambda leaf: torch.as_tensor(leaf)[:, None].expand(batch, n_saves)
        if int(props.static_params.deadtime):
            buf_d_t, buf_q_t = ucd_t, ucq_t  # the buffer after step k holds u_con[k]
        else:
            buf_d_t, buf_q_t = expand(phys.u_d_buffer), expand(phys.u_q_buffer)
        traj_state = structures.replace(
            final_state,
            physical_state=env.PhysicalState(u_d_buffer=buf_d_t, u_q_buffer=buf_q_t, epsilon=eps_saves, i_d=i_d_t,
                                             i_q=i_q_t, torque=torque_t, omega_el=expand(omega)),
            PRNGKey=noise.save_keys(init_state, obs_stride, n_saves),
            additions=env.Additions(solver_state=None,
                                    active_solver_state=torch.ones((batch, n_saves), dtype=torch.bool, device=device)),
            reference=structures.map_leaves(expand, init_state.reference),
        )
        obs_traj = noise.save_obs(env.generate_observation(traj_state, env._props_for(props, 1)), obs_stride)
        actions_traj = torch.stack([a_d_t, a_q_t], dim=-1)
        if return_traj_states:
            return (obs_traj, actions_traj, traj_state, final_state) + tail
        return (obs_traj, actions_traj, final_state) + tail
