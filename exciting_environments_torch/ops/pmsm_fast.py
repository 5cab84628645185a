"""Fast-math PMSM rollout: trigonometry-free electrical drive stepping
(counterpart of ``exciting_environments_tpu/ops/pmsm_fast.py``).

``omega_el`` is constant along a rollout, so the Park rotations at the
deadtime-advanced angle collapse into an incremental 2-D rotation:

* ``(cos, sin)`` of the advanced angle are carried as state and advanced
  each step by one rotation with the per-trajectory constants
  ``(cos(omega tau), sin(omega tau))``, renormalized to first order;
* the hexagon's sector bits ``sin(angle - k 120 deg) >= 0`` are linear sign
  tests on ``(alpha, beta)`` (:func:`hex_clip_fast`, no ``atan2``);
* the final electrical angle is reconstructed once in closed form.

The rotation carry drifts by O(T ulp) from evaluating ``cos``/``sin``
directly, so the fast path is tolerance-gated against the exact one (1e-4 of
the current scale over 32 steps), never exact.

:func:`plain_pmsm_fast_rollout` is the step loop, and the plain version of
the kernel in ``csrc/pmsm_fast.cu``
(:mod:`exciting_environments_torch.ops.kernels.pmsm_fast_kernel`).
:func:`pmsm_fast_rollout` wraps it at the environment level: it runs the
loop eagerly on any device and is the reference that the kernel is held
against.  Users call ``PMSM.fast_rollout``, which launches the kernel on
CUDA tensors.  Scope: linear or LUT-saturated magnetics, scalar parameters
and action bounds, the Euler solver, deadtime 0 or 1; the rest raises
``ValueError``.
"""

from __future__ import annotations

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.fastmath import wrap_angle_fast
from exciting_environments_torch.ops.lut import bilinear_gather
from exciting_environments_torch.ops.solvers import Euler
from exciting_environments_torch.ops.transforms import _rotation_tables

_S3H = float(np.sqrt(3.0) / 2.0)


def hex_clip_fast(alpha, beta):
    """Voltage-hexagon clip of ``(alpha, beta)`` without trigonometry.

    The sector test ``sin(angle(u) - k 120 deg) >= 0`` is the sign of the
    cross product of ``u`` with the k-th symmetry axis, a linear function of
    ``(alpha, beta)``.  The sector rotation is a direct index of the float32
    table of ``ops/transforms.py``; the JAX package combines the table
    multilinearly in the three {0, 1} bits, which gives the same values up to
    the sign of a zero entry.
    """
    b0 = (beta >= 0).long()
    b1 = ((-0.5) * beta - _S3H * alpha >= 0).long()
    b2 = ((-0.5) * beta + _S3H * alpha >= 0).long()
    table_re, table_im = _rotation_tables(alpha.device)
    rot_re = table_re[b0, b1, b2].to(alpha.dtype)
    rot_im = table_im[b0, b1, b2].to(alpha.dtype)
    ra = alpha * rot_re - beta * rot_im
    rb = alpha * rot_im + beta * rot_re
    ra = torch.clamp(ra, -2.0 / 3.0, 2.0 / 3.0)
    rb = torch.clamp(rb, 0.0, float(2.0 / 3.0 * np.sqrt(3.0)))
    oa = ra * rot_re + rb * rot_im
    ob = rb * rot_re - ra * rot_im
    return oa, ob


def fast_constants(env) -> dict:
    """The fast path's scope check and its constants, folded in double as the
    JAX package folds them.  Raises ``ValueError`` out of scope."""
    props = env.env_properties
    params, an = props.static_params, props.action_normalizations
    leaves = structures.leaves(params) + structures.leaves(an)
    if any(isinstance(leaf, torch.Tensor) for leaf in leaves):
        raise ValueError(
            "the fast PMSM rollout folds all parameters into the program; per-batch (B,) "
            "parameters and action bounds go through env.fused_rollout"
        )
    if int(params.deadtime) not in (0, 1) or params.deadtime != int(params.deadtime):
        raise ValueError("the fast PMSM rollout takes a deadtime of 0 or 1")
    if env._has_noise:
        raise ValueError(
            "the fast PMSM rollout integrates deterministically; stochastic drives go through "
            "vmap_rollout or the exact fused kernel (env.fused_rollout)"
        )
    if type(env._solver) is not Euler:
        raise ValueError("the fast PMSM rollout requires the Euler solver")
    saturated = bool(props.saturated)
    if saturated:
        if env._lut is None:
            raise ValueError("a saturated drive needs the motor variant's tables")
        # the linear parameters are NaN in the saturated preset and unused
        l_d = l_q = 1.0
        psi_p = 0.0
    else:
        l_d, l_q, psi_p = float(params.l_d), float(params.l_q), float(params.psi_p)
    u_dc = float(params.u_dc)
    return dict(
        tau=float(env.tau), p15=1.5 * float(params.p), r_s=float(params.r_s),
        l_d=l_d, l_q=l_q, psi_p=psi_p, inv_ld=1.0 / l_d, inv_lq=1.0 / l_q, deadtime=int(params.deadtime),
        a_scale_d=float((an.u_d.max - an.u_d.min) / 2.0), a_off_d=float((an.u_d.max + an.u_d.min) / 2.0),
        a_scale_q=float((an.u_q.max - an.u_q.min) / 2.0), a_off_q=float((an.u_q.max + an.u_q.min) / 2.0),
        to_halfdc=2.0 / u_dc, from_halfdc=u_dc / 2.0, saturated=saturated,
    )


def fast_start(eps, omega, consts):
    """The rotation carry's start ``(cA, sA)`` at the deadtime-advanced
    angle and its per-step constants ``(cos(omega tau), sin(omega tau))``."""
    tau = consts["tau"]
    delta = omega * tau
    adv0 = eps + (consts["deadtime"] + 0.5) * tau * omega
    return torch.cos(adv0), torch.sin(adv0), torch.cos(delta), torch.sin(delta)


def fast_final_angle(eps, omega, consts, n_steps):
    """The electrical angle after ``n_steps``, in closed form."""
    return wrap_angle_fast(eps + n_steps * (omega * consts["tau"]))


def advance_rotation(cA, sA, c_delta, s_delta):
    """One step of the rotation carry: rotate ``(cA, sA)`` by the per-step
    constants, then renormalize to first order."""
    cA, sA = cA * c_delta - sA * s_delta, sA * c_delta + cA * s_delta
    r2 = cA * cA + sA * sA
    corr = 0.5 * (3.0 - r2)
    return cA * corr, sA * corr


def _lut_args(env):
    lut = env._lut
    return lut.values, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny


def plain_pmsm_fast_rollout(env, actions_tm, i_d, i_q, cA, sA, buf_d, buf_q, omega, c_delta, s_delta, consts):
    """The fast step loop over normalized time-major actions ``(T, B, 2)`` and
    ``(B,)`` leaves; returns the final ``(i_d, i_q, buf_d, buf_q, torque)``.
    Runs on any device; the kernel's plain version."""
    c = consts
    tau, r_s = c["tau"], c["r_s"]
    for t in range(actions_tm.shape[0]):
        u_d = actions_tm[t, :, 0] * c["a_scale_d"] + c["a_off_d"]
        u_q = actions_tm[t, :, 1] * c["a_scale_q"] + c["a_off_q"]
        nd = u_d * c["to_halfdc"]
        nq = u_q * c["to_halfdc"]
        # dq -> alpha/beta at the advanced angle, the hexagon, and back
        alpha = cA * nd - sA * nq
        beta = sA * nd + cA * nq
        alpha, beta = hex_clip_fast(alpha, beta)
        ud_c = (cA * alpha + sA * beta) * c["from_halfdc"]
        uq_c = (-sA * alpha + cA * beta) * c["from_halfdc"]
        if c["deadtime"] > 0:
            u_app_d, u_app_q = buf_d, buf_q
            buf_d, buf_q = ud_c, uq_c
        else:
            u_app_d, u_app_q = ud_c, uq_c
        # Euler step of the currents (old currents on the right-hand side)
        if c["saturated"]:
            l_dd, l_dq, l_qd, l_qq, psi_d, psi_q = bilinear_gather(*_lut_args(env), i_d, i_q)
            det = l_dd * l_qq - l_dq * l_qd
            rhs_d = u_app_d - r_s * i_d + omega * psi_q
            rhs_q = u_app_q - r_s * i_q - omega * psi_d
            di_d = (l_qq * rhs_d - l_dq * rhs_q) / det
            di_q = (l_dd * rhs_q - l_qd * rhs_d) / det
        else:
            di_d = (u_app_d + omega * c["l_q"] * i_q - r_s * i_d) * c["inv_ld"]
            di_q = (u_app_q - omega * (c["l_d"] * i_d + c["psi_p"]) - r_s * i_q) * c["inv_lq"]
        i_d = i_d + tau * di_d
        i_q = i_q + tau * di_q
        cA, sA = advance_rotation(cA, sA, c_delta, s_delta)
    if c["saturated"]:
        vals = bilinear_gather(*_lut_args(env), i_d, i_q)
        torque = c["p15"] * (vals[4] * i_q - vals[5] * i_d)
    else:
        torque = c["p15"] * (c["psi_p"] + (c["l_d"] - c["l_q"]) * i_d) * i_q
    return i_d, i_q, buf_d, buf_q, torque


def fast_inputs(env, init_state, actions_norm, time_major):
    """The rollout's inputs: the scope's constants, the time-major actions
    ``(T, B, 2)`` in the state's dtype, and every physical leaf in that dtype
    broadcast to ``(B,)``."""
    consts = fast_constants(env)
    phys = init_state.physical_state
    dtype, device = phys.i_d.dtype, phys.i_d.device
    batch = env.batch_size
    bc = lambda v: torch.broadcast_to(torch.as_tensor(v, dtype=dtype, device=device), (batch,))
    leaves = {n: bc(getattr(phys, n)) for n in ("i_d", "i_q", "epsilon", "omega_el", "u_d_buffer", "u_q_buffer")}
    if actions_norm.ndim != 3 or actions_norm.shape[2] != 2:
        raise ValueError(f"actions must be (B, n_steps, 2) or (n_steps, B, 2), got {tuple(actions_norm.shape)}")
    actions_tm = (actions_norm if time_major else actions_norm.transpose(0, 1)).to(dtype)
    if actions_tm.shape[1] != batch:
        raise ValueError(f"actions hold {actions_tm.shape[1]} drives, the environment {batch}")
    return consts, actions_tm, leaves


def fast_final_state(env, init_state, leaves, i_d, i_q, eps_final, torque, buf_d, buf_q):
    """The final batched ``State`` (``vmap_rollout``'s structure, no solver
    carry)."""
    phys = structures.replace(
        init_state.physical_state, i_d=i_d, i_q=i_q, epsilon=eps_final, torque=torque,
        u_d_buffer=buf_d, u_q_buffer=buf_q, omega_el=leaves["omega_el"],
    )
    return structures.replace(
        init_state, physical_state=phys,
        additions=env.Additions(solver_state=None,
                                active_solver_state=torch.ones(env.batch_size, dtype=torch.bool, device=i_d.device)),
    )


def pmsm_fast_rollout(env, init_state, actions_norm, time_major: bool = False):
    """Trig-free rollout of a PMSM drive, step by step in eager PyTorch on the
    state's device: the plain version of ``PMSM.fast_rollout`` at the
    environment level.

    Args:
        env: a :class:`PMSM` in the fast scope (:func:`fast_constants`).
        init_state: batched state (``vmap_reset``).
        actions_norm: normalized dq voltages ``(B, n_steps, 2)``, or
            ``(n_steps, B, 2)`` with ``time_major=True``.

    Returns:
        the final batched ``State``.
    """
    consts, actions_tm, leaves = fast_inputs(env, init_state, actions_norm, time_major)
    eps, omega = leaves["epsilon"], leaves["omega_el"]
    cA, sA, c_delta, s_delta = fast_start(eps, omega, consts)
    i_d, i_q, buf_d, buf_q, torque = plain_pmsm_fast_rollout(
        env, actions_tm, leaves["i_d"], leaves["i_q"], cA, sA, leaves["u_d_buffer"], leaves["u_q_buffer"],
        omega, c_delta, s_delta, consts,
    )
    eps_final = fast_final_angle(eps, omega, consts, actions_tm.shape[0])
    return fast_final_state(env, init_state, leaves, i_d, i_q, eps_final, torque, buf_d, buf_q)
