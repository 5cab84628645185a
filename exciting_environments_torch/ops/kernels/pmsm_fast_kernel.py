"""Trig-free fused PMSM rollout: the counterpart of
``exciting_environments_tpu/ops/pallas/pmsm_fast_kernel.py``.

The fast-math semantics of :mod:`exciting_environments_torch.ops.pmsm_fast`
run inside one launch of the kernel in ``csrc/pmsm_fast.cu``: the hexagon
clip at the carried rotation, the deadtime buffer, the LUT gather or the
linear ODE, the Euler step and the rotation carry, streaming only the
normalized actions (no eager pre-pass, unlike the exact
``env.fused_rollout``).  The kernel's plain version is
:func:`~exciting_environments_torch.ops.pmsm_fast.plain_pmsm_fast_rollout`;
:func:`pmsm_fast_fused_rollout` takes it only for CPU tensors.

The carry's start, the rotation constants and the final angle are computed
here with the plain version's eager operations, so that the kernel and the
plain version start from identical tensors.  The JAX function's TPU options
(``gather=``, ``interpret=``, the chunk budget, ``batch % 1024``) have no
counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from exciting_environments_torch.ops.pmsm_fast import (
    fast_final_angle,
    fast_final_state,
    fast_inputs,
    fast_start,
    plain_pmsm_fast_rollout,
)
from exciting_environments_torch.ops.transforms import ROTATION_IM, ROTATION_RE

from .pmsm_stepper import N_CHANNELS, supports_pmsm_fused
from .stepper import KernelLibrary, _check_leaf

_c_double = ctypes.c_double
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


class PmsmFastArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct PmsmFastArgs`` in ``csrc/pmsm_fast.cu``."""

    _fields_ = [
        ("tau", _c_double),
        ("p15", _c_double),
        ("r_s", _c_double),
        ("l_d", _c_double),
        ("l_q", _c_double),
        ("psi_p", _c_double),
        ("dl", _c_double),
        ("inv_ld", _c_double),
        ("inv_lq", _c_double),
        ("a_scale_d", _c_double),
        ("a_off_d", _c_double),
        ("a_scale_q", _c_double),
        ("a_off_q", _c_double),
        ("to_halfdc", _c_double),
        ("from_halfdc", _c_double),
        ("x0", _c_double),
        ("dx", _c_double),
        ("y0", _c_double),
        ("dy", _c_double),
        ("rot_re", _c_double * 8),
        ("rot_im", _c_double * 8),
        ("lut", _c_void_p),
        ("actions", _c_void_p),
        ("state0", _c_void_p * 6),
        ("omega", _c_void_p),
        ("c_delta", _c_void_p),
        ("s_delta", _c_void_p),
        ("out", _c_void_p * 5),
        ("batch", ctypes.c_longlong),
        ("nx", _c_int),
        ("ny", _c_int),
        ("n_steps", _c_int),
        ("saturated", _c_int),
        ("deadtime", _c_int),
    ]


KERNEL = KernelLibrary("pmsm_fast", "pmsm_fast", PmsmFastArgs, ("pmsm_fast",))


def kernel_pmsm_fast_rollout(env, actions_tm, i_d, i_q, cA, sA, buf_d, buf_q, omega, c_delta, s_delta, consts):
    """Launch the CUDA kernel (argument contract:
    :func:`~exciting_environments_torch.ops.pmsm_fast.plain_pmsm_fast_rollout`).
    Outputs are allocated here; the launch is asynchronous on the current
    stream, and a refused launch raises."""
    dtype, device = i_d.dtype, i_d.device
    batch, n_steps = i_d.shape[0], actions_tm.shape[0]
    if device.type != "cuda":
        raise ValueError(f"the fast PMSM kernel runs on CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the fast PMSM kernel takes float32 or float64, got {dtype}")
    state0 = (i_d, i_q, cA, sA, buf_d, buf_q)
    per_drive = state0 + (omega, c_delta, s_delta)
    for j, leaf in enumerate(per_drive):
        _check_leaf(f"leaf {j}", leaf, dtype, device, (batch,))
    _check_leaf("actions_tm", actions_tm, dtype, device, (n_steps, batch, 2))
    if any(t.requires_grad for t in per_drive + (actions_tm,)):
        raise NotImplementedError(
            "the fast PMSM kernel has no backward yet: its VJP comes with the training slice, "
            "ROADMAP.md Queue 2 item 3"
        )
    keep = []  # tensors whose pointers the launch reads

    def ptr(t):
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    c = consts
    args = PmsmFastArgs()
    for name in ("tau", "p15", "r_s", "l_d", "l_q", "psi_p", "inv_ld", "inv_lq", "a_scale_d", "a_off_d",
                 "a_scale_q", "a_off_q", "to_halfdc", "from_halfdc"):
        setattr(args, name, c[name])
    args.dl = c["l_d"] - c["l_q"]
    for i, (re, im) in enumerate(zip(ROTATION_RE.reshape(-1), ROTATION_IM.reshape(-1))):
        args.rot_re[i], args.rot_im[i] = float(re), float(im)
    smem_bytes = 0
    if c["saturated"]:
        lut = env._lut
        _check_leaf("LUT", lut.values, dtype, device, (N_CHANNELS, lut.nx, lut.ny))
        args.lut = ptr(lut.values)
        args.x0, args.dx, args.y0, args.dy = lut.x0, lut.dx, lut.y0, lut.dy
        args.nx, args.ny = lut.nx, lut.ny
        smem_bytes = lut.values.numel() * lut.values.element_size()
    args.actions = ptr(actions_tm)
    for j, leaf in enumerate(state0):
        args.state0[j] = ptr(leaf)
    args.omega, args.c_delta, args.s_delta = ptr(omega), ptr(c_delta), ptr(s_delta)
    out = [torch.empty(batch, dtype=dtype, device=device) for _ in range(5)]
    for j, t in enumerate(out):
        args.out[j] = t.data_ptr()
    args.batch = batch
    args.n_steps = n_steps
    args.saturated = int(c["saturated"])
    args.deadtime = c["deadtime"]
    KERNEL.launch(args, dtype, device, "pmsm_fast", detail=f" (dynamic shared memory asked: {smem_bytes} B)")
    return tuple(out)


def pmsm_fast_fused_rollout(env, init_state, actions_norm, time_major: bool = False):
    """Trig-free rollout of a PMSM drive with the whole step in one kernel
    launch (the plain version for CPU tensors); the semantics and accuracy of
    :func:`~exciting_environments_torch.ops.pmsm_fast.pmsm_fast_rollout`.

    Args:
        env: a :class:`PMSM` with linear or saturated magnetics, scalar
            parameters and action bounds, the Euler solver, deadtime 0 or 1.
        init_state: batched state (``vmap_reset``).
        actions_norm: normalized dq voltages ``(B, n_steps, 2)``, or
            ``(n_steps, B, 2)`` with ``time_major=True`` (the layout the
            kernel reads; batch-major input costs one transposed copy).

    Returns:
        the final batched ``State`` (``omega_el`` broadcast to ``(B,)``, no
        solver carry).  Out of scope it raises ``ValueError``.
    """
    if not supports_pmsm_fused(env):
        raise ValueError("pmsm_fast_fused_rollout requires a drive in the fused kernels' scope")
    consts, actions_tm, leaves = fast_inputs(env, init_state, actions_norm, time_major)
    eps, omega = leaves["epsilon"], leaves["omega_el"]
    cA, sA, c_delta, s_delta = fast_start(eps, omega, consts)
    run = kernel_pmsm_fast_rollout if eps.device.type == "cuda" else plain_pmsm_fast_rollout
    i_d, i_q, buf_d, buf_q, torque = run(
        env, actions_tm, leaves["i_d"], leaves["i_q"], cA, sA, leaves["u_d_buffer"], leaves["u_q_buffer"],
        omega, c_delta, s_delta, consts,
    )
    eps_final = fast_final_angle(eps, omega, consts, actions_tm.shape[0])
    return fast_final_state(env, init_state, leaves, i_d, i_q, eps_final, torque, buf_d, buf_q)
