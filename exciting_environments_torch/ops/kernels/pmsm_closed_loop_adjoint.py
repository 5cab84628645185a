"""The PMSM closed loop's reverse sweep as one kernel: the launch of
``csrc/pmsm_closed_loop_adjoint.cu``, its own kernel library.

:class:`~.pmsm_closed_loop.PmsmClosedLoopVJP` takes it in its backward where
the forward ran the kernel on CUDA tensors with a save every step (1-step
segments: ``obs_stride=1``, as :func:`~exciting_environments_torch.utils.train.train_policy`
asks for) and everything else is in the kernel's scope
(:func:`adjoint_scope`): the affine law without clip, explicit Euler, no
noise slab, no schedule, and no cotangent wanted for the speed, the
references or the properties' tensors.  One launch pulls back the
cotangents of every output onto the five start leaves, the carry and the
flat gains ``[K, b, Ki]``; its plain version is
:func:`~.pmsm_closed_loop.plain_pmsm_cl_adjoint`.
"""

from __future__ import annotations

import ctypes

import torch

from exciting_environments_torch.ops.kernels.checkpoint import ckpt_stride
from exciting_environments_torch.ops.kernels.pmsm_closed_loop import (
    MAX_CARRY,
    N_BASE_OBS,
    PmsmClArgs,
    pack_drive,
)
from exciting_environments_torch.ops.kernels.plans import Pointers
from exciting_environments_torch.ops.kernels.pmsm_stepper import N_CHANNELS
from exciting_environments_torch.ops.kernels.stepper import KernelLibrary, _check_leaf, _stage_rows

_c_void_p = ctypes.c_void_p
#: threads of a block (the kernel's ``ADJ_THREADS``)
THREADS = 128


class PmsmClAdjointArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct PmsmClAdjointArgs`` in ``csrc/pmsm_closed_loop_adjoint.cu``."""

    _fields_ = [
        ("fwd", PmsmClArgs),
        ("saves", _c_void_p * 7),
        ("g_traj", _c_void_p * 7),
        ("g_traj_carry", _c_void_p * MAX_CARRY),
        ("g_final", _c_void_p * 6),
        ("g_u_last", _c_void_p * 2),
        ("g_carry", _c_void_p * MAX_CARRY),
        ("eps", _c_void_p),
        ("g_state0", _c_void_p * 5),
        ("g_carry0", _c_void_p * MAX_CARRY),
        ("partials", _c_void_p),
        ("g_params", _c_void_p),
    ]


PMSM_CL_ADJOINT_KERNEL = KernelLibrary("pmsm_closed_loop_adjoint", "pmsm_closed_loop_adjoint", PmsmClAdjointArgs,
                                       ("adjoint",))


def adjoint_scope(device, policy, solver, n_steps, traj_stride, noise, sched_lut, needs_omega_refs_props) -> str:
    """Why a backward of :class:`~.pmsm_closed_loop.PmsmClosedLoopVJP` replays
    its plain step instead of launching the adjoint: ``"cpu"`` (the forward
    ran the plain loop), ``"family"`` (not ``AffinePolicy``, or one with a
    clip), ``"solver"`` (not explicit Euler), ``"noise"`` (a noise slab),
    ``"schedule"`` (a scheduled gather), ``"segments"`` (checkpoints more
    than one step apart: :func:`~.checkpoint.ckpt_stride`), ``"inputs"`` (a
    cotangent wanted for the speed, the references or the properties'
    tensors); ``""`` where the adjoint is in scope."""
    if device.type != "cuda":
        return "cpu"
    if policy.policy_id != 0 or getattr(policy, "clip", None) is not None:
        return "family"
    if len(_stage_rows(solver)[1]) != 1 or tuple(solver.b) != (1.0,):
        return "solver"
    if noise:
        return "noise"
    if sched_lut is not None:
        return "schedule"
    if ckpt_stride(n_steps, traj_stride) != 1:
        return "segments"
    if needs_omega_refs_props:
        return "inputs"
    return ""


def kernel_pmsm_cl_adjoint(env, policy, flat, state0, omega, ref_leaves, carry0, traj, cot, *, tau, props):
    """Launch the adjoint (arguments and returns as
    :func:`~.pmsm_closed_loop.plain_pmsm_cl_adjoint`, without the angles,
    which the kernel replays itself): ``(g_state0, g_carry0, g_flat)``.
    Asynchronous on the current stream; null pointers stand for the
    cotangents that are ``None``."""
    dtype, device, batch = omega.dtype, omega.device, omega.shape[0]
    n_steps, n_refs, n_carry = traj[0].shape[0], len(ref_leaves), len(carry0)
    params = props.static_params
    args = PmsmClAdjointArgs()
    fa = args.fwd
    ptr = Pointers()
    fa.tau = float(tau)
    fa.b[0] = fa.rate_b[0] = 1.0
    fa.n_stages = fa.n_rate = 1
    pack_drive(fa, props, dtype, device, batch, ptr)
    saturated = bool(props.saturated)
    if saturated:
        lut = env._lut
        _check_leaf("LUT", lut.values, dtype, device, (N_CHANNELS, lut.nx, lut.ny))
        fa.lut = ptr(lut.interleaved())
        fa.x0, fa.dx, fa.y0, fa.dy = lut.x0, lut.dx, lut.y0, lut.dy
        fa.nx, fa.ny = lut.nx, lut.ny
    for field, leaves in ((fa.state0, state0), (fa.carry0, carry0), (fa.refs, ref_leaves)):
        for i, leaf in enumerate(leaves):
            field[i] = ptr(leaf)
    fa.omega = ptr(omega)
    fa.policy_params = ptr(flat)
    fa.batch, fa.n_steps = batch, n_steps
    fa.saturated, fa.deadtime = int(saturated), int(params.deadtime)
    fa.n_refs, fa.n_carry, fa.n_pp = n_refs, n_carry, flat.numel()
    fa.policy_id, fa.has_integral = 0, int(policy.Ki is not None)
    if flat.numel() != 2 * (N_BASE_OBS + n_refs) * (2 if policy.Ki is not None else 1) + 2:
        raise ValueError(f"{flat.numel()} gains for an affine law over {N_BASE_OBS + n_refs} columns")

    for field, planes, shape in ((args.saves, traj, (n_steps, batch)), (args.g_traj, cot.traj, (n_steps, batch)),
                                 (args.g_traj_carry, cot.traj_carry, (n_steps, batch)),
                                 (args.g_final, cot.final, (batch,)), (args.g_u_last, cot.u_last, (batch,)),
                                 (args.g_carry, cot.carry, (batch,))):
        for i, plane in enumerate(planes):
            if plane is not None:
                _check_leaf("a save or cotangent", plane, dtype, device, shape)
            field[i] = None if plane is None else ptr(plane)
    new = lambda: torch.empty(batch, dtype=dtype, device=device)
    g_state0 = tuple(new() for _ in range(5))
    g_carry0 = tuple(new() for _ in range(n_carry))
    blocks = -(-batch // THREADS)
    partials = torch.empty((blocks, flat.numel()), dtype=torch.float64, device=device)
    g_flat = torch.empty(flat.numel(), dtype=dtype, device=device)
    eps = torch.empty((n_steps, batch), dtype=dtype, device=device)
    for field, tensors in ((args.g_state0, g_state0), (args.g_carry0, g_carry0)):
        for i, t in enumerate(tensors):
            field[i] = t.data_ptr()
    args.eps, args.partials, args.g_params = eps.data_ptr(), partials.data_ptr(), g_flat.data_ptr()
    PMSM_CL_ADJOINT_KERNEL.launch(args, dtype, device, "adjoint")
    return g_state0, g_carry0, g_flat
