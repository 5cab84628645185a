"""The PMSM drive's angle recurrence in one launch: ``csrc/pmsm_angles.cu``,
its own kernel library.

:func:`angle_trajectory` is :func:`~.pmsm_stepper._eps_trajectory` (the
pre-step angles ``(T, B)`` and the final angle of ``eps <- wrap(eps + tau *
rate)``) in one launch for CUDA tensors that autograd does not record, with
the same values bit for bit; the eager loop otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from exciting_environments_torch.ops.kernels.checkpoint import records_grad
from exciting_environments_torch.ops.kernels.pmsm_stepper import _eps_rate, _eps_trajectory
from exciting_environments_torch.ops.kernels.stepper import KernelLibrary


class PmsmAnglesArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct PmsmAnglesArgs`` in ``csrc/pmsm_angles.cu``."""

    _fields_ = [
        ("tau", ctypes.c_double),
        ("eps0", ctypes.c_void_p),
        ("rate", ctypes.c_void_p),
        ("seq", ctypes.c_void_p),
        ("final", ctypes.c_void_p),
        ("batch", ctypes.c_longlong),
        ("n_steps", ctypes.c_int),
    ]


PMSM_ANGLES_KERNEL = KernelLibrary("pmsm_angles", "pmsm_angles", PmsmAnglesArgs, ("angles",))


def angle_trajectory(eps0, omega, tau, n_steps: int, solver):
    """``(eps_seq (T, B), eps_final (B,))`` as :func:`~.pmsm_stepper._eps_trajectory`
    returns them: one launch of ``csrc/pmsm_angles.cu`` for contiguous
    float32 or float64 CUDA leaves of one dtype that autograd does not
    record, the eager loop for any others."""
    if not (eps0.is_cuda and eps0.dtype in (torch.float32, torch.float64) and omega.dtype == eps0.dtype
            and eps0.ndim == 1 and omega.shape == eps0.shape and not records_grad(eps0, omega)):
        return _eps_trajectory(eps0, omega, tau, n_steps, solver)
    rate = _eps_rate(solver, omega).contiguous()
    eps0 = eps0.contiguous()
    seq = torch.empty((n_steps, eps0.shape[0]), dtype=eps0.dtype, device=eps0.device)
    final = torch.empty_like(eps0)
    args = PmsmAnglesArgs(tau=float(tau), eps0=eps0.data_ptr(), rate=rate.data_ptr(), seq=seq.data_ptr(),
                          final=final.data_ptr(), batch=eps0.shape[0], n_steps=n_steps)
    PMSM_ANGLES_KERNEL.launch(args, eps0.dtype, eps0.device, "angles")
    return seq, final
