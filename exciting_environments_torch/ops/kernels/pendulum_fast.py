"""Speed-of-light pendulum rollout: the counterpart of
``exciting_environments_tpu/ops/pallas/pendulum_fast.py``.

A fast-math Euler rollout of a pendulum fleet for the benchmark workload
(huge batch, long horizon): ``sin`` as the polynomial of ``ops/fastmath.py``,
the angle wrap as its floored-modulo identity, the action denormalization
folded into one multiply and one add, and the division by ``m l**2`` as a
multiply by its reciprocal.  It is gated on tolerance against the exact
path (``bench.py``'s ``ATOL_FAST = 1e-2`` rad over 24,576 steps), never on
exactness.

For CUDA tensors the whole horizon is one launch of the kernel in
``csrc/pendulum_fast.cu`` (one thread per pendulum, the state in registers,
the action slab streamed through a shared-memory ring from either layout in
place); beside it lives the plain PyTorch version,
:func:`plain_pendulum_fast_rollout`, a Python loop of the same operations.
:func:`pendulum_fast_rollout` takes the plain version only for CPU tensors.

The JAX function's quirks stay: it checks neither the solver nor
``env.fast_math``, runs in float32 whatever the state's dtype, and folds the
parameters into the program, so per-batch parameters raise.  It is
deterministic: it reads no process or sensor noise, and a stochastic
pendulum's noise options and keys are ignored here (the exact paths,
``fused_rollout`` and ``vmap_rollout``, draw them).  Its TPU
conditions (``batch % 128``, ``n_steps % chunk``) are gone: any B and any T
run, and ``chunk`` is accepted without effect on the result.
"""

from __future__ import annotations

import ctypes

import torch

from exciting_environments_torch.ops.fastmath import poly_sin, wrap_angle_fast

from .stepper import KernelLibrary, _check_leaf, _slab_layout

_c_double = ctypes.c_double
_c_void_p = ctypes.c_void_p


class PendulumFastArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct PendulumFastArgs`` in ``csrc/pendulum_fast.cu``."""

    _fields_ = [
        ("tau", _c_double),
        ("c_grav", _c_double),
        ("inv_ml2", _c_double),
        ("a_scale", _c_double),
        ("a_offset", _c_double),
        ("actions", _c_void_p),
        ("theta0", _c_void_p),
        ("omega0", _c_void_p),
        ("theta_out", _c_void_p),
        ("omega_out", _c_void_p),
        ("batch", ctypes.c_longlong),
        ("n_steps", ctypes.c_int),
        ("batch_major", ctypes.c_int),
    ]


KERNEL = KernelLibrary("pendulum_fast", "pendulum_fast", PendulumFastArgs, ("pendulum_fast",))


def fast_constants(env) -> dict:
    """The step's constants, folded in double as the JAX function folds them:
    ``tau``, ``c_grav = l m g``, ``inv_ml2 = 1 / (m l**2)`` and the torque
    normalization's ``a_scale``, ``a_offset``.  Per-batch leaves raise."""
    params = env.env_properties.static_params
    norm = env.env_properties.action_normalizations.torque
    if any(isinstance(v, torch.Tensor) for v in (params.l, params.m, params.g, norm.min, norm.max)):
        raise ValueError(
            "pendulum_fast_rollout folds scalar parameters into the kernel; per-batch (B,) "
            "parameters and torque bounds go through env.fused_rollout"
        )
    l, m, g = float(params.l), float(params.m), float(params.g)
    return dict(
        tau=float(env.tau), c_grav=float(l * m * g), inv_ml2=float(1.0 / (m * l**2)),
        a_scale=float((norm.max - norm.min) / 2.0), a_offset=float((norm.max + norm.min) / 2.0),
    )


def plain_pendulum_fast_rollout(theta0, omega0, actions_tm, *, tau, c_grav, inv_ml2, a_scale, a_offset):
    """The kernel's rollout as a Python loop over the normalized time-major
    actions ``(T, B)``; returns the final ``(theta, omega)``.  Runs on any
    device."""
    th, om = theta0, omega0
    for t in range(actions_tm.shape[0]):
        u = actions_tm[t] * a_scale + a_offset
        d_om = (u + c_grav * poly_sin(th)) * inv_ml2
        th1 = wrap_angle_fast(th + tau * om)
        om = om + tau * d_om
        th = th1
    return th, om


def kernel_pendulum_fast_rollout(theta0, omega0, slab, *, tau, c_grav, inv_ml2, a_scale, a_offset,
                                 batch_major=False):
    """Launch the CUDA kernel (argument contract:
    :func:`plain_pendulum_fast_rollout`, float32 CUDA tensors; with
    ``batch_major=True`` the slab is ``(B, T)``: the kernel reads either
    layout in place).  Outputs are allocated here; the launch is
    asynchronous on the current stream."""
    device, batch = theta0.device, theta0.shape[0]
    if device.type != "cuda":
        raise ValueError(f"the fast pendulum kernel runs on CUDA tensors, got {device}")
    for name, leaf in (("theta0", theta0), ("omega0", omega0)):
        _check_leaf(name, leaf, torch.float32, device, (batch,))
    n_steps = slab.shape[1] if batch_major else slab.shape[0]
    _check_leaf("actions", slab, torch.float32, device, (batch, n_steps) if batch_major else (n_steps, batch))
    if any(t.requires_grad for t in (theta0, omega0, slab)):
        raise NotImplementedError(
            "the fast pendulum kernel has no backward: it is forward-only, as the reference's "
            "kernel is (exciting_environments_tpu/ops/pallas/pendulum_fast.py:82 defines no VJP)"
        )
    keep = [t.contiguous() for t in (slab, theta0, omega0)]
    theta, omega = torch.empty_like(theta0), torch.empty_like(omega0)
    args = PendulumFastArgs(tau, c_grav, inv_ml2, a_scale, a_offset, *(t.data_ptr() for t in keep),
                            theta.data_ptr(), omega.data_ptr(), batch, n_steps, int(batch_major))
    KERNEL.launch(args, torch.float32, device, "pendulum_fast")
    return theta, omega


def kernel_slab(actions_norm, time_major: bool):
    """``(slab, batch_major)``: the normalized actions ``(B, T, 1)`` (or
    ``(T, B, 1)`` with ``time_major``) as the kernel reads them, ``(B, T)`` or
    ``(T, B)`` float32, in place where the slab is contiguous in either
    layout (``_slab_layout``)."""
    return _slab_layout(actions_norm.to(torch.float32)[..., 0], time_major)


def pendulum_fast_rollout(env, init_state, actions_norm, chunk: int = 16, time_major: bool = False):
    """Fast-math Euler rollout of a :class:`Pendulum` fleet.

    Args:
        env: a ``Pendulum`` with scalar parameters and torque bounds.
        init_state: batched state (``vmap_reset``).
        actions_norm: normalized actions ``(B, n_steps, 1)``, or ``(n_steps,
            B, 1)`` with ``time_major=True``.  The kernel reads a slab that
            is contiguous in either layout in place (``_slab_layout``); only
            a slab contiguous in neither is copied.
        chunk: accepted for the JAX signature; no effect on the result.
        time_major: see ``actions_norm``.

    Returns:
        ``(theta, omega)``, the final float32 states, each ``(B,)``: from the
        kernel for CUDA tensors, from the plain version for CPU tensors.
    """
    if chunk < 1:
        raise ValueError("chunk must be positive")
    if actions_norm.ndim != 3 or actions_norm.shape[2] != 1:
        raise ValueError(f"actions must be (B, n_steps, 1) or (n_steps, B, 1), got {tuple(actions_norm.shape)}")
    consts = fast_constants(env)
    phys = init_state.physical_state
    theta0 = phys.theta.to(torch.float32).reshape(-1)
    omega0 = phys.omega.to(torch.float32).reshape(-1)
    actions = actions_norm.to(torch.float32)[..., 0]
    actions_tm = actions if time_major else actions.transpose(0, 1)
    if actions_tm.shape[1] != theta0.shape[0]:
        raise ValueError(f"actions hold {actions_tm.shape[1]} instances, the state {theta0.shape[0]}")
    if theta0.device.type == "cuda":
        slab, batch_major = kernel_slab(actions_norm, time_major)
        return kernel_pendulum_fast_rollout(theta0, omega0, slab, batch_major=batch_major, **consts)
    return plain_pendulum_fast_rollout(theta0, omega0, actions_tm, **consts)
