"""Trig-free fused PMSM rollout: the counterpart of
``exciting_environments_tpu/ops/pallas/pmsm_fast_kernel.py``.

The fast-math semantics of :mod:`exciting_environments_torch.ops.pmsm_fast`
run inside one launch of the kernel in ``csrc/pmsm_fast.cu``: the carry's
start, the hexagon clip at the carried rotation, the deadtime buffer, the LUT
gather or the linear ODE, the Euler step, the rotation carry, the final
torque and the final angle, streaming only the normalized actions (read in
place from either layout) and reading the per-drive leaves in place (a
broadcast scalar with stride 0).  So :func:`pmsm_fast_fused_rollout` on CUDA
tensors is one launch and no eager pre- or post-pass.

The kernel's plain version is :func:`plain_kernel_rollout`: the plain
version's eager start (``fast_start``), its step loop
(:func:`~exciting_environments_torch.ops.pmsm_fast.plain_pmsm_fast_rollout`)
and its final angle (``fast_final_angle``); :func:`pmsm_fast_fused_rollout`
takes it only for CPU tensors.  The JAX function's TPU options
(``gather=``, ``interpret=``, the chunk budget, ``batch % 1024``) have no
counterpart.
"""

from __future__ import annotations

import ctypes

import torch

from exciting_environments_torch.ops.lut import padded_channels
from exciting_environments_torch.ops.pmsm_fast import (
    fast_constants,
    fast_final_angle,
    fast_final_state,
    fast_inputs,
    fast_start,
    plain_pmsm_fast_rollout,
)
from exciting_environments_torch.ops.transforms import ROTATION_IM, ROTATION_RE

from .pmsm_stepper import N_CHANNELS, supports_pmsm_fused
from .stepper import KernelLibrary, _check_leaf, _slab_layout

_c_double = ctypes.c_double
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_longlong = ctypes.c_longlong

#: the per-drive leaves, in the kernel's order
LEAVES = ("i_d", "i_q", "epsilon", "omega_el", "u_d_buffer", "u_q_buffer")


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
        ("adv_scale", _c_double),
        ("rot_re", _c_double * 8),
        ("rot_im", _c_double * 8),
        ("lut", _c_void_p),
        ("actions", _c_void_p),
        ("leaf", _c_void_p * 6),
        ("leaf_stride", _c_longlong * 6),
        ("out", _c_void_p * 6),
        ("batch", _c_longlong),
        ("nx", _c_int),
        ("ny", _c_int),
        ("n_steps", _c_int),
        ("saturated", _c_int),
        ("deadtime", _c_int),
        ("batch_major", _c_int),
    ]


KERNEL = KernelLibrary("pmsm_fast", "pmsm_fast", PmsmFastArgs, ("pmsm_fast",))
#: the rotation table as the argument struct holds it (doubles of the float32 values)
_ROT_RE = (_c_double * 8)(*(float(v) for v in ROTATION_RE.reshape(-1)))
_ROT_IM = (_c_double * 8)(*(float(v) for v in ROTATION_IM.reshape(-1)))


def _dtype_code(dtype: torch.dtype) -> int:
    return 0 if dtype == torch.float32 else 1


def shared_memory_bytes(args: PmsmFastArgs, dtype: torch.dtype) -> int:
    """The dynamic shared memory per block of the kernel that ``args``
    (:func:`pack_args`) selects in ``dtype``, as ``csrc/pmsm_fast.cu`` sizes
    it (``pmsm_fast_smem_bytes``): the table and the eight sector rotations.
    Needs the built library."""
    fn = KERNEL.lib().pmsm_fast_smem_bytes
    fn.argtypes = [_c_void_p, _c_int]
    fn.restype = _c_longlong
    return fn(ctypes.byref(args), _dtype_code(dtype))


def pack_args(env, slab, leaves, consts, batch_major=False):
    """The kernel's arguments for ``slab`` (normalized actions, ``(T, B, 2)``,
    or ``(B, T, 2)`` with ``batch_major``, contiguous) and the ``(B,)``
    ``leaves`` (:data:`LEAVES`, any element stride), on any device: returns
    ``(args, out, keep)``, the argument struct, the six outputs ``(i_d, i_q,
    u_d_buffer, u_q_buffer, torque, epsilon)`` allocated beside the state,
    and the tensors whose pointers the launch reads.  Raises on what the
    kernel does not take."""
    first = leaves[LEAVES[0]]
    dtype, device, batch = first.dtype, first.device, first.shape[0]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the fast PMSM kernel takes float32 or float64, got {dtype}")
    n_steps = slab.shape[1] if batch_major else slab.shape[0]
    _check_leaf("actions", slab, dtype, device, (batch, n_steps, 2) if batch_major else (n_steps, batch, 2))
    if not slab.is_contiguous() or slab.data_ptr() % (2 * slab.element_size()):
        raise ValueError("the fast PMSM kernel reads a contiguous slab whose action pairs are aligned")
    for name in LEAVES:
        _check_leaf(name, leaves[name], dtype, device, (batch,))
    keep = [slab] + [leaves[name] for name in LEAVES]
    c = consts
    args = PmsmFastArgs()
    for name in ("tau", "p15", "r_s", "l_d", "l_q", "psi_p", "inv_ld", "inv_lq", "a_scale_d", "a_off_d",
                 "a_scale_q", "a_off_q", "to_halfdc", "from_halfdc"):
        setattr(args, name, c[name])
    args.dl = c["l_d"] - c["l_q"]
    args.adv_scale = (c["deadtime"] + 0.5) * c["tau"]  # folded as fast_start folds it
    args.rot_re, args.rot_im = _ROT_RE, _ROT_IM
    nx = ny = 0
    if c["saturated"]:
        lut = env._lut
        table = lut.interleaved()
        _check_leaf("LUT", table, dtype, device, (lut.nx, lut.ny, padded_channels(N_CHANNELS)))
        keep.append(table)
        args.lut = table.data_ptr()
        args.x0, args.dx, args.y0, args.dy = lut.x0, lut.dx, lut.y0, lut.dy
        nx, ny = lut.nx, lut.ny
    args.nx, args.ny = nx, ny
    args.actions = slab.data_ptr()
    for j, name in enumerate(LEAVES):
        args.leaf[j] = leaves[name].data_ptr()
        args.leaf_stride[j] = leaves[name].stride(0)
    out = tuple(torch.empty(batch, dtype=dtype, device=device) for _ in range(6))
    for j, t in enumerate(out):
        args.out[j] = t.data_ptr()
    args.batch = batch
    args.n_steps = n_steps
    args.saturated = int(c["saturated"])
    args.deadtime = c["deadtime"]
    args.batch_major = int(batch_major)
    return args, out, keep


def kernel_pmsm_fast_rollout(env, slab, leaves, consts, batch_major=False):
    """Launch the CUDA kernel (argument contract: :func:`pack_args`); returns
    the final ``(i_d, i_q, u_d_buffer, u_q_buffer, torque, epsilon)``.  The
    launch is asynchronous on the current stream, and a refused launch
    raises."""
    device = leaves[LEAVES[0]].device
    if device.type != "cuda":
        raise ValueError(f"the fast PMSM kernel runs on CUDA tensors, got {device}")
    if any(t.requires_grad for t in [slab, *leaves.values()]):
        raise NotImplementedError(
            "the fast PMSM kernel has no backward: it is forward-only, as the reference's "
            "kernel is (exciting_environments_tpu/ops/pallas/pmsm_fast_kernel.py:217 defines no VJP)"
        )
    args, out, keep = pack_args(env, slab, leaves, consts, batch_major)
    dtype = leaves[LEAVES[0]].dtype
    try:
        KERNEL.launch(args, dtype, device, "pmsm_fast")
    except RuntimeError as err:
        raise RuntimeError(f"{err} (dynamic shared memory asked: {shared_memory_bytes(args, dtype)} B)") from None
    return out


def plain_kernel_rollout(env, actions_tm, leaves, consts):
    """The kernel's function in plain PyTorch over time-major actions ``(T, B,
    2)``: ``fast_start``, the step loop of ``plain_pmsm_fast_rollout`` and
    ``fast_final_angle``, each as the plain version runs it.  Returns what
    :func:`kernel_pmsm_fast_rollout` returns."""
    eps, omega = leaves["epsilon"], leaves["omega_el"]
    cA, sA, c_delta, s_delta = fast_start(eps, omega, consts)
    i_d, i_q, buf_d, buf_q, torque = plain_pmsm_fast_rollout(
        env, actions_tm, leaves["i_d"], leaves["i_q"], cA, sA, leaves["u_d_buffer"], leaves["u_q_buffer"],
        omega, c_delta, s_delta, consts,
    )
    return i_d, i_q, buf_d, buf_q, torque, fast_final_angle(eps, omega, consts, actions_tm.shape[0])


def occupancy(env, dtype: torch.dtype) -> tuple[int, int]:
    """``(blocks per SM, dynamic shared memory per block in bytes)`` of the
    kernel for ``env`` in ``dtype``: how many blocks the card holds on one SM
    at once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and what
    :func:`shared_memory_bytes` asks.  Needs the card."""
    consts = fast_constants(env)
    slab = torch.zeros((1, env.batch_size, 2), dtype=dtype, device="cuda")
    leaves = {name: torch.zeros(env.batch_size, dtype=dtype, device="cuda") for name in LEAVES}
    args, _, _ = pack_args(env, slab, leaves, consts)
    blocks = _c_int(0)
    fn = KERNEL.lib().pmsm_fast_blocks_per_sm
    fn.argtypes = [_c_void_p, _c_int, _c_void_p]
    fn.restype = _c_int
    rc = fn(ctypes.byref(args), _dtype_code(dtype), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"pmsm_fast occupancy query failed with CUDA error {rc}")
    return blocks.value, shared_memory_bytes(args, dtype)


def start_trig_mismatches(x: torch.Tensor) -> dict:
    """The kernel's start trigonometry (``start_sincos`` in
    ``csrc/pmsm_fast.cu``) over the CUDA tensor ``x`` (float32 or float64),
    held bit for bit against PyTorch's ``torch.sin``/``torch.cos``: the
    count of mismatches per function and of inputs."""
    s, c = torch.empty_like(x), torch.empty_like(x)
    fn = KERNEL.lib().pmsm_fast_start_trig
    fn.argtypes = [_c_void_p, _c_void_p, _c_void_p, _c_longlong, _c_int, _c_void_p]
    fn.restype = _c_int
    rc = fn(x.data_ptr(), s.data_ptr(), c.data_ptr(), x.numel(), _dtype_code(x.dtype),
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pmsm_fast start trigonometry check failed with CUDA error {rc}")
    bits = (lambda t: t.view(torch.int32)) if x.dtype == torch.float32 else (lambda t: t.view(torch.int64))
    return {"sin": int((bits(s) != bits(torch.sin(x))).sum()), "cos": int((bits(c) != bits(torch.cos(x))).sum()),
            "inputs": x.numel()}


def kernel_slab(actions_tm):
    """``(slab, batch_major)``: the time-major actions ``(T, B, 2)`` (a view
    of either layout) as the kernel reads them, in place where the slab is
    contiguous in either layout (``_slab_layout``) and its action pairs are
    8- or 16-byte aligned; else a copy."""
    slab, batch_major = _slab_layout(actions_tm, True)
    if slab.data_ptr() % (2 * slab.element_size()):
        slab = slab.clone()  # a view whose action pairs straddle 8- or 16-byte boundaries
    return slab, batch_major


def pmsm_fast_fused_rollout(env, init_state, actions_norm, time_major: bool = False):
    """Trig-free rollout of a PMSM drive with the whole rollout in one kernel
    launch (the plain version for CPU tensors); the semantics and accuracy of
    :func:`~exciting_environments_torch.ops.pmsm_fast.pmsm_fast_rollout`.

    Args:
        env: a :class:`PMSM` with linear or saturated magnetics, scalar
            parameters and action bounds, the Euler solver, deadtime 0 or 1.
        init_state: batched state (``vmap_reset``).
        actions_norm: normalized dq voltages ``(B, n_steps, 2)``, or
            ``(n_steps, B, 2)`` with ``time_major=True``.  The kernel reads a
            slab that is contiguous in either layout in place
            (``_slab_layout``); only a slab contiguous in neither is copied.

    Returns:
        the final batched ``State`` (``omega_el`` broadcast to ``(B,)``, no
        solver carry).  Out of scope, and for a stochastic drive, it raises
        ``ValueError``.
    """
    if not supports_pmsm_fused(env):
        raise ValueError("pmsm_fast_fused_rollout requires a drive in the fused kernels' scope")
    if env._has_noise:
        raise ValueError(
            "pmsm_fast_fused_rollout integrates deterministically; stochastic drives go through the "
            "exact fused kernel (env.fused_rollout) or vmap_rollout"
        )
    consts, actions_tm, leaves = fast_inputs(env, init_state, actions_norm, time_major)
    if leaves["i_d"].device.type == "cuda":
        slab, batch_major = kernel_slab(actions_tm)
        i_d, i_q, buf_d, buf_q, torque, eps_final = kernel_pmsm_fast_rollout(env, slab, leaves, consts, batch_major)
    else:
        i_d, i_q, buf_d, buf_q, torque, eps_final = plain_kernel_rollout(env, actions_tm, leaves, consts)
    return fast_final_state(env, init_state, leaves, i_d, i_q, eps_final, torque, buf_d, buf_q)
