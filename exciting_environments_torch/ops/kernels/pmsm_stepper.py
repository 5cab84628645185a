"""Fused PMSM drive rollout: the counterpart of the open-loop part of
``exciting_environments_tpu/ops/pallas/pmsm_stepper.py``.

``omega_el`` is frozen along a rollout, so the electrical angle and with it
the whole inverter constraint (Park rotation at the deadtime-advanced angle,
hexagon sector clip) depend only on the actions and the initial angle.  The
JAX package computes them in a pre-pass over the ``(T, B)`` slab and streams
the constrained voltages into its kernel.  The port's kernel,
``csrc/pmsm_stepper.cu``, takes the NORMALIZED actions instead and does the
angle recurrence, the environment's constraint (:meth:`PMSM._constrain`),
the deadtime buffer swap and the integration of ``(i_d, i_q)`` per instance
in one launch (see the note at the top of that file).

Beside it lives the plain PyTorch version, :func:`plain_pmsm_rollout`: the
eager pre-pass (:func:`_eps_trajectory` and :func:`_constraint_denorm_batched`,
the environment's own constraint arithmetic on the whole slab), then a
Python loop of :func:`plain_pmsm_step` through the environment's own ODE and
torque maps.  It performs the kernel's arithmetic operation for operation.
:func:`pmsm_rollout` takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.

Two modes, as in the JAX package: step mode (:func:`pmsm_fused_rollout`,
identical to repeated ``vmap_step`` calls) and sim-ahead mode
(:func:`pmsm_fused_sim_ahead`, identical to ``vmap_sim_ahead`` for
``obs_stepsize == action_stepsize``: constraint at angles extrapolated with
the env ``tau``, unwrapped angle accumulation, ``c == 1`` stages reading the
next applied voltage, patched buffer columns).  Step mode has a second
instantiation for :meth:`RolloutCollector.collect_fused`, the collection's
epilogue (:func:`pmsm_fused_collect`): the kernel writes each step's
observation row, reward and flags in place of the saved states.  Its plain
version is the eager rebuild from the saved states, which CPU tensors and
collections outside :func:`supports_collect_epilogue` take.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import _Components, with_env_properties
from exciting_environments_torch.models.pmsm.pmsm_env import (
    extrapolated_angles,
    extrapolation_offsets,
    wrap_angle,
)
from exciting_environments_torch.ops.kernels import checkpoint as ck
from exciting_environments_torch.ops.kernels.stepper import (
    MAX_STAGES,
    KernelLibrary,
    _check_leaf,
    _lincomb,
    _needs_next_action,
    _stage_rows,
)
from exciting_environments_torch.ops.solvers import ExplicitRungeKutta
from exciting_environments_torch.ops.transforms import ROTATION_IM, ROTATION_RE
from exciting_environments_torch.utils import MinMaxNormalization
from exciting_environments_torch.utils.profiling import annotate

#: static parameters the kernel reads, in its parameter-slot order
PMSM_PARAMS = ("p", "r_s", "l_d", "l_q", "psi_p")
#: the constraint's leaves the kernel reads, in its band-slot order: the DC
#: link and the (min, max) of the u_d and u_q action bands
BAND_FIELDS = ("u_dc", "a_d_mn", "a_d_mx", "a_q_mn", "a_q_mx")
#: the fields the collection's epilogue normalizes, in its band-slot order
#: (each a ``(min, max)`` pair)
OBS_FIELDS = ("i_d", "i_q", "omega_el", "torque", "u_d_buffer", "u_q_buffer")
#: columns of the observation row the epilogue writes (with the two tracked
#: references)
N_OBS = 10
N_CHANNELS = 6

_c_double = ctypes.c_double
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


class PmsmArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct PmsmArgs`` in ``csrc/pmsm_stepper.cu``."""

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
        ("band_value", _c_double * len(BAND_FIELDS)),
        ("con_tau", _c_double),
        ("adv_scale", _c_double),
        ("rot_re", _c_double * 8),
        ("rot_im", _c_double * 8),
        ("param_ptr", _c_void_p * len(PMSM_PARAMS)),
        ("band_ptr", _c_void_p * len(BAND_FIELDS)),
        ("lut", _c_void_p),
        ("actions", _c_void_p),
        ("offsets", _c_void_p),
        ("state0", _c_void_p * 5),
        ("omega", _c_void_p),
        ("noise", _c_void_p),
        ("out", _c_void_p * 6),
        ("u_last", _c_void_p * 2),
        ("traj", _c_void_p * 6),
        ("batch", ctypes.c_longlong),
        ("nx", _c_int),
        ("ny", _c_int),
        ("n_steps", _c_int),
        ("n_stages", _c_int),
        ("n_rate", _c_int),
        ("saturated", _c_int),
        ("deadtime", _c_int),
        ("traj_stride", _c_int),
        ("use_next", _c_int * MAX_STAGES),
        ("sim_ahead", _c_int),
        ("batch_major", _c_int),
        ("noise_idx", _c_int * 2),
        ("n_noise", _c_int),
        ("obs_band_value", _c_double * (2 * len(OBS_FIELDS))),
        ("obs_band_ptr", _c_void_p * (2 * len(OBS_FIELDS))),
        ("refs", _c_void_p * 2),
        ("obs", _c_void_p),
        ("reward", _c_void_p),
        ("terminated", _c_void_p),
        ("truncated", _c_void_p),
        ("collect", _c_int),
    ]


KERNEL = KernelLibrary("pmsm_stepper", "pmsm", PmsmArgs, ("pmsm_step", "pmsm_sim_ahead"))

#: fused PMSM collections (:meth:`RolloutCollector.collect_fused` on a
#: drive) by path: ``"epilogue"`` where the kernel wrote the observations,
#: rewards and flags (:func:`pmsm_fused_collect`), ``"eager"`` where they were
#: rebuilt from its saved states
COLLECT_PATHS = {"epilogue": 0, "eager": 0}


# ---------------------------------------------------------------------------
# the pre-pass (the plain version's first half)
# ---------------------------------------------------------------------------


def _eps_rate(solver, omega):
    """The per-step angle increment rate ``sum_i b_i k_i`` with every stage
    derivative exactly ``omega``, with the term order of the solvers'
    ``_weighted_increment``; ``omega`` itself for Euler."""
    acc = None
    for cb in solver.b:
        if cb == 0.0:
            continue
        term = omega if cb == 1.0 else cb * omega
        acc = term if acc is None else acc + term
    return acc


def _eps_trajectory(eps0, omega, tau, n_steps, solver):
    """Pre-step angles ``(n_steps, B)`` and the final angle, replaying the
    solver update and the wrap of ``PMSM._ode_solver_step`` step by step."""
    rate = _eps_rate(solver, omega)
    eps = eps0
    seq = []
    for _ in range(n_steps):
        seq.append(eps)
        eps = wrap_angle(eps + tau * rate)
    return torch.stack(seq), eps


def _constraint_denorm_batched(env, props, acts, eps, omega):
    """:meth:`PMSM.constraint_denormalization` over a time-major ``(T, B, 2)``
    action slab at the angles ``eps`` ``(T, B)``.  The environment's
    constraint is elementwise, so this is the same arithmetic on the whole
    slab; the sector rotation is a direct gather of the table."""
    return env._constrain(acts, eps, omega, props)


def _constrained_voltages(env, state, acts_tm, props):
    """The angle/constraint pre-pass of step mode.  Returns ``(u_con (T, B,
    2), eps_seq (T, B), eps_final (B,))``."""
    phys = state.physical_state
    eps_seq, eps_final = _eps_trajectory(phys.epsilon, phys.omega_el, env.tau, acts_tm.shape[0], env._solver)
    return _constraint_denorm_batched(env, props, acts_tm, eps_seq, phys.omega_el), eps_seq, eps_final


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _applied(u_con_tm, buf, deadtime, row):
    """The voltage applied at step ``row``: the initial buffer at row 0 with
    deadtime, else the constrained voltage ``deadtime`` rows earlier."""
    return buf if (deadtime and row == 0) else u_con_tm[row - deadtime]


def plain_pmsm_step(env, solver, tau, props, omega, y, u, u_next=None):
    """One step of the kernel's current integration in plain PyTorch: the
    currents ``y = (i_d, i_q)`` ``(B,)`` under the applied voltage ``u``
    ``(B, 2)``, through the environment's own ODE; stages at ``c == 1`` read
    ``u_next`` when it is given (sim-ahead mode)."""
    ode = env.nonlinear_ode if props.saturated else env.linear_ode
    args = (props.static_params, omega)

    def f(yy, uu):
        return ode(None, (yy[0], yy[1], None), args, lambda t: _Components(uu))[:2]

    a_rows, b = _stage_rows(solver)
    ks = [f(y, u)]
    for row, c in zip(a_rows, solver.c[1:]):
        act = u_next if (u_next is not None and c == 1.0) else u
        yi = tuple(_lincomb(yl, [k[j] for k in ks], row, tau) for j, yl in enumerate(y))
        ks.append(f(yi, act))
    return tuple(_lincomb(yl, [k[j] for k in ks], b, tau) for j, yl in enumerate(y))


def add_current_noise(y, noise_row, noise_idx):
    """The process noise of one step on the currents ``y = (i_d, i_q)``:
    column ``j`` of ``noise_row`` ``(B, n)`` added to current
    ``noise_idx[j]``."""
    if not noise_idx:
        return y
    y = list(y)
    for j, idx in enumerate(noise_idx):
        y[idx] = y[idx] + noise_row[:, j]
    return tuple(y)


def _current_loop(env, u_con_tm, i_d0, i_q0, omega, buf, deadtime, *, tau, solver, props, obs_stride,
                  has_next, noise_tm=None, noise_idx=()):
    """The loop of :func:`plain_pmsm_step` over the constrained voltages
    ``u_con_tm`` ``(T, B, 2)``, each step's process noise added after it;
    returns the final ``(i_d, i_q, torque)`` and the saves ``(i_d, i_q,
    torque)`` (``None`` without ``obs_stride``)."""
    n_steps = u_con_tm.shape[0]
    y = (i_d0, i_q0)
    saves = []
    for t in range(n_steps):
        u = _applied(u_con_tm, buf, deadtime, t)
        u_next = _applied(u_con_tm, buf, deadtime, min(t + 1, n_steps - 1)) if has_next else None
        y = plain_pmsm_step(env, solver, tau, props, omega, y, u, u_next)
        if noise_idx:
            y = add_current_noise(y, noise_tm[t], noise_idx)
        if obs_stride is not None and (t + 1) % obs_stride == 0:
            saves.append((y[0], y[1], env._torque(y[0], y[1], props)))
    final = (y[0], y[1], env._torque(y[0], y[1], props))
    traj = tuple(torch.stack(leaf, dim=0) for leaf in zip(*saves)) if obs_stride is not None else None
    return final, traj


def plain_pmsm_rollout(env, actions, state0, omega, *, tau, solver=None, props=None, obs_stride=None,
                       sim_ahead=False, batch_major=False, noise_tm=None, noise_idx=()):
    """The kernel's rollout in plain PyTorch (argument contract:
    :func:`pmsm_rollout`): the eager angle/constraint pre-pass over the whole
    slab, then the loop of :func:`plain_pmsm_step`, and the by-products the
    kernel writes (angles, buffers, the last applied voltage) taken from the
    pre-pass.  A process-noise slab ``noise_tm`` ``(T, B, n)`` is added to
    the currents ``noise_idx`` after each step (step mode).  Runs on any
    device and is differentiable by autograd; :func:`pmsm_rollout` uses it
    for CPU tensors."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    deadtime = int(props.static_params.deadtime)
    acts_tm = actions.transpose(0, 1) if batch_major else actions
    n_steps = acts_tm.shape[0]
    i_d0, i_q0, eps0, buf_d0, buf_q0 = state0
    if sim_ahead and noise_idx:
        raise ValueError("process noise is step-mode only")
    if sim_ahead:
        # the constraint at the angles extrapolated with the env tau; the
        # solver accumulates the angle unwrapped and saves it wrapped
        u_con = _constraint_denorm_batched(env, props, acts_tm, extrapolated_angles(eps0, omega, env.tau, n_steps),
                                           omega)
        rate = _eps_rate(solver, omega)
        eps = [eps0]
        for _ in range(n_steps):
            eps.append(eps[-1] + tau * rate)
        eps_post = wrap_angle(torch.stack(eps[1:]))
    else:
        eps_seq, eps_final = _eps_trajectory(eps0, omega, tau, n_steps, solver)
        u_con = _constraint_denorm_batched(env, props, acts_tm, eps_seq, omega)
        eps_post = torch.cat([eps_seq[1:], eps_final[None]], dim=0)
    buf = torch.stack((buf_d0, buf_q0), dim=-1)
    (i_d, i_q, torque), currents = _current_loop(
        env, u_con, i_d0, i_q0, omega, buf, deadtime, tau=tau, solver=solver, props=props, obs_stride=obs_stride,
        has_next=sim_ahead and _needs_next_action(solver), noise_tm=noise_tm, noise_idx=tuple(noise_idx))
    buf_final = (u_con[-1, :, 0], u_con[-1, :, 1]) if deadtime else (buf_d0, buf_q0)
    u_last = _applied(u_con, buf, deadtime, n_steps - 1)
    final = (i_d, i_q, torque, eps_post[-1], *buf_final)
    traj = None
    if obs_stride is not None:
        at = slice(obs_stride - 1, None, obs_stride)
        bufs = (u_con[at, :, 0], u_con[at, :, 1]) if deadtime else (None, None)
        traj = currents + (eps_post[at], *bufs)
    return final, (u_last[:, 0], u_last[:, 1]), traj


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _kernel_leaves(leaves, batch):
    """Band leaves as the kernel takes them: a Python number for a scalar
    leaf (it folds as Python folds it), a ``(B,)`` tensor for a per-batch one
    (a 0-d tensor is expanded to ``(B,)``); ``None`` where a leaf has another
    shape (out of the kernel's scope)."""
    out = []
    for leaf in leaves:
        if not isinstance(leaf, torch.Tensor):
            out.append(float(leaf))
        elif leaf.ndim == 0:
            out.append(leaf.expand(batch))
        elif tuple(leaf.shape) == (batch,):
            out.append(leaf)
        else:
            return None
    return out


def kernel_bands(props, batch) -> dict:
    """The constraint's leaves of ``props`` by :data:`BAND_FIELDS` name, as
    :func:`_kernel_leaves` takes them; ``None`` out of the kernel's scope."""
    an = props.action_normalizations
    leaves = _kernel_leaves([props.static_params.u_dc] + [getattr(getattr(an, n), bound) for n in ("u_d", "u_q")
                                                          for bound in ("min", "max")], batch)
    return None if leaves is None else dict(zip(BAND_FIELDS, leaves))


def observation_bands(props, batch):
    """The ``(min, max)`` leaves of the :data:`OBS_FIELDS` normalizations of
    ``props``, flat in the epilogue's band-slot order, as
    :func:`_kernel_leaves` takes them; ``None`` where a leaf has another shape
    or a normalization is not :class:`MinMaxNormalization`'s own (out of the
    epilogue's scope)."""
    pn = props.physical_normalizations
    norms = [getattr(pn, name) for name in OBS_FIELDS]
    if any(getattr(type(n), "normalize", None) is not MinMaxNormalization.normalize for n in norms):
        return None
    return _kernel_leaves([bound for n in norms for bound in (n.min, n.max)], batch)


def pmsm_kernel_rollout(env, actions, state0, omega, *, tau, solver=None, props=None, obs_stride=None,
                        sim_ahead=False, batch_major=False, noise_tm=None, noise_idx=(), epilogue=None):
    """Launch the CUDA PMSM kernel (argument contract: :func:`pmsm_rollout`).
    Outputs are allocated here; the launch is asynchronous on the current
    stream, and a refused launch raises.  Where autograd records the call
    (grad mode on and an input that requires grad), the launch is the
    forward of the checkpointed VJP (:class:`PmsmRolloutVJP`).

    ``epilogue``, the tracked ``(i_d, i_q)`` references (``(B,)`` or 0-d
    tensors), asks for the collection's epilogue in step mode with
    ``obs_stride``: the kernel then writes, in place of the saved states,
    each save's :meth:`PMSM.generate_observation` row, current reward and
    flags, and ``traj`` is ``(obs (n_saves, B, 10), reward, terminated,
    truncated (n_saves, B))``, time-major.  It takes no autograd (raises
    where autograd would record the call) and scalar or ``(B,)``
    observation bands (:func:`observation_bands`)."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    params = props.static_params
    state0 = tuple(state0)
    dtype, device = state0[0].dtype, state0[0].device
    batch = state0[0].shape[0]
    n_steps = actions.shape[1] if batch_major else actions.shape[0]
    a_rows, b = _stage_rows(solver)
    saturated = bool(props.saturated)

    if device.type != "cuda":
        raise ValueError(f"the PMSM kernel runs on CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the PMSM kernel takes float32 or float64, got {dtype}")
    if len(b) > MAX_STAGES or len(solver.b) > MAX_STAGES:
        raise ValueError("solver exceeds the kernel's stage limit")
    if isinstance(params.deadtime, torch.Tensor) or int(params.deadtime) not in (0, 1):
        raise ValueError("the PMSM kernel takes a scalar deadtime of 0 or 1")
    if saturated and env._lut is None:
        raise ValueError("a saturated drive needs the motor variant's tables")
    if n_steps < 1:
        raise ValueError("the PMSM kernel needs at least one step")
    if obs_stride is not None and n_steps % obs_stride:
        raise ValueError("n_steps must be divisible by obs_stride")
    for name, leaf in zip(("i_d0", "i_q0", "eps0", "u_d_buffer0", "u_q_buffer0", "omega"), state0 + (omega,)):
        _check_leaf(name, leaf, dtype, device, (batch,))
    _check_leaf("actions", actions, dtype, device, (batch, n_steps, 2) if batch_major else (n_steps, batch, 2))
    if not actions.is_contiguous():
        raise ValueError("the PMSM kernel reads a contiguous action slab")
    bands = kernel_bands(props, batch)
    if bands is None:
        raise ValueError("the PMSM kernel takes scalar or (batch,) u_dc and action bands")
    noise_idx = tuple(noise_idx)
    if (noise_tm is not None) != bool(noise_idx):
        raise ValueError("noise_tm and noise_idx must be set together")
    if noise_idx:
        if sim_ahead:
            raise ValueError("process noise is step-mode only")
        if len(noise_idx) > 2 or not all(i in (0, 1) for i in noise_idx):
            raise ValueError(f"noise_idx {noise_idx} must index the currents (0 = i_d, 1 = i_q)")
        _check_leaf("noise_tm", noise_tm, dtype, device, (n_steps, batch, len(noise_idx)))
        if not noise_tm.is_contiguous():
            raise ValueError("the PMSM kernel reads a contiguous noise slab")
    grads = [actions, *state0, omega] + ([noise_tm] if noise_tm is not None else [])
    obs_bands = refs = None
    if epilogue is not None:
        if sim_ahead or obs_stride is None:
            raise ValueError("the collection's epilogue runs in step mode with saves")
        obs_bands = observation_bands(props, batch)
        if obs_bands is None:
            raise ValueError("the collection's epilogue takes scalar or (batch,) MinMaxNormalization bands")
        refs = [leaf.expand(batch) if leaf.ndim == 0 else leaf for leaf in epilogue]
        for name, leaf in zip(("i_d reference", "i_q reference"), refs):
            _check_leaf(name, leaf, dtype, device, (batch,))
        for i, leaf in enumerate(obs_bands):
            if isinstance(leaf, torch.Tensor):
                _check_leaf(f"observation band {OBS_FIELDS[i // 2]}", leaf, dtype, device, (batch,))
        grads += refs + [leaf for leaf in obs_bands if isinstance(leaf, torch.Tensor)]

    args = PmsmArgs()
    keep = []  # tensors whose pointers the launch reads

    def ptr(t):
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    args.tau = float(tau)
    for s, row in enumerate(a_rows, start=1):
        for j, c in enumerate(row):
            args.a[s][j] = float(c)
    for j, c in enumerate(b):
        args.b[j] = float(c)
    for j, c in enumerate(solver.b):
        args.rate_b[j] = float(c)
    args.n_rate = len(solver.b)
    for i, name in enumerate(PMSM_PARAMS):
        leaf = getattr(params, name)
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"parameter {name}", leaf, dtype, device, (batch,))
            grads.append(leaf)
            args.param_ptr[i] = ptr(leaf)
        else:
            args.param_value[i] = float(leaf)
    for i, (name, leaf) in enumerate(bands.items()):
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"band {name}", leaf, dtype, device, (batch,))
            grads.append(leaf)
            args.band_ptr[i] = ptr(leaf)
        else:
            args.band_value[i] = leaf
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        if epilogue is not None:
            raise ValueError("the collection's epilogue is not differentiable: autograd records this call")
        return pmsm_rollout_vjp(env, actions, state0, omega, tau=tau, solver=solver, props=props,
                                obs_stride=obs_stride, sim_ahead=sim_ahead, batch_major=batch_major,
                                noise_tm=noise_tm, noise_idx=noise_idx)
    args.con_tau = float(env.tau)
    args.adv_scale = int(params.deadtime) + 0.5
    for i, (re, im) in enumerate(zip(ROTATION_RE.reshape(-1), ROTATION_IM.reshape(-1))):
        args.rot_re[i], args.rot_im[i] = float(re), float(im)
    elem = torch.empty((), dtype=dtype).element_size()
    smem_bytes = 16 * elem
    if saturated:
        lut = env._lut
        _check_leaf("LUT", lut.values, dtype, device, (N_CHANNELS, lut.nx, lut.ny))
        table = lut.interleaved()
        args.lut = ptr(table)
        args.x0, args.dx, args.y0, args.dy = lut.x0, lut.dx, lut.y0, lut.dy
        args.nx, args.ny = lut.nx, lut.ny
        smem_bytes += table.numel() * elem
    if sim_ahead:
        args.offsets = ptr(extrapolation_offsets(env.tau, n_steps, dtype, device))
        for s, c in enumerate(solver.c[: len(b)]):
            args.use_next[s] = int(s > 0 and c == 1.0)

    deadtime = int(params.deadtime)
    new = lambda *shape: torch.empty(shape, dtype=dtype, device=device)
    out = [new(batch) for _ in range(6)]
    u_last = [new(batch), new(batch)]
    traj = None
    if epilogue is not None:
        n_saves = n_steps // obs_stride
        flag = lambda: torch.empty((n_saves, batch), dtype=torch.bool, device=device)
        traj = (new(n_saves, batch, N_OBS), new(n_saves, batch), flag(), flag())
        args.obs, args.reward, args.terminated, args.truncated = (t.data_ptr() for t in traj)
        for i, leaf in enumerate(obs_bands):
            if isinstance(leaf, torch.Tensor):
                args.obs_band_ptr[i] = ptr(leaf)
            else:
                args.obs_band_value[i] = leaf
        args.refs[0], args.refs[1] = ptr(refs[0]), ptr(refs[1])
        args.collect = 1
    elif obs_stride is not None:
        n_saves = n_steps // obs_stride
        traj = [new(n_saves, batch) if i < 4 or deadtime else None for i in range(6)]
        for i, t in enumerate(traj):
            if t is not None:
                args.traj[i] = t.data_ptr()
    for i in range(6):
        args.out[i] = out[i].data_ptr()
    args.u_last[0], args.u_last[1] = u_last[0].data_ptr(), u_last[1].data_ptr()
    args.actions = ptr(actions)
    for i, leaf in enumerate(state0):
        args.state0[i] = ptr(leaf)
    args.omega = ptr(omega)
    if noise_idx:
        args.noise = ptr(noise_tm)
        for j, idx in enumerate(noise_idx):
            args.noise_idx[j] = idx
        args.n_noise = len(noise_idx)
    args.batch = batch
    args.n_steps = n_steps
    args.n_stages = len(b)
    args.saturated = int(saturated)
    args.deadtime = deadtime
    args.traj_stride = obs_stride or 0
    args.sim_ahead = int(sim_ahead)
    args.batch_major = int(batch_major)

    KERNEL.launch(args, dtype, device, "pmsm_sim_ahead" if sim_ahead else "pmsm_step",
                  detail=f" (dynamic shared memory asked: {smem_bytes} B)")
    return tuple(out), tuple(u_last), (tuple(traj) if traj is not None else None)


# ---------------------------------------------------------------------------
# the VJP: the kernel's forward with checkpoint saves, a segment replay back
# ---------------------------------------------------------------------------


class PmsmRolloutVJP(torch.autograd.Function):
    """The PMSM rollout as one differentiable operation, the counterpart of
    the JAX package's ``_pmsm_core_diff`` ``custom_vjp``.

    Forward: the kernel on CUDA tensors, :func:`plain_pmsm_rollout` on CPU
    tensors, both on detached inputs and with saves every
    :func:`~.checkpoint.ckpt_stride` steps (currents, torque, angle and,
    with deadtime, the buffers); the user's saves are a slice of them.
    Backward: the segments in reverse, each replayed from its checkpoint
    (``_pmsm_core_diff_bwd``).  The kernel takes the normalized actions and
    folds the constraint in, so the replay runs the pre-pass of its segment
    too (the angles, then :meth:`PMSM._constrain` over the segment's rows)
    before the steps of :func:`plain_pmsm_step`, and the cotangent reaches
    the normalized slab through the hexagon.  The state a segment carries is
    ``(i_d, i_q, angle, u_d_buffer, u_q_buffer)``; in sim-ahead mode the
    angle is the unwrapped sum the solver accumulates (rebuilt from the
    initial angle, since the saves hold it wrapped), and the constraint's
    angles are extrapolated from the initial one.  The table is a constant:
    it gets no cotangent, as in the reference.  With a process-noise slab
    the checkpoints hold the post-noise currents and a segment's replay adds
    its rows after each step, so the slab's rows get their cotangents
    (``g_noise`` of ``_pmsm_core_diff_bwd``).  Inputs, after the
    configuration: the action slab (either layout), the five state leaves,
    ``omega``, the floating tensor leaves of ``props`` and the noise slab
    (or ``None``)."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        ctx.set_materialize_grads(False)
        (slab,), state0, (omega,), pt, (noise,) = cfg.split(tensors)
        ckpt = ck.ckpt_stride(cfg.n_steps, cfg.obs_stride)
        kwargs = dict(tau=cfg.tau, solver=cfg.solver, props=ck.props_with(cfg.props, pt), obs_stride=ckpt,
                      sim_ahead=cfg.sim_ahead, batch_major=cfg.batch_major, noise_tm=noise,
                      noise_idx=cfg.noise_idx)
        if slab.device.type == "cuda":
            final, u_last, traj = pmsm_kernel_rollout(cfg.env, slab, state0, omega, **kwargs)
        else:
            final, u_last, traj = plain_pmsm_rollout(cfg.env, slab, state0, omega, **kwargs)
        saves = tuple(leaf for leaf in traj if leaf is not None)
        ctx.cfg = cfg
        ctx.save_for_backward(*tensors[: cfg.n_in], *saves)
        out = tuple(final) + tuple(u_last)
        if cfg.obs_stride is not None:
            skip = cfg.obs_stride // ckpt
            out += tuple(leaf[skip - 1 :: skip] for leaf in saves)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        (slab,), state0, (omega,), pt, (noise,) = cfg.split(saved[: cfg.n_in])
        saves = saved[cfg.n_in :]
        env, solver, tau, n_steps = cfg.env, cfg.solver, cfg.tau, cfg.n_steps
        deadtime = int(cfg.props.static_params.deadtime)
        ckpt = ck.ckpt_stride(n_steps, cfg.obs_stride)
        n_seg = n_steps // ckpt
        # outputs: final (i_d, i_q, torque, eps, buf_d, buf_q), u_last (2), saves
        g_id, g_iq, g_tq_f, g_eps, g_bd, g_bq = grads[:6]
        g_ul = grads[6:8]
        g_tr = ck.inject(grads[8:], cfg.obs_stride // ckpt, n_seg) if cfg.obs_stride else (None,) * len(saves)
        g_tr = tuple(g_tr) + (None,) * (6 - len(g_tr))  # (i_d, i_q, torque, eps, buf_d, buf_q)
        # segment starts: the saved currents (and, with deadtime, buffers);
        # the angle as the recurrence carries it
        i_starts = ck.starts(state0[:2], saves[:2])
        if deadtime:
            b_starts = ck.starts(state0[3:5], saves[4:6])
        else:
            b_starts = tuple(leaf[None].expand((n_seg,) + tuple(leaf.shape)) for leaf in state0[3:5])
        if cfg.sim_ahead:
            rate = _eps_rate(solver, omega)
            acc, e_starts = state0[2], []
            for t in range(n_steps):
                if t % ckpt == 0:
                    e_starts.append(acc)
                acc = acc + tau * rate
            e_starts = torch.stack(e_starts)
            offsets = extrapolation_offsets(env.tau, n_steps, slab.dtype, slab.device)
        else:
            e_starts = ck.starts(state0[2:3], saves[3:4])[0]
        acts_tm = slab.transpose(0, 1) if cfg.batch_major else slab
        has_next = cfg.sim_ahead and _needs_next_action(solver)
        needs = ctx.needs_input_grad[1:]
        need_slab, need_eps0, need_omega = needs[0], needs[3], needs[6]
        need_pt, need_noise = needs[7 : 7 + len(pt)], needs[-1]
        g_acts = torch.zeros_like(acts_tm) if need_slab else None
        g_noise = torch.zeros_like(noise) if need_noise else None
        g_eps0 = g_omega = None
        g_pt = [None] * len(pt)
        g_state = [g_id, g_iq, g_eps, g_bd, g_bq]
        at = lambda g, s: None if g is None else g[s]
        g_sv = (g_tr[0], g_tr[1], g_tr[3], g_tr[4], g_tr[5])  # the saves of the carried state
        # with a c == 1 stage and no deadtime, a segment's last step reads the
        # next segment's first constrained voltage: that row is an input of the
        # next segment's replay, and its cotangent there is added to this
        # segment's own before the row's constraint is pulled back, once, as
        # the plain loop pulls back the whole slab's
        shared = has_next and not deadtime
        g_next_row = None
        for s in reversed(range(n_seg)):
            t0, t1 = s * ckpt, (s + 1) * ckpt
            last = s == n_seg - 1
            if last:
                g_state = [ck.add(g, at(gs, s)) for g, gs in zip(g_state, g_sv)]
            # the saves at the segment's start enter as seeds of its start leaves
            seeds = [(1 + j, at(gs, s - 1)) for j, gs in enumerate(g_sv)] if s else []
            # a save's torque and the final torque are separate outputs, made in
            # the plain loop's order
            g_tqs = [g for g in (at(g_tr[2], s), (g_tq_f if last else None)) if g is not None]
            g_u = g_ul if last else (None, None)
            if all(g is None for g in (*g_state, *g_tqs, *g_u, g_next_row, *(g for _, g in seeds))):
                g_state = [ck.add(g, gs) for g, (_, gs) in zip(g_state, seeds)] if seeds else g_state
                g_next_row = None
                continue
            r1 = min(t1 + 1, n_steps) if has_next else t1
            r0 = t0 + 1 if shared and s else t0  # the first row computed here
            first_row = None
            if r0 > t0:  # its values (the backward runs without grad)
                first_row = _constraint_denorm_batched(env, ck.props_with(cfg.props, pt), acts_tm[t0:r0],
                                                       (state0[2] + offsets[t0] * omega)[None], omega)

            def replay(a, i_d, i_q, eps, bd, bq, eps0, om, row, nz, *q, t0=t0, t1=t1, r0=r0, r1=r1,
                       g_state=g_state, g_tqs=g_tqs, g_u=g_u, g_row=g_next_row):
                props = ck.props_with(cfg.props, q)
                rate = _eps_rate(solver, om)
                if cfg.sim_ahead:
                    angles = eps0 + offsets[r0:r1].reshape(-1, 1) * om
                else:
                    seq, e = [], eps
                    for _ in range(t0, t1):
                        seq.append(e)
                        e = wrap_angle(e + tau * rate)
                    angles = torch.stack(seq)
                u_con = _constraint_denorm_batched(env, props, a, angles, om)
                if row is not None:
                    u_con = torch.cat([row, u_con])
                buf = torch.stack((bd, bq), dim=-1)
                applied = lambda t: buf if (deadtime and t == t0) else u_con[t - t0 - deadtime]
                y, e = (i_d, i_q), eps
                for t in range(t0, t1):
                    u = applied(t)
                    u_next = applied(min(t + 1, n_steps - 1)) if has_next else None
                    y = plain_pmsm_step(env, solver, tau, props, om, y, u, u_next)
                    if nz is not None:
                        y = add_current_noise(y, nz[t - t0], cfg.noise_idx)
                    e = e + tau * rate if cfg.sim_ahead else wrap_angle(e + tau * rate)
                bufs = (u_con[t1 - 1 - t0, :, 0], u_con[t1 - 1 - t0, :, 1]) if deadtime else (bd, bq)
                pairs = [(y[0], g_state[0]), (y[1], g_state[1]), (e, g_state[2]), (bufs[0], g_state[3]),
                         (bufs[1], g_state[4])]
                pairs += [(env._torque(y[0], y[1], props), g) for g in g_tqs]
                if g_u[0] is not None or g_u[1] is not None:
                    pairs += [(u[:, 0], g_u[0]), (u[:, 1], g_u[1])]
                if g_row is not None:
                    pairs.append((u_con[t1 - t0 : t1 - t0 + 1], g_row))
                return pairs

            seg_inputs = [acts_tm[r0:r1], i_starts[0][s], i_starts[1][s], e_starts[s], b_starts[0][s],
                          b_starts[1][s], state0[2], omega, first_row, None if noise is None else noise[t0:t1], *pt]
            got = ck.segment_vjp(replay, seg_inputs, [need_slab, True, True, True, True, True,
                                                      cfg.sim_ahead and need_eps0, need_omega, True, need_noise,
                                                      *need_pt],
                                 seeds)
            ga, gid, giq, ge, gbd, gbq, ge0, gom, g_next_row, gn = got[:10]
            g_state = [gid, giq, ge, gbd, gbq]
            g_eps0 = ck.add(g_eps0, ge0)
            g_omega = ck.add(g_omega, gom)
            g_pt = [ck.add(a, b) for a, b in zip(g_pt, got[10:])]
            if ga is not None:
                g_acts[r0:r1] += ga
            if gn is not None:
                g_noise[t0:t1] = gn
        g_eps0 = ck.add(g_eps0, g_state[2])
        if g_acts is not None and cfg.batch_major:
            g_acts = g_acts.transpose(0, 1)
        return (None, g_acts, g_state[0], g_state[1], g_eps0, g_state[3], g_state[4], g_omega, *g_pt, g_noise)


def pmsm_rollout_vjp(env, actions, state0, omega, *, tau, solver=None, props=None, obs_stride=None,
                     sim_ahead=False, batch_major=False, noise_tm=None, noise_idx=()):
    """The rollout through :class:`PmsmRolloutVJP` (arguments and returns as
    :func:`pmsm_rollout`, on any device)."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    n_steps = actions.shape[1] if batch_major else actions.shape[0]
    if obs_stride is not None and n_steps % obs_stride:
        raise ValueError("n_steps must be divisible by obs_stride")
    pt = ck.prop_tensors(props)
    cfg = ck.VJPConfig((1, 5, 1, len(pt), 1), env=env, n_steps=n_steps, tau=tau, solver=solver, props=props,
                       obs_stride=obs_stride, sim_ahead=sim_ahead, batch_major=batch_major,
                       noise_idx=tuple(noise_idx))
    out = PmsmRolloutVJP.apply(cfg, actions, *state0, omega, *pt, noise_tm)
    final, u_last = out[:6], out[6:8]
    if obs_stride is None:
        return final, u_last, None
    traj = out[8:]
    return final, u_last, (traj if len(traj) == 6 else traj + (None, None))


def pmsm_rollout(env, actions, state0, omega, *, tau, solver=None, props=None, obs_stride=None,
                 sim_ahead=False, batch_major=False, noise_tm=None, noise_idx=()):
    """Roll the drive out over ``n_steps`` fixed-``tau`` solver steps from
    normalized actions: the kernel for CUDA tensors, :func:`plain_pmsm_rollout`
    for CPU tensors.

    Args:
        env: a :class:`~exciting_environments_torch.models.pmsm.PMSM`.
        actions: normalized dq actions ``(n_steps, B, 2)``, or ``(B, n_steps,
            2)`` with ``batch_major`` (the kernel reads either in place).
        state0: ``(i_d, i_q, epsilon, u_d_buffer, u_q_buffer)``, ``(B,)`` each.
        omega: ``(B,)`` frozen electrical speed.
        tau: solver step size (the constraint's angle advance always uses
            ``env.tau``, as the environment's ``_constrain`` does).
        solver: explicit RK solver (default ``env._solver``).
        props: ``EnvProperties`` (default ``env.env_properties``); scalar
            deadtime 0 or 1, ``(B,)`` or scalar parameters, DC link and
            action bands.
        obs_stride: also return the state after every ``obs_stride``-th step.
        sim_ahead: sim-ahead mode (constraint at the extrapolated angles,
            unwrapped angle, ``c == 1`` stages read the next applied voltage).
        noise_tm, noise_idx: step mode's process-noise slab, pre-scaled
            increments ``(n_steps, B, len(noise_idx))`` added to the currents
            ``noise_idx`` (0 = ``i_d``, 1 = ``i_q``) after each step.

    Returns:
        ``(final, u_last, traj)``: ``final`` the ``(B,)`` leaves ``(i_d, i_q,
        torque, epsilon, u_d_buffer, u_q_buffer)``; ``u_last`` the ``(u_d,
        u_q)`` applied in the last step; ``traj`` the same six leaves after
        every ``obs_stride``-th step, ``(n_saves, B)`` each (the buffers
        ``None`` with deadtime 0, where they stay the initial ones), or
        ``None`` without ``obs_stride``.
    """
    kwargs = dict(tau=tau, solver=solver, props=props, obs_stride=obs_stride, sim_ahead=sim_ahead,
                  batch_major=batch_major, noise_tm=noise_tm, noise_idx=tuple(noise_idx))
    if state0[0].device.type == "cuda":
        return pmsm_kernel_rollout(env, actions.contiguous(), state0, omega, **kwargs)
    if ck.records_grad(actions, state0, omega, kwargs, env.env_properties):
        return pmsm_rollout_vjp(env, actions, state0, omega, **kwargs)
    return plain_pmsm_rollout(env, actions, state0, omega, **kwargs)


def sector_mismatches(alpha: torch.Tensor, beta: torch.Tensor) -> dict:
    """The kernel's ``atan2f`` and sector index of
    ``transforms.py::apply_hex_constraint`` (``csrc/pmsm_stepper.cu``) over
    contiguous float32 CUDA pairs ``(alpha, beta)``, held bit for bit against
    PyTorch's CUDA ``torch.atan2`` and the signs of ``torch.sin(angle - 2/3
    pi k)``.  Returns the count of mismatches of each and of the inputs."""
    if alpha.device.type != "cuda" or alpha.dtype != torch.float32 or not (alpha.is_contiguous()
                                                                           and beta.is_contiguous()):
        raise ValueError("sector_mismatches takes contiguous float32 CUDA tensors")
    fn = KERNEL.lib().pmsm_sector
    fn.argtypes = [_c_void_p] * 4 + [ctypes.c_longlong, _c_void_p]
    fn.restype = _c_int
    angle = torch.empty_like(alpha)
    sector = torch.empty(alpha.shape, dtype=torch.int32, device=alpha.device)
    rc = fn(alpha.data_ptr(), beta.data_ptr(), angle.data_ptr(), sector.data_ptr(), alpha.numel(),
            torch.cuda.current_stream(alpha.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pmsm_stepper sector check launch failed with CUDA error {rc}")
    want = torch.atan2(beta, alpha)
    bits = [(torch.sin(want - 2 / 3 * np.pi * k) >= 0).int() for k in range(3)]
    want_sector = bits[0] * 4 + bits[1] * 2 + bits[2]
    same_angle = (angle.view(torch.int32) == want.view(torch.int32)) | (torch.isnan(angle) & torch.isnan(want))
    return {"atan2": int((~same_angle).sum()), "sector": int((sector != want_sector).sum()),
            "inputs": alpha.numel()}


# ---------------------------------------------------------------------------
# scope and the environment-level entry points
# ---------------------------------------------------------------------------


def supports_pmsm_fused(env) -> bool:
    """Whether ``env`` is inside the fused PMSM path's scope: an explicit RK
    solver, a scalar deadtime of 0 or 1, the tables of a saturated drive,
    finite linear parameters otherwise, and a DC link and action bands that
    are scalars or ``(B,)`` planes.  Per-batch ``(B,)`` parameters reach the
    kernel as pointers; any batch size is in scope (the kernel masks the
    ragged edge)."""
    props = env.env_properties
    params = props.static_params
    if isinstance(params.deadtime, torch.Tensor) or int(params.deadtime) not in (0, 1):
        return False
    if props.saturated:
        if env._lut is None:
            return False
    elif not all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in (params.l_d, params.l_q, params.psi_p)):
        return False
    if kernel_bands(props, env.batch_size) is None:
        return False
    return isinstance(env._solver, ExplicitRungeKutta) and len(_stage_rows(env._solver)[1]) <= MAX_STAGES


def supports_pmsm_fused_sim_ahead(env, obs_stepsize: float, action_stepsize: float) -> bool:
    """:func:`supports_pmsm_fused` for equal stepsizes (on which the
    reference PMSM ``sim_ahead`` itself fails otherwise) and a deterministic
    drive (a stochastic sim-ahead is the Euler-Maruyama loop of
    ``vmap_sim_ahead``; step mode takes the noise slab)."""
    return obs_stepsize == action_stepsize and not env._has_noise and supports_pmsm_fused(env)


def _pmsm_final_solver_state(env, props, i_d, i_q, eps, u_last, omega):
    """The scan path's final solver carry: ``f(tau, y)`` under the last applied
    voltage for FSAL methods, ``None`` otherwise."""
    if not env._solver.fsal:
        return None
    f = env._pmsm_vector_field(props.saturated, lambda t: u_last)
    return f(env.tau, (i_d, i_q, eps), (props.static_params, omega))


def _start(init_state):
    """``(state0, omega)`` of :func:`pmsm_rollout` from a ``State``."""
    phys = init_state.physical_state
    return (phys.i_d, phys.i_q, phys.epsilon, phys.u_d_buffer, phys.u_q_buffer), phys.omega_el


def pmsm_fused_rollout(env, init_state, actions_norm, obs_stride: int = None,
                       time_major: bool = False, strict: bool = False, return_traj_states: bool = False,
                       env_properties=None):
    """Fused rollout of a PMSM drive with the semantics of
    :meth:`PMSM.vmap_rollout`: normalized dq voltages ``(B, n_steps, 2)`` (or
    ``(n_steps, B, 2)`` with ``time_major=True``) in, ``(obs, final_state)``
    out, with ``obs`` ``(B, obs_dim)``, or ``(B, n_steps // obs_stride,
    obs_dim)`` with ``obs_stride`` set.  One kernel launch on the card.  Out
    of scope it takes the loop (``strict=True`` raises instead).

    A stochastic drive's draws (:meth:`CoreEnvironment._noise_slabs`, either
    mode) are made first: the pre-scaled current increments go to the
    kernel as its noise slab, the sensor draws of the saved steps meet the
    observations, and the final and saved states carry their advanced keys.
    ``return_traj_states`` (with ``obs_stride``) returns ``(obs, traj_state,
    final_state)``.  ``env_properties`` replaces ``env.env_properties`` for
    this launch (a shard's property slices)."""
    env = with_env_properties(env, env_properties)
    n_steps = actions_norm.shape[0] if time_major else actions_norm.shape[1]
    if return_traj_states and obs_stride is None:
        raise ValueError("return_traj_states requires obs_stride")
    with annotate("ee.rollout.prepare"):
        in_scope = supports_pmsm_fused(env)
        if in_scope:
            if obs_stride is not None and n_steps % obs_stride:
                raise ValueError("n_steps must be divisible by obs_stride")
            props = env.env_properties
            state0, omega = _start(init_state)
            noise_tm, noise_idx, eps_obs, keys_saves, final_keys = env._noise_streams(init_state, n_steps,
                                                                                      obs_stride or n_steps)
            final, u_last, traj = pmsm_rollout(env, actions_norm, state0, omega, tau=env.tau, props=props,
                                               obs_stride=obs_stride, batch_major=not time_major,
                                               noise_tm=noise_tm, noise_idx=noise_idx)
    if not in_scope:
        if strict or return_traj_states:
            raise ValueError(
                "pmsm_fused_rollout out of kernel scope (per-batch or other deadtime, missing "
                "tables, non-finite linear parameters, band shapes, or solver family); strict=True "
                "forbids the loop fallback"
            )
        if time_major:
            actions_norm = actions_norm.transpose(0, 1)
        obs, last_state = env.vmap_rollout(init_state, actions_norm, obs_stride or n_steps)
        return (obs[:, -1] if obs_stride is None else obs), last_state

    with annotate("ee.rollout.rebuild"):
        final_state = _final_state(env, init_state, props, final, u_last, omega, final_keys)
        obs_final = env.generate_observation(final_state, props)
        if obs_stride is None:
            if eps_obs is not None:
                obs_final = env._apply_observation_noise_eps(obs_final, props, eps_obs[-1])
            return obs_final, final_state
        obs, traj_state = _trajectory_observations(env, init_state, props, traj, keys_saves)
        if eps_obs is not None:
            obs = env._apply_observation_noise_eps(obs, props, eps_obs.transpose(0, 1), batch_major=True)
        if return_traj_states:
            return obs, structures.map_leaves(lambda leaf: leaf.movedim(0, 1) if leaf.ndim >= 2 else leaf,
                                              traj_state), final_state
        return obs, final_state


def _final_state(env, init_state, props, final, u_last, omega, final_keys):
    """The final ``State`` of a step-mode launch from its final leaves
    ``(i_d, i_q, torque, epsilon, u_d_buffer, u_q_buffer)``, the last applied
    voltage and, for a stochastic drive, the advanced keys."""
    i_d, i_q, torque, eps_final, buf_d, buf_q = final
    return structures.replace(
        init_state,
        physical_state=env.PhysicalState(
            u_d_buffer=buf_d, u_q_buffer=buf_q, epsilon=eps_final,
            i_d=i_d, i_q=i_q, torque=torque, omega_el=omega,
        ),
        PRNGKey=init_state.PRNGKey if final_keys is None else final_keys,
        additions=env.Additions(
            solver_state=_pmsm_final_solver_state(env, props, i_d, i_q, eps_final, torch.stack(u_last, dim=-1),
                                                  omega),
            active_solver_state=torch.ones(env.batch_size, dtype=torch.bool, device=i_d.device),
        ),
    )


#: the methods whose arithmetic the epilogue mirrors
_EPILOGUE_METHODS = ("generate_observation", "generate_reward", "generate_truncated", "generate_terminated",
                     "current_reward_func", "normalize_state")


def supports_collect_epilogue(env) -> bool:
    """Whether a fused collection over ``env`` is inside the epilogue's scope
    (:func:`pmsm_fused_collect`), by what the environment shows: a
    :class:`PMSM` (not a batch split) inside :func:`supports_pmsm_fused`,
    with the class's own observation, reward, flag and normalization
    methods, ``control_state == ["i_d", "i_q"]`` (the current reward), no
    observation noise, and scalar or ``(B,)`` :class:`MinMaxNormalization`
    bands.  :meth:`RolloutCollector.collect_fused` takes the epilogue only
    where this holds, the tensors are CUDA tensors and autograd does not
    record the call (:func:`collect_epilogue_engages`)."""
    from exciting_environments_torch.models.pmsm import PMSM

    if not isinstance(env, PMSM) or any(getattr(type(env), name) is not getattr(PMSM, name) or name in vars(env)
                                        for name in _EPILOGUE_METHODS):
        return False
    if list(env.control_state) != ["i_d", "i_q"] or env._observation_noise:
        return False
    return supports_pmsm_fused(env) and observation_bands(env.env_properties, env.batch_size) is not None


def collect_epilogue_engages(env, init_state, actions) -> bool:
    """Whether :meth:`RolloutCollector.collect_fused` takes the epilogue on
    these inputs: :func:`supports_collect_epilogue`, CUDA tensors, the
    tracked references ``(B,)`` or 0-d tensors of the state's dtype, and no
    autograd recording (on CPU tensors, or where autograd records, the eager
    rebuild runs)."""
    if not supports_collect_epilogue(env):
        return False
    state0, omega = _start(init_state)
    refs = (init_state.reference.i_d, init_state.reference.i_q)
    if state0[0].device.type != "cuda" or not all(
            isinstance(r, torch.Tensor) and r.dtype == state0[0].dtype and r.shape in ((), (env.batch_size,))
            for r in refs):
        return False
    return not ck.records_grad(actions, state0, omega, refs, env.env_properties)


def pmsm_fused_collect(env, init_state, actions_norm):
    """A fused collection's step-mode launch with the kernel's epilogue:
    normalized dq voltages ``(B, n_steps, 2)`` in, ``(obs, reward,
    terminated, truncated, final_state)`` out, with the contract of
    ``pmsm_fused_rollout(..., obs_stride=1, return_traj_states=True)``
    followed by :meth:`RolloutCollector._assemble_batch`: post-step
    observations ``(B, n_steps, 10)``, rewards and the two flags ``(B,
    n_steps, 1)``, bit for bit, as views of the kernel's time-major outputs
    with the eager path's shapes and strides.  One launch; no state plane
    is saved.  Scope: :func:`collect_epilogue_engages` (a process-noise
    slab is streamed as in :func:`pmsm_fused_rollout`)."""
    n_steps = actions_norm.shape[1]
    with annotate("ee.rollout.prepare"):
        props = env.env_properties
        state0, omega = _start(init_state)
        noise_tm, noise_idx, _, _, final_keys = env._noise_streams(init_state, n_steps, n_steps)
        final, u_last, outputs = pmsm_kernel_rollout(
            env, actions_norm.contiguous(), state0, omega, tau=env.tau, props=props, obs_stride=1,
            batch_major=True, noise_tm=noise_tm, noise_idx=noise_idx,
            epilogue=(init_state.reference.i_d, init_state.reference.i_q))
    with annotate("ee.rollout.rebuild"):
        final_state = _final_state(env, init_state, props, final, u_last, omega, final_keys)
        obs, reward, terminated, truncated = (leaf.movedim(0, 1) for leaf in outputs)
        return obs, reward[..., None], terminated[..., None], truncated[..., None], final_state


def _trajectory_observations(env, init_state, props, traj, keys_saves=None):
    """Every ``obs_stride``-th observation ``(B, n_saves, obs_dim)``, from the
    kernel's saves (currents, torque, angles and, with deadtime, buffers),
    and the time-major saved states; ``keys_saves`` ``(n_saves, B, 2)`` are
    a stochastic drive's per-save keys."""
    phys = init_state.physical_state
    i_d_t, i_q_t, torque_t, eps_t, buf_d, buf_q = traj
    shape = tuple(i_d_t.shape)  # (n_saves, B)
    tile = lambda leaf: torch.as_tensor(leaf).expand(shape)
    if buf_d is None:  # without deadtime the buffers keep their initial values
        buf_d, buf_q = tile(phys.u_d_buffer), tile(phys.u_q_buffer)
    traj_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(
            u_d_buffer=buf_d, u_q_buffer=buf_q, epsilon=eps_t,
            i_d=i_d_t, i_q=i_q_t, torque=torque_t, omega_el=tile(phys.omega_el),
        ),
        PRNGKey=env._tile_time(init_state.PRNGKey, shape[0]) if keys_saves is None else keys_saves,
        additions=env.Additions(solver_state=None, active_solver_state=torch.ones(shape, dtype=torch.bool,
                                                                                   device=i_d_t.device)),
        reference=structures.map_leaves(tile, init_state.reference),
    )
    return env.generate_observation(traj_state, props).movedim(0, 1), traj_state


def pmsm_fused_sim_ahead(env, init_state, actions_norm, obs_stepsize: float, action_stepsize: float,
                         time_major: bool = False, strict: bool = False, env_properties=None):
    """Fused trajectory solve with the semantics of :meth:`PMSM.vmap_sim_ahead`
    for ``obs_stepsize == action_stepsize`` (one solver step per action
    interval, any explicit RK method).  Returns ``(observations (B, n_steps +
    1, obs_dim), last_state)``; the full ``states`` trajectory is not
    materialized.  One kernel launch on the card.  Otherwise, and for a
    stochastic drive (the Euler-Maruyama loop of ``vmap_sim_ahead``), the
    loop, or a raise with ``strict=True``.  ``env_properties`` replaces
    ``env.env_properties`` for this launch."""
    env = with_env_properties(env, env_properties)
    if not supports_pmsm_fused_sim_ahead(env, obs_stepsize, action_stepsize):
        if strict:
            raise ValueError(
                "pmsm_fused_sim_ahead out of kernel scope (kernel support, a stochastic drive, or "
                "obs_stepsize != action_stepsize, on which the reference PMSM sim_ahead itself fails); "
                "strict=True forbids the loop fallback"
            )
        if time_major:
            actions_norm = actions_norm.transpose(0, 1)
        obs, _, last = env.vmap_sim_ahead(init_state, actions_norm, obs_stepsize, action_stepsize)
        return obs, last

    props = env.env_properties
    phys = init_state.physical_state
    state0, omega = _start(init_state)
    final, u_last, traj = pmsm_rollout(env, actions_norm, state0, omega, tau=float(obs_stepsize), props=props,
                                       obs_stride=1, sim_ahead=True, batch_major=not time_major)
    first = lambda leaf, saves: torch.cat([leaf[None], saves])
    i_d_t = first(phys.i_d, traj[0])
    i_q_t = first(phys.i_q, traj[1])
    torque_t = first(env._torque(phys.i_d, phys.i_q, props), traj[2])
    eps_t = first(wrap_angle(phys.epsilon), traj[3])
    shape = tuple(i_d_t.shape)  # (n_steps + 1, B)
    if traj[4] is not None:  # deadtime: the buffer columns patched from the constrained sequence
        buf_d, buf_q = first(phys.u_d_buffer, traj[4]), first(phys.u_q_buffer, traj[5])
    else:
        buf_d = buf_q = env._full(shape, 0.0)
    nan = lambda leaf: env._full(shape, float("nan"))
    traj_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(
            u_d_buffer=buf_d, u_q_buffer=buf_q, epsilon=eps_t,
            i_d=i_d_t, i_q=i_q_t, torque=torque_t, omega_el=omega.expand(shape),
        ),
        PRNGKey=env._tile_time(init_state.PRNGKey, shape[0]),
        additions=env.Additions(solver_state=None,
                                active_solver_state=torch.ones(shape, dtype=torch.bool, device=i_d_t.device)),
        reference=structures.map_leaves(nan, init_state.reference),
    )
    observations = env.generate_observation(traj_state, props).movedim(0, 1)
    last_state = structures.replace(
        env._index_time(traj_state, -1),
        additions=env.Additions(
            # the scan's sim_ahead stores solver.init at (t1, y_last) under
            # the end-clamped zero-order-hold voltage
            solver_state=_pmsm_final_solver_state(env, props, i_d_t[-1], i_q_t[-1], eps_t[-1],
                                                  torch.stack(u_last, dim=-1), omega),
            active_solver_state=torch.ones(env.batch_size, dtype=torch.bool, device=i_d_t.device),
        ),
    )
    return observations, last_state
