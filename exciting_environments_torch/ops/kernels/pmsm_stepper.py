"""Fused PMSM drive rollout: the counterpart of the open-loop part of
``exciting_environments_tpu/ops/pallas/pmsm_stepper.py``.

``omega_el`` is frozen along a rollout, so the electrical angle and with it
the whole inverter constraint (Park rotation at the deadtime-advanced angle,
hexagon sector clip) depend only on the actions and the initial angle.  Two
stages follow from that:

1. **Pre-pass (eager PyTorch).**  :func:`_eps_trajectory` replays the solver
   step's angle arithmetic and wrap over T steps, and
   :func:`_constraint_denorm_batched` runs the environment's own constraint
   arithmetic on the whole ``(T, B)`` slab, giving the constrained voltages
   ``u_con (T, B, 2)``.  The deadtime buffer swap of ``PMSM.step`` is a
   one-row shift of that stream.
2. **Current integration (CUDA).**  ``csrc/pmsm_stepper.cu`` integrates
   ``(i_d, i_q)`` over the stream in one launch, with the magnetics table
   in shared memory (see the note at the top of that file).  Beside it lives
   the plain PyTorch version, :func:`plain_pmsm_rollout`, a Python loop that
   performs the kernel's arithmetic operation for operation through the
   environment's own ODE and torque maps.  :func:`pmsm_rollout` takes the
   plain version only for tensors on the CPU; for CUDA tensors it launches
   the kernel or raises.

Two modes, as in the JAX package: step mode (:func:`pmsm_fused_rollout`,
identical to repeated ``vmap_step`` calls) and sim-ahead mode
(:func:`pmsm_fused_sim_ahead`, identical to ``vmap_sim_ahead`` for
``obs_stepsize == action_stepsize``: constraint at angles extrapolated with
the env ``tau``, unwrapped angle accumulation, ``c == 1`` stages reading the
next applied voltage, patched buffer columns).
"""

from __future__ import annotations

import ctypes

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import _Components
from exciting_environments_torch.models.pmsm.pmsm_env import extrapolated_angles, wrap_angle
from exciting_environments_torch.ops.kernels.stepper import (
    MAX_STAGES,
    KernelLibrary,
    _check_leaf,
    _lincomb,
    _needs_next_action,
    _stage_rows,
)
from exciting_environments_torch.ops.solvers import ExplicitRungeKutta

#: static parameters the kernel reads, in its parameter-slot order
PMSM_PARAMS = ("p", "r_s", "l_d", "l_q", "psi_p")
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
        ("param_value", _c_double * len(PMSM_PARAMS)),
        ("x0", _c_double),
        ("dx", _c_double),
        ("y0", _c_double),
        ("dy", _c_double),
        ("param_ptr", _c_void_p * len(PMSM_PARAMS)),
        ("lut", _c_void_p),
        ("u_con", _c_void_p),
        ("buf0", _c_void_p * 2),
        ("i_d0", _c_void_p),
        ("i_q0", _c_void_p),
        ("omega", _c_void_p),
        ("out", _c_void_p * 3),
        ("traj", _c_void_p * 3),
        ("batch", ctypes.c_longlong),
        ("nx", _c_int),
        ("ny", _c_int),
        ("n_steps", _c_int),
        ("n_stages", _c_int),
        ("saturated", _c_int),
        ("deadtime", _c_int),
        ("traj_stride", _c_int),
        ("use_next", _c_int * MAX_STAGES),
    ]


KERNEL = KernelLibrary("pmsm_stepper", "pmsm", PmsmArgs, ("pmsm_step", "pmsm_sim_ahead"))


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _applied(u_con_tm, buf, deadtime, row):
    """The voltage applied at step ``row``: the initial buffer at row 0 with
    deadtime, else the constrained voltage ``deadtime`` rows earlier."""
    return buf if (deadtime and row == 0) else u_con_tm[row - deadtime]


def plain_pmsm_step(env, solver, tau, props, omega, y, u, u_next=None):
    """One step of the kernel's computation in plain PyTorch: the currents
    ``y = (i_d, i_q)`` ``(B,)`` under the applied voltage ``u`` ``(B, 2)``,
    through the environment's own ODE; stages at ``c == 1`` read ``u_next``
    when it is given (sim-ahead mode)."""
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


def plain_pmsm_rollout(env, u_con_tm, i_d0, i_q0, omega, buf0, *, tau, solver=None, props=None,
                       obs_stride=None, sim_ahead=False):
    """The kernel's rollout as a Python loop of :func:`plain_pmsm_step`
    (argument contract: :func:`pmsm_rollout`).  Runs on any device;
    :func:`pmsm_rollout` uses it for CPU tensors."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    deadtime = int(props.static_params.deadtime)
    n_steps = u_con_tm.shape[0]
    has_next = sim_ahead and _needs_next_action(solver)
    buf = torch.stack(tuple(buf0), dim=-1)
    y = (i_d0, i_q0)
    saves = []
    for t in range(n_steps):
        u = _applied(u_con_tm, buf, deadtime, t)
        u_next = _applied(u_con_tm, buf, deadtime, min(t + 1, n_steps - 1)) if has_next else None
        y = plain_pmsm_step(env, solver, tau, props, omega, y, u, u_next)
        if obs_stride is not None and (t + 1) % obs_stride == 0:
            saves.append((y[0], y[1], env._torque(y[0], y[1], props)))
    final = (y[0], y[1], env._torque(y[0], y[1], props))
    traj = tuple(torch.stack(leaf, dim=0) for leaf in zip(*saves)) if obs_stride is not None else None
    return final, traj


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def pmsm_kernel_rollout(env, u_con_tm, i_d0, i_q0, omega, buf0, *, tau, solver=None, props=None,
                        obs_stride=None, sim_ahead=False):
    """Launch the CUDA PMSM kernel (argument contract: :func:`pmsm_rollout`).
    Outputs are allocated here; the launch is asynchronous on the current
    stream, and a refused launch raises."""
    solver = env._solver if solver is None else solver
    props = env.env_properties if props is None else props
    params = props.static_params
    dtype, device = i_d0.dtype, i_d0.device
    batch = i_d0.shape[0]
    n_steps = u_con_tm.shape[0]
    a_rows, b = _stage_rows(solver)
    saturated = bool(props.saturated)

    if device.type != "cuda":
        raise ValueError(f"the PMSM kernel runs on CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the PMSM kernel takes float32 or float64, got {dtype}")
    if len(b) > MAX_STAGES:
        raise ValueError("solver exceeds the kernel's stage limit")
    if isinstance(params.deadtime, torch.Tensor) or int(params.deadtime) not in (0, 1):
        raise ValueError("the PMSM kernel takes a scalar deadtime of 0 or 1")
    if saturated and env._lut is None:
        raise ValueError("a saturated drive needs the motor variant's tables")
    if obs_stride is not None and n_steps % obs_stride:
        raise ValueError("n_steps must be divisible by obs_stride")
    for name, leaf in (("i_d0", i_d0), ("i_q0", i_q0), ("omega", omega), ("buf0[0]", buf0[0]), ("buf0[1]", buf0[1])):
        _check_leaf(name, leaf, dtype, device, (batch,))
    _check_leaf("u_con_tm", u_con_tm, dtype, device, (n_steps, batch, 2))
    grads = [u_con_tm, i_d0, i_q0, omega, *buf0]

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
    for i, name in enumerate(PMSM_PARAMS):
        leaf = getattr(params, name)
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"parameter {name}", leaf, dtype, device, (batch,))
            grads.append(leaf)
            args.param_ptr[i] = ptr(leaf)
        else:
            args.param_value[i] = float(leaf)
    if any(t.requires_grad for t in grads):
        raise NotImplementedError(
            "the PMSM kernel has no backward yet: its VJP (checkpointed recompute "
            "through plain_pmsm_rollout) comes with training, ROADMAP.md Queue 2 item 4"
        )
    smem_bytes = 0
    if saturated:
        lut = env._lut
        _check_leaf("LUT", lut.values, dtype, device, (N_CHANNELS, lut.nx, lut.ny))
        args.lut = ptr(lut.values)
        args.x0, args.dx, args.y0, args.dy = lut.x0, lut.dx, lut.y0, lut.dy
        args.nx, args.ny = lut.nx, lut.ny
        smem_bytes = lut.values.numel() * lut.values.element_size()

    out = [torch.empty(batch, dtype=dtype, device=device) for _ in range(3)]
    traj = (
        [torch.empty((n_steps // obs_stride, batch), dtype=dtype, device=device) for _ in range(3)]
        if obs_stride is not None else None
    )
    args.u_con = ptr(u_con_tm)
    args.buf0[0], args.buf0[1] = ptr(buf0[0]), ptr(buf0[1])
    args.i_d0, args.i_q0, args.omega = ptr(i_d0), ptr(i_q0), ptr(omega)
    for i in range(3):
        args.out[i] = out[i].data_ptr()
        if traj is not None:
            args.traj[i] = traj[i].data_ptr()
    args.batch = batch
    args.n_steps = n_steps
    args.n_stages = len(b)
    args.saturated = int(saturated)
    args.deadtime = int(params.deadtime)
    args.traj_stride = obs_stride or 0
    if sim_ahead:
        for s, c in enumerate(solver.c[: len(b)]):
            args.use_next[s] = int(s > 0 and c == 1.0)

    KERNEL.launch(args, dtype, device, "pmsm_sim_ahead" if sim_ahead else "pmsm_step",
                  detail=f" (dynamic shared memory asked: {smem_bytes} B)")
    return tuple(out), (tuple(traj) if traj is not None else None)


def pmsm_rollout(env, u_con_tm, i_d0, i_q0, omega, buf0, *, tau, solver=None, props=None,
                 obs_stride=None, sim_ahead=False):
    """Integrate the drive currents over ``n_steps`` fixed-``tau`` solver
    steps: the kernel for CUDA tensors, :func:`plain_pmsm_rollout` for CPU
    tensors.

    Args:
        env: a :class:`~exciting_environments_torch.models.pmsm.PMSM`.
        u_con_tm: constrained physical voltages ``(n_steps, B, 2)``; with
            deadtime 1 step ``t`` applies row ``t - 1`` (``buf0`` at ``t = 0``).
        i_d0, i_q0, omega: ``(B,)`` initial currents and frozen speed.
        buf0: ``(u_d, u_q)`` initial deadtime buffer, ``(B,)`` each.
        tau: solver step size.
        solver: explicit RK solver (default ``env._solver``).
        props: ``EnvProperties`` (default ``env.env_properties``); scalar
            deadtime 0 or 1, ``(B,)`` or scalar parameters.
        obs_stride: also return ``(i_d, i_q, torque)`` after every
            ``obs_stride``-th step, each ``(n_steps // obs_stride, B)``.
        sim_ahead: ``c == 1`` stages read the next applied voltage.

    Returns:
        ``((i_d, i_q, torque), traj)`` with ``(B,)`` finals and the saves
        (``None`` without ``obs_stride``).
    """
    kwargs = dict(tau=tau, solver=solver, props=props, obs_stride=obs_stride, sim_ahead=sim_ahead)
    if i_d0.device.type == "cuda":
        return pmsm_kernel_rollout(env, u_con_tm.contiguous(), i_d0, i_q0, omega, buf0, **kwargs)
    return plain_pmsm_rollout(env, u_con_tm, i_d0, i_q0, omega, buf0, **kwargs)


# ---------------------------------------------------------------------------
# the pre-pass
# ---------------------------------------------------------------------------


def supports_pmsm_fused(env) -> bool:
    """Whether ``env`` is inside the fused PMSM path's scope: an explicit RK
    solver, a scalar deadtime of 0 or 1, the tables of a saturated drive, and
    finite linear parameters otherwise.  Per-batch ``(B,)`` parameters and
    action normalizations are in scope (they reach the kernel as pointers, or
    stay in the pre-pass); any batch size is (the kernel masks the ragged
    edge)."""
    props = env.env_properties
    params = props.static_params
    if isinstance(params.deadtime, torch.Tensor) or int(params.deadtime) not in (0, 1):
        return False
    if props.saturated:
        if env._lut is None:
            return False
    elif not all(bool(torch.isfinite(torch.as_tensor(v)).all()) for v in (params.l_d, params.l_q, params.psi_p)):
        return False
    return isinstance(env._solver, ExplicitRungeKutta) and len(_stage_rows(env._solver)[1]) <= MAX_STAGES


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


def _pmsm_final_solver_state(env, props, i_d, i_q, eps, u_last, omega):
    """The scan path's final solver carry: ``f(tau, y)`` under the last applied
    voltage for FSAL methods, ``None`` otherwise."""
    if not env._solver.fsal:
        return None
    f = env._pmsm_vector_field(props.saturated, lambda t: u_last)
    return f(env.tau, (i_d, i_q, eps), (props.static_params, omega))


def _last_applied(u_con, buf, deadtime):
    return _applied(u_con, buf, deadtime, u_con.shape[0] - 1)


# ---------------------------------------------------------------------------
# environment-level entry points
# ---------------------------------------------------------------------------


def pmsm_fused_rollout(env, init_state, actions_norm, obs_stride: int = None,
                       time_major: bool = False, strict: bool = False):
    """Fused rollout of a PMSM drive with the semantics of
    :meth:`PMSM.vmap_rollout`: normalized dq voltages ``(B, n_steps, 2)`` (or
    ``(n_steps, B, 2)`` with ``time_major=True``) in, ``(obs, final_state)``
    out, with ``obs`` ``(B, obs_dim)``, or ``(B, n_steps // obs_stride,
    obs_dim)`` with ``obs_stride`` set.  Out of scope it takes the loop
    (``strict=True`` raises instead)."""
    n_steps = actions_norm.shape[0] if time_major else actions_norm.shape[1]
    if not supports_pmsm_fused(env):
        if strict:
            raise ValueError(
                "pmsm_fused_rollout out of kernel scope (per-batch or other deadtime, missing "
                "tables, non-finite linear parameters, or solver family); strict=True forbids "
                "the loop fallback"
            )
        if time_major:
            actions_norm = actions_norm.transpose(0, 1)
        obs, last_state = env.vmap_rollout(init_state, actions_norm, obs_stride or n_steps)
        return (obs[:, -1] if obs_stride is None else obs), last_state
    if obs_stride is not None and n_steps % obs_stride:
        raise ValueError("n_steps must be divisible by obs_stride")

    props = env.env_properties
    deadtime = int(props.static_params.deadtime)
    phys = init_state.physical_state
    acts_tm = actions_norm if time_major else actions_norm.transpose(0, 1)
    u_con, eps_seq, eps_final = _constrained_voltages(env, init_state, acts_tm, props)
    buf0 = (phys.u_d_buffer, phys.u_q_buffer)
    omega = phys.omega_el
    (i_d, i_q, torque), traj = pmsm_rollout(env, u_con, phys.i_d, phys.i_q, omega, buf0,
                                            tau=env.tau, props=props, obs_stride=obs_stride)
    buf_final = (u_con[-1, :, 0], u_con[-1, :, 1]) if deadtime > 0 else buf0
    u_last = _last_applied(u_con, torch.stack(buf0, dim=-1), deadtime)
    final_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(
            u_d_buffer=buf_final[0], u_q_buffer=buf_final[1], epsilon=eps_final,
            i_d=i_d, i_q=i_q, torque=torque, omega_el=omega,
        ),
        additions=env.Additions(
            solver_state=_pmsm_final_solver_state(env, props, i_d, i_q, eps_final, u_last, omega),
            active_solver_state=torch.ones(env.batch_size, dtype=torch.bool, device=i_d.device),
        ),
    )
    obs_final = env.generate_observation(final_state, props)
    if obs_stride is None:
        return obs_final, final_state
    eps_post = torch.cat([eps_seq[1:], eps_final[None]], dim=0)
    return _trajectory_observations(env, init_state, props, u_con, traj, eps_post, obs_stride, deadtime), final_state


def _trajectory_observations(env, init_state, props, u_con, traj, eps_post, obs_stride, deadtime):
    """Every ``obs_stride``-th observation ``(B, n_saves, obs_dim)``, from the
    kernel's saved currents and torque and the state-independent post-step
    angles ``eps_post`` ``(T, B)`` and buffers."""
    phys = init_state.physical_state
    i_d_t, i_q_t, torque_t = traj
    shape = tuple(i_d_t.shape)  # (n_saves, B)
    tile = lambda leaf: torch.as_tensor(leaf).expand(shape)
    if deadtime > 0:  # the buffer after step k holds u_con[k]
        bufs = u_con[obs_stride - 1 :: obs_stride]
        buf_d, buf_q = bufs[..., 0], bufs[..., 1]
    else:
        buf_d, buf_q = tile(phys.u_d_buffer), tile(phys.u_q_buffer)
    traj_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(
            u_d_buffer=buf_d, u_q_buffer=buf_q, epsilon=eps_post[obs_stride - 1 :: obs_stride],
            i_d=i_d_t, i_q=i_q_t, torque=torque_t, omega_el=tile(phys.omega_el),
        ),
        PRNGKey=tile(init_state.PRNGKey),
        additions=env.Additions(solver_state=None, active_solver_state=torch.ones(shape, dtype=torch.bool,
                                                                                   device=i_d_t.device)),
        reference=structures.map_leaves(tile, init_state.reference),
    )
    return env.generate_observation(traj_state, props).movedim(0, 1)


def pmsm_fused_sim_ahead(env, init_state, actions_norm, obs_stepsize: float, action_stepsize: float,
                         time_major: bool = False, strict: bool = False):
    """Fused trajectory solve with the semantics of :meth:`PMSM.vmap_sim_ahead`
    for ``obs_stepsize == action_stepsize`` (one solver step per action
    interval, any explicit RK method).  Returns ``(observations (B, n_steps +
    1, obs_dim), last_state)``; the full ``states`` trajectory is not
    materialized.  Otherwise the loop, or a raise with ``strict=True``."""
    if obs_stepsize != action_stepsize or not supports_pmsm_fused(env):
        if strict:
            raise ValueError(
                "pmsm_fused_sim_ahead out of kernel scope (kernel support, or obs_stepsize != "
                "action_stepsize, on which the reference PMSM sim_ahead itself fails); "
                "strict=True forbids the loop fallback"
            )
        if time_major:
            actions_norm = actions_norm.transpose(0, 1)
        obs, _, last = env.vmap_sim_ahead(init_state, actions_norm, obs_stepsize, action_stepsize)
        return obs, last

    props = env.env_properties
    deadtime = int(props.static_params.deadtime)
    phys = init_state.physical_state
    acts_tm = actions_norm if time_major else actions_norm.transpose(0, 1)
    n_steps = acts_tm.shape[0]
    dt = float(obs_stepsize)
    omega = phys.omega_el
    # the hexagon constraint at angles extrapolated with the env tau (the
    # reference's hard-coded tau, constraint_denormalization_ahead)
    eps_ext = extrapolated_angles(phys.epsilon, omega, env.tau, n_steps)
    u_con = _constraint_denorm_batched(env, props, acts_tm, eps_ext, omega)
    buf0 = (phys.u_d_buffer, phys.u_q_buffer)
    _, traj = pmsm_rollout(env, u_con, phys.i_d, phys.i_q, omega, buf0, tau=dt, props=props,
                           obs_stride=1, sim_ahead=True)

    # unwrapped solver accumulation of the angle; saves wrapped
    rate = _eps_rate(env._solver, omega)
    eps = [phys.epsilon]
    for _ in range(n_steps):
        eps.append(eps[-1] + dt * rate)
    eps_t = wrap_angle(torch.stack(eps))
    i_d_t = torch.cat([phys.i_d[None], traj[0]])
    i_q_t = torch.cat([phys.i_q[None], traj[1]])
    torque_t = torch.cat([env._torque(phys.i_d, phys.i_q, props)[None], traj[2]])
    shape = tuple(i_d_t.shape)  # (n_steps + 1, B)
    if deadtime > 0:  # the buffer columns patched from the constrained sequence
        acts_m = torch.cat([torch.stack(buf0, dim=-1)[None], u_con])
        buf_d, buf_q = acts_m[..., 0], acts_m[..., 1]
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
    u_last = _last_applied(u_con, torch.stack(buf0, dim=-1), deadtime)
    last_state = structures.replace(
        env._index_time(traj_state, -1),
        additions=env.Additions(
            # the scan's sim_ahead stores solver.init at (t1, y_last) under
            # the end-clamped zero-order-hold voltage
            solver_state=_pmsm_final_solver_state(env, props, i_d_t[-1], i_q_t[-1], eps_t[-1], u_last, omega),
            active_solver_state=torch.ones(env.batch_size, dtype=torch.bool, device=i_d_t.device),
        ),
    )
    return observations, last_state
