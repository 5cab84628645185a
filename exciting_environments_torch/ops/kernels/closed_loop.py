"""Fused closed-loop rollout: the counterpart of the closed-loop part of
``exciting_environments_tpu/ops/pallas/stepper.py``.

The policy runs inside the loop: every step the state is normalized into
the observation (``generate_observation``'s arithmetic, then the normalized
tracked references), the policy maps it to a normalized action, the action
is denormalized and the environment takes its RK step.  For CUDA tensors the
whole horizon is one launch of the kernel in ``csrc/closed_loop.cu``; beside
it lives the plain PyTorch version, :func:`plain_closed_loop`, a Python loop
of :func:`plain_cl_step` that performs the kernel's arithmetic operation for
operation.  :func:`fused_closed_loop` takes the plain version only for CPU
tensors.

The policy follows the JAX tile contract (``ops/policies.py``).  On the CPU
any callable with that contract works; on CUDA only the families compiled
into the kernel (:class:`~exciting_environments_torch.ops.policies.KernelPolicy`:
``AffinePolicy``, the PPO ``ActorPolicy``), and any other callable raises
before a launch.  The loop never runs eagerly on the card.

Stochastic inputs are streamed slabs, as in the JAX kernel: a sensor-noise
slab ``(T, B, len(obs_noise_cols))`` added to the indexed observation
columns before the policy, and a process-noise slab ``(T, B,
len(proc_noise_idx))`` added to the indexed state leaves after wrap/clip.
"""

from __future__ import annotations

import ctypes
from dataclasses import fields

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.policies import KernelPolicy

from .stepper import (
    MAX_ACTION,
    MAX_PARAMS,
    MAX_STAGES,
    MAX_STATE,
    KernelLibrary,
    _broadcast_saves,
    _check_leaf,
    _final_solver_state,
    _stage_rows,
    plain_step,
    supports_fused_rollout,
)

MAX_REFS = 4
MAX_OBS = MAX_STATE + MAX_REFS
MAX_CARRY = 4
MAX_LAYERS = 4
MAX_WIDTH = 64
MAX_POLICY_PARAMS = 4096
#: stage counts the kernel is instantiated for (FSAL last stage skipped):
#: Euler 1, Midpoint and Heun 2, RK4 4, Tsit5 and Dopri5 6
KERNEL_STAGES = (1, 2, 4, 6)

_c_double = ctypes.c_double
_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


class ClosedLoopArgs(ctypes.Structure):
    """Field-for-field mirror of ``struct ClosedLoopArgs`` in ``csrc/closed_loop.cu``."""

    _fields_ = [
        ("tau", _c_double),
        ("a", (_c_double * MAX_STAGES) * MAX_STAGES),
        ("b", _c_double * MAX_STAGES),
        ("param_value", _c_double * MAX_PARAMS),
        ("obs_min", _c_double * MAX_STATE),
        ("obs_max", _c_double * MAX_STATE),
        ("act_min", _c_double * MAX_ACTION),
        ("act_max", _c_double * MAX_ACTION),
        ("clip", _c_double),
        ("param_ptr", _c_void_p * MAX_PARAMS),
        ("y0", _c_void_p * MAX_STATE),
        ("carry0", _c_void_p * MAX_CARRY),
        ("refs", _c_void_p * MAX_REFS),
        ("policy_params", _c_void_p),
        ("obs_noise", _c_void_p),
        ("proc_noise", _c_void_p),
        ("y_out", _c_void_p * MAX_STATE),
        ("carry_out", _c_void_p * MAX_CARRY),
        ("traj_state", _c_void_p * MAX_STATE),
        ("traj_action", _c_void_p * MAX_ACTION),
        ("traj_carry", _c_void_p * MAX_CARRY),
        ("batch", ctypes.c_longlong),
        ("n_steps", _c_int),
        ("n_stages", _c_int),
        ("n_refs", _c_int),
        ("n_carry", _c_int),
        ("n_pp", _c_int),
        ("policy_id", _c_int),
        ("has_integral", _c_int),
        ("has_clip", _c_int),
        ("deterministic", _c_int),
        ("n_layers", _c_int),
        ("widths", _c_int * (MAX_LAYERS + 1)),
        ("wrap", _c_int * MAX_STATE),
        ("obs_cols", _c_int * MAX_OBS),
        ("n_obs_noise", _c_int),
        ("noise_idx", _c_int * MAX_STATE),
        ("n_proc_noise", _c_int),
        ("traj_stride", _c_int),
        ("env_id", _c_int),
        ("fast", _c_int),
    ]


CL_KERNEL = KernelLibrary("closed_loop", "closed_loop", ClosedLoopArgs, ("closed_loop",))

_PLAIN_CALLABLE_ON_CUDA = (
    "on CUDA tensors the closed loop runs inside the kernel, which compiles in the "
    "policy families AffinePolicy (ops/policies.py) and ActorPolicy (utils/rl_fused.py, "
    "make_actor_tile); a plain callable runs the loop on the CPU only (an environment "
    "made with device='cpu')"
)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def plain_cl_step(env, policy, y, c, t, refs, pparams=None, *, tau, solver, props, has_carry,
                  eo=None, ep=None, obs_cols=(), noise_idx=()):
    """One step of the kernel's computation in plain PyTorch over ``(B,)``
    leaves: normalize -> [+ sensor noise] -> policy -> denormalize -> RK
    step -> wrap/clip [-> + process noise -> wrap/clip].  ``eo``/``ep`` are
    the step's noise rows ``(B, n)``.  Returns ``(y1, c1, a_norm)``
    (``c1 = ()`` for a stateless policy)."""
    pn = props.physical_normalizations
    obs = tuple(getattr(pn, n).normalize(leaf) for n, leaf in zip(env._ode_state_fields, y)) + tuple(refs)
    if obs_cols:
        obs = list(obs)
        for j, col in enumerate(obs_cols):
            obs[col] = obs[col] + eo[..., j]
        obs = tuple(obs)
    args = (obs, t) + ((c,) if has_carry else ()) + ((pparams,) if pparams is not None else ())
    out = policy(*args)
    a_norm, c1 = (tuple(out[0]), tuple(out[1])) if has_carry else (tuple(out), ())
    u = env.denormalize_action(torch.stack(a_norm, dim=-1), props)
    y1 = plain_step(env, solver, tau, props.static_params, False, y, u, noise_row=ep, noise_idx=noise_idx)
    return y1, c1, a_norm


def plain_closed_loop(env, y0, policy, n_steps, *, tau, solver, props, ref_leaves=(), traj_stride=None,
                      policy_params=None, policy_carry=None, obs_noise_tm=None, proc_noise_tm=None,
                      obs_noise_cols=(), proc_noise_idx=()):
    """The kernel's loop as a Python loop of :func:`plain_cl_step` (argument
    contract: :func:`fused_closed_loop`).  Runs on any device and is
    differentiable by autograd.  Returns ``(final, final_carry, traj_state,
    traj_action, traj_carry)`` with time-major ``(n_saves, B)`` saves, or
    ``None`` for each without ``traj_stride``."""
    has_carry = policy_carry is not None
    y, c = tuple(y0), tuple(policy_carry) if has_carry else ()
    saves = []
    for t in range(n_steps):
        y, c, a = plain_cl_step(
            env, policy, y, c, t, ref_leaves, policy_params, tau=tau, solver=solver, props=props,
            has_carry=has_carry, eo=None if obs_noise_tm is None else obs_noise_tm[t],
            ep=None if proc_noise_tm is None else proc_noise_tm[t], obs_cols=obs_noise_cols,
            noise_idx=proc_noise_idx,
        )
        if traj_stride is not None and (t + 1) % traj_stride == 0:
            saves.append((y, a, c))
    if traj_stride is None:
        return y, c, None, None, None
    stack = lambda group: tuple(torch.stack(leaf, dim=0) for leaf in zip(*group))
    ys, acts, cs = zip(*saves)
    return y, c, stack(ys), stack(acts), (stack(cs) if has_carry else ())


# ---------------------------------------------------------------------------
# the kernel's wrapper
# ---------------------------------------------------------------------------


def _tensors(tree):
    """Every tensor in a nest of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def kernel_closed_loop(env, y0, policy, n_steps, *, tau, solver, props, ref_leaves=(), traj_stride=None,
                       policy_params=None, policy_carry=None, obs_noise_tm=None, proc_noise_tm=None,
                       obs_noise_cols=(), proc_noise_idx=()):
    """Launch the CUDA closed-loop kernel (argument contract:
    :func:`fused_closed_loop`; returns as :func:`plain_closed_loop`).
    Outputs are allocated here; the launch is asynchronous on the current
    stream."""
    y0 = tuple(y0)
    dtype, device = y0[0].dtype, y0[0].device
    batch = y0[0].shape[0]
    a_rows, b = _stage_rows(solver)
    n_state, n_action = len(y0), env.action_dim
    n_refs = len(ref_leaves)
    carry0 = tuple(policy_carry) if policy_carry is not None else ()
    n_carry = len(carry0)

    if not isinstance(policy, KernelPolicy):
        raise ValueError(_PLAIN_CALLABLE_ON_CUDA)
    if device.type != "cuda":
        raise ValueError(f"the closed-loop kernel runs on CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the closed-loop kernel takes float32 or float64, got {dtype}")
    if (len(b) not in KERNEL_STAGES or n_state > MAX_STATE or n_action > MAX_ACTION
            or len(env._kernel_params) > MAX_PARAMS or n_refs > MAX_REFS):
        raise ValueError("configuration exceeds the closed-loop kernel's stage/state/action/parameter/"
                         "reference limits")
    if n_carry != policy.n_carry:
        raise ValueError(f"{type(policy).__name__} carries {policy.n_carry} leaves, policy_carry has {n_carry}")
    for i, leaf in enumerate(y0):
        _check_leaf(f"state leaf {i}", leaf, dtype, device, (batch,))
    for i, leaf in enumerate(ref_leaves):
        _check_leaf(f"reference {i}", leaf, dtype, device, (batch,))
    for i, leaf in enumerate(carry0):
        _check_leaf(f"policy carry leaf {i}", leaf, dtype, device, (batch,))
    grads = [*y0, *ref_leaves, *carry0, *_tensors(policy_params), *policy.parameters()]

    spec = policy.kernel_spec(dtype, device, policy_params)
    flat = spec.flat
    n_obs = n_state + n_refs
    if flat.numel() > MAX_POLICY_PARAMS:
        raise ValueError(f"{flat.numel()} policy parameters exceed the kernel's {MAX_POLICY_PARAMS}")
    if spec.n_obs != n_obs:
        raise ValueError(f"the policy reads {spec.n_obs} observation columns, the environment gives {n_obs}")
    widths = spec.options.get("widths", ())
    if widths and (len(widths) > MAX_LAYERS + 1 or max(widths) > MAX_WIDTH):
        raise ValueError(f"actor widths {widths}: at most {MAX_LAYERS} layers of at most {MAX_WIDTH}")

    args = ClosedLoopArgs()
    keep = []  # tensors whose pointers the launch reads

    def ptr(t):
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    args.tau = float(tau)
    for s, row in enumerate(a_rows, start=1):
        for j, coef in enumerate(row):
            args.a[s][j] = float(coef)
    for j, coef in enumerate(b):
        args.b[j] = float(coef)
    for i, name in enumerate(env._kernel_params):  # the functor's parameter order
        leaf = getattr(props.static_params, name)
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"parameter {name}", leaf, dtype, device, (batch,))
            grads.append(leaf)
            args.param_ptr[i] = ptr(leaf)
        else:
            args.param_value[i] = float(leaf)
    pn, an = props.physical_normalizations, props.action_normalizations
    for i, name in enumerate(env._ode_state_fields):
        norm = getattr(pn, name)
        if isinstance(norm.min, torch.Tensor) or isinstance(norm.max, torch.Tensor):
            raise ValueError("the closed-loop kernel's scope needs scalar observation normalizations")
        args.obs_min[i], args.obs_max[i] = float(norm.min), float(norm.max)
        args.wrap[i] = int(name in env._angle_fields)
    for j, f in enumerate(fields(an)):
        norm = getattr(an, f.name)
        if isinstance(norm.min, torch.Tensor) or isinstance(norm.max, torch.Tensor):
            raise ValueError("the closed-loop kernel's scope needs scalar action normalizations")
        args.act_min[j], args.act_max[j] = float(norm.min), float(norm.max)
    if (obs_noise_tm is not None) != bool(obs_noise_cols) or (proc_noise_tm is not None) != bool(proc_noise_idx):
        raise ValueError("each noise slab and its columns must be set together")
    if obs_noise_tm is not None:
        if len(obs_noise_cols) > MAX_OBS or not all(0 <= col < n_obs for col in obs_noise_cols):
            raise ValueError(f"obs_noise_cols {obs_noise_cols} out of the {n_obs} observation columns")
        _check_leaf("obs_noise_tm", obs_noise_tm, dtype, device, (n_steps, batch, len(obs_noise_cols)))
        grads.append(obs_noise_tm)
        args.obs_noise = ptr(obs_noise_tm)
        for j, col in enumerate(obs_noise_cols):
            args.obs_cols[j] = col
        args.n_obs_noise = len(obs_noise_cols)
    if proc_noise_tm is not None:
        if len(proc_noise_idx) > MAX_STATE or not all(0 <= i < n_state for i in proc_noise_idx):
            raise ValueError(f"proc_noise_idx {proc_noise_idx} out of the {n_state} state leaves")
        _check_leaf("proc_noise_tm", proc_noise_tm, dtype, device, (n_steps, batch, len(proc_noise_idx)))
        grads.append(proc_noise_tm)
        args.proc_noise = ptr(proc_noise_tm)
        for j, idx in enumerate(proc_noise_idx):
            args.noise_idx[j] = idx
        args.n_proc_noise = len(proc_noise_idx)
    if any(t.requires_grad for t in grads):
        raise NotImplementedError(
            "the closed-loop kernel has no backward yet: its VJP (checkpointed recompute "
            "through plain_cl_step) comes with the training slice, ROADMAP.md Queue 2 item 3"
        )

    new = lambda: torch.empty(batch, dtype=dtype, device=device)
    y_out = [new() for _ in y0]
    c_out = [new() for _ in carry0]
    if traj_stride is not None:
        n_saves = n_steps // traj_stride
        new_traj = lambda: torch.empty((n_saves, batch), dtype=dtype, device=device)
        traj_state = [new_traj() for _ in y0]
        traj_action = [new_traj() for _ in range(n_action)]
        traj_carry = [new_traj() for _ in carry0]
        for i, t in enumerate(traj_state):
            args.traj_state[i] = t.data_ptr()
        for j, t in enumerate(traj_action):
            args.traj_action[j] = t.data_ptr()
        for i, t in enumerate(traj_carry):
            args.traj_carry[i] = t.data_ptr()
    for i, leaf in enumerate(y0):
        args.y0[i] = ptr(leaf)
        args.y_out[i] = y_out[i].data_ptr()
    for i, leaf in enumerate(carry0):
        args.carry0[i] = ptr(leaf)
        args.carry_out[i] = c_out[i].data_ptr()
    for r, leaf in enumerate(ref_leaves):
        args.refs[r] = ptr(leaf)
    args.policy_params = ptr(flat) if flat.numel() else None
    args.batch = batch
    args.n_steps = n_steps
    args.n_stages = len(b)
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
    args.env_id = env._kernel_env_id
    args.fast = int(getattr(env, "fast_math", False))

    CL_KERNEL.launch(args, dtype, device, "closed_loop")
    if traj_stride is None:
        return tuple(y_out), tuple(c_out), None, None, None
    return tuple(y_out), tuple(c_out), tuple(traj_state), tuple(traj_action), tuple(traj_carry)


def fused_closed_loop(env, y0, policy, n_steps, *, tau=None, solver=None, props=None, ref_leaves=(),
                      traj_stride=None, policy_params=None, policy_carry=None, obs_noise_tm=None,
                      proc_noise_tm=None, obs_noise_cols=(), proc_noise_idx=()):
    """Closed-loop rollout of ``env``'s vector field with ``policy`` in the
    loop: the kernel for CUDA tensors, :func:`plain_closed_loop` for CPU
    tensors.

    Args:
        env: a classic environment in the closed-loop kernel's scope.
        y0: tuple of ``(B,)`` state leaves in ``env._ode_state_fields`` order.
        policy: the tile contract ``policy(obs, step[, carry][, params])``;
            on CUDA a :class:`~exciting_environments_torch.ops.policies.KernelPolicy`.
        n_steps: horizon.
        tau, solver, props: step size, explicit RK solver and
            ``EnvProperties`` (default: the environment's).
        ref_leaves: normalized tracked references, ``(B,)`` each, appended
            to the observation.
        traj_stride: also return every ``traj_stride``-th post-step state,
            the normalized action of that step and the carry after it.
        policy_params: passed to the policy as its last argument.
        policy_carry: tuple of ``(B,)`` carry leaves (a stateful policy).
        obs_noise_tm, obs_noise_cols: sensor-noise slab ``(n_steps, B,
            len(obs_noise_cols))`` added to those observation columns before
            the policy (row ``i`` is what the policy sees at step ``i``).
        proc_noise_tm, proc_noise_idx: process-noise slab ``(n_steps, B,
            len(proc_noise_idx))`` added to those state leaves after
            wrap/clip, followed by a second wrap/clip.

    Returns:
        ``final`` (tuple of ``(B,)``), or with ``traj_stride`` ``(final,
        traj_state, traj_action)`` with ``(B, n_steps // traj_stride)``
        leaves.  With ``policy_carry``: ``(final, final_carry)`` or
        ``(final, final_carry, traj_state, traj_action, traj_carry)``.
    """
    if traj_stride is not None and n_steps % traj_stride:
        raise ValueError("n_steps must be divisible by traj_stride")
    kwargs = dict(
        tau=env.tau if tau is None else tau, solver=env._solver if solver is None else solver,
        props=env.env_properties if props is None else props, ref_leaves=tuple(ref_leaves),
        traj_stride=traj_stride, policy_params=policy_params,
        policy_carry=None if policy_carry is None else tuple(policy_carry), obs_noise_tm=obs_noise_tm,
        proc_noise_tm=proc_noise_tm, obs_noise_cols=tuple(obs_noise_cols), proc_noise_idx=tuple(proc_noise_idx),
    )
    if y0[0].device.type == "cuda":
        out = kernel_closed_loop(env, y0, policy, n_steps, **kwargs)
    else:
        out = plain_closed_loop(env, y0, policy, n_steps, **kwargs)
    final, final_carry, traj_state, traj_action, traj_carry = out
    has_carry = policy_carry is not None
    if traj_stride is None:
        return (final, final_carry) if has_carry else final
    bm = lambda leaves: tuple(s.transpose(0, 1) for s in leaves)
    if has_carry:
        return final, final_carry, bm(traj_state), bm(traj_action), bm(traj_carry)
    return final, bm(traj_state), bm(traj_action)


# ---------------------------------------------------------------------------
# scope and the environment-level entry point
# ---------------------------------------------------------------------------


def supports_fused_closed_loop(env) -> bool:
    """Scope of the closed-loop kernel: the stepper's scope with a stage
    count the kernel is built for, scalar physical and action
    normalizations, the physical fields in the ODE's order (the kernel builds
    the observation from the integrated leaves), and at most ``MAX_REFS``
    tracked references.  Any batch size is in scope."""
    if not supports_fused_rollout(env):
        return False
    props = env.env_properties
    norms = structures.leaves(props.physical_normalizations) + structures.leaves(props.action_normalizations)
    return (
        len(_stage_rows(env._solver)[1]) in KERNEL_STAGES
        and not any(isinstance(leaf, torch.Tensor) for leaf in norms)
        and tuple(f.name for f in fields(env.PhysicalState)) == tuple(env._ode_state_fields)
        and len(env.control_state) <= MAX_REFS
    )


def env_fused_closed_loop(env, init_state, policy, n_steps: int, obs_stride: int = None,
                          return_traj_states: bool = False, policy_params=None, policy_carry=None):
    """Environment-level closed loop (:meth:`CoreEnvironment.fused_closed_loop`).

    Returns ``(obs, final_state)``, or with ``obs_stride`` ``(obs_traj,
    actions_traj, final_state)`` with ``obs_traj`` ``(B, n_saves, obs_dim)``
    and ``actions_traj`` ``(B, n_saves, action_dim)`` (normalized, as the
    policy emitted them), or with ``return_traj_states`` as well
    ``(obs_traj, actions_traj, traj_state, final_state)``.  With
    ``policy_carry`` each gains the final carry tuple as its last element.
    Raises out of scope: a closed loop has no open-loop fallback.
    """
    if return_traj_states and obs_stride is None:
        raise ValueError("return_traj_states requires obs_stride")
    if not supports_fused_closed_loop(env):
        raise ValueError(
            "env_fused_closed_loop out of kernel scope (the stepper's scope, a kernel stage "
            "count, scalar normalizations and the fields in ODE order are required)"
        )
    props = env.env_properties
    pn = props.physical_normalizations
    y0 = tuple(getattr(init_state.physical_state, n) for n in env._ode_state_fields)
    # normalized tracked references, constant along the rollout
    ref_leaves = tuple(getattr(pn, name).normalize(getattr(init_state.reference, name))
                       for name in env.control_state)
    has_carry = policy_carry is not None
    result = fused_closed_loop(
        env, y0, policy, n_steps, props=props, ref_leaves=ref_leaves, traj_stride=obs_stride,
        policy_params=policy_params, policy_carry=policy_carry,
    )
    final_carry = None
    if obs_stride is None:
        y_final, final_carry = result if has_carry else (result, None)
        traj_state_t = traj_act_t = None
    elif has_carry:
        y_final, final_carry, traj_state_t, traj_act_t, _ = result
    else:
        y_final, traj_state_t, traj_act_t = result

    # the FSAL solver carry of the scan path: under the last saved action in
    # trajectory mode; in final-only mode the pre-final observation is gone,
    # so under the policy's action at the FINAL state, step n_steps - 1 and
    # (stateful) the post-final carry, evaluated with the plain forward
    if not env._solver.fsal:
        solver_carry = None
    else:
        if traj_act_t is not None:
            a_norm_last = tuple(a[:, -1] for a in traj_act_t)
        else:
            obs_last = tuple(getattr(pn, n).normalize(leaf)
                             for n, leaf in zip(env._ode_state_fields, y_final)) + ref_leaves
            pol_args = (obs_last, n_steps - 1) + ((final_carry,) if has_carry else ())
            pol_args += (policy_params,) if policy_params is not None else ()
            out_last = policy(*pol_args)
            a_norm_last = out_last[0] if has_carry else out_last
        a_phys_last = env.denormalize_action(torch.stack(tuple(a_norm_last), dim=-1), props)
        solver_carry = _final_solver_state(env, y_final, a_phys_last, props)

    device = y_final[0].device
    final_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_final))),
        additions=env.Additions(
            solver_state=solver_carry,
            active_solver_state=torch.ones(env.batch_size, dtype=torch.bool, device=device),
        ),
    )
    tail = (final_carry,) if has_carry else ()
    if obs_stride is None:
        return (env.generate_observation(final_state, props), final_state) + tail

    n_saves = n_steps // obs_stride
    expand = lambda leaf: _broadcast_saves(leaf, n_saves)
    traj_state = structures.replace(
        final_state,
        physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, traj_state_t))),
        PRNGKey=expand(init_state.PRNGKey),
        additions=env.Additions(
            solver_state=None,
            active_solver_state=torch.ones((env.batch_size, n_saves), dtype=torch.bool, device=device),
        ),
        reference=structures.map_leaves(expand, init_state.reference),
    )
    obs_traj = env.generate_observation(traj_state, env._props_for(props, 1))
    actions_traj = torch.stack(traj_act_t, dim=-1)
    if return_traj_states:
        return (obs_traj, actions_traj, traj_state, final_state) + tail
    return (obs_traj, actions_traj, final_state) + tail
