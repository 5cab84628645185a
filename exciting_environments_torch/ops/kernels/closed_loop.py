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
``AffinePolicy``, the PPO ``ActorPolicy``, and on their own environments the
induction machine's ``FocPolicy`` and ``SensorlessFocPolicy``, on scalar or
per-drive operating points, and the EESM's ``EesmCurrentPolicy``), and any
other callable raises before a launch.  The
loop never runs eagerly on the card.

Stochastic inputs are streamed slabs, as in the JAX kernel: a sensor-noise
slab ``(T, B, len(obs_noise_cols))`` added to the indexed observation
columns before the policy, and a process-noise slab ``(T, B,
len(proc_noise_idx))`` added to the indexed state leaves after wrap/clip.
"""

from __future__ import annotations

import ctypes
from dataclasses import fields

import torch
from torch.autograd.function import once_differentiable

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.policies import KernelPolicy
from exciting_environments_torch.utils.profiling import annotate

from . import checkpoint as ck
from .plans import Key, PlanCache, Pointers
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
    kernel_env_scope,
    kernel_svm_limit,
    phys_action,
    plain_step,
    traj_keys,
)

MAX_REFS = 4
MAX_OBS = MAX_STATE + MAX_REFS
MAX_CARRY = 8
MAX_LAYERS = 4
MAX_WIDTH = 64
MAX_POLICY_PARAMS = 4096
MAX_POLICY_PLANES = 16
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
        ("svm_limit", _c_double),
        ("clip", _c_double),
        ("frame_step", _c_double),
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
        ("variant", _c_int),
        ("policy_planes", _c_void_p * MAX_POLICY_PLANES),
        ("n_planes", _c_int),
    ]


CL_KERNEL = KernelLibrary("closed_loop", "closed_loop", ClosedLoopArgs, ("closed_loop",))

#: the kernel's policy instantiations, in ``ClosedLoopArgs.variant`` order:
#: the affine law in registers at a compile-time observation width (the
#: state plus 0 or 1 reference), the affine law at any width, the actor with
#: two hidden layers of 16 in registers, the actor at any widths, and (on
#: their own environments only) the induction machine's FOC and sensorless
#: FOC tiles and the EESM's current tile, then the two FOC tiles reading each
#: drive's speed, torque setpoint (and observer gains) from per-drive planes
VARIANTS = ("affine", "affine_generic", "actor_16x16", "actor_generic", "foc", "sensorless_foc", "eesm_current",
            "foc_per_drive", "sensorless_foc_per_drive")
#: the variant of each family compiled for one kind of tile (policy_id 4-6)
_TILE_VARIANTS = {4: "foc", 5: "sensorless_foc", 6: "eesm_current"}
#: launches per instantiation, counted beside ``CL_KERNEL.launches``
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)
#: launches of each closed-loop wrapper through a kept launch plan (``hits``)
#: and through its full path (``misses``): a fleet run of n chunks makes
#: n - 1 hits (``ops/kernels/plans.py``)
LAUNCH_PLANS = {name: {"hits": 0, "misses": 0} for name in ("closed_loop", "pmsm_closed_loop")}
#: the launch plans of :func:`kernel_closed_loop`
PLANS = PlanCache(LAUNCH_PLANS["closed_loop"])

_PLAIN_CALLABLE_ON_CUDA = (
    "on CUDA tensors the closed loop runs inside the kernel, which compiles in the "
    "policy families AffinePolicy (ops/policies.py), ActorPolicy (utils/rl_fused.py, "
    "make_actor_tile) and, on their own machines, the tiles of utils/foc.py (make_foc_tile and "
    "make_sensorless_foc_tile on the InductionMachine, make_eesm_current_tile on the EESM); a "
    "plain callable runs the loop on the CPU only (an environment made with device='cpu')"
)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def plain_cl_step(env, policy, y, c, t, refs, pparams=None, *, tau, solver, props, has_carry,
                  eo=None, ep=None, obs_cols=(), noise_idx=()):
    """One step of the kernel's computation in plain PyTorch over ``(B,)``
    leaves: normalize -> [+ sensor noise] -> policy -> denormalize -> the
    environment's action constraint -> RK step -> wrap/clip [-> + process
    noise -> wrap/clip].  ``eo``/``ep`` are
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
    u = phys_action(env, torch.stack(a_norm, dim=-1), props)
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


def policy_spec(policy, dtype, device, params=None):
    """``policy.kernel_spec(dtype, device, params)`` inside the program's span
    ``ee.policy.spec``: what a launch packs of its policy (the flat slots and
    the per-drive planes; a tile packs them once and hands them out again)."""
    with annotate("ee.policy.spec"):
        return policy.kernel_spec(dtype, device, params)


def kernel_variant(n_state: int, spec) -> str:
    """The instantiation of ``csrc/closed_loop.cu`` that runs a policy's
    :class:`~exciting_environments_torch.ops.policies.KernelSpec` over an
    environment of ``n_state`` leaves: the register versions where the
    policy fits them, the generic ones otherwise (:data:`VARIANTS`)."""
    if spec.policy_id == 0:
        return "affine" if spec.n_obs - n_state in (0, 1) else "affine_generic"
    if spec.policy_id == 1:
        return "actor_16x16" if tuple(spec.options["widths"][1:-1]) == (16, 16) else "actor_generic"
    if spec.policy_id in _TILE_VARIANTS:
        variant = _TILE_VARIANTS[spec.policy_id] + ("_per_drive" if spec.planes else "")
        if variant not in VARIANTS:
            raise ValueError(f"no closed-loop kernel instantiation reads per-drive planes for policy_id "
                             f"{spec.policy_id}")
        return variant
    raise ValueError(f"no closed-loop kernel family has policy_id {spec.policy_id}")


def _chunk_args(args, y0, carry0, ref_leaves, obs_noise_tm, proc_noise_tm, n_steps, traj_stride, n_action):
    """Write one launch's per-chunk pointers into ``args``: the start leaves,
    the references, the carry, the noise slabs and the outputs, allocated
    here.  Returns the wrapper's outputs and the tensors the launch reads."""
    dtype, device, batch = y0[0].dtype, y0[0].device, y0[0].shape[0]
    ptr = Pointers()
    new = lambda: torch.empty(batch, dtype=dtype, device=device)
    y_out = [new() for _ in y0]
    c_out = [new() for _ in carry0]
    outputs = [(args.y_out, y_out), (args.carry_out, c_out)]
    if traj_stride is not None:
        n_saves = n_steps // traj_stride
        new_traj = lambda: torch.empty((n_saves, batch), dtype=dtype, device=device)
        traj_state = [new_traj() for _ in y0]
        traj_action = [new_traj() for _ in range(n_action)]
        traj_carry = [new_traj() for _ in carry0]
        outputs += [(args.traj_state, traj_state), (args.traj_action, traj_action), (args.traj_carry, traj_carry)]
    # each field read of a ctypes array makes a new view: one per field
    for field, tensors in outputs:
        for i, t in enumerate(tensors):
            field[i] = t.data_ptr()
    for field, leaves in ((args.y0, y0), (args.carry0, carry0), (args.refs, ref_leaves)):
        for i, leaf in enumerate(leaves):
            field[i] = ptr(leaf)
    args.obs_noise = None if obs_noise_tm is None else ptr(obs_noise_tm)
    args.proc_noise = None if proc_noise_tm is None else ptr(proc_noise_tm)
    if traj_stride is None:
        return (tuple(y_out), tuple(c_out), None, None, None), ptr.keep
    return (tuple(y_out), tuple(c_out), tuple(traj_state), tuple(traj_action), tuple(traj_carry)), ptr.keep


def _plan_key(env, props, solver, policy, policy_params, tau, n_steps, traj_stride, dtype, device, batch, n_state,
              n_refs, n_carry, obs_noise_cols, proc_noise_idx, has_obs_noise, has_proc_noise) -> Key:
    """What :func:`kernel_closed_loop`'s checks and static fields read."""
    key = Key().env(env, props, solver)
    key.obj(policy)
    key.leaf(policy_params)
    key.leaf(tau)
    key.values(n_steps, traj_stride, dtype, device, batch, n_state, n_refs, n_carry, tuple(obs_noise_cols),
               tuple(proc_noise_idx), has_obs_noise, has_proc_noise)
    return key


def kernel_closed_loop(env, y0, policy, n_steps, *, tau, solver, props, ref_leaves=(), traj_stride=None,
                       policy_params=None, policy_carry=None, obs_noise_tm=None, proc_noise_tm=None,
                       obs_noise_cols=(), proc_noise_idx=()):
    """Launch the CUDA closed-loop kernel (argument contract:
    :func:`fused_closed_loop`; returns as :func:`plain_closed_loop`).
    Outputs are allocated here; the launch is asynchronous on the current
    stream.  Where autograd records the call (grad mode on and an input
    that requires grad), the launch is the forward of the checkpointed VJP
    (:class:`ClosedLoopVJP`).

    A launch whose static inputs (everything but the start leaves, the
    references, the carry and the noise slabs) are those of a kept launch
    plan (:data:`PLANS`) checks only its per-chunk leaves and the policy's
    spec, and writes only the per-chunk pointers into a copy of the plan's
    struct: the kernel gets the same bytes as from the full path."""
    y0 = tuple(y0)
    dtype, device = y0[0].dtype, y0[0].device
    batch = y0[0].shape[0]
    n_state, n_action = len(y0), env.action_dim
    n_refs = len(ref_leaves)
    carry0 = tuple(policy_carry) if policy_carry is not None else ()
    n_carry = len(carry0)
    key = None  # no plan for a policy that packs a new spec every launch, or no kernel policy
    if getattr(policy, "spec_packs", None) is not None:
        key = _plan_key(env, props, solver, policy, policy_params, tau, n_steps, traj_stride, dtype, device, batch,
                        n_state, n_refs, n_carry, obs_noise_cols, proc_noise_idx, obs_noise_tm is not None,
                        proc_noise_tm is not None)
    leaves = (*y0, *ref_leaves, *carry0)

    def launch(args, variant):
        CL_KERNEL.launch(args, dtype, device, "closed_loop", detail=f" ({variant} instantiation)")
        VARIANT_LAUNCHES[variant] += 1

    outputs, spec = PLANS.launch(
        key, leaves, ((obs_noise_tm, (n_steps, batch, len(obs_noise_cols))),
                      (proc_noise_tm, (n_steps, batch, len(proc_noise_idx)))),
        policy, lambda: policy_spec(policy, dtype, device, policy_params), ClosedLoopArgs,
        lambda args: _chunk_args(args, y0, carry0, ref_leaves, obs_noise_tm, proc_noise_tm, n_steps, traj_stride,
                                 n_action),
        launch)
    if outputs is not None:
        return outputs

    a_rows, b = _stage_rows(solver)
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
    if policy.env_ids is not None and env._kernel_env_id not in policy.env_ids:
        raise ValueError(f"{type(policy).__name__} is compiled into the closed-loop kernel for its own machine "
                         f"only, not for {type(env).__name__}")
    svm_limit = kernel_svm_limit(env)
    if svm_limit is None:
        raise ValueError("the closed-loop kernel computes no action constraint but the inverter circle "
                         "(svm_circle); another hook runs the plain loop on CPU tensors only")
    for i, leaf in enumerate(y0):
        _check_leaf(f"state leaf {i}", leaf, dtype, device, (batch,))
    for i, leaf in enumerate(ref_leaves):
        _check_leaf(f"reference {i}", leaf, dtype, device, (batch,))
    for i, leaf in enumerate(carry0):
        _check_leaf(f"policy carry leaf {i}", leaf, dtype, device, (batch,))

    if spec is None:
        spec = policy_spec(policy, dtype, device, policy_params)
    flat = spec.flat
    static_grads = []  # the static tensors autograd could record
    n_obs = n_state + n_refs
    if flat.numel() > MAX_POLICY_PARAMS:
        raise ValueError(f"{flat.numel()} policy parameters exceed the kernel's {MAX_POLICY_PARAMS}")
    if spec.n_obs != n_obs:
        raise ValueError(f"the policy reads {spec.n_obs} observation columns, the environment gives {n_obs}")
    widths = spec.options.get("widths", ())
    if widths and (len(widths) > MAX_LAYERS + 1 or max(widths) > MAX_WIDTH):
        raise ValueError(f"actor widths {widths}: at most {MAX_LAYERS} layers of at most {MAX_WIDTH}")
    if len(spec.planes) > MAX_POLICY_PLANES:
        raise ValueError(f"{len(spec.planes)} per-drive policy planes exceed the kernel's {MAX_POLICY_PLANES}")
    for i, plane in enumerate(spec.planes):
        _check_leaf(f"policy plane {i}", plane, dtype, device, (batch,))

    args = ClosedLoopArgs()
    ptr = Pointers()  # the static fields' tensors, alive until the launch

    args.tau = float(tau)
    args.svm_limit = svm_limit
    for s, row in enumerate(a_rows, start=1):
        for j, coef in enumerate(row):
            args.a[s][j] = float(coef)
    for j, coef in enumerate(b):
        args.b[j] = float(coef)
    for i, name in enumerate(env._kernel_params):  # the functor's parameter order
        leaf = getattr(props.static_params, name)
        if isinstance(leaf, torch.Tensor):
            _check_leaf(f"parameter {name}", leaf, dtype, device, (batch,))
            static_grads.append(leaf)
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
        for j, col in enumerate(obs_noise_cols):
            args.obs_cols[j] = col
        args.n_obs_noise = len(obs_noise_cols)
    if proc_noise_tm is not None:
        if len(proc_noise_idx) > MAX_STATE or not all(0 <= i < n_state for i in proc_noise_idx):
            raise ValueError(f"proc_noise_idx {proc_noise_idx} out of the {n_state} state leaves")
        _check_leaf("proc_noise_tm", proc_noise_tm, dtype, device, (n_steps, batch, len(proc_noise_idx)))
        for j, idx in enumerate(proc_noise_idx):
            args.noise_idx[j] = idx
        args.n_proc_noise = len(proc_noise_idx)
    grads = [*leaves, flat, *static_grads] + [t for t in (obs_noise_tm, proc_noise_tm) if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in grads):
        return closed_loop_vjp(env, y0, policy, n_steps, tau=tau, solver=solver, props=props, ref_leaves=ref_leaves,
                               traj_stride=traj_stride, policy_params=policy_params, policy_carry=policy_carry,
                               obs_noise_tm=obs_noise_tm, proc_noise_tm=proc_noise_tm,
                               obs_noise_cols=obs_noise_cols, proc_noise_idx=proc_noise_idx)

    args.policy_params = ptr(flat) if flat.numel() else None
    for i, plane in enumerate(spec.planes):
        args.policy_planes[i] = ptr(plane)
    args.n_planes = len(spec.planes)
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
    variant = kernel_variant(n_state, spec)
    args.variant = VARIANTS.index(variant)
    static = ClosedLoopArgs.from_buffer_copy(args)

    outputs, chunk_keep = _chunk_args(args, y0, carry0, ref_leaves, obs_noise_tm, proc_noise_tm, n_steps,
                                      traj_stride, n_action)
    launch(args, variant)
    PLANS.missed(key, static, policy, ptr, grads=static_grads, extra=variant)
    return outputs


# ---------------------------------------------------------------------------
# the VJP: the kernel's forward with checkpoint saves, a segment replay back
# ---------------------------------------------------------------------------


class ClosedLoopVJP(torch.autograd.Function):
    """The closed loop as one differentiable operation, the counterpart of the
    JAX package's ``_cl_core`` ``custom_vjp``.

    Forward: the kernel on CUDA tensors, :func:`plain_closed_loop` on CPU
    tensors, both on detached inputs and with saves every
    :func:`~.checkpoint.ckpt_stride` steps; the user's saves are a slice of
    them.  Backward: the segments in reverse, each replayed through
    :func:`plain_cl_step` from its checkpoint (``_cl_core_bwd``).  The saved
    action of a save step is the policy's output at the segment's last step.
    Inputs, after the configuration: the state leaves, the references, the
    carry, the flat vector of the policy's
    :class:`~exciting_environments_torch.ops.policies.KernelSpec` (autograd
    carries its cotangent on into the policy's parameter tree), the floating
    tensor leaves of ``props`` and the two noise slabs (or ``None``)."""

    @staticmethod
    def forward(ctx, cfg, *tensors):
        ctx.set_materialize_grads(False)
        y0, refs, carry0, pp, pt, (on,), (pn,) = cfg.split(tensors)
        ckpt = ck.ckpt_stride(cfg.n_steps, cfg.traj_stride)
        kwargs = dict(tau=cfg.tau, solver=cfg.solver, props=ck.props_with(cfg.props, pt), ref_leaves=refs,
                      traj_stride=ckpt, policy_params=cfg.rebuild(pp), policy_carry=carry0 if cfg.n_carry else None,
                      obs_noise_tm=on, proc_noise_tm=pn, obs_noise_cols=cfg.obs_cols, proc_noise_idx=cfg.noise_idx)
        if y0[0].device.type == "cuda":
            final, final_c, ts, ta, tc = kernel_closed_loop(cfg.env, y0, cfg.policy, cfg.n_steps, **kwargs)
        else:
            final, final_c, ts, ta, tc = plain_closed_loop(cfg.env, y0, cfg.policy, cfg.n_steps, **kwargs)
        ctx.cfg = cfg
        ctx.save_for_backward(*tensors[: cfg.n_in], *ts, *tc)
        out = tuple(final) + tuple(final_c)
        if cfg.traj_stride is not None:
            at = slice(cfg.traj_stride // ckpt - 1, None, cfg.traj_stride // ckpt)
            out += tuple(leaf[at] for leaf in (*ts, *ta, *tc))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, *grads):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        inputs = saved[: cfg.n_in]
        y0, refs, carry0, pp, pt, (on,), (pn,) = cfg.split(inputs)
        ts = saved[cfg.n_in : cfg.n_in + cfg.n_state]
        tc = saved[cfg.n_in + cfg.n_state :]
        ns, nc, na = cfg.n_state, cfg.n_carry, cfg.env.action_dim
        ckpt = ck.ckpt_stride(cfg.n_steps, cfg.traj_stride)
        n_seg = cfg.n_steps // ckpt
        g_y, g_c = list(grads[:ns]), list(grads[ns : ns + nc])
        none = lambda n: (None,) * n
        if cfg.traj_stride is not None:
            g_ts, g_ta, g_tc = grads[ns + nc : 2 * ns + nc], grads[2 * ns + nc : 2 * ns + nc + na], grads[2 * ns + nc + na :]
            skip = cfg.traj_stride // ckpt
            g_ts, g_ta, g_tc = (ck.inject(g, skip, n_seg) for g in (g_ts, g_ta, g_tc))
        else:
            g_ts, g_ta, g_tc = none(ns), none(na), none(nc)
        y_starts, c_starts = ck.starts(y0, ts), ck.starts(carry0, tc)
        needs = ctx.needs_input_grad[1:]
        i_refs = ns
        i_carry = i_refs + len(refs)
        i_pp = i_carry + nc
        i_pt = i_pp + len(pp)
        i_on = i_pt + len(pt)
        need_refs, need_pp, need_pt = needs[i_refs:i_carry], needs[i_pp:i_pt], needs[i_pt:i_on]
        need_on, need_pn = needs[i_on], needs[i_on + 1]
        g_refs, g_pp, g_pt = [None] * len(refs), [None] * len(pp), [None] * len(pt)
        g_on = torch.zeros_like(on) if need_on else None
        g_pn = torch.zeros_like(pn) if need_pn else None
        has_carry = nc > 0
        at_seg = lambda g, s: None if g is None else g[s]
        for s in reversed(range(n_seg)):
            t0 = s * ckpt
            if s == n_seg - 1:
                g_y = [ck.add(g, at_seg(gs, s)) for g, gs in zip(g_y, g_ts)]
                g_c = [ck.add(g, at_seg(gs, s)) for g, gs in zip(g_c, g_tc)]
            # the saves at the segment's start enter as seeds of its start leaves
            seeds = ([(j, at_seg(gs, s - 1)) for j, gs in enumerate(g_ts)]
                     + [(i_carry + j, at_seg(gs, s - 1)) for j, gs in enumerate(g_tc)]) if s else []
            g_a = [at_seg(g, s) for g in g_ta]
            if all(g is None for g in (*g_y, *g_c, *g_a, *(g for _, g in seeds))):
                g_y = [ck.add(g, gs) for g, (_, gs) in zip(g_y, seeds[:ns])] if seeds else g_y
                g_c = [ck.add(g, gs) for g, (_, gs) in zip(g_c, seeds[ns:])] if seeds else g_c
                continue
            rows = slice(t0, t0 + ckpt)

            def replay(*leaves, t0=t0, g_y=g_y, g_c=g_c, g_a=g_a):
                y, rf, c, p, q, (eo,), (ep,) = cfg.split(leaves)
                props = ck.props_with(cfg.props, q)
                pparams = cfg.rebuild(p)
                for k in range(ckpt):
                    y, c, a = plain_cl_step(
                        cfg.env, cfg.policy, y, c, t0 + k, rf, pparams, tau=cfg.tau, solver=cfg.solver,
                        props=props, has_carry=has_carry, eo=None if eo is None else eo[k],
                        ep=None if ep is None else ep[k], obs_cols=cfg.obs_cols, noise_idx=cfg.noise_idx,
                    )
                return [*zip(y, g_y), *zip(c, g_c), *zip(a, g_a)]

            seg_inputs = [*(leaf[s] for leaf in y_starts), *refs, *(leaf[s] for leaf in c_starts), *pp, *pt,
                          None if on is None else on[rows], None if pn is None else pn[rows]]
            seg_needs = [True] * ns + list(need_refs) + [True] * nc + list(need_pp) + list(need_pt) + [need_on,
                                                                                                      need_pn]
            got = ck.segment_vjp(replay, seg_inputs, seg_needs, seeds)
            gy, grf, gc, gp, gq, (gon,), (gpn,) = cfg.split(got)
            g_y, g_c = list(gy), list(gc)
            g_refs = [ck.add(a, b) for a, b in zip(g_refs, grf)]
            g_pp = [ck.add(a, b) for a, b in zip(g_pp, gp)]
            g_pt = [ck.add(a, b) for a, b in zip(g_pt, gq)]
            if gon is not None:
                g_on[rows] = gon
            if gpn is not None:
                g_pn[rows] = gpn
        return (None, *g_y, *g_refs, *g_c, *g_pp, *g_pt, g_on, g_pn)


def closed_loop_vjp(env, y0, policy, n_steps, *, tau, solver, props, ref_leaves=(), traj_stride=None,
                    policy_params=None, policy_carry=None, obs_noise_tm=None, proc_noise_tm=None,
                    obs_noise_cols=(), proc_noise_idx=()):
    """The closed loop of a compiled policy family through
    :class:`ClosedLoopVJP` (arguments and returns as
    :func:`plain_closed_loop`, on any device)."""
    y0 = tuple(y0)
    if traj_stride is not None and n_steps % traj_stride:
        raise ValueError("n_steps must be divisible by traj_stride")
    carry0 = tuple(policy_carry) if policy_carry is not None else ()
    flat = policy.kernel_spec(y0[0].dtype, y0[0].device, policy_params).flat
    pt = ck.prop_tensors(props)
    refs = tuple(ref_leaves)
    cfg = ck.VJPConfig((len(y0), len(refs), len(carry0), 1, len(pt), 1, 1), env=env, policy=policy,
                       n_steps=n_steps, tau=tau, solver=solver, props=props, traj_stride=traj_stride,
                       rebuild=lambda p: policy.params_from_flat(p[0], policy_params), n_state=len(y0),
                       n_carry=len(carry0), obs_cols=tuple(obs_noise_cols), noise_idx=tuple(proc_noise_idx))
    out = ClosedLoopVJP.apply(cfg, *y0, *refs, *carry0, flat, *pt, obs_noise_tm, proc_noise_tm)
    ns, nc, na = len(y0), len(carry0), env.action_dim
    final, final_c = out[:ns], out[ns : ns + nc]
    if traj_stride is None:
        return final, final_c, None, None, None
    rest = out[ns + nc :]
    return final, final_c, rest[:ns], rest[ns : ns + na], rest[ns + na :]


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
    elif isinstance(policy, KernelPolicy) and ck.records_grad(y0, policy, kwargs):
        out = closed_loop_vjp(env, y0, policy, n_steps, **kwargs)
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


class ClosedLoopNoise:
    """A stochastic environment's closed-loop draws (the JAX package's
    ``env_fused_closed_loop`` pre-pass), from :meth:`CoreEnvironment._noise_slabs`
    with stride 1, since the policy reads a measurement every step:

    * ``slabs``: the kernel's keyword arguments, the pre-scaled process slab
      and the sensor slab of the noisy columns, shifted one step (the policy
      at step ``t`` sees step ``t - 1``'s post-step measurement; step 0 adds
      zeros to the exact reset observation);
    * the returned observations take their own steps' draws, the final
      state the final keys and each save its step's advanced key.

    Empty for a deterministic environment."""

    def __init__(self, env, props, eps_proc=None, eps_obs=None, keys_steps=None, final_keys=None):
        self.env, self.props = env, props
        self.eps_obs, self.keys_steps, self.final_keys = eps_obs, keys_steps, final_keys
        self.slabs = {}
        if eps_proc is not None:
            noise_tm, noise_idx = env._process_noise_slab(eps_proc)
            self.slabs.update(proc_noise_tm=noise_tm, proc_noise_idx=noise_idx)
        if eps_obs is not None:
            sigmas = env._obs_noise_sigma_norm(props)
            noisy = [(k, col) for k, (col, name) in enumerate(env._obs_noise_layout) if name in env._observation_noise]
            scaled = torch.stack([sigmas[k] * eps_obs[..., k] for k, _ in noisy], dim=-1)  # (T, B, n)
            self.slabs.update(obs_noise_tm=torch.cat([torch.zeros_like(scaled[:1]), scaled[:-1]]).contiguous(),
                              obs_noise_cols=tuple(col for _, col in noisy))

    def final_key(self, init_state):
        return init_state.PRNGKey if self.final_keys is None else self.final_keys

    def final_obs(self, obs):
        """The final observation with the last step's sensor draw."""
        return obs if self.eps_obs is None else self.env._apply_observation_noise_eps(obs, self.props, self.eps_obs[-1])

    def save_keys(self, init_state, stride, n_saves):
        """The key leaf of the batch-major saves (:func:`~.stepper.traj_keys`)."""
        keys = None if self.keys_steps is None else self.keys_steps[stride - 1 :: stride]
        return traj_keys(init_state.PRNGKey, keys, n_saves)

    def save_obs(self, obs, stride):
        """Batch-major saved observations ``(B, n_saves, obs_dim)`` with their
        steps' sensor draws."""
        if self.eps_obs is None:
            return obs
        eps = self.eps_obs[stride - 1 :: stride].transpose(0, 1)
        return self.env._apply_observation_noise_eps(obs, self.props, eps, batch_major=True)


def closed_loop_noise(env, init_state, n_steps, props) -> ClosedLoopNoise:
    """:class:`ClosedLoopNoise` of ``env`` from ``init_state``'s keys."""
    if not env._has_noise:
        return ClosedLoopNoise(env, props)
    eps_proc, eps_obs, keys_steps, final_keys = env._noise_slabs(env._require_noise_key(init_state), n_steps, 1)
    return ClosedLoopNoise(env, props, eps_proc, eps_obs, keys_steps, final_keys)


def supports_fused_closed_loop(env) -> bool:
    """Scope of the closed-loop kernel: the kernels' environment scope
    (:func:`~.stepper.kernel_env_scope`) with a stage count the kernel is built for, scalar physical and action
    normalizations, the physical fields in the ODE's order (the kernel builds
    the observation from the integrated leaves), and at most ``MAX_REFS``
    tracked references.  Any batch size is in scope.  An action-constraint
    hook other than the inverter circle is not checked here: the plain loop
    runs it on CPU tensors, and on CUDA the launch raises before it runs, as
    for a policy outside the compiled families."""
    if not kernel_env_scope(env):
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

    A stochastic environment streams its draws (:func:`closed_loop_noise`):
    the policy acts on the noisy measurement of the step before (the exact
    reset observation at step 0), the process increments follow each step,
    and the returned observations, final and saved states carry their
    steps' sensor draws and advanced keys, as
    :func:`~exciting_environments_torch.utils.collect.tile_policy_scan`.
    """
    if return_traj_states and obs_stride is None:
        raise ValueError("return_traj_states requires obs_stride")
    with annotate("ee.rollout.prepare"):
        scope = Key().env(env, env.env_properties, env._solver)
        if not PLANS.in_scope(scope, lambda: supports_fused_closed_loop(env)):
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
        noise = closed_loop_noise(env, init_state, n_steps, props)
        result = fused_closed_loop(
            env, y0, policy, n_steps, props=props, ref_leaves=ref_leaves, traj_stride=obs_stride,
            policy_params=policy_params, policy_carry=policy_carry, **noise.slabs,
        )
    with annotate("ee.rollout.rebuild"):
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
            a_phys_last = phys_action(env, torch.stack(tuple(a_norm_last), dim=-1), props)
            solver_carry = _final_solver_state(env, y_final, a_phys_last, props)

        device = y_final[0].device
        final_state = structures.replace(
            init_state,
            physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y_final))),
            PRNGKey=noise.final_key(init_state),
            additions=env.Additions(
                solver_state=solver_carry,
                active_solver_state=torch.ones(env.batch_size, dtype=torch.bool, device=device),
            ),
        )
        tail = (final_carry,) if has_carry else ()
        if obs_stride is None:
            return (noise.final_obs(env.generate_observation(final_state, props)), final_state) + tail

        n_saves = n_steps // obs_stride
        expand = lambda leaf: _broadcast_saves(leaf, n_saves)
        traj_state = structures.replace(
            final_state,
            physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, traj_state_t))),
            PRNGKey=noise.save_keys(init_state, obs_stride, n_saves),
            additions=env.Additions(
                solver_state=None,
                active_solver_state=torch.ones((env.batch_size, n_saves), dtype=torch.bool, device=device),
            ),
            reference=structures.map_leaves(expand, init_state.reference),
        )
        obs_traj = noise.save_obs(env.generate_observation(traj_state, env._props_for(props, 1)), obs_stride)
        actions_traj = torch.stack(traj_act_t, dim=-1)
        if return_traj_states:
            return (obs_traj, actions_traj, traj_state, final_state) + tail
        return (obs_traj, actions_traj, final_state) + tail
