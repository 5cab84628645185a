"""Batched adaptive step-size integration with per-instance error control
(counterpart of ``exciting_environments_tpu/ops/adaptive.py``).

A PI-style controller over an embedded Runge-Kutta pair (Tsit5, Dopri5):
the whole batch advances together, but every instance keeps its own time,
step size and acceptance state, so stiff and smooth instances of one batch
each take the steps they need.  Every comparison is an elementwise mask.

* :func:`adaptive_solve`: one smooth vector field from ``t0`` to ``t1``;
* :func:`adaptive_rollout`: an environment across a zero-order-hold action
  sequence, each hold interval integrated adaptively, the step proposal
  carried from one interval to the next.

Where the JAX package runs one ``lax.while_loop``, the port runs a Python
loop of masked tensor operations.  The loop ends when every instance has
reached its end time, which the host reads from the device (a
synchronization).  An instance that has finished is left exactly as it was
by further iterations (no acceptance, unchanged time, state, first stage and
step, counters plus 0), so the loop reads that condition only before
iterations ``0, 1, 2, 4, 8, 16`` and then every :data:`CHECK_EVERY`: the
same result bit for bit as a check before every iteration, with fewer
synchronizations.  The iteration bound ``max_steps`` stays exact.
"""

from __future__ import annotations

import math

import torch

from exciting_environments_torch.core.structures import dataclass

#: the longest run of iterations between two reads of the loop condition
CHECK_EVERY = 16
#: what the controller loops did since the last reset: iterations run and
#: loop conditions read on the host (one synchronization each)
COUNTS = {"iterations": 0, "syncs": 0}


def reset_counts():
    for name in COUNTS:
        COUNTS[name] = 0


@dataclass
class AdaptiveStats:
    """Per-instance integration statistics.

    ``incomplete`` flags instances whose loop hit the ``max_steps`` bound
    before reaching the end time: their state is only integrated up to some
    ``t < t1``.
    """

    accepted: torch.Tensor
    rejected: torch.Tensor
    final_dt: torch.Tensor
    incomplete: torch.Tensor


def _error_ratio(y, y_new, err, rtol, atol):
    """Max over state leaves of ``|err| / (atol + rtol * max(|y|, |y_new|))``."""
    out = None
    for leaf, leaf_new, leaf_err in zip(y, y_new, err):
        scale = atol + rtol * torch.maximum(torch.abs(leaf), torch.abs(leaf_new))
        r = torch.abs(leaf_err) / scale
        out = r if out is None else torch.maximum(out, r)
    return out


def _check_solver(solver):
    if getattr(solver, "b_err", None) is None:
        raise ValueError(f"{type(solver).__name__} has no embedded error estimate")


def adaptive_solve(solver, f, y0, args, t0: float, t1: float, rtol: float = 1e-6, atol: float = 1e-8,
                   dt0: float = None, max_steps: int = 10_000, safety: float = 0.9, min_factor: float = 0.2,
                   max_factor: float = 5.0, device=None):
    """Integrate ``dy/dt = f(t, y, args)`` from ``t0`` to ``t1`` with
    per-instance adaptive steps.

    Args:
        solver: an embedded-pair solver (``Tsit5`` or ``Dopri5``).
        f: vector field over tuple states (leaves scalar or ``(B,)``).
        y0: initial state; scalar leaves are broadcast to the batch shape.
        args: parameters forwarded to ``f``.
        t0, t1: integration interval (shared; instances finish independently).
        rtol, atol: tolerance of the embedded local-error test.
        dt0: initial step (default ``(t1 - t0) / 100``).
        max_steps: iteration bound of the controller loop.
        safety, min_factor, max_factor: step controller constants.
        device: of a state whose leaves are all Python numbers (default
            CUDA, raising without a GPU; such a state is float64); otherwise
            the device and promoted dtype of its tensor leaves hold.

    Returns:
        ``(y_final, AdaptiveStats)``.
    """
    _check_solver(solver)
    if dt0 is None:
        dt0 = (t1 - t0) / 100.0
    tensors = [leaf for leaf in y0 if isinstance(leaf, torch.Tensor)]
    if tensors:
        device, dtype = tensors[0].device, tensors[0].dtype
        for leaf in tensors[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
    else:
        from exciting_environments_torch.core.env import resolve_device

        device, dtype = resolve_device(device), torch.float64
    shape = torch.broadcast_shapes(*(tuple(getattr(leaf, "shape", ())) for leaf in y0))
    proto = torch.zeros(shape, dtype=dtype, device=device)
    y0 = tuple(torch.as_tensor(leaf, dtype=dtype, device=device).expand(shape).clone() for leaf in y0)
    y, dt, t_end, accepted, rejected = _adaptive_interval(
        solver, f, y0, args, proto + t0, proto + t1, proto + dt0,
        rtol, atol, max_steps, safety, min_factor, max_factor,
    )
    return y, AdaptiveStats(accepted=accepted, rejected=rejected, final_dt=dt, incomplete=t_end < t1)


def _adaptive_interval(solver, f, y0, args, t, t1, dt, rtol, atol, max_steps, safety, min_factor, max_factor):
    """Controlled integration of one smooth interval; ``t``, ``t1`` and
    ``dt`` are per-instance tensors, the leaves of ``y0`` of their shape.

    Returns ``(y, dt, t, accepted, rejected)``: ``dt`` the controller's last
    step proposal (the warm start of a following interval) and ``t`` the
    time each instance reached (``< t1`` where the ``max_steps`` bound came
    first).
    """
    accepted = torch.zeros(t.shape, dtype=torch.int32, device=t.device)
    rejected = torch.zeros_like(accepted)
    inv_order = 1.0 / solver.order
    # FSAL: an accepted step's last stage is the next step's first stage
    # (per instance, because the vector field is elementwise over the batch)
    fsal = bool(getattr(solver, "fsal", False))
    y = tuple(y0)
    k0 = f(t, y, args)

    def iteration(t, dt, y, k0, accepted, rejected):
        active = t < t1
        dt_try = torch.where(active, torch.minimum(dt, t1 - t), dt)
        y_new, err, k_end = solver.step_with_error(f, t, t + dt_try, y, args, dt=dt_try, k0=k0 if fsal else None)
        ratio = _error_ratio(y, y_new, err, rtol, atol)
        # a non-finite trial step (overflowing dynamics) is infinitely
        # wrong: reject it and shrink by min_factor
        ratio = torch.where(torch.isfinite(ratio), ratio, math.inf)
        accept = (ratio <= 1.0) & active
        y = tuple(torch.where(accept, new, old) for old, new in zip(y, y_new))
        if fsal:
            k0 = tuple(torch.where(accept, new, old) for old, new in zip(k0, k_end))
        t = torch.where(accept, t + dt_try, t)
        accepted = accepted + accept.to(torch.int32)
        rejected = rejected + (active & ~accept).to(torch.int32)
        factor = torch.clamp(safety * ratio ** (-inv_order), min_factor, max_factor)
        dt_prop = dt_try * factor
        # a step shortened only by the end of the interval and then accepted
        # says nothing against the longer proposal: keep the larger, or the
        # warm start would collapse to each interval's remainder
        clipped = dt_try < dt
        dt_prop = torch.where(clipped & accept, torch.maximum(dt_prop, dt), dt_prop)
        dt = torch.where(active, dt_prop, dt)
        return t, dt, y, k0, accepted, rejected

    i = 0
    while i < max_steps:
        COUNTS["syncs"] += 1
        if not bool((t < t1).any()):
            break
        run = min(CHECK_EVERY, max(1, i), max_steps - i)
        for _ in range(run):
            t, dt, y, k0, accepted, rejected = iteration(t, dt, y, k0, accepted, rejected)
        i += run
        COUNTS["iterations"] += run
    return y, dt, t, accepted, rejected


def _hold_intervals(y, args, n_intervals, tau, field, boundary, rtol, atol, solver, dt0, max_steps_per_interval,
                    safety, min_factor, max_factor):
    """The controller across ``n_intervals`` zero-order-hold intervals of
    ``tau`` from ``y`` (leaves ``(B,)``): ``field(i, y)`` gives interval
    ``i``'s vector field at its start (a hook may advance its own carry
    there, as the drive's deadtime buffer), ``boundary(y)`` what applies at
    its end (wrap, clip).  The step proposal carries from one interval to
    the next.  Returns ``(y, AdaptiveStats)`` summed over the intervals."""
    from exciting_environments_torch.ops.solvers import Tsit5

    solver = solver if solver is not None else Tsit5()
    _check_solver(solver)
    proto = torch.zeros(y[0].shape, dtype=y[0].dtype, device=y[0].device)
    dt, t0 = proto + (dt0 if dt0 is not None else tau / 10.0), proto
    accepted = torch.zeros(proto.shape, dtype=torch.int32, device=proto.device)
    rejected = torch.zeros_like(accepted)
    incomplete = torch.zeros(proto.shape, dtype=torch.bool, device=proto.device)
    for i in range(n_intervals):
        f = field(i, y)
        t1 = t0 + tau
        y, dt, t_end, acc, rej = _adaptive_interval(solver, f, y, args, t0, t1, dt, rtol, atol,
                                                    max_steps_per_interval, safety, min_factor, max_factor)
        incomplete = incomplete | (t_end < t1)
        y = boundary(y)
        t0, accepted, rejected = t1, accepted + acc, rejected + rej
    return y, AdaptiveStats(accepted=accepted, rejected=rejected, final_dt=dt, incomplete=incomplete)


def adaptive_rollout(env, init_state, actions_norm, rtol: float = 1e-6, atol: float = 1e-8, solver=None,
                     dt0: float = None, max_steps_per_interval: int = 1_000, safety: float = 0.9,
                     min_factor: float = 0.2, max_factor: float = 5.0, env_properties=None):
    """Integrate an environment's dynamics across a zero-order-hold action
    sequence with per-instance adaptive steps.

    The fixed-step paths (``vmap_rollout``, the fused kernels) take one solver
    step per control interval ``tau``, which under-resolves stiff parameter
    regions.  Here each hold interval is integrated by the controller of
    :func:`adaptive_solve`, the step proposal carried across intervals.  The
    angle wrap and the post-step clip (e.g. the fluid tank's ``h >= 0``)
    apply at interval boundaries, where the fixed-step paths apply them.

    Args:
        env: an environment (scalar or per-batch ``(B,)`` parameters).  An
            environment with its own ``_adaptive_rollout`` (the PMSM drive)
            runs that.
        init_state: batched state from ``vmap_reset``.
        actions_norm: normalized actions ``(B, n_intervals, A)``, each held
            for ``env.tau`` seconds.
        rtol, atol: local-error tolerances.
        solver: embedded-pair solver (default ``Tsit5()``).
        dt0: initial step proposal (default ``tau / 10``).
        max_steps_per_interval: iteration bound per hold interval.
        safety, min_factor, max_factor: controller constants.
        env_properties: optional override of ``env.env_properties``.

    Returns:
        ``(obs, final_state, stats)``: observations at the final time, the
        environment ``State`` and per-instance :class:`AdaptiveStats` summed
        over the horizon.
    """
    from exciting_environments_torch.core import structures
    from exciting_environments_torch.core.env import CoreEnvironment, _Components

    if env._has_noise:
        raise ValueError(
            "adaptive_rollout integrates the deterministic dynamics only: the embedded pair's local-error "
            "estimate measures a smooth Taylor remainder, which an O(sigma*sqrt(h)) diffusion increment "
            "swamps, and adding noise only at accepted steps would make the path's law depend on the "
            "tolerance.  Stochastic envs step through vmap_rollout/vmap_step at the fixed control rate."
        )
    custom = getattr(env, "_adaptive_rollout", None)
    if custom is not None:
        return custom(init_state, actions_norm, rtol=rtol, atol=atol, solver=solver, dt0=dt0,
                      max_steps_per_interval=max_steps_per_interval, safety=safety, min_factor=min_factor,
                      max_factor=max_factor, env_properties=env_properties)

    props = env_properties if env_properties is not None else env.env_properties
    if len(env._ode_state_fields) != env.physical_state_dim:
        raise ValueError(
            f"adaptive_rollout supports environments whose physical state is exactly the integrated ODE "
            f"state; {type(env).__name__} carries derived fields beyond {env._ode_state_fields}: implement "
            f"_adaptive_rollout on the environment (see the PMSM drive)"
        )

    batch, n_intervals, _ = actions_norm.shape
    acts = env._constrained_phys_action(env.denormalize_action(actions_norm, env._props_for(props, 1)))
    phys = init_state.physical_state
    y = tuple(torch.as_tensor(getattr(phys, n)).expand(batch) for n in env._ode_state_fields)
    clip = type(env)._clip_state is not CoreEnvironment._clip_state

    def field(i, y):
        act = _Components(acts[:, i])
        return lambda t, yy, aa: env._ode(t, yy, aa, lambda _t: act)

    def boundary(y):
        y = env._wrap_angles(y)
        return env._clip_state(y) if clip else y

    y, stats = _hold_intervals(y, props.static_params, n_intervals, float(env.tau), field, boundary, rtol, atol,
                               solver, dt0, max_steps_per_interval, safety, min_factor, max_factor)
    final_state = structures.replace(
        init_state,
        physical_state=env.PhysicalState(**dict(zip(env._ode_state_fields, y))),
        additions=env.Additions(solver_state=None,
                                active_solver_state=torch.ones(batch, dtype=torch.bool, device=y[0].device)),
    )
    return env.generate_observation(final_state, props), final_state, stats
