"""Trajectory integration engine (counterpart of
``exciting_environments_tpu/ops/rollout.py``): a Python time loop over the
solver's ``step`` where the JAX package runs ``lax.scan``.

Step times are computed on the host in float64 (``t_k = k * obs_stepsize``)
and rounded to the working dtype, and the zero-order-hold action index is
computed on the host in that same dtype, so the device never synchronizes to
look up an action.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _np_dtype(tensor_dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[tensor_dtype]


def zoh_action(actions, action_stepsize: float) -> Callable:
    """Zero-order-hold interpolation of an action sequence.

    ``actions`` has a leading time axis ``(n_action_steps, ...)``; the
    returned callable maps a host time ``t`` (Python float or numpy scalar)
    to the action row active at ``t``.  The truncating index carries the
    reference's floor guard against division jitter (a relative epsilon of
    4 ulps) and is clamped to the last row, like a JAX gather.
    """
    n = actions.shape[0]

    def action(t):
        dt = type(t) if isinstance(t, np.floating) else np.float64
        kq = dt(t) / dt(action_stepsize)
        kq = kq + (4 * np.finfo(dt).eps) * abs(kq)
        idx = min(max(int(np.floor(kq)), 0), n - 1)
        return actions[idx]

    return action


def solve_trajectory(solver, f: Callable, y0, args, n_steps: int, obs_stepsize: float):
    """Integrate ``n_steps`` fixed steps of size ``obs_stepsize`` from ``t=0``.

    Returns ``(ys, y_last)``: ``ys`` is a tuple of time-major tensors with
    leading axis ``n_steps + 1`` (the initial state included) and ``y_last``
    the final state.  The explicit ``dt`` keeps ``fl(t + h) - t`` rounding
    out of the step.
    """
    dt = _np_dtype(y0[0].dtype)
    ts = (np.arange(n_steps, dtype=np.float64) * obs_stepsize).astype(dt)
    carry = solver.init(f, 0.0, obs_stepsize, y0, args)
    y = y0
    saved = [y0]
    for t in ts:
        y, carry = solver.step(f, t, t + dt(obs_stepsize), y, args, carry, dt=obs_stepsize)
        saved.append(y)
    ys = tuple(torch.stack(leaf, dim=0) for leaf in zip(*saved))
    return ys, y


def step_loop(solver, f: Callable, y0, args, n_steps: int, tau: float):
    """Repeatedly apply the single-step protocol (each step over ``[0, tau]``)."""
    carry = solver.init(f, 0.0, tau, y0, args)
    y = y0
    saved = []
    for _ in range(n_steps):
        y, carry = solver.step(f, 0.0, tau, y, args, carry)
        saved.append(y)
    return tuple(torch.stack(leaf, dim=0) for leaf in zip(*saved)), y
