"""Constant-gain state estimation of a linear environment (counterpart of the
stationary-Kalman part of ``exciting_environments_tpu/utils/estimate.py``).

:func:`stationary_kalman_gain` extracts a linear environment's one-step
transition ``x' = A x + B u + c`` in normalized coordinates from the
environment's own step (``torch.func.jacrev`` in float64 through
``_state_from_normalized_physical`` → ``_advance_state`` →
``normalize_state``), checks at a probe point that the step is affine, and
iterates the predicted-form Riccati equation to its fixed point in numpy
float64.  The result is one constant gain, the observer that
``utils/foc.py::make_sensorless_foc_tile`` runs inside the closed-loop
kernel.

Conventions as in the JAX package: the filter state is the normalized
physical vector; ``process_std`` / ``measurement_std`` are ``{field: sigma}``
dicts in physical units (per sqrt-second for the process part) and default
to the environment's own ``process_noise`` / ``observation_noise``.  The
EKF and UKF runners (``run_ekf``, ``run_ukf``) are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from exciting_environments_torch.core import structures

__all__ = ["StationaryKalman", "stationary_kalman_gain"]


def _phys_names(env) -> tuple:
    return tuple(f.name for f in dataclasses.fields(env.PhysicalState))


def _norm_span(env_properties, name):
    norm = getattr(env_properties.physical_normalizations, name)
    return norm.max - norm.min


def _as_scalar_span(env_properties, name) -> float:
    span = _norm_span(env_properties, name)
    if isinstance(span, torch.Tensor) and span.ndim != 0:
        raise ValueError(
            "filtering needs scalar normalizations (a single plant model); "
            f"field {name!r} has a per-batch normalization of shape {tuple(span.shape)}"
        )
    return float(span)


def _float64_twin(env):
    """A shallow copy of ``env`` that makes its states in float64 on the CPU
    (the environment's properties are scalars here, so they carry over)."""
    twin = copy.copy(env)
    twin.device, twin.dtype = torch.device("cpu"), torch.float64
    return twin


def _dynamics_fn(env):
    """``f(x_norm, action_norm, env_properties) -> x_norm'``: one
    deterministic step in normalized coordinates, built from the
    environment's own hooks (``_state_from_normalized_physical`` →
    ``_advance_state`` → ``normalize_state``).  Differentiable; bypasses the
    environment's noise (the filter models it through Q and R)."""
    names = _phys_names(env)

    def f(x_norm, action_norm, props):
        state = env._state_from_normalized_physical(x_norm, props)
        new_state = env._advance_state(state, action_norm, props)
        norm = env.normalize_state(new_state, props)
        return torch.stack([getattr(norm.physical_state, n) for n in names])

    return f


def _make_dynamics(env, env_properties):
    """:func:`_dynamics_fn` closed over one set of properties."""
    f = _dynamics_fn(env)
    return lambda x, u: f(x, u, env_properties)


def _angle_periods(env, env_properties, names) -> np.ndarray:
    """Normalized-unit circular period per field (``0`` = not an angle)."""
    return np.array([
        2.0 * math.pi * 2.0 / _as_scalar_span(env_properties, name) if name in getattr(env, "_angle_fields", ())
        else 0.0
        for name in names
    ])


def _std_dict_to_norm(env_properties, names, std, scale=1.0, what="std") -> np.ndarray:
    """``{field: sigma_physical}`` → normalized-band std vector ``(n,)``."""
    std = dict(std or {})
    unknown = set(std) - set(names)
    if unknown:
        raise ValueError(f"{what} names {sorted(unknown)} not in physical fields {names}")
    out = []
    for name in names:
        sigma = float(std.get(name, 0.0))
        if sigma < 0:
            raise ValueError(f"{what}[{name!r}] must be >= 0, got {sigma}")
        out.append(scale * 2.0 * sigma / _as_scalar_span(env_properties, name) if sigma else 0.0)
    return np.array(out)


def _resolve_setup(env, env_properties, measured_fields, process_std, measurement_std):
    """``(names, n, midx, zidx, Q, R, periods)`` of a filter over ``env``:
    the state order, the measured fields' state indices and observation
    columns, and the normalized process and sensor covariances."""
    if not hasattr(env, "_state_from_normalized_physical") or not hasattr(env, "_obs_noise_layout"):
        raise TypeError(f"filtering needs a CoreEnvironment; got {type(env).__name__}")
    # the dynamics closure captures env_properties; a per-batch (B,) leaf
    # would broadcast into each per-instance filter
    if any(isinstance(leaf, torch.Tensor) for leaf in structures.leaves(env_properties)):
        raise ValueError(
            "filtering needs scalar env properties (one plant model per filter); "
            "this env carries per-batch (batch_size,) property leaves — construct "
            "a scalar-parameter twin for the filter model"
        )
    names = _phys_names(env)
    n = len(names)
    obs_columns = {name: col for col, name in env._obs_noise_layout}
    if measured_fields is None:
        measured_fields = tuple(name for _col, name in env._obs_noise_layout)
    measured_fields = tuple(measured_fields)
    unknown = set(measured_fields) - set(obs_columns)
    if unknown:
        raise ValueError(
            f"measured_fields {sorted(unknown)} are not measurable observation columns {sorted(obs_columns)}"
        )
    if not measured_fields:
        raise ValueError("measured_fields must name at least one observed component")
    midx = np.array([names.index(m) for m in measured_fields])
    zidx = np.array([obs_columns[m] for m in measured_fields])

    if process_std is None:
        process_std = getattr(env, "_process_noise", None) or {}
    if measurement_std is None:
        src = getattr(env, "_observation_noise", None) or {}
        measurement_std = {k: v for k, v in src.items() if k in measured_fields}

    sqrt_tau = float(env.tau) ** 0.5
    q_std = _std_dict_to_norm(env_properties, names, process_std, scale=sqrt_tau, what="process_std")
    r_std = _std_dict_to_norm(env_properties, names, measurement_std, what="measurement_std")[midx]
    # a singular R makes the innovation solve ill-posed; floor it at a band
    # resolution far below any physical sensor
    r_std = np.maximum(r_std, 1e-6)
    return names, n, midx, zidx, np.diag(q_std**2), np.diag(r_std**2), _angle_periods(env, env_properties, names)


class StationaryKalman(NamedTuple):
    """Steady-state Kalman observer of a LINEAR environment in normalized
    coordinates (see :func:`stationary_kalman_gain`).

    ``A``/``B``/``c``: the one-step transition ``x' = A x + B u + c`` (``u``
    the normalized action).  ``K``: the converged predicted-form gain, the
    correction ``x(t|t) = x(t|t-1) + K (z - x(t|t-1)[midx])``.  ``P``: the
    converged pre-measurement covariance.  ``midx``: the measured fields'
    state indices; ``zidx``: their observation columns; ``names``: the field
    order.  Host numpy float64 throughout: constants that a kernel policy
    folds into its flat parameters."""

    A: object
    B: object
    c: object
    K: object
    P: object
    midx: object
    zidx: object
    names: tuple


def stationary_kalman_gain(env, *, measured_fields=None, process_std=None, measurement_std=None,
                           q_floor: float = 1e-8, max_iters: int = 200_000, tol: float = 1e-13) -> StationaryKalman:
    """Steady-state Kalman filter of a LINEAR environment.

    For a time-invariant linear plant the EKF's covariance recursion
    converges to a fixed point, so the per-step Riccati update collapses to
    one constant gain, cheap enough to run inside the closed-loop kernel
    (one ``K``-correction and one ``A x + B u`` predict per step).

    The transition is the environment's OWN step, differentiated with
    ``torch.func.jacrev`` in float64 at the origin (an explicit solver of a
    linear ODE is itself linear, so the matrices are exact), and linearity is
    verified: the step at a probe point is compared with the affine model,
    and a nonlinear environment raises.

    Args:
        env: a linear environment with scalar properties (the induction
            machine, the mass-spring-damper, the EESM...); angle-wrapped
            fields are rejected (the wrap is nonlinear).
        measured_fields: measured observation fields (default: every
            measurable column).
        process_std / measurement_std: ``{field: sigma}`` in physical units
            (default: the environment's own noise configuration).
        q_floor: diagonal process-covariance floor (normalized units^2).
        max_iters / tol: the fixed-point iteration's budget, iterated to
            ``max |dP| < tol``.

    Returns:
        :class:`StationaryKalman` (host numpy constants).
    """
    env_properties = env.env_properties
    names, n, midx, zidx, Q, R, periods = _resolve_setup(env, env_properties, measured_fields, process_std,
                                                         measurement_std)
    if bool(np.any(periods > 0)):
        raise ValueError(
            "stationary_kalman_gain needs a linear env; angle-wrapped fields "
            f"{tuple(getattr(env, '_angle_fields', ()))} make the step nonlinear "
            "— use run_ekf / run_output_feedback_controller instead"
        )
    f = _make_dynamics(_float64_twin(env), env_properties)
    x0 = torch.zeros(n, dtype=torch.float64)
    u0 = torch.zeros(env.action_dim, dtype=torch.float64)
    jac_x, jac_u = torch.func.jacrev(f, argnums=(0, 1))(x0, u0)
    A, B = jac_x.numpy().astype(np.float64), jac_u.numpy().astype(np.float64)
    c = f(x0, u0).numpy().astype(np.float64)
    # verify linearity at a generic probe point (a nonlinear env would make
    # the constant-gain observer silently wrong)
    xp = np.linspace(0.13, 0.29, n)
    up = np.linspace(-0.41, 0.37, env.action_dim)
    probe = f(torch.as_tensor(xp), torch.as_tensor(up)).numpy()
    affine = A @ xp + B @ up + c
    err = float(np.abs(probe - affine).max())
    # the observer predicts one step at a time, so the deviation that
    # matters is relative to the per-step increment, not the state scale
    scale = float(np.abs(affine - xp).max()) + 1e-12
    if err > 1e-3 * scale:
        raise ValueError(
            f"stationary_kalman_gain needs a linear env: the step deviates from its linearization by "
            f"{err:.3e} ({err / scale:.1%} of the step increment) at a probe point — use run_ekf (per-step "
            "relinearization) instead"
        )

    Qn = Q + q_floor * np.eye(n)
    # predicted-form Riccati fixed point: P is the PRE-measurement covariance
    P = Qn.copy()
    for _ in range(max_iters):
        S = P[np.ix_(midx, midx)] + R
        K = np.linalg.solve(S.T, P[:, midx].T).T
        P_next = A @ (P - K @ P[midx, :]) @ A.T + Qn
        if float(np.abs(P_next - P).max()) < tol:
            P = P_next
            break
        P = P_next
    S = P[np.ix_(midx, midx)] + R
    K = np.linalg.solve(S.T, P[:, midx].T).T
    return StationaryKalman(A=A, B=B, c=c, K=K, P=P, midx=midx, zidx=zidx, names=names)
