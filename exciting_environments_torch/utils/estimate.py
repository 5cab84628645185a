"""State estimation through the environment's own step (counterpart of
``exciting_environments_tpu/utils/estimate.py``).

* :func:`run_ekf` — extended Kalman filter: the transition Jacobian is the
  forward-mode derivative of the environment's own deterministic step, so
  the filter model is the simulator (any solver, any environment), with an
  optional Rauch–Tung–Striebel smoother (``smooth=True``).
* :func:`run_ukf` — unscented Kalman filter (scaled sigma points, van der
  Merwe weights): no Jacobian, only forward steps.
* :func:`stationary_kalman_gain` — the converged constant gain of a LINEAR
  environment, extracted with ``torch.func.jacrev`` in float64 and iterated
  to the Riccati fixed point in numpy float64; the observer that
  ``utils/foc.py::make_sensorless_foc_tile`` runs inside the closed-loop
  kernel.

The filters run ONE batched program over all trajectories, where the JAX
package ``vmap``s one filter per trajectory: the mean is ``(B, n)``, the
covariance ``(B, n, n)``, and the step ``f(x, u)`` goes through the
environment's hooks (``_state_from_normalized_physical`` →
``_advance_state`` → ``normalize_state``) on ``(..., n)`` inputs.  The EKF's
Jacobian is ``(B, n, n)``: ``n`` forward-mode products with one-hot
tangents, evaluated in one pass over an ``(n, B, n)`` copy of the mean
(exact, because the step is elementwise over the batch).  The UKF folds its
``2n + 1`` sigma points into the batch axis: one step of ``B (2n + 1)``
instances per filter step.  Every tensor lives on the environment's device
in its dtype; inputs are promoted to that dtype (the JAX package promotes
to its default float).

Conventions as in the JAX package: the filter state is the normalized
physical vector; ``process_std`` / ``measurement_std`` are ``{field:
sigma}`` dicts in physical units (per sqrt-second for the process part) and
default to the environment's own ``process_noise`` / ``observation_noise``;
angle fields (``env._angle_fields``) are circular (innovations and
corrections wrap on the field's normalized period); ``observations[k]`` is
the measurement after ``actions[k]`` (``vmap_rollout``'s alignment).  A
single trajectory ``(T, obs_dim)`` is a batch of one.  The PMSM's
transition includes the inverter hexagon and the deadtime buffer swap; its
epsilon is cos/sin-encoded and not measurable.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from exciting_environments_torch.core import structures

__all__ = ["FilterResult", "StationaryKalman", "run_ekf", "run_ukf", "stationary_kalman_gain"]


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
        return torch.stack([getattr(norm.physical_state, n) for n in names], dim=-1)

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


class FilterResult(NamedTuple):
    """Outcome of :func:`run_ekf` / :func:`run_ukf`.

    ``means``: filtered normalized state means ``(B, T, n_phys)`` (``(T,
    n_phys)`` for a single trajectory); entry ``k`` estimates the state after
    ``actions[k]``.  ``covs``: filtered covariances ``(B, T, n_phys,
    n_phys)``.  ``nll``: the innovation-form negative log marginal likelihood
    of the measurements, ``(B,)`` (a scalar for a single trajectory).
    ``smoothed_means`` / ``smoothed_covs``: the Rauch–Tung–Striebel
    estimates (``run_ekf(smooth=True)`` only, else ``None``)."""

    means: torch.Tensor
    covs: torch.Tensor
    nll: torch.Tensor
    smoothed_means: torch.Tensor = None
    smoothed_covs: torch.Tensor = None


def _filter_setup(env, measured_fields, process_std, measurement_std):
    """:func:`_resolve_setup` over ``env.env_properties`` with ``midx``,
    ``Q``, ``R`` and ``periods`` as tensors on the environment's device in
    its dtype: ``(names, n, midx, zidx, Q, R, periods)``."""
    names, n, midx, zidx, Q, R, periods = _resolve_setup(env, env.env_properties, measured_fields, process_std,
                                                         measurement_std)
    as_t = lambda a: torch.as_tensor(a, dtype=env.dtype, device=env.device)
    midx_t = torch.as_tensor(midx, dtype=torch.long, device=env.device)
    zidx_t = torch.as_tensor(zidx, dtype=torch.long, device=env.device)
    return names, n, midx_t, zidx_t, as_t(Q), as_t(R), as_t(periods)


def _jacobian(f, x, u, n_out: int = None):
    """``(f(x, u), F)`` for a batch of means ``x`` ``(..., n)``: ``F`` ``(...,
    n_out, n)`` with ``F[b, k, i] = d f_k / d x_i`` at instance ``b``
    (``n_out`` outputs, default ``n``).

    ``n_out`` vector-Jacobian products with one-hot cotangents, in one
    reverse pass over an ``(n_out, ..., n)`` copy of the mean (copy ``k``
    seeds output ``k``): the step is elementwise over the batch, so each
    instance's block is exact and the dense ``(n B)²`` Jacobian is never
    formed.  Reverse mode, as ``jax.jacobian``: eager forward-mode AD runs
    its zero-tangent arithmetic through Python decompositions, which made a
    forward-mode Jacobian 12-25 times the plain step on the CPU, against
    2-3 times here."""
    n = x.shape[-1] if n_out is None else n_out
    with torch.enable_grad():
        xs = x.detach().expand((n,) + tuple(x.shape)).clone().requires_grad_(True)
        out = f(xs, u.expand((n,) + tuple(u.shape)))
        k = torch.arange(n, device=x.device)
        (rows,) = torch.autograd.grad(out[k, ..., k].sum(), xs)
    return out[0].detach(), rows.movedim(0, -2)


def _wrap_diff(d, periods):
    """Shortest circular representative of ``d`` where ``periods > 0``."""
    circular = periods > 0
    safe = torch.where(circular, periods, torch.ones_like(periods))
    return torch.where(circular, d - safe * torch.round(d / safe), d)


def _solve(A, B):
    """``A^-1 B`` over a batch; a singular ``A`` gives non-finite values
    rather than a raise, as ``jnp.linalg.solve`` does (and the check would
    wait for the device every step)."""
    return torch.linalg.solve_ex(A, B).result


def _cholesky(A):
    """The lower Cholesky factor over a batch, NaN for a matrix that is not
    positive definite (as ``jnp.linalg.cholesky``), without the raise's
    device wait."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], math.nan, L)


def _matvec(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _ekf_core(f, Q, R, midx, periods):
    """One batched EKF predict/update in normalized coordinates (shared by
    :func:`run_ekf` and ``utils/ofc.py``).

    Returns ``step(x, P, u, z) -> (x_new, P_new, innov, S, x_pred, P_pred,
    F)`` over ``x`` ``(B, n)``, ``P`` ``(B, n, n)``, ``u`` ``(B, A)`` and the
    measured columns ``z`` ``(B, m)``: Joseph-form covariance update,
    circular innovation and state correction on angle fields."""
    n = Q.shape[0]
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    m_periods = periods[midx]

    def step(x, P, u, z):
        x_pred, F = _jacobian(f, x, u)
        P_pred = F @ P @ F.mT + Q
        innov = _wrap_diff(z - x_pred[..., midx], m_periods)
        S = P_pred[..., midx[:, None], midx[None, :]] + R
        K = _solve(S.mT, P_pred[..., :, midx].mT).mT
        x_new = x_pred + _matvec(K, innov)
        x_new = torch.where(periods > 0, x_pred + _wrap_diff(x_new - x_pred, periods), x_new)
        KH = torch.zeros_like(P_pred)
        KH[..., :, midx] = K
        IKH = eye - KH
        P_new = IKH @ P_pred @ IKH.mT + K @ R @ K.mT
        P_new = 0.5 * (P_new + P_new.mT)
        return x_new, P_new, innov, S, x_pred, P_pred, F

    return step


def _initial_belief(x0, P0, n, midx, R, dtype, device):
    """The prior ``(x0 (n,), P0 (n, n))``: the given mean (default zeros) and
    covariance (``(n,)`` diagonal or full; default the sensor variance on
    measured fields, 1 elsewhere)."""
    if x0 is None:
        x0 = torch.zeros(n, dtype=dtype, device=device)
    else:
        x0 = torch.as_tensor(x0, dtype=dtype, device=device)
        if tuple(x0.shape) != (n,):
            raise ValueError(f"x0 must have shape ({n},), got {tuple(x0.shape)}")
    if P0 is None:
        p_diag = torch.ones(n, dtype=dtype, device=device)
        p_diag[midx] = torch.clamp(torch.diagonal(R), min=1e-6)
        P0 = torch.diag(p_diag)
    else:
        P0 = torch.as_tensor(P0, dtype=dtype, device=device)
        if tuple(P0.shape) == (n,):
            P0 = torch.diag(P0)
        if tuple(P0.shape) != (n, n):
            raise ValueError(f"P0 must have shape ({n},) or ({n}, {n}), got {tuple(P0.shape)}")
    return x0, P0


def _on_env(env, a):
    """``a`` (a tensor, a numpy array or nested numbers) on the environment's
    device in its dtype."""
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.array(a), dtype=env.dtype, device=env.device)


def _check_traj(env, observations, actions, what):
    """Observations and actions on the environment's device in its dtype,
    batched ``(B, T, ...)``, and whether the input was one trajectory."""
    observations, actions = (_on_env(env, a) for a in (observations, actions))
    if observations.ndim not in (2, 3) or actions.ndim != observations.ndim:
        raise ValueError(
            f"{what} expects observations (T, obs_dim) with actions (T, action_dim) "
            f"or batched (B, T, ...), got {tuple(observations.shape)} / {tuple(actions.shape)}"
        )
    if observations.shape[:-1] != actions.shape[:-1]:
        raise ValueError(
            f"observations and actions disagree on (batch,) time shape: "
            f"{tuple(observations.shape[:-1])} vs {tuple(actions.shape[:-1])}"
        )
    if actions.shape[-1] != env.action_dim:
        raise ValueError(f"actions last dim must be {env.action_dim}, got {actions.shape[-1]}")
    n_phys = len(_phys_names(env))
    if observations.shape[-1] < n_phys:
        raise ValueError(
            f"observations last dim {observations.shape[-1]} is smaller than the "
            f"physical state dim {n_phys} — pass observations as produced by the env"
        )
    single = observations.ndim == 2
    if single:
        observations, actions = observations[None], actions[None]
    return observations, actions, single


def _nll_term(innov, S):
    """The Gaussian negative log likelihood of each innovation ``(B, m)``
    under its covariance ``S`` ``(B, m, m)``: ``(B,)``.  One LU
    factorization gives both the solve and the log-determinant (``S`` is
    positive definite, so ``log |det|`` is its log-determinant): the JAX
    package's Cholesky, but MKL's batched Cholesky on the CPU waits
    milliseconds for its thread pool after other work, every filter
    step."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(S)
    alpha = torch.linalg.lu_solve(lu, pivots, innov.unsqueeze(-1)).squeeze(-1)
    logdet = torch.sum(torch.log(torch.abs(torch.diagonal(lu, dim1=-2, dim2=-1))), dim=-1)
    m = innov.shape[-1]
    return 0.5 * (torch.sum(innov * alpha, dim=-1) + logdet + m * math.log(2.0 * math.pi))


def _result(single, means, covs, nll, smoothed_means=None, smoothed_covs=None):
    """:class:`FilterResult` from per-step ``(B, ...)`` lists, time on axis 1;
    a single trajectory drops the batch axis."""
    stack = lambda xs: None if xs is None else torch.stack(xs, dim=1)
    out = [stack(means), stack(covs), nll, stack(smoothed_means), stack(smoothed_covs)]
    if single:
        out = [None if t is None else t[0] for t in out]
    return FilterResult(*out)


def run_ekf(env, observations, actions, *, measured_fields=None, process_std=None, measurement_std=None,
            x0=None, P0=None, smooth: bool = False) -> FilterResult:
    """Extended Kalman filter over the environment's own step dynamics.

    Args:
        env: an environment with scalar properties — any classic
            environment, or the PMSM drive (any solver; the filter steps the
            deterministic transition, so a noise-configured environment
            filters the disturbances it simulates).
        observations: normalized observations ``(T, obs_dim)`` or batched
            ``(B, T, obs_dim)``; row ``k`` is measured after ``actions[k]``.
            Only the ``measured_fields`` columns are read.
        actions: normalized actions ``(T, action_dim)`` (or batched).
        measured_fields: physical fields actually observed (default: every
            measurable column).  Unmeasured fields are reconstructed.
        process_std: ``{field: sigma}`` in physical units per sqrt-second
            (default: the environment's ``process_noise``).
        measurement_std: ``{field: sigma}`` in physical units (default: the
            environment's ``observation_noise``), floored at 1e-6 of the
            normalized band.
        x0: initial normalized mean ``(n_phys,)`` (default zeros).
        P0: initial covariance, ``(n_phys,)`` diagonal or full (default: the
            sensor variance on measured fields, 1 elsewhere).
        smooth: also run the Rauch–Tung–Striebel backward pass.

    Returns:
        :class:`FilterResult` (smoothed fields set iff ``smooth``), on the
        environment's device in its dtype.
    """
    obs, acts, single = _check_traj(env, observations, actions, "run_ekf")
    names, n, midx, zidx, Q, R, periods = _filter_setup(env, measured_fields, process_std, measurement_std)
    f = _make_dynamics(env, env.env_properties)
    x0, P0 = _initial_belief(x0, P0, n, midx, R, env.dtype, env.device)
    ekf = _ekf_core(f, Q, R, midx, periods)
    B, T = obs.shape[:2]
    z_all = obs[..., zidx]
    x, P = x0.expand(B, n), P0.expand(B, n, n)
    nll = torch.zeros(B, dtype=env.dtype, device=env.device)
    xs, Ps, x_preds, P_preds, Fs = [], [], [], [], []
    for t in range(T):
        x, P, innov, S, x_pred, P_pred, F = ekf(x, P, acts[:, t], z_all[:, t])
        nll = nll + _nll_term(innov, S)
        xs.append(x)
        Ps.append(P)
        if smooth:
            x_preds.append(x_pred)
            P_preds.append(P_pred)
            Fs.append(F)
    if not smooth:
        return _result(single, xs, Ps, nll)
    # smooth states 0..T-2 against their successors (T-1 is already the
    # smoothed terminal state): filtered k pairs with predicted k+1
    xs_s, Ps_s = [None] * T, [None] * T
    xs_s[-1], Ps_s[-1] = xs[-1], Ps[-1]
    for k in range(T - 2, -1, -1):
        x_f, P_f = xs[k], Ps[k]
        x_pred_next, P_pred_next, F_next = x_preds[k + 1], P_preds[k + 1], Fs[k + 1]
        C = _solve(P_pred_next.mT, (P_f @ F_next.mT).mT).mT
        dx = _wrap_diff(xs_s[k + 1] - x_pred_next, periods)
        x_s = x_f + _matvec(C, dx)
        xs_s[k] = torch.where(periods > 0, x_f + _wrap_diff(x_s - x_f, periods), x_s)
        P_s = P_f + C @ (Ps_s[k + 1] - P_pred_next) @ C.mT
        Ps_s[k] = 0.5 * (P_s + P_s.mT)
    return _result(single, xs, Ps, nll, xs_s, Ps_s)


def run_ukf(env, observations, actions, *, measured_fields=None, process_std=None, measurement_std=None,
            x0=None, P0=None, alpha: float = 0.5, beta: float = 2.0, kappa: float = 0.0) -> FilterResult:
    """Unscented Kalman filter (scaled sigma points, van der Merwe weights).

    The contract of :func:`run_ekf`, derivative-free: ``2n + 1`` forward
    steps per filter step, folded into one step of ``B (2n + 1)``
    instances.  Sigma points propagated through wrapping dynamics are
    re-referenced to the central point's image (shortest circular
    representative) before the mean and covariance are formed, so the seam
    at ±pi does not corrupt the statistics.
    """
    obs, acts, single = _check_traj(env, observations, actions, "run_ukf")
    names, n, midx, zidx, Q, R, periods = _filter_setup(env, measured_fields, process_std, measurement_std)
    f = _make_dynamics(env, env.env_properties)
    x0, P0 = _initial_belief(x0, P0, n, midx, R, env.dtype, env.device)
    dtype, device = env.dtype, env.device

    lam = alpha**2 * (n + kappa) - n
    c = n + lam
    n_pts = 2 * n + 1
    wm = torch.cat([torch.tensor([lam / c], dtype=dtype, device=device),
                    torch.full((2 * n,), 0.5 / c, dtype=dtype, device=device)])
    wc = wm.clone()
    wc[0] = wc[0] + (1.0 - alpha**2 + beta)
    m_periods = periods[midx]
    jitter = 1e-12 * torch.eye(n, dtype=dtype, device=device)

    B, T = obs.shape[:2]
    z_all = obs[..., zidx]
    x, P = x0.expand(B, n), P0.expand(B, n, n)
    nll = torch.zeros(B, dtype=dtype, device=device)
    xs, Ps = [], []
    for t in range(T):
        # jitter keeps the Cholesky factorizable when the filter has
        # collapsed a component to numerical zero variance
        chol = _cholesky(P + jitter) * math.sqrt(c)
        pts = torch.cat([x[:, None], x[:, None] + chol.mT, x[:, None] - chol.mT], dim=1)  # (B, 2n+1, n)
        u = acts[:, t, None].expand(B, n_pts, env.action_dim)
        pts_f = f(pts.reshape(B * n_pts, n), u.reshape(B * n_pts, -1)).reshape(B, n_pts, n)
        center = pts_f[:, :1]
        pts_f = torch.where(periods > 0, center + _wrap_diff(pts_f - center, periods), pts_f)
        x_pred = torch.einsum("p,bpn->bn", wm, pts_f)
        dev = pts_f - x_pred[:, None]
        weighted = (dev * wc[:, None]).mT  # (B, n, 2n+1)
        P_pred = weighted @ dev + Q
        z_pred = x_pred[:, midx]
        z_dev = pts_f[..., midx] - z_pred[:, None]
        S = (z_dev * wc[:, None]).mT @ z_dev + R
        Pxz = weighted @ z_dev
        K = _solve(S.mT, Pxz.mT).mT
        innov = _wrap_diff(z_all[:, t] - z_pred, m_periods)
        x_new = x_pred + _matvec(K, innov)
        x = torch.where(periods > 0, x_pred + _wrap_diff(x_new - x_pred, periods), x_new)
        P_new = P_pred - K @ S @ K.mT
        P = 0.5 * (P_new + P_new.mT)
        nll = nll + _nll_term(innov, S)
        xs.append(x)
        Ps.append(P)
    return _result(single, xs, Ps, nll)


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
