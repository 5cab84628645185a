"""Gradient-based system identification through the differentiable simulator
(counterpart of ``exciting_environments_tpu/utils/sysid.py``).

* :func:`fit_parameters` — recover physical ``StaticParams`` fields from an
  observed trajectory by multistart gradient descent with multiple
  shooting.  Every start and every segment integrates in ONE batched
  simulation: a shallow copy of the environment (as
  ``utils/mpc.py::_tile_env`` makes) whose ``batch_size`` is ``n_starts *
  n_segments`` (start-major), whose free static parameters are per-batch
  leaves, each start's candidate repeated over its segments, and whose
  start states are the segment states tiled per start.  One call to its
  ``fused_sim_ahead`` evaluates the loss: on the card one launch of the
  stepper kernel (``csrc/stepper.cu``, classic environments) or the PMSM
  kernel (``csrc/pmsm_stepper.cu``) in sim-ahead mode, its gradient to the
  parameters through the kernels' VJPs (``RolloutVJP``, ``PmsmRolloutVJP``);
  on CPU tensors the kernels' plain versions.  Out of the kernels' scope (a
  stochastic environment, a non-integral grid ratio, a PMSM with a finer
  observation grid) the same call takes ``vmap_sim_ahead`` under autograd.
* :func:`fisher_information` — the Fisher information matrix and
  Cramér–Rao bound of the parameter estimate for a given excitation:
  ``J = d(trajectory)/d(theta)`` from one reverse pass over a batch of
  ``n_obs * obs_dim`` copies of the single instance, each with its own
  per-batch parameter leaf and a one-hot cotangent on its own output
  (``estimate._jacobian``'s construction), through the same
  ``fused_sim_ahead``.  The JAX package uses ``jax.jacfwd`` (``P`` forward
  passes); CHANGES.md gives both methods' times on the CPU.
* :func:`optimize_excitation` — D/A-optimal input design: ascend ``log det
  FIM`` over the excitation.  This differentiates through the
  sensitivities, a second derivative of the simulation, and the kernels'
  backward passes are first-order only (``once_differentiable``): it runs
  the eager ``vmap_sim_ahead`` on every device, ``create_graph=True``.

All three take the reference ``sim_ahead`` semantics (ZOH actions,
observation grid decoupled from the action grid).  Optimizers are factories
``optimizer([theta]) -> opt`` with ``opt.update(leaves, grads) -> leaves``
(:class:`~exciting_environments_torch.utils.rl.ClippedAdam`'s interface),
where the JAX package takes an optax transformation.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import NamedTuple

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils.estimate import _on_env
from exciting_environments_torch.utils.mpc import _tile_state
from exciting_environments_torch.utils.rl import ClippedAdam, cosine_decay_schedule

__all__ = ["ExcitationResult", "FisherResult", "FitResult", "fisher_information", "fit_parameters",
           "optimize_excitation"]


class FitResult(NamedTuple):
    """Outcome of :func:`fit_parameters`.

    ``params``: best-fit values, ``{name: float}``.  ``final_loss``: weighted
    MSE of the best start.  ``losses``: per-iteration best-across-starts loss,
    shape ``(iterations,)``.  ``start_params``: per-start best-iterate values,
    ``{name: (n_starts,)}``.  ``start_losses``: per-start best loss,
    ``(n_starts,)``.  ``best_start``: index of the winning start.
    """

    params: dict
    final_loss: float
    losses: torch.Tensor
    start_params: dict
    start_losses: torch.Tensor
    best_start: int


class FisherResult(NamedTuple):
    """``fim``: Fisher information matrix ``(P, P)``.  ``crlb``: Cramér–Rao
    lower bound ``inv(fim)`` ``(P, P)`` (minimum achievable estimator
    covariance).  ``names``: parameter order for both."""

    fim: torch.Tensor
    crlb: torch.Tensor
    names: tuple


class ExcitationResult(NamedTuple):
    """``actions``: optimized normalized excitation ``(n_steps, action_dim)``
    in ``[-1, 1]``.  ``objectives``: per-iteration design objective
    (``log det FIM`` for the D-criterion).  ``fisher``: :class:`FisherResult`
    at the optimized excitation."""

    actions: torch.Tensor
    objectives: torch.Tensor
    fisher: FisherResult


def _param_names(env):
    return tuple(f.name for f in dataclasses.fields(env.env_properties.static_params))


def _check_free(env, names):
    valid = _param_names(env)
    unknown = [n for n in names if n not in valid]
    if unknown:
        raise ValueError(f"unknown static parameter(s) {unknown}; {type(env).__name__} has {list(valid)}")
    for field in valid:
        leaf = getattr(env.env_properties.static_params, field)
        if hasattr(leaf, "ndim") and leaf.ndim > 0:
            raise ValueError(
                f"static parameter {field!r} is per-batch (shape {tuple(leaf.shape)}); system "
                "identification needs a scalar-parameter env — construct one with scalar "
                "static_params (the fit supplies its own candidate batch)"
            )


def _resolve_grid(env, obs_stepsize, action_stepsize):
    action_stepsize = env.tau if action_stepsize is None else action_stepsize
    obs_stepsize = action_stepsize if obs_stepsize is None else obs_stepsize
    if obs_stepsize > action_stepsize:
        raise ValueError(
            f"obs_stepsize ({obs_stepsize}) must not exceed action_stepsize "
            f"({action_stepsize}) — sim_ahead samples observations on the finer grid"
        )
    ratio = action_stepsize / obs_stepsize
    if abs(ratio - round(ratio)) > 1e-9 * ratio:
        raise ValueError(
            f"action_stepsize/obs_stepsize must be an integer, got {ratio}"
        )
    return obs_stepsize, action_stepsize


def _obs_circular_periods(env):
    """Per-observation-column period in normalized units (0 = linear column).

    Wrapped-angle states live on a circle: a trajectory crossing the ±π seam
    one step earlier than the recording differs by a full revolution in
    linear MSE, which carves spurious local minima into the fit landscape.
    Columns backed by ``_angle_fields`` therefore get the circular metric
    ``d - period*round(d/period)``.  Normalization maps Δx to
    ``2Δx/(max-min)``, so a 2π physical period is ``4π/(max-min)``
    normalized.  Returns ``None`` when nothing is circular (or when the
    normalization bounds are per-batch tensors)."""
    fields = getattr(env, "_physical_field_names", None)
    angles = set(getattr(env, "_angle_fields", ()) or ())
    if not fields or not angles:
        return None
    periods = []
    for name in fields:
        if name in angles:
            norm = getattr(env.env_properties.physical_normalizations, name)
            if any(isinstance(b, torch.Tensor) and b.ndim > 0 for b in (norm.min, norm.max)):
                return None  # per-batch normalization bounds: skip circular handling
            periods.append(4.0 * math.pi / (float(norm.max) - float(norm.min)))
        else:
            periods.append(0.0)
    periods += [0.0] * len(getattr(env, "control_state", ()) or ())
    return torch.as_tensor(periods, dtype=env.dtype, device=env.device)


def _default_loss_weights(env):
    """Zero out tracked-reference observation columns.

    A default or recorded initial state carries NaN references, so reference
    columns must not enter the fit residual — they describe the
    *controller's* target, not the plant.  Physical columns keep unit
    weight."""
    n_ref = len(getattr(env, "control_state", ()) or ())
    if n_ref == 0:
        return None
    n_obs = len(env.obs_description)
    return torch.cat([torch.ones(n_obs - n_ref, dtype=env.dtype, device=env.device),
                      torch.zeros(n_ref, dtype=env.dtype, device=env.device)])


def _resolve_init_state(env, init_state, observed_obs):
    if init_state is not None:
        return init_state
    return env.generate_state_from_observation(observed_obs[0], env.env_properties)


def _resolve_free_point(env, free, relative):
    """(names, values) evaluation point from a dict / name sequence."""
    names = tuple(free.keys()) if isinstance(free, dict) else tuple(free)
    _check_free(env, names)  # before any getattr/float so errors stay friendly
    if isinstance(free, dict):
        values = [float(free[n]) for n in names]
    else:
        values = [float(getattr(env.env_properties.static_params, n)) for n in names]
    values = torch.as_tensor(values, dtype=env.dtype, device=env.device)
    if relative and not bool(torch.all(values > 0)):
        raise ValueError(
            "relative=True differentiates w.r.t. log θ and needs strictly positive "
            "parameter values; pass relative=False for sign-indefinite parameters"
        )
    return names, values


# ---------------------------------------------------------------------------
# the batched simulation: starts and segments (or sensitivity copies) folded
# into one environment's batch
# ---------------------------------------------------------------------------


def _batched_env(env, names, values):
    """A shallow copy of ``env`` whose batch is ``values``' rows: the free
    static parameters ``names`` become the per-batch leaves ``values[:, i]``
    ``(N,)``; every other property keeps its scalar."""
    shadow = copy.copy(env)
    shadow.batch_size = values.shape[0]
    sp = structures.replace(env.env_properties.static_params,
                            **{n: values[:, i] for i, n in enumerate(names)})
    shadow.env_properties = structures.replace(env.env_properties, static_params=sp)
    return shadow


def _batch_of_one(state):
    """A single-instance state as a batch of one (every tensor leaf gains a
    leading axis; Python-scalar leaves stay)."""
    return structures.map_leaves(lambda leaf: leaf.unsqueeze(0) if isinstance(leaf, torch.Tensor) else leaf, state)


def _simulate(env, names, values, states, actions, obs_stepsize, action_stepsize, eager=False):
    """Observations ``(N, n_obs, obs_dim)`` of the batched environment with
    per-batch parameters ``values`` ``(N, P)`` from ``states`` under
    ``actions`` ``(N, n_act, action_dim)``: ``fused_sim_ahead`` (the
    kernels where in scope), or ``vmap_sim_ahead`` with ``eager=True``.
    Reference columns hold the start state's reference on every row, as the
    JAX package's ``sim_ahead`` tiles it."""
    shadow = _batched_env(env, names, values)
    if eager:
        obs, _, _ = shadow.vmap_sim_ahead(states, actions, obs_stepsize, action_stepsize)
    else:
        obs, _ = shadow.fused_sim_ahead(states, actions, obs_stepsize, action_stepsize)
    n_ref = len(getattr(env, "control_state", ()) or ())
    if n_ref:
        obs = torch.cat([obs[..., :-n_ref], obs[:, :1, -n_ref:].expand(tuple(obs.shape[:-1]) + (n_ref,))], dim=-1)
    return obs


def _fit_problem(env, actions, observed_obs, free, init_state, obs_stepsize, action_stepsize, n_starts, spread,
                 loss_weights, transform, segment_length, key):
    """The multistart, multiple-shooting problem of :func:`fit_parameters`
    (arguments as there, grids resolved, tensors on the environment):
    ``(theta0 (n_starts, P), from_theta, losses)``, where ``losses(theta,
    eager=False)`` is the per-start weighted MSE ``(n_starts,)``."""
    names = tuple(free.keys())
    guess = torch.as_tensor([float(free[n]) for n in names], dtype=env.dtype, device=env.device)
    if transform == "log":
        if not bool(torch.all(guess > 0)):
            raise ValueError(
                "transform='log' needs strictly positive initial guesses; "
                "pass transform='none' for sign-indefinite parameters"
            )
        to_theta, from_theta = torch.log, torch.exp
    else:
        to_theta = from_theta = lambda x: x

    jitter = prng.normal(key, (n_starts, len(names)), env.dtype)
    jitter[0] = 0.0  # start 0 is the user's exact guess
    if transform == "log":
        theta0 = to_theta(guess)[None, :] + spread * jitter
    else:
        theta0 = guess[None, :] * (1.0 + spread * jitter)

    weights = _on_env(env, loss_weights) if loss_weights is not None else _default_loss_weights(env)

    n_act = actions.shape[0]
    sub = int(round(action_stepsize / obs_stepsize))  # observations per action step
    expected_rows = n_act * sub + 1
    if observed_obs.shape[0] != expected_rows:
        raise ValueError(
            f"observed_obs has {observed_obs.shape[0]} rows but the grid implies "
            f"{expected_rows} (n_action_steps*action_stepsize/obs_stepsize + 1)"
        )

    if segment_length is None or segment_length >= n_act:
        seg_states = _batch_of_one(_resolve_init_state(env, init_state, observed_obs))
        seg_actions = actions[None]
        seg_targets = observed_obs[None]                   # (1, n_act*sub+1, obs)
    else:
        n_seg = n_act // segment_length
        seg_actions = actions[: n_seg * segment_length].reshape(n_seg, segment_length, actions.shape[1])
        row = torch.arange(segment_length * sub + 1, device=env.device)
        starts = torch.arange(n_seg, device=env.device) * (segment_length * sub)
        seg_targets = observed_obs[starts[:, None] + row[None, :]]   # (n_seg, L*sub+1, obs)
        # seed every segment from the recorded observation at its start
        seg_states = env.generate_state_from_observation(observed_obs[starts], env.env_properties)
        if init_state is not None:
            # a user-supplied initial state is exact knowledge — segment 0
            # uses it instead of the (possibly noisy) recorded observation
            seg_states = _with_first(seg_states, init_state)
    n_seg = seg_actions.shape[0]
    states = _tile_state(seg_states, n_starts)
    acts = seg_actions.repeat(n_starts, 1, 1)
    periods = _obs_circular_periods(env)

    def losses(theta, eager=False):
        """Per-start weighted MSE ``(n_starts,)``: one batched simulation of
        every start and segment (``eager``: through ``vmap_sim_ahead``)."""
        values = from_theta(theta).repeat_interleave(n_seg, dim=0)
        sim = _simulate(env, names, values, states, acts, obs_stepsize, action_stepsize, eager=eager)
        d = sim.reshape((n_starts,) + tuple(seg_targets.shape)) - seg_targets
        if periods is not None:
            circular = periods > 0
            safe = torch.where(circular, periods, torch.ones_like(periods))
            d = torch.where(circular, d - periods * torch.round(d / safe), d)
        err = d**2
        if weights is not None:
            # where (not multiply): zero weight must mask NaN reference
            # columns, and 0 * NaN is NaN
            err = torch.where(weights == 0, torch.zeros_like(err), err * weights)
        return err.reshape(n_starts, -1).mean(dim=1)

    return theta0, from_theta, losses


def fit_parameters(
    env,
    actions,
    observed_obs,
    free: dict,
    *,
    init_state=None,
    obs_stepsize: float = None,
    action_stepsize: float = None,
    n_starts: int = 32,
    spread: float = 0.3,
    iterations: int = 300,
    optimizer=None,
    loss_weights=None,
    transform: str = "log",
    segment_length: int = 32,
    key=None,
) -> FitResult:
    """Fit physical parameters to an observed trajectory by gradient descent.

    Args:
        env: any environment with the reference ``sim_ahead`` protocol and
            scalar static parameters; its non-fitted static params are taken
            as ground truth.
        actions: normalized ZOH action sequence ``(n_action_steps, action_dim)``
            — the excitation that produced the data.
        observed_obs: recorded normalized observations ``(n_obs, obs_dim)``
            on the ``obs_stepsize`` grid (the layout ``sim_ahead`` returns).
        free: ``{param_name: initial_guess}`` for the parameters to identify;
            every other static param stays at the env's value.
        init_state: optional known-exact initial single-instance ``State``;
            it seeds the rollout (single shooting) or segment 0 (multiple
            shooting — later segments always re-seed from the recording).
            Defaults to ``generate_state_from_observation(observed_obs[0])``.
        obs_stepsize / action_stepsize: sampling grids (default ``env.tau``).
        n_starts: number of simultaneous multistart candidates (one batched
            simulation regardless of count).
        spread: multiplicative jitter of the initial guesses across starts
            (start 0 keeps the exact guess).
        iterations: optimizer steps.
        optimizer: optional factory ``optimizer([theta]) -> opt`` with
            ``opt.update(leaves, grads) -> leaves``; default Adam under a
            cosine-decayed step size, ``ClippedAdam([theta],
            cosine_decay_schedule(0.1, iterations))`` (the JAX package's
            ``optax.adam(cosine_decay_schedule(0.1, iterations))``).
        loss_weights: optional per-observation-column weights ``(obs_dim,)``;
            zero-weight columns are fully masked (NaN-safe).  Default: unit
            weight on physical columns, zero on tracked-reference columns.
        transform: ``"log"`` (default) optimizes ``log θ``; ``"none"``
            optimizes raw values.
        segment_length: multiple-shooting segment length in action steps:
            the trajectory is split into segments each re-seeded from the
            *recorded* observation at its start, all fitted jointly.
            ``None`` disables segmentation (single shooting).  A trailing
            remainder of fewer than ``segment_length`` action steps is
            dropped.
        key: key of :mod:`~exciting_environments_torch.ops.random` for the
            multistart jitter (default ``PRNGKey(0)`` on the env's device).

    Returns:
        :class:`FitResult` with per-start best-iterate tracking (the global
        best iterate across all starts and iterations wins).
    """
    names = tuple(free.keys())
    _check_free(env, names)
    if transform not in ("log", "none"):
        raise ValueError(f"transform must be 'log' or 'none', got {transform!r}")
    obs_stepsize, action_stepsize = _resolve_grid(env, obs_stepsize, action_stepsize)
    observed_obs = _on_env(env, observed_obs)
    actions = _on_env(env, actions)
    if optimizer is None:
        optimizer = lambda leaves: ClippedAdam(leaves, cosine_decay_schedule(0.1, iterations))
    if key is None:
        key = prng.PRNGKey(0, env.device)

    theta0, from_theta, losses = _fit_problem(env, actions, observed_obs, free, init_state, obs_stepsize,
                                              action_stepsize, n_starts, spread, loss_weights, transform,
                                              segment_length, key)
    theta = theta0
    opt = optimizer([theta])
    best_theta = theta0
    best_loss = torch.full((n_starts,), math.inf, dtype=env.dtype, device=env.device)
    history = []
    for _ in range(iterations):
        with torch.enable_grad():
            theta_var = theta.detach().requires_grad_(True)
            per_start = losses(theta_var)
            (grad,) = torch.autograd.grad(per_start.sum(), theta_var)
        per_start = per_start.detach()
        improved = per_start < best_loss
        best_theta = torch.where(improved[:, None], theta, best_theta)
        best_loss = torch.where(improved, per_start, best_loss)
        history.append(per_start.min())
        (theta,) = opt.update([theta], [grad])
    # the post-update final iterate may beat every recorded pre-update one
    with torch.no_grad():
        final = losses(theta)
    improved = final < best_loss
    best_theta = torch.where(improved[:, None], theta, best_theta)
    best_loss = torch.where(improved, final, best_loss)

    best_values = from_theta(best_theta)
    best = int(torch.argmin(best_loss))
    return FitResult(
        params={n: float(best_values[best, i]) for i, n in enumerate(names)},
        final_loss=float(best_loss[best]),
        losses=torch.stack(history) if history else best_loss.new_zeros((0,)),
        start_params={n: best_values[:, i] for i, n in enumerate(names)},
        start_losses=best_loss,
        best_start=best,
    )


def _with_first(batched, single):
    """``batched`` with instance 0 replaced by the single-instance state
    ``single`` (leaf by leaf; a Python-scalar leaf of ``batched`` stays)."""
    s_leaves = iter(structures.leaves(single))

    def put(b):
        s = next(s_leaves)
        if not isinstance(b, torch.Tensor):
            return b
        out = b.clone()
        out[0] = torch.as_tensor(s, dtype=b.dtype, device=b.device)
        return out

    return structures.map_leaves(put, batched)


def fisher_information(
    env,
    actions,
    free: dict | tuple | list,
    *,
    init_state=None,
    obs_stepsize: float = None,
    action_stepsize: float = None,
    noise_std: float = 1.0,
    relative: bool = True,
) -> FisherResult:
    """Fisher information of the parameter estimate under a given excitation.

    Assumes i.i.d. Gaussian observation noise of ``noise_std`` on the
    normalized observations: ``FIM = Jᵀ J / noise_std²`` where ``J =
    ∂(trajectory)/∂θ`` ``(n_obs * obs_dim, P)`` comes from one reverse pass
    over ``n_obs * obs_dim`` copies of the trajectory, each seeding its own
    output (through the kernels and their VJPs where in scope).

    Args:
        free: parameter names to include; a dict uses its values as the
            evaluation point, a tuple/list evaluates at the env's values.
        relative: differentiate w.r.t. ``log θ`` (sensitivity per *relative*
            parameter change).
        init_state: single-instance state; defaults to the env's
            deterministic initial state.

    Returns:
        :class:`FisherResult`; ``det(fim)`` is the D-optimality objective,
        ``diag(crlb)`` the per-parameter variance floor.
    """
    names, values = _resolve_free_point(env, free, relative)
    obs_stepsize, action_stepsize = _resolve_grid(env, obs_stepsize, action_stepsize)
    actions = _on_env(env, actions)
    if init_state is None:
        init_state = env.init_state(env.env_properties)

    fim = _fim(env, names, values, init_state, actions, obs_stepsize, action_stepsize, noise_std, relative)
    return FisherResult(fim=fim, crlb=torch.linalg.inv(fim), names=names)


def _n_out(env, actions, obs_stepsize, action_stepsize):
    sub = int(round(action_stepsize / obs_stepsize))
    return (actions.shape[0] * sub + 1) * len(env.obs_description)


def _fim(env, names, values, init_state, actions, obs_stepsize, action_stepsize, noise_std, relative,
         eager=False, create_graph=False):
    """``Jᵀ J / noise_std²`` with ``J`` ``(n_out, P)`` from one reverse pass
    over ``n_out = n_obs * obs_dim`` copies of the single trajectory: copy
    ``k``'s own parameter row receives output ``k``'s sensitivity."""
    n_out = _n_out(env, actions, obs_stepsize, action_stepsize)
    theta = torch.log(values) if relative else values
    states = _tile_state(_batch_of_one(init_state), n_out)
    acts = actions.expand((n_out,) + tuple(actions.shape))
    with torch.enable_grad():
        theta_c = theta.detach().expand(n_out, -1).clone().requires_grad_(True)
        vals = torch.exp(theta_c) if relative else theta_c
        obs = _simulate(env, names, vals, states, acts, obs_stepsize, action_stepsize, eager=eager)
        k = torch.arange(n_out, device=obs.device)
        # the sum's cotangent is one on every output, so a constant NaN
        # reference column contributes no sensitivity
        out = obs.reshape(n_out, n_out)[k, k]
        (jac,) = torch.autograd.grad(out.sum(), theta_c, create_graph=create_graph)
    return (jac.mT @ jac) / (noise_std**2)


def optimize_excitation(
    env,
    free: dict | tuple | list,
    n_steps: int,
    *,
    init_actions=None,
    init_state=None,
    obs_stepsize: float = None,
    action_stepsize: float = None,
    noise_std: float = 1.0,
    relative: bool = True,
    iterations: int = 100,
    optimizer=None,
    criterion: str = "d",
    key=None,
) -> ExcitationResult:
    """Design a D/A-optimal excitation signal by backprop through the simulator.

    Ascends the information the trajectory carries about the parameters with
    respect to the *input signal itself*: reverse mode over the reverse-mode
    sensitivities ``J(u)`` (``create_graph=True``), through the eager
    ``vmap_sim_ahead`` on every device, since the kernels' backward passes
    are not differentiable again.  Actions are parametrized as ``tanh(u)``
    so the optimized excitation respects the normalized band ``[-1, 1]``.

    Args:
        free: parameters the excitation should inform (dict = evaluation
            point, tuple/list = env's values).
        n_steps: excitation length in action steps.
        init_actions: optional ``(n_steps, action_dim)`` warm start in
            ``(-1, 1)``; defaults to ``0.1 * normal(key)``.
        criterion: ``"d"`` maximizes ``log det FIM``, ``"a"`` minimizes
            ``trace(CRLB)``.
        optimizer: optional factory as in :func:`fit_parameters`; default
            ``ClippedAdam([u], 0.05)`` (the JAX package's ``optax.adam(0.05)``).
        iterations / noise_std / relative / key: as in
            :func:`fit_parameters` / :func:`fisher_information`.

    Returns:
        :class:`ExcitationResult` with the optimized signal, the
        per-iteration objective trace and the final :class:`FisherResult`.
    """
    names, values = _resolve_free_point(env, free, relative)
    if criterion not in ("d", "a"):
        raise ValueError(f"criterion must be 'd' or 'a', got {criterion!r}")
    obs_stepsize, action_stepsize = _resolve_grid(env, obs_stepsize, action_stepsize)
    if init_state is None:
        init_state = env.init_state(env.env_properties)
    if optimizer is None:
        optimizer = lambda leaves: ClippedAdam(leaves, 0.05)
    if key is None:
        key = prng.PRNGKey(0, env.device)

    if init_actions is None:
        u0 = 0.1 * prng.normal(key, (n_steps, env.action_dim), env.dtype)
    else:
        init_actions = _on_env(env, init_actions)
        if tuple(init_actions.shape) != (n_steps, env.action_dim):
            raise ValueError(
                f"init_actions shape {tuple(init_actions.shape)} does not match "
                f"(n_steps, action_dim) = {(n_steps, env.action_dim)}"
            )
        u0 = torch.atanh(torch.clamp(init_actions, -1 + 1e-6, 1 - 1e-6))

    eps = 1e-9  # keeps logdet/inv finite while the signal is still uninformative

    def objective(u):
        fim = _fim(env, names, values, init_state, torch.tanh(u), obs_stepsize, action_stepsize, noise_std,
                   relative, eager=True, create_graph=True)
        fim = fim + eps * torch.eye(fim.shape[0], dtype=fim.dtype, device=fim.device)
        if criterion == "d":
            return torch.linalg.slogdet(fim)[1]
        return -torch.trace(torch.linalg.inv(fim))

    u = u0
    opt = optimizer([u])
    history = []
    for _ in range(iterations):
        with torch.enable_grad():
            u_var = u.detach().requires_grad_(True)
            value = objective(u_var)
            (grad,) = torch.autograd.grad(value, u_var)
        history.append(value.detach())
        # ascent: the optimizer descends, so feed the negated gradient
        (u,) = opt.update([u], [-grad])
    actions = torch.tanh(u)
    fim = _fim(env, names, values, init_state, actions, obs_stepsize, action_stepsize, noise_std, relative)
    return ExcitationResult(
        actions=actions,
        objectives=torch.stack(history) if history else u.new_zeros((0,)),
        fisher=FisherResult(fim=fim, crlb=torch.linalg.inv(fim), names=names),
    )
