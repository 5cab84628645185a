"""Model-predictive control: MPPI and a gradient planner (counterpart of
``exciting_environments_tpu/utils/mpc.py``).

An MPPI update evaluates ``n_samples`` candidate action sequences of length
``horizon`` for every one of the environment's ``batch_size`` instances.
The sample axis folds into the batch axis of a tiled shadow environment
(:func:`_tile_env`, ``batch_size = n_samples * B``, sample-major), so one
update is one batched rollout of ``n_samples * B`` candidates, on either
backend:

* the fused backend: one launch of the stepper kernel
  (``csrc/stepper.cu``, classic environments) or the PMSM kernel
  (``csrc/pmsm_stepper.cu``) per MPPI iteration, through
  ``env_fused_rollout`` / ``pmsm_fused_rollout`` with ``strict=True``
  (their plain versions on CPU tensors); the default cost is then the
  environment's ``generate_reward`` over the saved states;
* the scan backend: one eager ``episodes.step_with_flags`` over the
  ``n_samples * B`` instances per horizon step.

Both see the same candidate draws: ``split(key, n_iterations)`` and one
``normal(key, (K, B, H, A))`` per iteration with :mod:`ops.random
<exciting_environments_torch.ops.random>`, the JAX package's draws (keys and
uniforms bit for bit, normals within ``erfinv``'s last bits).  ``fused=None``
picks the kernel for the PMSM drive only, as in the JAX package; ``True``
requires it and raises out of scope; ``False`` takes the scan.  Which
backend is faster on the card is in PERF.md.

Costs default to the negative sum of the environment's rewards along the
candidate; a ``cost_fn(obs, actions) -> (batch,)`` sees one candidate's
whole normalized observation trajectory ``(B, H, obs_dim)``, called under
``torch.func.vmap`` over the samples on both backends.  Candidates are
clipped to the normalized ``[-1, 1]`` band before evaluation; optional
exponential smoothing colors the noise along the horizon with its marginal
variance kept.

:func:`optimize_actions` refines a ``tanh``-parameterized plan with Adam
(``utils/rl.py::ClippedAdam``, optax's ``adam`` written out), the rollout
differentiated by autograd through the eager loop.

A :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv` plans on
the fused backend shard by shard (:func:`_shard_mapped`: each shard's
kernel launch over its own candidates, its draws from the key folded with
the shard index, as the JAX package's ``shard_map`` body folds in the axis
index); on the scan backend, and in :func:`optimize_actions`, it plans as
its whole batch on the facade's first device (``episodes.unwrap_sharded``).
No ``interpret`` flag: on CPU tensors the fused entry points run their plain
versions.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, NamedTuple

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes


class MPPIConfig(NamedTuple):
    """Hyperparameters of the MPPI planner.

    ``horizon``: planning horizon in control steps.  ``n_samples``: candidate
    sequences per instance.  ``temperature``: softmax temperature over the
    candidate costs (lower = greedier).  ``noise_sigma``: exploration noise
    scale in normalized action units (scalar or ``(action_dim,)``).
    ``n_iterations``: refinement iterations per plan.  ``smoothing``:
    exponential noise smoothing in ``[0, 1)`` (0 = white noise).
    """

    horizon: int = 24
    n_samples: int = 256
    temperature: float = 0.05
    noise_sigma: float = 0.3
    n_iterations: int = 1
    smoothing: float = 0.0


class MPCResult(NamedTuple):
    """Outcome of :func:`run_mppi`: ``observations`` ``(B, n_steps,
    obs_dim)`` after each applied action, the applied ``actions`` ``(B,
    n_steps, action_dim)``, their ``rewards`` ``(B, n_steps)``, the
    ``final_state`` and the final shifted ``plan`` ``(B, horizon,
    action_dim)``."""

    observations: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    final_state: object
    plan: torch.Tensor


class PlanResult(NamedTuple):
    """Outcome of :func:`optimize_actions`: the optimized normalized plan
    ``(B, horizon, action_dim)`` and the mean cost curve ``(iterations +
    1,)`` (entry 0 = the initial plan)."""

    actions: torch.Tensor
    costs: torch.Tensor


def _check_cost_setup(env, cost_fn, state=None):
    if cost_fn is None and not env.control_state:
        raise ValueError(
            "the default planning cost is the negative sum of the env's "
            "tracking rewards, which are identically zero without "
            "control_state — construct the env with control_state=[...] "
            "or pass an explicit cost_fn(obs, actions)"
        )
    # a bare vmap_reset leaves the references NaN, and the tracking reward of
    # a NaN reference is NaN for every candidate
    if cost_fn is None and state is not None:
        for name in env.control_state:
            leaf = getattr(state.reference, name, None)
            if leaf is not None and bool(torch.isnan(torch.as_tensor(leaf)).any()):
                raise ValueError(
                    f"state.reference.{name} contains NaN — the default "
                    "planning cost tracks references, which vmap_reset does "
                    "not draw; populate them first (e.g. "
                    "utils.episodes.reset_with_references, or set them "
                    "explicitly) or pass cost_fn"
                )


def _rollout(env, state, actions):
    """Open-loop rollout of normalized ``actions`` ``(B, horizon,
    action_dim)`` by ``episodes.step_with_flags``: batch-major ``(obs
    (B, horizon, obs_dim), rewards (B, horizon))`` and the final state."""
    obs, rew = [], []
    for t in range(actions.shape[1]):
        o, state, r, _, _, _ = episodes.step_with_flags(env, state, actions[:, t])
        obs.append(o)
        rew.append(r)
    return torch.stack(obs, dim=1), torch.stack(rew, dim=1), state


def _horizon_sum(rew):
    """The sum of ``rew`` ``(N, H)`` over the horizon, step after step: one
    order whatever the tensor's layout (the kernels' saved states are
    time-major views), so both backends' costs agree bit for bit."""
    total = rew[:, 0]
    for t in range(1, rew.shape[1]):
        total = total + rew[:, t]
    return total


def _trajectory_cost(env, state, actions, cost_fn):
    """Total planning cost of one plan per instance, ``(B,)``."""
    obs, rew, _ = _rollout(env, state, actions)
    if cost_fn is None:
        return -_horizon_sum(rew)
    return cost_fn(obs, actions)


# ---------------------------------------------------------------------------
# the sample axis folded into the batch
# ---------------------------------------------------------------------------


def _tile_env(env, k):
    """A shallow copy of ``env`` with ``batch_size = k * B``: each per-batch
    ``(B,)`` property leaf tiled sample-major (index ``s * B + b``, as
    ``jnp.tile``).  The magnetics table and the noise configuration do not
    depend on the batch and are shared."""
    B = env.batch_size
    tile = lambda leaf: leaf.repeat(k) if isinstance(leaf, torch.Tensor) and leaf.shape[:1] == (B,) else leaf
    shadow = copy.copy(env)
    shadow.batch_size = k * B
    shadow.env_properties = structures.map_leaves(tile, env.env_properties)
    return shadow


def _tile_state(state, k):
    """Every tensor leaf of a batched state repeated ``k`` times along its
    batch axis, sample-major (keys included)."""
    return structures.map_leaves(
        lambda leaf: leaf.repeat((k,) + (1,) * (leaf.ndim - 1))
        if isinstance(leaf, torch.Tensor) and leaf.ndim >= 1 else leaf,
        state,
    )


def planning_path(env, config: MPPIConfig = MPPIConfig()) -> str:
    """Which backend can evaluate ``env``'s candidates: ``"pmsm_fused"`` /
    ``"fused"`` (one kernel launch over the folded ``n_samples x batch``
    axis) or ``"scan"``.  The kernels' scope alone decides
    (:func:`~exciting_environments_torch.ops.kernels.rollout_path` of the
    tiled shadow): the port has no batch-tiling rule, and on CPU tensors the
    fused entry points run their plain versions.

    For a :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv` the
    question is asked of a shard's shadow; a fleet with per-batch
    properties plans through the scan (the per-shard candidate sweep tiles
    no property slices, as in the JAX package)."""
    from exciting_environments_torch.ops.kernels import rollout_path

    if _is_sharded(env):
        if any(isinstance(leaf, torch.Tensor) and leaf.ndim > 0
               for leaf in structures.leaves(env.env.env_properties)):
            return "scan"
        env = env._local_shadow()
    return rollout_path(_tile_env(env, config.n_samples))


def _is_sharded(env):
    from exciting_environments_torch.parallel.mesh import ShardedEnv

    return isinstance(env, ShardedEnv)


def _shard_mapped(senv, core_fn, state, plan, key, *args):
    """``core_fn(shadow, state, plan, key, *args)`` on every shard of a
    :class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`, each with
    its rows and the key folded with its index (so the shards draw
    decorrelated noise, and a split plan differs from the unsplit one by
    construction); the outputs joined on the first device."""
    from exciting_environments_torch.parallel.mesh import _concat

    outs = [
        core_fn(shadow, senv._split(state, i), senv._split(plan, i), prng.fold_in(key.to(shadow.device), i), *args)
        for i, shadow in enumerate(senv._local_shadows())
    ]
    return _concat(outs, senv.mesh.devices[0])


def _resolve_fused(env, config, fused):
    """The backend of :func:`mppi_plan` / :func:`run_mppi`: ``fused=None``
    takes the kernel for the PMSM drive only, ``True`` requires the kernel
    (a raise out of scope), ``False`` the scan."""
    if fused is False:
        return False
    path = planning_path(env, config)
    if path == "scan":
        if fused:
            raise ValueError(
                "fused=True but the fused kernels do not cover this planning "
                "configuration (planning_path() == 'scan': per-batch deadtime, "
                "an action constraint the kernels do not compute, state layout, "
                "or solver family)"
            )
        return False
    return True if fused else path == "pmsm_fused"


def _candidate_costs(env, state, cand, cost_fn, use_fused):
    """The costs ``(K, B)`` of candidates ``cand`` ``(K, B, H, A)``: one
    rollout of the ``K * B`` tiled instances, through the kernel or the eager
    step loop."""
    from exciting_environments_torch.ops.kernels import traj_rollout

    K, B, H, A = cand.shape
    big = _tile_env(env, K)
    state_big = _tile_state(state, K)
    cand_flat = cand.reshape(K * B, H, A)
    if use_fused:
        obs, traj_state, _ = traj_rollout(big)(big, state_big, cand_flat, obs_stride=1, return_traj_states=True,
                                               strict=True)
        if cost_fn is None:
            reward = big.generate_reward(traj_state, cand_flat, big._props_for(big.env_properties, 1))
            return -_horizon_sum(reward.reshape(K * B, H)).reshape(K, B)
    else:
        obs, rew, _ = _rollout(big, state_big, cand_flat)
        if cost_fn is None:
            return -_horizon_sum(rew).reshape(K, B)
    # one (B, H, ...) call per candidate on both backends
    return torch.func.vmap(cost_fn)(obs.reshape((K, B) + tuple(obs.shape[1:])), cand)


def _smooth_noise(eps, beta):
    """Exponentially smooth noise along the horizon axis (``-2``), keeping
    the marginal variance: ``e_t = beta e_{t-1} + sqrt(1 - beta^2) n_t``."""
    if beta == 0.0:
        return eps
    scale = math.sqrt(1.0 - beta**2)
    out = [eps[..., 0, :]]
    for t in range(1, eps.shape[-2]):
        out.append(beta * out[-1] + scale * eps[..., t, :])
    return torch.stack(out, dim=-2)


def _validate_plan(env, config, plan, cost_fn, state):
    _check_cost_setup(env, cost_fn, state)
    B, H, A = env.batch_size, config.horizon, env.action_dim
    if tuple(plan.shape) != (B, H, A):
        raise ValueError(
            f"plan must have shape (batch_size, horizon, action_dim) = "
            f"{(B, H, A)}, but {tuple(plan.shape)} is given"
        )


def _plan_core(env, state, plan, key, config, cost_fn, use_fused):
    """The MPPI update of ``plan``, no validation: per iteration the draws,
    the candidates' costs, the softmax weights and the weighted mean."""
    B, H, A = env.batch_size, config.horizon, env.action_dim
    sigma = torch.as_tensor(config.noise_sigma, dtype=plan.dtype, device=plan.device).broadcast_to((A,))
    for k in prng.split(key, config.n_iterations):
        eps = prng.normal(k, (config.n_samples, B, H, A), plan.dtype)
        eps = _smooth_noise(eps, config.smoothing) * sigma
        cand = torch.clamp(plan[None] + eps, -1.0, 1.0)
        costs = _candidate_costs(env, state, cand, cost_fn, use_fused)
        w = torch.softmax(-costs / config.temperature, dim=0)  # (K, B)
        plan = torch.einsum("kb,kbha->bha", w, cand)
    return plan


def mppi_plan(env, state, plan, key, config: MPPIConfig = MPPIConfig(), cost_fn=None, fused: bool = None):
    """One MPPI update of the mean plan.

    Args:
        env: a batched environment.
        state: batched state to plan from.
        plan: current normalized mean plan ``(batch_size, horizon,
            action_dim)`` (``config.horizon`` must equal ``plan.shape[1]``).
        key: a key of :mod:`~exciting_environments_torch.ops.random`.
        config: :class:`MPPIConfig`.
        cost_fn: optional ``cost_fn(obs, actions) -> (batch_size,)``;
            default minus the summed rewards.
        fused: ``None`` (the kernel for the PMSM drive in scope, else the
            scan), ``True`` (the kernel; raises out of scope) or ``False``
            (the scan).  Both backends see the same draws.

    Returns:
        The updated mean plan, same shape, inside ``[-1, 1]``.
    """
    use_fused = _resolve_fused(env, config, fused)
    if _is_sharded(env) and use_fused:
        _validate_plan(env.env, config, plan, cost_fn, state)
        return _shard_mapped(env, _plan_core, state, plan, key, config, cost_fn, True)
    env, place = episodes.unwrap_sharded(env)
    state, plan = place(state), place(plan)
    _validate_plan(env, config, plan, cost_fn, state)
    return _plan_core(env, state, plan, key, config, cost_fn, use_fused)


def run_mppi(env, state, n_steps: int, key=None, config: MPPIConfig = MPPIConfig(), cost_fn: Callable = None,
             plan=None, fused: bool = None) -> MPCResult:
    """Receding-horizon MPPI: each of the ``n_steps`` control steps re-plans
    with :func:`mppi_plan` (one kernel launch per iteration on the fused
    backend), applies the plan's first action through ``vmap_step`` and
    shifts the plan one slot (repeating its last entry).

    Args:
        env: a batched environment, or a ``ShardedEnv`` (on the fused
            backend the whole loop runs shard by shard).
        state: batched initial state; with the default cost its references
            must be drawn (``utils.episodes.reset_with_references``), else
            a ``ValueError``.
        n_steps: control steps.
        key: a key (default ``PRNGKey(0)`` on the environment's device).
        config: :class:`MPPIConfig`.
        cost_fn: optional trajectory cost, see :func:`mppi_plan`.
        plan: optional warm start (default zeros).
        fused: the backend, see :func:`mppi_plan`.

    Returns:
        :class:`MPCResult`.
    """
    use_fused = _resolve_fused(env, config, fused)
    sharded_fused = _is_sharded(env) and use_fused
    senv = env
    env, place = episodes.unwrap_sharded(env)
    if key is None:
        key = prng.PRNGKey(0, env.device)
    B, H, A = env.batch_size, config.horizon, env.action_dim
    if plan is None:
        plan = torch.zeros((B, H, A), dtype=env.dtype, device=env.device)
    _validate_plan(env, config, plan, cost_fn, state)
    state, plan = place(state), place(plan)
    if sharded_fused:
        # the whole receding-horizon loop runs shard by shard
        return MPCResult(*_shard_mapped(senv, _control_core, state, plan, key, config, cost_fn, True, n_steps))
    return MPCResult(*_control_core(env, state, plan, key, config, cost_fn, use_fused, n_steps))


def _control_core(env, state, plan, key, config, cost_fn, use_fused, n_steps):
    """Plan, apply the first action, shift, ``n_steps`` times; returns
    batch-major ``(obs, actions, rewards, final_state, plan)``."""
    obs, act, rew = [], [], []
    for k in prng.split(key, n_steps):
        plan = _plan_core(env, state, plan, k, config, cost_fn, use_fused)
        action = plan[:, 0]
        o, state, r, _, _, _ = episodes.step_with_flags(env, state, action)
        plan = torch.cat([plan[:, 1:], plan[:, -1:]], dim=1)
        obs.append(o)
        act.append(action)
        rew.append(r)
    return torch.stack(obs, dim=1), torch.stack(act, dim=1), torch.stack(rew, dim=1), state, plan


def optimize_actions(env, state, actions, iterations: int, learning_rate: float = 0.1, optimizer=None,
                     cost_fn: Callable = None) -> PlanResult:
    """Gradient-based open-loop trajectory optimization.

    Backpropagates the planning cost through the eager rollout into a
    ``tanh``-parameterized plan, so every iterate stays inside ``(-1, 1)``.

    Args:
        env: a batched environment.
        state: batched state to plan from.
        actions: initial normalized plan ``(batch_size, horizon,
            action_dim)`` (entries inside ``(-1, 1)`` are recovered exactly
            by the ``tanh`` warm start).
        iterations: optimizer steps.
        learning_rate: Adam's learning rate (unused with ``optimizer``).
        optimizer: optional ``optimizer([z]) -> opt``, ``opt.update(leaves,
            grads) -> leaves`` (the interface of
            :class:`~exciting_environments_torch.utils.rl.ClippedAdam`);
            default ``ClippedAdam([z], learning_rate)``, optax's ``adam``.
        cost_fn: optional trajectory cost, see :func:`mppi_plan`.

    Returns:
        :class:`PlanResult`.
    """
    from exciting_environments_torch.utils.rl import ClippedAdam

    env, place = episodes.unwrap_sharded(env)
    state, actions = place(state), place(actions)
    _check_cost_setup(env, cost_fn, state)
    B, A = env.batch_size, env.action_dim
    if actions.ndim != 3 or actions.shape[0] != B or actions.shape[2] != A:
        raise ValueError(
            f"actions must have shape (batch_size, horizon, action_dim) = "
            f"({B}, horizon, {A}), but {tuple(actions.shape)} is given"
        )
    if optimizer is None:
        optimizer = lambda leaves: ClippedAdam(leaves, learning_rate)

    def mean_cost(z):
        return torch.mean(_trajectory_cost(env, state, torch.tanh(z), cost_fn))

    z = torch.atanh(torch.clamp(actions.detach(), -1.0 + 1e-6, 1.0 - 1e-6))
    opt = optimizer([z])
    costs = []
    for _ in range(iterations):
        with torch.enable_grad():
            z_var = z.detach().requires_grad_(True)
            cost = mean_cost(z_var)
            (grad,) = torch.autograd.grad(cost, z_var)
        costs.append(cost.detach())
        (z,) = opt.update([z], [grad])
    with torch.no_grad():
        costs.append(mean_cost(z))
    return PlanResult(actions=torch.tanh(z), costs=torch.stack(costs))
