"""Soft Actor-Critic on a batched environment (counterpart of
``exciting_environments_tpu/utils/sac.py``; the off-policy companion of
``utils/rl.py``).

A fixed-capacity ring buffer of device tensors holds the transitions.  One
iteration collects ``n_steps`` vector steps with same-step autoreset (the
first ``learning_starts`` transitions with uniform random actions, gated
per step), writes them at the ring's pointer, and, once ``learning_starts``
transitions are stored, runs ``updates_per_iteration`` gradient updates on
minibatches drawn with ``randint``: twin-Q targets from the Polyak-tracked
critics, the squashed-Gaussian actor, the temperature ``alpha`` driven to
``target_entropy`` (default ``-action_dim``).  The JAX package jits the
iteration into one program; here it runs eagerly on the environment's
device, the same operations in the same order and with the same keys
(:mod:`~exciting_environments_torch.ops.random`; the replay indices are the
64-bit ``randint`` draws of JAX under ``jax_enable_x64``).

Agent: a tanh-squashed Gaussian actor (one MLP with ``2 * action_dim``
outputs: mean and log-std clipped to [-5, 2]), with the ``log(1 -
tanh(u)**2)`` correction in its stable form ``2 (log 2 - u - softplus(-2
u))``; ``softplus`` is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` computes
it (``torch.nn.functional.softplus`` returns ``x`` itself above its
threshold of 20).  Each trainable group (``actor``, ``q1``, ``q2``,
``log_alpha``) has its own ``optax.adam`` (``utils/rl.py::ClippedAdam``
without the clip).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes
from exciting_environments_torch.utils.rl import (
    ClippedAdam,
    _env_step,
    _log_prob,
    _metrics,
    _mlp_apply,
    _mlp_init,
    tree_leaves,
    tree_unflatten,
)

__all__ = ["SACConfig", "SACResult", "evaluate_sac", "init_sac_agent", "sac_policy_mean", "train_sac"]

METRICS = ("mean_reward", "q_loss", "actor_loss", "alpha", "entropy")
_LOG_STD_MIN, _LOG_STD_MAX = -5.0, 2.0


class SACConfig(NamedTuple):
    """Hyperparameters of :func:`train_sac`.

    Each iteration collects ``n_steps x batch_size`` transitions and runs
    ``updates_per_iteration`` updates on minibatches of
    ``update_batch_size``.  ``buffer_capacity`` is a multiple of ``n_steps *
    batch_size``.  The first ``learning_starts`` transitions are collected
    with uniform random actions, and updates begin once they are stored.
    """

    n_steps: int = 8
    updates_per_iteration: int = 8
    update_batch_size: int = 1024
    buffer_capacity: int = 2**17
    gamma: float = 0.99
    polyak: float = 0.995
    learning_rate: float = 3e-4
    target_entropy: float | None = None
    learning_starts: int = 4096
    max_episode_steps: int | None = None


class SACResult(NamedTuple):
    """Outcome of :func:`train_sac`.

    ``params``: the trained tree (``actor``, ``q1``, ``q2``, the targets,
    ``log_alpha``).  ``metrics``: float64 CPU tensors ``(iterations,)``:
    ``mean_reward``, ``q_loss``, ``actor_loss``, ``alpha``, ``entropy``.
    """

    params: object
    metrics: dict


def init_sac_agent(env, key, hidden=(128, 128)):
    """Initial SAC parameter tree in ``env.dtype`` on its device: the actor
    (``2 * action_dim`` outputs, head down-scaled 0.01x), twin Q critics
    over ``(obs, action)``, their targets (copies) and ``log_alpha`` 0."""
    obs_dim, act_dim = len(env.obs_description), env.action_dim
    k_a, k_1, k_2 = prng.split(key, 3)
    d = dict(dtype=env.dtype, device=env.device)
    q_sizes = (obs_dim + act_dim, *hidden, 1)
    q1, q2 = _mlp_init(k_1, q_sizes, **d), _mlp_init(k_2, q_sizes, **d)
    copy = lambda q: [{k: v.clone() for k, v in layer.items()} for layer in q]
    return {
        "actor": _mlp_init(k_a, (obs_dim, *hidden, 2 * act_dim), final_scale=0.01, **d),
        "q1": q1,
        "q2": q2,
        "q1_target": copy(q1),
        "q2_target": copy(q2),
        "log_alpha": torch.zeros((), **d),
    }


def _actor_dist(params, obs):
    mean, log_std = torch.chunk(_mlp_apply(params["actor"], obs), 2, dim=-1)
    return mean, torch.clamp(log_std, _LOG_STD_MIN, _LOG_STD_MAX)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sample_action(params, obs, key):
    """Reparameterized tanh-Gaussian sample and its log-probability."""
    mean, log_std = _actor_dist(params, obs)
    u = mean + torch.exp(log_std) * prng.normal(key, tuple(mean.shape), mean.dtype)
    logp = _log_prob(mean, log_std, u) - torch.sum(2.0 * (math.log(2.0) - u - _softplus(-2.0 * u)), dim=-1)
    return torch.tanh(u), logp


def sac_policy_mean(params, obs):
    """Deterministic action (tanh of the mean) of a SAC agent."""
    mean, _ = _actor_dist(params, obs)
    return torch.tanh(mean)


def _q(params_q, obs, act):
    return _mlp_apply(params_q, torch.cat([obs, act], dim=-1))[..., 0]


def _update(config, target_entropy, params, opts, buffer, size, key):
    """One gradient update on a replay minibatch: the twin critics, the
    actor, the temperature, then the Polyak targets.  Returns the new tree
    and ``(q_loss, actor_loss, alpha, entropy)``."""
    k_idx, k_next, k_pi = prng.split(key, 3)
    idx = prng.randint(k_idx, (config.update_batch_size,), 0, size)
    batch = {k: v[idx] for k, v in buffer.items()}
    with torch.no_grad():
        a_next, logp_next = _sample_action(params, batch["next_obs"], k_next)
        q_next = torch.minimum(_q(params["q1_target"], batch["next_obs"], a_next),
                               _q(params["q2_target"], batch["next_obs"], a_next))
        alpha = torch.exp(params["log_alpha"])
        nonterm = 1.0 - batch["term"].to(q_next.dtype)
        y = batch["reward"] + config.gamma * nonterm * (q_next - alpha * logp_next)

    live = lambda name: [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params[name])]
    q1_l, q2_l = live("q1"), live("q2")
    q1, q2 = tree_unflatten(params["q1"], q1_l), tree_unflatten(params["q2"], q2_l)
    l1 = torch.mean((_q(q1, batch["obs"], batch["action"]) - y) ** 2)
    l2 = torch.mean((_q(q2, batch["obs"], batch["action"]) - y) ** 2)
    q_loss = l1 + l2
    g_q = torch.autograd.grad(q_loss, q1_l + q2_l)
    g1, g2 = g_q[: len(q1_l)], g_q[len(q1_l):]

    actor_l = live("actor")
    a, logp_pi = _sample_action(dict(params, actor=tree_unflatten(params["actor"], actor_l)), batch["obs"], k_pi)
    q_min = torch.minimum(_q(params["q1"], batch["obs"], a), _q(params["q2"], batch["obs"], a))
    actor_loss = torch.mean(alpha * logp_pi - q_min)
    g_actor = torch.autograd.grad(actor_loss, actor_l)
    logp_pi = logp_pi.detach()

    (log_alpha,) = live("log_alpha")
    alpha_loss = -torch.mean(torch.exp(log_alpha) * (logp_pi + target_entropy))
    g_alpha = torch.autograd.grad(alpha_loss, [log_alpha])

    new = dict(params)
    for name, grads in (("q1", g1), ("q2", g2), ("actor", g_actor), ("log_alpha", g_alpha)):
        new[name] = tree_unflatten(params[name], opts[name].update(tree_leaves(params[name]), list(grads)))
    with torch.no_grad():
        for q in ("q1", "q2"):
            new[f"{q}_target"] = tree_unflatten(params[f"{q}_target"], [
                config.polyak * t + (1.0 - config.polyak) * s
                for t, s in zip(tree_leaves(params[f"{q}_target"]), tree_leaves(new[q]))])
        metrics = torch.stack([q_loss.detach(), actor_loss.detach(), torch.exp(new["log_alpha"]),
                               -torch.mean(logp_pi)])
    return new, metrics


def train_sac(env, iterations, key=None, config: SACConfig = SACConfig(), params=None,
              scan_iterations: bool = False) -> SACResult:
    """Train a SAC agent on a batched environment.

    Args:
        env: a batched environment (its tracking reward needs
            ``control_state``).
        iterations: training iterations, each ``config.n_steps *
            batch_size`` environment steps and, past ``learning_starts``,
            ``config.updates_per_iteration`` updates.
        key: a key of :mod:`~exciting_environments_torch.ops.random`
            (default ``PRNGKey(0)`` on the environment's device).
        config: :class:`SACConfig`.
        params: warm-start parameter tree (default :func:`init_sac_agent`).
        scan_iterations: the key stream of the JAX package's one-program mode
            (``split(key, iterations)``).

    Returns:
        :class:`SACResult`.
    """
    env, _ = episodes.unwrap_sharded(env)
    if key is None:
        key = prng.PRNGKey(0, env.device)
    k_init, k_reset, key = prng.split(key, 3)
    if params is None:
        params = init_sac_agent(env, k_init)
    B, A = env.batch_size, env.action_dim
    obs_dim = len(env.obs_description)
    chunk = config.n_steps * B
    C = config.buffer_capacity
    if C % chunk:
        raise ValueError(f"buffer_capacity = {C} must be a multiple of n_steps * batch_size = {chunk} "
                         "(ring insertion in whole chunks)")
    target_entropy = -float(A) if config.target_entropy is None else float(config.target_entropy)
    d = dict(dtype=env.dtype, device=env.device)
    opts = {name: ClippedAdam(tree_leaves(params[name]), config.learning_rate)
            for name in ("actor", "q1", "q2", "log_alpha")}
    buffer = {"obs": torch.zeros((C, obs_dim), **d), "action": torch.zeros((C, A), **d),
              "reward": torch.zeros(C, **d), "next_obs": torch.zeros((C, obs_dim), **d),
              "term": torch.zeros(C, dtype=torch.bool, device=env.device)}
    with torch.no_grad():
        obs, state = episodes.reset_with_references(env, k_reset)
    elapsed = torch.zeros(B, dtype=torch.int32, device=env.device)
    ptr = total = 0

    def collect(params, state, obs, elapsed, key):
        """``n_steps`` of experience with same-step autoreset, written into
        the ring at ``ptr``."""
        rows = {k: [] for k in buffer}
        rewards = []
        for i, k in enumerate(prng.split(key, config.n_steps)):
            k_act, k_rand, k_reset = prng.split(k, 3)
            # the per-step warm-up gate: total + i * B transitions were stored
            # before this step
            if total + i * B < config.learning_starts:
                action = prng.uniform(k_rand, (B, A), env.dtype, -1.0, 1.0)
            else:
                action, _ = _sample_action(params, obs, k_act)
            obs_n, state, obs_step, reward, term, _done, elapsed = _env_step(
                env, state, action, elapsed, config.max_episode_steps, k_reset)
            for name, v in (("obs", obs), ("action", action), ("reward", reward), ("next_obs", obs_step),
                            ("term", term)):
                rows[name].append(v)
            rewards.append(reward)
            obs = obs_n
        for name, v in rows.items():
            buffer[name][ptr : ptr + chunk] = torch.stack(v).reshape((chunk,) + tuple(buffer[name].shape[1:]))
        return state, obs, elapsed, torch.mean(torch.stack(rewards))

    keys = prng.split(key, iterations) if scan_iterations and iterations else None
    rows = []
    for it in range(iterations):
        if keys is None:
            key, k = prng.split(key)
        else:
            k = keys[it]
        k_collect, k_update = prng.split(k)
        with torch.no_grad():
            state, obs, elapsed, mean_reward = collect(params, state, obs, elapsed, k_collect)
        ptr, total = (ptr + chunk) % C, total + chunk
        if total >= config.learning_starts:
            ms = []
            for ku in prng.split(k_update, config.updates_per_iteration):
                params, m = _update(config, target_entropy, params, opts, buffer, min(total, C), ku)
                ms.append(m)
            upd = torch.stack(ms).mean(dim=0)
        else:
            # warm-up: the update metrics are 0, alpha its true value
            zero = torch.zeros((), **d)
            upd = torch.stack([zero, zero, torch.exp(params["log_alpha"]).to(env.dtype), zero])
        rows.append(torch.cat([mean_reward[None], upd]))
    return SACResult(params=params, metrics=_metrics(rows, METRICS))


def evaluate_sac(env, params, n_steps, key=None, max_episode_steps=None) -> float:
    """Mean per-step reward of the deterministic (tanh-mean) policy over a
    fresh ``n_steps`` x ``batch_size`` rollout."""
    env, _ = episodes.unwrap_sharded(env)
    if key is None:
        key = prng.PRNGKey(0, env.device)
    k_reset, k_roll = prng.split(key)
    with torch.no_grad():
        obs, state = episodes.reset_with_references(env, k_reset)
        elapsed = torch.zeros(env.batch_size, dtype=torch.int32, device=env.device)
        rewards = []
        for k in prng.split(k_roll, n_steps):
            obs, state, _, reward, _, _, elapsed = _env_step(env, state, sac_policy_mean(params, obs), elapsed,
                                                            max_episode_steps, k)
            rewards.append(reward)
        return float(torch.mean(torch.stack(rewards)))
