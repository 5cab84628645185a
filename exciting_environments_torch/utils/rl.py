"""Proximal Policy Optimization on a batched environment (counterpart of
``exciting_environments_tpu/utils/rl.py``).

One PPO iteration: a rollout of ``n_steps`` vector steps with same-step
autoreset and per-episode tracking references, generalized advantage
estimation, and ``n_epochs`` x ``n_minibatches`` clipped-surrogate updates.
The JAX package jits the iteration into one program; here it is eager
PyTorch on the environment's device, the same operations in the same order.

Semantics (as in the JAX package):

* each step is ``vmap_step`` plus the Gym reward and flags
  (``utils/episodes.py::step_with_flags``); terminated or truncated
  instances are re-drawn from ``init_state`` with fresh references in the
  same step, and the stored ``next_value`` is the critic on the PRE-reset
  successor observation, zeroed in GAE only at genuine termination;
* the policy is a tanh MLP Gaussian with a state-independent ``log_std``;
  actions are clipped to [-1, 1] before stepping, log-probabilities are
  taken at the unclipped sample;
* minibatches follow ``jax.random.permutation`` per epoch;
* the optimizer is ``optax.chain(clip_by_global_norm(max_grad_norm),
  adam(learning_rate))``, written out here (:class:`ClippedAdam`) so that
  the update is optax's formula operation for operation.

The key stream is the JAX package's, draw for draw
(:mod:`~exciting_environments_torch.ops.random`): with the same key and the
same initial parameters both packages collect the same experience up to
rounding.  ``scan_iterations=True`` keeps the JAX package's key stream of
its one-program mode (``split(key, iterations)`` in place of a chained
split); here it runs the same iterations eagerly.

A parameter tree is ``{"actor": [{"w": (m, n), "b": (n,)}, ...], "log_std":
(A,), "critic": [...]}`` of tensors, ``x @ w + b`` per layer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes

__all__ = ["ClippedAdam", "PPOConfig", "PPOResult", "cosine_decay_schedule", "evaluate_policy", "init_agent",
           "policy_mean", "train_ppo"]

METRICS = ("mean_reward", "pg_loss", "value_loss", "entropy", "approx_kl")


class PPOConfig(NamedTuple):
    """Hyperparameters of :func:`train_ppo` (CleanRL-style defaults)."""

    n_steps: int = 128
    n_epochs: int = 4
    n_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    max_episode_steps: int | None = None
    normalize_advantage: bool = True


class PPOResult(NamedTuple):
    """Outcome of :func:`train_ppo`.

    ``params``: the trained parameter tree (detached tensors).  ``metrics``:
    float64 CPU tensors of shape ``(iterations,)``: ``mean_reward``,
    ``pg_loss``, ``value_loss``, ``entropy``, ``approx_kl``.
    """

    params: object
    metrics: dict


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree in JAX's leaf order (dict keys
    sorted, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with the tensors ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))`` over a
    list of tensors: the global norm over every gradient (clip when it is
    not below ``max_grad_norm``: ``g / norm * max_norm``), then Adam's
    moments ``(1 - b) * g**k + b * m``, the bias corrections
    ``1 - b**count`` and ``m_hat / (sqrt(v_hat) + eps)``, scaled by ``-lr``
    and added.  ``max_grad_norm=None`` is plain ``optax.adam``.  ``lr`` may
    be a schedule, a callable of the number of earlier updates (0 for the
    first), as optax's ``scale_by_learning_rate`` reads it, e.g.
    :func:`cosine_decay_schedule`."""

    def __init__(self, leaves, lr, max_grad_norm: float = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.max_grad_norm, self.b1, self.b2, self.eps = lr, max_grad_norm, b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in leaves]
        self.nu = [torch.zeros_like(p) for p in leaves]

    @torch.no_grad()
    def update(self, leaves, grads) -> list:
        """The new leaves after one step on ``grads``."""
        if self.max_grad_norm is not None:
            g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            keep = g_norm < self.max_grad_norm
            grads = [torch.where(keep, g, (g / g_norm) * self.max_grad_norm) for g in grads]
        b1, b2 = self.b1, self.b2
        self.mu = [(1 - b1) * g + b1 * m for g, m in zip(grads, self.mu)]
        self.nu = [(1 - b2) * (g * g) + b2 * v for g, v in zip(grads, self.nu)]
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        out = []
        for p, m, v in zip(leaves, self.mu, self.nu):
            u = (m / c1) / (torch.sqrt(v / c2 + 0.0) + self.eps)
            out.append(p + (-lr) * u)
        return out


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """``optax.cosine_decay_schedule``: ``init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``, a
    Python number per update count."""
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return schedule


# ---------------------------------------------------------------------------
# agent: tanh-MLP Gaussian actor + MLP critic
# ---------------------------------------------------------------------------


def _mlp_init(key, sizes, dtype, device, final_scale=1.0):
    """He-normal layers ``{"w": (m, n), "b": (n,)}``, the last scaled by
    ``final_scale``; one key per layer from a chained split."""
    params = []
    for i, (m, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        key, k = prng.split(key)
        scale = math.sqrt(2.0 / m) * (final_scale if i == len(sizes) - 2 else 1.0)
        w = prng.normal(k, (m, n), torch.float64) * scale
        params.append({"w": w.to(dtype=dtype, device=device), "b": torch.zeros(n, dtype=dtype, device=device)})
    return params


def _mlp_apply(params, x):
    for layer in params[:-1]:
        x = torch.tanh(x @ layer["w"] + layer["b"])
    return x @ params[-1]["w"] + params[-1]["b"]


def init_agent(env, key, hidden=(64, 64)):
    """Initial PPO parameter tree for ``env`` in ``env.dtype`` on its device:
    ``{"actor", "log_std", "critic"}``, the actor's head down-scaled
    (0.01x), ``log_std`` zero."""
    obs_dim, act_dim = len(env.obs_description), env.action_dim
    k_a, k_c = prng.split(key)
    d = dict(dtype=env.dtype, device=env.device)
    return {
        "actor": _mlp_init(k_a, (obs_dim, *hidden, act_dim), final_scale=0.01, **d),
        "log_std": torch.zeros(act_dim, **d),
        "critic": _mlp_init(k_c, (obs_dim, *hidden, 1), final_scale=1.0, **d),
    }


def policy_mean(params, obs):
    """Deterministic (mean) action, clipped to [-1, 1]; ``obs``:
    ``(..., obs_dim)``."""
    return torch.clamp(_mlp_apply(params["actor"], obs), -1.0, 1.0)


def _log_prob(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


# ---------------------------------------------------------------------------
# environment plumbing
# ---------------------------------------------------------------------------


def _fresh(env, key):
    """A random full-batch reset with drawn references, and its observations."""
    return episodes.reset_with_references(env, key)


def _env_step(env, state, action, elapsed, max_episode_steps, key):
    """One vector step with same-step autoreset: ``(obs_next, state_next,
    obs_step, reward, term, done, elapsed)``, ``obs_step`` the PRE-reset
    successor observation."""
    obs_s, state_s, reward, term, trunc, elapsed = episodes.step_with_flags(
        env, state, action, elapsed, max_episode_steps)
    done = term | trunc
    obs_r, state_r = _fresh(env, key)
    state_n = episodes.tree_where(done, state_r, state_s)
    obs_n = torch.where(done[:, None], obs_r, obs_s)
    elapsed = torch.where(done, torch.zeros_like(elapsed), elapsed)
    return obs_n, state_n, obs_s, reward, term, done, elapsed


def _rollout(env, params, carry, key, n_steps, max_episode_steps, deterministic):
    """``n_steps`` of experience from the carry ``(state, obs, elapsed)``;
    returns the new carry and the time-major trajectory dict."""
    out = {k: [] for k in ("obs", "action", "logp", "value", "next_value", "reward", "term", "done")}
    state, obs, elapsed = carry
    for k in prng.split(key, n_steps):
        k_act, k_reset = prng.split(k)
        mean = _mlp_apply(params["actor"], obs)
        if deterministic:
            action = mean
            logp = torch.zeros(mean.shape[:-1], dtype=mean.dtype, device=mean.device)
        else:
            action = mean + torch.exp(params["log_std"]) * prng.normal(k_act, tuple(mean.shape), mean.dtype)
            logp = _log_prob(mean, params["log_std"], action)
        value = _mlp_apply(params["critic"], obs)[..., 0]
        obs_n, state, obs_step, reward, term, done, elapsed = _env_step(
            env, state, torch.clamp(action, -1.0, 1.0), elapsed, max_episode_steps, k_reset)
        row = {"obs": obs, "action": action, "logp": logp, "value": value,
               "next_value": _mlp_apply(params["critic"], obs_step)[..., 0], "reward": reward, "term": term,
               "done": done}
        for name, v in row.items():
            out[name].append(v)
        obs = obs_n
    return (state, obs, elapsed), {k: torch.stack(v) for k, v in out.items()}


def _gae(traj, gamma, lam):
    """Generalized advantage estimation over the time-major trajectory
    (a reverse loop); returns ``(advantages, returns)``.  The bootstrap is
    cut at termination, the accumulation at every episode boundary."""
    value = traj["value"]
    adv = torch.zeros_like(value[0])
    advs = [None] * value.shape[0]
    for t in reversed(range(value.shape[0])):
        nonterm = 1.0 - traj["term"][t].to(value.dtype)
        delta = traj["reward"][t] + gamma * traj["next_value"][t] * nonterm - value[t]
        adv = delta + gamma * lam * (1.0 - traj["done"][t].to(value.dtype)) * adv
        advs[t] = adv
    advs = torch.stack(advs)
    return advs, advs + value


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _ppo_loss(config, p, batch):
    """The clipped-surrogate loss of one minibatch and its
    ``(pg, v_loss, entropy, approx_kl)``."""
    mean = _mlp_apply(p["actor"], batch["obs"])
    logp = _log_prob(mean, p["log_std"], batch["action"])
    value = _mlp_apply(p["critic"], batch["obs"])[..., 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    if config.normalize_advantage:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = torch.mean(torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1.0 - config.clip_eps,
                                                                   1.0 + config.clip_eps)))
    v_loss = 0.5 * torch.mean((value - batch["ret"]) ** 2)
    entropy = torch.sum(p["log_std"] + 0.5 * math.log(2.0 * math.pi * math.e))
    approx_kl = torch.mean((ratio - 1.0) - torch.log(ratio))
    loss = pg + config.vf_coef * v_loss - config.ent_coef * entropy
    return loss, (pg, v_loss, entropy, approx_kl)


def _minibatch_updates(loss_fn, params, opt, data, perms):
    """One optimizer step per row of ``perms`` (minibatch indices) on
    ``loss_fn(params, batch) -> (loss, aux)``; returns the new parameters
    and the aux rows stacked ``(n_rows, n_aux)``."""
    leaves = tree_leaves(params)
    rows = []
    for idx in perms:
        batch = {k: v[idx] for k, v in data.items()}
        live = [leaf.detach().requires_grad_(True) for leaf in leaves]
        loss, aux = loss_fn(tree_unflatten(params, live), batch)
        grads = torch.autograd.grad(loss, live)
        leaves = opt.update(live, grads)
        rows.append(torch.stack([a.detach() for a in aux]))
    return tree_unflatten(params, [leaf.detach() for leaf in leaves]), torch.stack(rows)


def _epoch_perms(key, n_epochs, n_minibatches, N):
    """``vmap(permutation)(split(key, n_epochs))`` cut into minibatch rows."""
    return prng.permutation(prng.split(key, n_epochs), N).reshape(n_epochs * n_minibatches, N // n_minibatches)


def _metrics(rows, names=METRICS):
    rows = torch.stack(rows).double().cpu() if rows else torch.zeros((0, len(names)), dtype=torch.float64)
    return {n: rows[:, i] for i, n in enumerate(names)}


def train_ppo(env, iterations, key=None, config: PPOConfig = PPOConfig(), params=None,
              scan_iterations: bool = False) -> PPOResult:
    """Train a PPO agent on a batched environment.

    Args:
        env: a batched environment (its tracking reward needs
            ``control_state``, otherwise every reward is 0).
        iterations: PPO iterations, each ``config.n_steps * batch_size``
            environment steps.
        key: a key of :mod:`~exciting_environments_torch.ops.random`
            (default ``PRNGKey(0)`` on the environment's device).
        config: :class:`PPOConfig`.
        params: warm-start parameter tree (default :func:`init_agent`).
        scan_iterations: the key stream of the JAX package's one-program mode
            (``split(key, iterations)``).

    Returns:
        :class:`PPOResult`.
    """
    if key is None:
        key = prng.PRNGKey(0, env.device)
    k_init, k_reset, key = prng.split(key, 3)
    if params is None:
        params = init_agent(env, k_init)
    B = env.batch_size
    N = config.n_steps * B
    if N % config.n_minibatches:
        raise ValueError(f"n_steps * batch_size = {N} must be divisible by n_minibatches = {config.n_minibatches}")
    opt = ClippedAdam(tree_leaves(params), config.learning_rate, config.max_grad_norm)
    loss_fn = lambda p, batch: _ppo_loss(config, p, batch)

    def train_iteration(params, carry, key):
        k_roll, k_perm = prng.split(key)
        with torch.no_grad():
            carry, traj = _rollout(env, params, carry, k_roll, config.n_steps, config.max_episode_steps, False)
            advs, rets = _gae(traj, config.gamma, config.gae_lambda)
        data = {"obs": traj["obs"].reshape(N, -1), "action": traj["action"].reshape(N, -1),
                "logp": traj["logp"].reshape(N), "adv": advs.reshape(N), "ret": rets.reshape(N)}
        perms = _epoch_perms(k_perm, config.n_epochs, config.n_minibatches, N)
        params, aux = _minibatch_updates(loss_fn, params, opt, data, perms)
        metrics = torch.cat([torch.mean(traj["reward"])[None], aux.mean(dim=0)])
        return params, carry, metrics

    with torch.no_grad():
        obs0, state0 = _fresh(env, k_reset)
    carry = (state0, obs0, torch.zeros(B, dtype=torch.int32, device=env.device))
    keys = prng.split(key, iterations) if scan_iterations and iterations else None
    rows = []
    for it in range(iterations):
        if keys is None:
            key, k = prng.split(key)
        else:
            k = keys[it]
        params, carry, metrics = train_iteration(params, carry, k)
        rows.append(metrics)
    return PPOResult(params=params, metrics=_metrics(rows))


def evaluate_policy(env, params, n_steps, key=None, max_episode_steps=None) -> float:
    """Mean per-step reward of the deterministic (mean-action) policy over a
    fresh ``n_steps`` x ``batch_size`` rollout."""
    if key is None:
        key = prng.PRNGKey(0, env.device)
    k_reset, k_roll = prng.split(key)
    with torch.no_grad():
        obs0, state0 = _fresh(env, k_reset)
        carry = (state0, obs0, torch.zeros(env.batch_size, dtype=torch.int32, device=env.device))
        _, traj = _rollout(env, params, carry, k_roll, n_steps, max_episode_steps, deterministic=True)
        return float(torch.mean(traj["reward"]))
