"""PPO with kernel-resident collection (counterpart of
``exciting_environments_tpu/utils/rl_fused.py``).

The actor runs INSIDE the closed-loop kernel as a policy: a small tanh MLP
with a linear head (``hidden=(16, 16)`` by default), plus Gaussian
exploration ``exp(log_std_j) * z`` where ``z`` is drawn by a counter-based
hash of ``(instance id, step, action dim, seed)`` — a murmur3 finalizer and
Box–Muller — and the action is clamped to ``[-1, 1]``.  The hash is integer
arithmetic, so the kernel and the plain version draw the same ``z``; the
instance id rides the policy carry and ``seed`` (a float-encoded integer
below 2**24) is streamed with the weights.  Both closed-loop kernels build
the actor in: ``csrc/closed_loop.cu`` for the classic environments and
``csrc/pmsm_closed_loop.cu`` for the PMSM drive (``csrc/policy_laws.cuh``'s
``ActorReg``/``ActorLaw``).

Here: the hash (:func:`_mix32`, :func:`_hash_normal`) on ``torch.int32``,
the MLP (:func:`_tile_mlp`), :class:`ActorPolicy` (the functors' plain
version), :func:`make_actor_tile`, :func:`init_fused_agent` and the trainer
:func:`train_ppo_fused`.

Episode semantics (as in the JAX package): episodes are exactly
``chunk_steps`` long.  Every chunk starts from a fresh full-batch reset with
fresh references and is truncated (value-bootstrapped) at its end; a
mid-chunk termination ends the advantage accumulation, zeroes its bootstrap
and masks the instance's later steps of the chunk out of the loss.  Rewards,
flags, values and log-probabilities are computed after the chunk over the
saved ``(B, T)`` slabs, and the unclipped sampled action is reconstructed
exactly from the counter-based draw, so the update sees ``utils/rl.py``'s
semantics.  ``collector="kernel"`` collects through the closed-loop kernel
(its plain version on CPU tensors; out of the kernel's scope it raises,
there is no quiet fallback), ``collector="scan"`` through the step loop
``utils/collect.py::tile_policy_scan`` with the same draws.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.ops.policies import KernelPolicy, KernelSpec
from exciting_environments_torch.utils import episodes
from exciting_environments_torch.utils.rl import (
    ClippedAdam,
    PPOResult,
    _epoch_perms,
    _gae,
    _log_prob,
    _metrics,
    _minibatch_updates,
    _mlp_apply,
    _mlp_init,
    tree_leaves,
)

__all__ = ["ActorPolicy", "FusedPPOConfig", "MAX_ACTOR_PARAMS", "init_fused_agent", "make_actor_tile",
           "train_ppo_fused"]

# murmur3 finalizer constants as signed int32 (two's complement)
_M1 = -2048144789  # 0x85ebca6b
_M2 = -1028477387  # 0xc2b2ae35
_KNUTH = -1640531535  # 0x9e3779b1
_SALT = 1013904223  # 0x3c6ef35f
_SEED_MUL = -2048144777  # 0x85ebca77

#: parameter budget of the in-kernel actor (weights, biases and log_std),
#: the JAX package's gate
MAX_ACTOR_PARAMS = 2048


class FusedPPOConfig(NamedTuple):
    chunk_steps: int = 64  # episode length == chunk length
    n_chunks: int = 1  # chunks (episode batches) per PPO iteration
    hidden: tuple = (16, 16)  # in-kernel actor sizes
    critic_hidden: tuple = (64, 64)  # host-side critic (never in-kernel)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    learning_rate: float = 3e-4
    n_epochs: int = 4
    n_minibatches: int = 8
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    normalize_advantage: bool = True


def _shr(h, n):
    """Logical right shift of an int32 tensor (``>>`` on ``torch.int32`` is
    arithmetic: mask off the copies of the sign bit)."""
    return (h >> n) & ((1 << (32 - n)) - 1)


def _mix32(h):
    """murmur3 finalizer on int32 tensors (wrap-around multiplies)."""
    h = h ^ _shr(h, 16)
    h = h * _M1
    h = h ^ _shr(h, 13)
    h = h * _M2
    h = h ^ _shr(h, 16)
    return h


def _hash_bits(idi, t, j, seed):
    """The two 24-bit integers of the draw of ``(idi, t, j, seed)``."""
    t = torch.as_tensor(t, dtype=torch.int32, device=idi.device)
    h0 = idi * _KNUTH + (t + 1) * 40503 + j * 7919 + seed * _SEED_MUL
    return _shr(_mix32(h0), 8), _shr(_mix32(h0 ^ _SALT), 8)


def _hash_normal(idi, t, j, seed, dtype):
    """One standard-normal draw per instance from the counter ``(instance id
    idi, step t, action dim j, seed)``: Box–Muller over two mixed 24-bit
    uniforms.  ``idi`` and ``seed`` are int32 tensors."""
    u1b, u2b = _hash_bits(idi, t, j, seed)
    u1 = u1b.to(dtype) * 2.0**-24 + 2.0**-25
    u2 = u2b.to(dtype) * 2.0**-24
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def _tile_mlp(actor, cols):
    """The actor MLP over a tuple of ``(B,)`` observation columns: per output
    ``b[j] + w[0][j] * h[0] + w[1][j] * h[1] + ...`` left to right, ``tanh``
    between layers, a linear head.  Weights are cast to the columns' type."""
    like = cols[0]
    h = list(cols)
    for li, layer in enumerate(actor):
        w = torch.as_tensor(layer["w"]).to(dtype=like.dtype, device=like.device)
        b = torch.as_tensor(layer["b"]).to(dtype=like.dtype, device=like.device)
        m, n = w.shape
        out = []
        for j in range(n):
            acc = b[j]
            for i in range(m):
                acc = acc + w[i, j] * h[i]
            out.append(torch.tanh(acc) if li < len(actor) - 1 else acc)
        h = out
    return h


class ActorPolicy(KernelPolicy):
    """The exploring PPO actor as a closed-loop policy:
    ``policy(obs, t, carry, params) -> (clamped actions, carry)``.

    ``params`` is ``{"actor": [{"w": (m, n), "b": (n,)}, ...], "log_std":
    (A,), "seed": float-encoded integer}``; the carry is one leaf, each
    instance's integer id (exact in float).  With ``deterministic`` the
    exploration draw is left out.
    """

    policy_id = 1
    n_carry = 1

    def __init__(self, n_action: int, deterministic: bool = False):
        super().__init__()
        self.n_action = n_action
        self.deterministic = deterministic

    def forward(self, obs, t, carry, params):
        idp = carry[0]
        idi = idp.to(torch.int32)
        seed = torch.as_tensor(params["seed"]).to(device=idp.device).to(torch.int32)
        log_std = torch.as_tensor(params["log_std"]).to(dtype=idp.dtype, device=idp.device)
        means = _tile_mlp(params["actor"], obs)
        acts = []
        for j in range(self.n_action):
            a = means[j]
            if not self.deterministic:
                z = _hash_normal(idi, t, j, seed, a.dtype)
                a = a + torch.exp(log_std[j]) * z
            acts.append(torch.clamp(a, -1.0, 1.0))
        return tuple(acts), (idp,)

    def kernel_spec(self, dtype, device, params=None) -> KernelSpec:
        if params is None:
            raise ValueError("the actor's weights come as policy_params")
        layers = params["actor"]
        widths = [int(layers[0]["w"].shape[0])] + [int(layer["w"].shape[1]) for layer in layers]
        if widths[-1] != self.n_action:
            raise ValueError(f"the actor's head has {widths[-1]} outputs for {self.n_action} actions")
        as_t = lambda x: torch.as_tensor(x).to(dtype=dtype, device=device).reshape(-1)
        parts = [as_t(p) for layer in layers for p in (layer["w"], layer["b"])]
        parts += [as_t(params["log_std"]), as_t(params["seed"])]
        flat = torch.cat(parts).contiguous()
        if flat.numel() - 1 > MAX_ACTOR_PARAMS:
            raise ValueError(f"in-kernel actor has {flat.numel() - 1} parameters (> {MAX_ACTOR_PARAMS})")
        options = {"deterministic": int(self.deterministic), "n_layers": len(layers), "widths": tuple(widths)}
        return KernelSpec(self.policy_id, widths[0], options, flat)

    def params_from_flat(self, flat, params=None):
        """The weight tree of :meth:`kernel_spec`'s flat vector, shaped as
        ``params``; the float-encoded ``seed`` gets no cotangent (it enters
        the hash as an integer)."""
        if params is None:
            raise ValueError("the actor's weights come as policy_params")
        layers, k = [], 0
        for layer in params["actor"]:
            m, n = (int(d) for d in layer["w"].shape)
            layers.append({"w": flat[k : k + m * n].reshape(m, n), "b": flat[k + m * n : k + m * n + n]})
            k += m * n + n
        n_std = torch.as_tensor(params["log_std"]).numel()
        seed_shape = torch.as_tensor(params["seed"]).shape
        return {"actor": layers, "log_std": flat[k : k + n_std], "seed": flat[k + n_std].reshape(seed_shape)}

    def extra_repr(self) -> str:
        return f"n_action={self.n_action}, deterministic={self.deterministic}"


def make_actor_tile(env, *, deterministic: bool = False):
    """The exploring actor policy for ``env`` and its initial carry, one
    ``(B,)`` leaf of instance ids in ``env.dtype`` on ``env.device``."""
    carry0 = (torch.arange(env.batch_size, dtype=env.dtype, device=env.device),)
    return ActorPolicy(env.action_dim, deterministic=deterministic), carry0


def init_fused_agent(env, key, config: FusedPPOConfig = FusedPPOConfig()):
    """Initial parameter tree: the small in-kernel actor (and ``log_std``)
    and the full-size critic, in ``utils/rl.py``'s format; raises for an
    actor above :data:`MAX_ACTOR_PARAMS` (weights, biases and ``log_std``)."""
    obs_dim, act_dim = len(env.obs_description), env.action_dim
    k_a, k_c = prng.split(key)
    d = dict(dtype=env.dtype, device=env.device)
    params = {
        "actor": _mlp_init(k_a, (obs_dim, *config.hidden, act_dim), final_scale=0.01, **d),
        "log_std": torch.zeros(act_dim, **d),
        "critic": _mlp_init(k_c, (obs_dim, *config.critic_hidden, 1), **d),
    }
    n_actor = sum(layer["w"].numel() + layer["b"].numel() for layer in params["actor"]) + act_dim
    if n_actor > MAX_ACTOR_PARAMS:
        raise ValueError(f"in-kernel actor has {n_actor} parameters (> {MAX_ACTOR_PARAMS}, the kernels' "
                         "parameter budget): shrink config.hidden or use utils.rl.train_ppo")
    return params


def _collect_chunk(env, actor_params, state, tile, carry0, chunk_steps, collector):
    """One chunk through the selected collector: ``(obs_traj, actions_traj,
    traj_state)``, batch-major ``(B, T, ...)``, post-step."""
    from exciting_environments_torch.ops.kernels import closed_loop_path
    from exciting_environments_torch.utils.collect import tile_policy_scan

    if collector == "kernel":
        if closed_loop_path(env) is None:
            raise ValueError("env out of closed-loop kernel scope: use collector='scan'")
        # a batch split runs here as one launch over its whole batch, not one per shard
        whole, _ = episodes.unwrap_sharded(env)
        obs_t, acts_t, traj_state, _final, _fc = whole.fused_closed_loop(
            state, tile, chunk_steps, obs_stride=1, policy_params=actor_params, return_traj_states=True,
            policy_carry=carry0)
    elif collector == "scan":
        obs_t, acts_t, traj_state, _final, _fc = tile_policy_scan(
            env, state, chunk_steps, tile, actor_params, True, policy_carry=carry0)
    else:
        raise ValueError(f"collector is 'kernel' or 'scan', got {collector!r}")
    return obs_t, acts_t, traj_state


def _chunk_transitions(env, params, state0, obs_t, acts_t, traj_state, seed):
    """Post-hoc PPO quantities of one chunk, time-major: rewards and flags
    from the saved states, values and log-probabilities over the ``(B, T)``
    slabs, the unclipped sampled actions reconstructed from the counter
    draw (``acts_t``, the applied clipped actions, feed only the reward), and
    the post-terminal mask."""
    B, T = obs_t.shape[:2]
    props = env.env_properties
    props1 = env._props_for(props, 1)
    obs0 = env.generate_observation(state0, props)
    obs_pre = torch.cat([obs0[:, None], obs_t[:, :-1]], dim=1)
    reward = env.generate_reward(traj_state, acts_t, props1).reshape(B, T)
    term = env.generate_terminated(traj_state, reward[..., None], props1).reshape(B, T, -1).any(dim=-1)
    # post-terminal steps (the plant continued, the episode did not): masked
    first = torch.ones((B, 1), dtype=torch.int64, device=term.device)
    alive = torch.cumprod(torch.cat([first, (~term[:, :-1]).long()], dim=1), dim=1).bool()
    term = term & alive
    done = term.clone()
    done[:, -1] = True  # the chunk's end truncates every episode
    value = _mlp_apply(params["critic"], obs_pre)[..., 0]
    next_value = _mlp_apply(params["critic"], obs_t)[..., 0]
    mean = _mlp_apply(params["actor"], obs_pre)
    idi = torch.arange(B, dtype=torch.int32, device=obs_t.device)[:, None]
    t_grid = torch.arange(T, dtype=torch.int32, device=obs_t.device)[None, :]
    seed_i = torch.as_tensor(seed).to(device=obs_t.device).to(torch.int32)
    z = torch.stack([_hash_normal(idi, t_grid, j, seed_i, obs_pre.dtype) for j in range(env.action_dim)], dim=-1)
    a_raw = mean + torch.exp(params["log_std"]) * z
    logp = _log_prob(mean, params["log_std"], a_raw)
    tm = lambda x: x.transpose(0, 1)
    return {"obs": tm(obs_pre), "action": tm(a_raw), "logp": tm(logp), "value": tm(value),
            "next_value": tm(next_value), "reward": tm(reward), "term": tm(term), "done": tm(done),
            "mask": tm(alive.to(reward.dtype))}


def _fused_loss(config, p, batch):
    """The masked clipped-surrogate loss of one minibatch and its ``(pg,
    v_loss, entropy, approx_kl)``."""
    mean = _mlp_apply(p["actor"], batch["obs"])
    logp = _log_prob(mean, p["log_std"], batch["action"])
    value = _mlp_apply(p["critic"], batch["obs"])[..., 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = batch["adv"]
    m = batch["mask"]
    w = m / (torch.sum(m) + 1e-8)
    if config.normalize_advantage:
        mu = torch.sum(adv * w)
        var = torch.sum((adv - mu) ** 2 * w)
        adv = (adv - mu) / (torch.sqrt(var) + 1e-8)
    pg = torch.sum(w * torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 1.0 - config.clip_eps,
                                                                      1.0 + config.clip_eps)))
    v_loss = 0.5 * torch.sum(w * (value - batch["ret"]) ** 2)
    entropy = torch.sum(p["log_std"] + 0.5 * math.log(2.0 * math.pi * math.e))
    approx_kl = torch.sum(w * ((ratio - 1.0) - torch.log(ratio)))
    return pg + config.vf_coef * v_loss - config.ent_coef * entropy, (pg, v_loss, entropy, approx_kl)


def train_ppo_fused(env, iterations, key=None, config: FusedPPOConfig = FusedPPOConfig(), params=None,
                    collector: str = "kernel", noise_seed: int = 0) -> PPOResult:
    """PPO with chunked collection inside the closed-loop kernel (module
    docstring).

    Args:
        env: a batched environment inside closed-loop kernel scope
            (``collector="kernel"``; on CUDA tensors the PMSM drive and the
            classic environments), or any environment (``collector="scan"``,
            the same actor and draws through ``tile_policy_scan``).
        iterations: PPO iterations, each ``n_chunks * chunk_steps *
            batch_size`` environment steps.
        key: a key of :mod:`~exciting_environments_torch.ops.random`
            (default ``PRNGKey(0)`` on the environment's device).
        config: :class:`FusedPPOConfig`.
        params: warm-start parameter tree (default :func:`init_fused_agent`).
        collector: ``"kernel"`` or ``"scan"``.
        noise_seed: offset of the counter-based exploration stream (the
            iteration and chunk indices are folded in).

    Returns:
        :class:`~exciting_environments_torch.utils.rl.PPOResult`.
    """
    if key is None:
        key = prng.PRNGKey(0, env.device)
    k_init, key = prng.split(key)
    if params is None:
        params = init_fused_agent(env, k_init, config)
    B, T = env.batch_size, config.chunk_steps
    N = config.n_chunks * T * B
    if N % config.n_minibatches:
        raise ValueError(f"n_chunks * chunk_steps * batch_size = {N} must be divisible by "
                         f"n_minibatches = {config.n_minibatches}")
    opt = ClippedAdam(tree_leaves(params), config.learning_rate, config.max_grad_norm)
    loss_fn = lambda p, batch: _fused_loss(config, p, batch)
    tile, carry0 = make_actor_tile(env)

    def train_iteration(params, key, seeds):
        k_perm, *k_chunks = prng.split(key, 1 + config.n_chunks)
        chunks = []
        with torch.no_grad():
            for c, k_c in enumerate(k_chunks):
                actor_params = {"actor": params["actor"], "log_std": params["log_std"], "seed": seeds[c]}
                _, state0 = episodes.reset_with_references(env, k_c)
                obs_t, acts_t, traj_state = _collect_chunk(env, actor_params, state0, tile, carry0, T, collector)
                chunks.append(_chunk_transitions(env, params, state0, obs_t, acts_t, traj_state, seeds[c]))
            traj = {k: torch.cat([ch[k] for ch in chunks], dim=0) for k in chunks[0]}
            advs, rets = _gae(traj, config.gamma, config.gae_lambda)
        data = {"obs": traj["obs"].reshape(N, -1), "action": traj["action"].reshape(N, -1),
                "logp": traj["logp"].reshape(N), "adv": advs.reshape(N), "ret": rets.reshape(N),
                "mask": traj["mask"].reshape(N)}
        perms = _epoch_perms(k_perm, config.n_epochs, config.n_minibatches, N)
        params, aux = _minibatch_updates(loss_fn, params, opt, data, perms)
        mean_r = torch.sum(traj["reward"] * traj["mask"]) / torch.sum(traj["mask"])
        return params, torch.cat([mean_r[None], aux.mean(dim=0)])

    rows = []
    for it in range(iterations):
        key, k = prng.split(key)
        # float-encoded hash seeds (exact below 2**24), one per chunk, folded
        # from (experiment seed, iteration, chunk)
        seeds = torch.tensor([(noise_seed + 131 * c + 524287 * it) % (1 << 24) for c in range(config.n_chunks)],
                             dtype=env.dtype, device=env.device)
        params, metrics = train_iteration(params, k, seeds)
        rows.append(metrics)
    return PPOResult(params=params, metrics=_metrics(rows))
