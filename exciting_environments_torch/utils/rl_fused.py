"""The in-kernel PPO actor (counterpart of the actor half of
``exciting_environments_tpu/utils/rl_fused.py``).

The actor runs INSIDE the closed-loop kernel as a policy: a small tanh MLP
with a linear head (``hidden=(16, 16)`` by default), plus Gaussian
exploration ``exp(log_std_j) * z`` where ``z`` is drawn by a counter-based
hash of ``(instance id, step, action dim, seed)`` — a murmur3 finalizer and
Box–Muller — and the action is clamped to ``[-1, 1]``.  The hash is integer
arithmetic, so the kernel and the plain version draw the same ``z``; the
instance id rides the policy carry and ``seed`` (a float-encoded integer
below 2**24) is streamed with the weights.

Here: the hash (:func:`_mix32`, :func:`_hash_normal`) on ``torch.int32``,
the MLP (:func:`_tile_mlp`), :class:`ActorPolicy` (the kernel's
``ActorLaw`` functor's plain version) and :func:`make_actor_tile`.  The PPO
trainer (``train_ppo_fused``) and ``init_fused_agent`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from exciting_environments_torch.ops.policies import KernelPolicy, KernelSpec

__all__ = ["ActorPolicy", "FusedPPOConfig", "MAX_ACTOR_PARAMS", "make_actor_tile"]

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
