"""Episode-state helpers shared by the learning stack (counterpart of
``exciting_environments_tpu/utils/episodes.py``).

An environment's ``vmap_reset`` leaves the ``reference`` fields NaN: the
tracking reward means something only once references are drawn.  These
helpers draw them from the environment's ``init_state`` distribution (the
reference's ``GymWrapper.generate_new_ref`` convention) and evaluate one
step with the Gymnasium reward and flag semantics, for ``utils/rl.py``,
``utils/rl_fused.py`` and ``utils/sac.py``.

Keys are those of :mod:`~exciting_environments_torch.ops.random`: one key is
an int64 tensor of shape ``(2,)`` on the environment's device.  A classic
environment's draws equal the JAX package's bit for bit; the PMSM's keyed
reset draws its current disc with other bits (its ``init_state``).

Not ported: ``cached_jit``/``jitted_reset`` are caches of JAX compilations,
which eager PyTorch has no counterpart of.
"""

from __future__ import annotations

import dataclasses

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as prng


def unwrap_sharded(env):
    """Split a possibly batch-split environment into ``(core_env, place)``.

    ``place`` puts a whole-batch tree on the facade's first device (identity
    for a plain environment).  The learning and planning loops run on the
    whole-batch environment there, whose batch the shards share."""
    from exciting_environments_torch.parallel.mesh import ShardedEnv

    if isinstance(env, ShardedEnv):
        return env.env, env.shard
    return env, lambda tree: tree


def draw_references(env, state, key):
    """Fresh per-episode tracking references for the ``control_state``
    fields of a batched ``state``, drawn from ``init_state`` at the keys
    ``split(key, batch_size)``."""
    if not env.control_state:
        return state
    keys = prng.split(key, env.batch_size)
    init = env.init_state(env.env_properties, keys, batch_shape=(env.batch_size,))
    with structures.copy_and_mutate(state, validate=False) as new:
        for name in env.control_state:
            setattr(new.reference, name, getattr(init.physical_state, name))
    return new


def step_with_flags(env, state, action, elapsed=None, max_episode_steps=None):
    """One ``vmap_step`` plus the Gym-contract reward and flags: the reward on
    the post-step state under the taken normalized action, ``any()`` over
    the per-component terminated and truncated flags, and the optional
    episode time limit.

    Returns ``(obs, state, reward, terminated, truncated, elapsed)`` with
    ``reward`` and the flags of shape ``(batch_size,)`` and ``elapsed``
    incremented (``None`` if not passed)."""
    B = env.batch_size
    props = env.env_properties
    obs, state_s = env.vmap_step(state, action)
    reward = env.generate_reward(state_s, action, props)
    term = env.generate_terminated(state_s, reward, props).reshape(B, -1).any(dim=1)
    trunc = env.generate_truncated(state_s, props).reshape(B, -1).any(dim=1)
    if elapsed is not None:
        elapsed = elapsed + 1
        if max_episode_steps is not None:
            trunc = trunc | (elapsed >= max_episode_steps)
    return obs, state_s, reward.reshape(B), term, trunc, elapsed


def reset_with_references(env, key):
    """A random full-batch reset with drawn tracking references, and its
    observations: ``(obs, state)``."""
    k_env, k_ref = prng.split(key)
    _, state = env.vmap_reset(prng.split(k_env, env.batch_size))
    state = draw_references(env, state, k_ref)
    return env.generate_observation(state, env.env_properties), state


def tree_where(mask, tree_a, tree_b):
    """``torch.where(mask, a, b)`` leaf by leaf over two states of one
    structure, ``mask`` of shape ``(B,)`` broadcast over each leaf's trailing
    axes (Python-scalar leaves become ``(B,)`` tensors, as JAX's vmapped
    select makes them)."""
    if tree_a is None:
        return None
    if structures.is_dataclass(tree_a):
        new = object.__new__(type(tree_a))
        for f in dataclasses.fields(tree_a):
            object.__setattr__(new, f.name, tree_where(mask, getattr(tree_a, f.name), getattr(tree_b, f.name)))
        return new
    if isinstance(tree_a, (tuple, list)):
        return type(tree_a)(tree_where(mask, a, b) for a, b in zip(tree_a, tree_b))
    a = torch.as_tensor(tree_a, device=mask.device)
    b = torch.as_tensor(tree_b, device=mask.device)
    m = mask.reshape(mask.shape + (1,) * (max(a.ndim, b.ndim) - 1))
    return torch.where(m, a, b)


def _autoreset_step(env, state, autoreset, any_reset: bool, elapsed, action, key, max_episode_steps=None):
    """One vector step with Gymnasium's NEXT_STEP autoreset, on the device.

    The stepped branch is :func:`step_with_flags`; an instance whose
    ``autoreset`` flag is set (it ended on the previous step) instead takes a
    fresh reset with drawn references (:func:`reset_with_references` at
    ``key``), reward 0, cleared flags and a zeroed episode counter.  The
    caller passes ``any_reset``, ``autoreset.any()`` read from the host copy
    of the previous step's flags, so that the reset draw runs only when some
    instance needs it and no step waits on the device.

    Returns ``(obs, reward, terminated, truncated, state, autoreset,
    elapsed)``, the new ``autoreset`` being ``terminated | truncated``."""
    obs, state, reward, term, trunc, elapsed = step_with_flags(env, state, action, elapsed, max_episode_steps)
    if any_reset:
        obs_r, state_r = reset_with_references(env, key)
        state = tree_where(autoreset, state_r, state)
        obs = torch.where(autoreset[:, None], obs_r, obs)
        reward = torch.where(autoreset, torch.zeros((), dtype=reward.dtype, device=reward.device), reward)
        term = term & ~autoreset
        trunc = trunc & ~autoreset
        elapsed = torch.where(autoreset, torch.zeros_like(elapsed), elapsed)
    return obs, reward, term, trunc, state, term | trunc, elapsed
