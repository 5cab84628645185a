"""Closed-loop trajectory collection (counterpart of part of
``exciting_environments_tpu/utils/collect.py``).

:func:`tile_policy_scan` is the semantic reference of a closed loop: a Python
loop of ``vmap_step`` driven by a tile-contract policy.  :class:`RolloutCollector`
collects through the closed-loop kernel (:meth:`RolloutCollector.collect_policy_fused`)
and evaluates rewards and flags on the kernel's per-step states.  The
open-loop collectors (``collect``, ``collect_fused``) and the on-device
policy loop ``collect_policy`` are not ported yet.
"""

from __future__ import annotations

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.ops.lut import bilinear_gather


def tile_policy_scan(env, state, n_steps, policy_tile, policy_params, collect_trajectory: bool,
                     policy_carry=None, sched_lut=None):
    """Closed loop over a tile-contract policy as a loop of ``vmap_step``.

    The policy gets the observation as a tuple of ``(B,)`` columns and the
    step: ``policy(obs, step[, params])`` returns a tuple of normalized
    action columns; with ``policy_carry`` the stateful contract
    ``policy(obs, step, carry[, params]) -> (actions, carry)``.  The first
    observation is the reset observation.

    A stochastic environment consumes the whole rollout's draws
    (:meth:`CoreEnvironment._noise_slabs` with stride 1, the slabs the
    closed-loop kernels stream, in both noise modes): each step advances,
    takes its process draws and its sensor draws, and carries its advanced
    key, so the policy closes the loop over the noisy measurements and the
    kernels stay draw for draw with it; in exact mode this is also a loop of
    ``vmap_step``.

    ``sched_lut`` (a :class:`~exciting_environments_torch.ops.lut.ScheduledLUT`
    on a saturated PMSM's grid) mirrors the PMSM closed loop's scheduled
    gather: its channels, gathered at the denormalized belief currents held
    in the carry leaves ``sched_lut.carry_idx``, are appended to the
    observation columns the policy sees.

    Returns ``(final_obs, final_state)``, or with ``collect_trajectory`` the
    batch-major ``(obs, actions, traj_states, final_state)`` with post-step
    observations ``(B, T, obs_dim)``, actions ``(B, T, A)`` and state leaves
    ``(B, T)``; each gains the final carry as its last element when
    ``policy_carry`` is given.
    """
    props = env.env_properties
    obs = env.generate_observation(state, props)
    has_carry = policy_carry is not None
    sched_cols = None
    if sched_lut is not None:
        if not has_carry:
            raise ValueError("sched_lut requires a stateful policy (policy_carry)")
        lut, pn = env._lut, props.physical_normalizations
        values = sched_lut.tensor(obs.dtype, obs.device)
        c0, c1 = sched_lut.carry_idx

        def sched_cols(pc):
            bi_d = (pc[c0] + 1) / 2 * (pn.i_d.max - pn.i_d.min) + pn.i_d.min
            bi_q = (pc[c1] + 1) / 2 * (pn.i_q.max - pn.i_q.min) + pn.i_q.min
            vals = bilinear_gather(values, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, bi_d, bi_q)
            return tuple(vals[c] for c in range(values.shape[0]))
    pc = tuple(policy_carry) if has_carry else ()
    if env._has_noise:
        eps_proc, eps_obs, keys_steps, _ = env._noise_slabs(env._require_noise_key(state), n_steps, 1)
    obs_t, act_t, states = [], [], []
    for t in range(n_steps):
        cols = tuple(obs[:, i] for i in range(obs.shape[1]))
        if sched_cols is not None:
            cols = cols + sched_cols(pc)
        extra = (policy_params,) if policy_params is not None else ()
        if has_carry:
            a, pc = policy_tile(cols, t, pc, *extra)
            pc = tuple(pc)
        else:
            a = policy_tile(cols, t, *extra)
        action = torch.stack(tuple(a), dim=-1)
        if env._has_noise:
            state = env._fast_noise_advance_eps(state, action, props, None if eps_proc is None else eps_proc[t])
            obs = env._fast_noise_observe_eps(state, props, None if eps_obs is None else eps_obs[t])
            state = structures.replace(state, PRNGKey=keys_steps[t])
        else:
            obs, state = env.vmap_step(state, action)
        if collect_trajectory:
            obs_t.append(obs)
            act_t.append(action)
            states.append(state)
    tail = (pc,) if has_carry else ()
    if not collect_trajectory:
        return (obs, state) + tail

    # stack every state leaf along a new time axis 1, in leaf order
    stacked = iter([torch.stack([torch.as_tensor(leaf) for leaf in group], dim=1)
                    for group in zip(*(structures.leaves(s) for s in states))])
    traj_state = structures.map_leaves(lambda _leaf: next(stacked), states[0])
    return (torch.stack(obs_t, dim=1), torch.stack(act_t, dim=1), traj_state, state) + tail


@dataclass
class TrajectoryBatch:
    """Trajectory storage, batch-major: every leaf ``(B, T, ...)``."""

    observations: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor


class RolloutCollector:
    """Collects trajectory batches from a batched environment."""

    def __init__(self, env):
        self.env = env

    def _assemble_batch(self, obs, actions, traj_state, final_state):
        """Rewards and flags on the per-step states ``(B, T)`` of a
        trajectory, then the :class:`TrajectoryBatch`."""
        env = self.env
        props = env._props_for(env.env_properties, 1)
        reward = env.generate_reward(traj_state, actions, props)
        terminated = env.generate_terminated(traj_state, reward, props)
        truncated = env.generate_truncated(traj_state, props)
        batch = TrajectoryBatch(observations=obs, actions=actions, rewards=reward,
                                terminated=terminated, truncated=truncated)
        return batch, final_state

    def collect_policy_fused(self, policy_tile, state, n_steps: int, policy_params=None, policy_carry=None):
        """Closed-loop collection with the policy inside the closed-loop
        kernel (its plain version on CPU tensors; see
        :func:`~exciting_environments_torch.ops.kernels.closed_loop.env_fused_closed_loop`
        for the policy contract).  Rewards and flags are evaluated on the
        kernel's per-step states.  Returns ``(TrajectoryBatch,
        final_state)`` with post-step observations and the policy's
        normalized actions, plus the final carry with ``policy_carry``.
        A PMSM drive runs on its own closed-loop kernel
        (:func:`~exciting_environments_torch.ops.kernels.select_closed_loop`).
        Raises when the environment is out of the kernel's scope."""
        from exciting_environments_torch.ops.kernels import select_closed_loop

        env = self.env
        kernel, extra = select_closed_loop(env)
        kwargs = dict(obs_stride=1, return_traj_states=True, policy_params=policy_params,
                      policy_carry=policy_carry)
        if kernel is None:
            # out of kernel scope: the environment's own entry point raises
            # its descriptive error
            out = env.fused_closed_loop(state, policy_tile, n_steps, **kwargs)
        else:
            out = kernel(env, state, policy_tile, n_steps, **kwargs, **extra)
        obs, actions, traj_state, final_state = out[:4]
        assembled = self._assemble_batch(obs, actions, traj_state, final_state)
        return assembled + (out[4],) if policy_carry is not None else assembled
