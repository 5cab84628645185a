"""Trajectory collection for RL and system-identification datasets
(counterpart of ``exciting_environments_tpu/utils/collect.py``).

:class:`RolloutCollector` gathers a :class:`TrajectoryBatch` (post-step
observations, actions, rewards and flags, batch-major) and the final state:

* open loop, from an action slab ``(B, T, A)`` (e.g. from
  :mod:`exciting_environments_torch.ops.signals`): :meth:`~RolloutCollector.collect`,
  the eager loop of the batched step, and :meth:`~RolloutCollector.collect_fused`,
  one launch of the stepper kernel (``csrc/stepper.cu``) or of the PMSM
  kernel (``csrc/pmsm_stepper.cu``) with the per-step states saved;
* closed loop: :meth:`~RolloutCollector.collect_policy`, the eager loop of a
  ``policy(obs, key)`` (stochastic exploration), and
  :meth:`~RolloutCollector.collect_policy_fused`, the policy inside the
  closed-loop kernel.

Both fused collectors evaluate rewards and flags on the kernel's per-step
states, but for a PMSM drive in the open loop, whose kernel writes them
itself (:meth:`~RolloutCollector.collect_fused`).  :func:`tile_policy_scan`
is the semantic reference of a closed loop: a Python loop of ``vmap_step``
driven by a tile-contract policy.
"""

from __future__ import annotations

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils.profiling import annotate


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
    in the carry leaves ``sched_lut.carry_idx`` (each drive from its own
    slice of a per-drive stack), are appended to the observation columns the
    policy sees; without it, those of the schedule the policy holds
    (``policy_tile.sched_lut``), where it holds one.

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
    if sched_lut is None:
        sched_lut = getattr(policy_tile, "sched_lut", None)
    if sched_lut is not None:
        if not has_carry:
            raise ValueError("sched_lut requires a stateful policy (policy_carry)")
        lut, pn = env._lut, props.physical_normalizations
        c0, c1 = sched_lut.carry_idx

        def sched_cols(pc):
            bi_d = (pc[c0] + 1) / 2 * (pn.i_d.max - pn.i_d.min) + pn.i_d.min
            bi_q = (pc[c1] + 1) / 2 * (pn.i_q.max - pn.i_q.min) + pn.i_q.min
            return tuple(sched_lut.gather(obs.dtype, obs.device, lut, bi_d, bi_q).unbind(0))
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

    def _flags(self, state, action, props):
        """Reward, terminated and truncated of post-step states under the
        (normalized) actions that led to them."""
        env = self.env
        reward = env.generate_reward(state, action, props)
        return reward, env.generate_terminated(state, reward, props), env.generate_truncated(state, props)

    @staticmethod
    def _batch(obs, actions, flags):
        """The :class:`TrajectoryBatch` of per-step rows, stacked along time."""
        reward, terminated, truncated = (torch.stack(rows, dim=1) for rows in zip(*flags))
        return TrajectoryBatch(observations=torch.stack(obs, dim=1), actions=actions, rewards=reward,
                               terminated=terminated, truncated=truncated)

    def collect(self, state, actions):
        """Open-loop collection, the eager loop of the batched step.

        Args:
            state: batched state (from ``vmap_reset``).
            actions: normalized actions ``(B, T, A)``.

        Returns:
            ``(TrajectoryBatch, final_state)`` with post-step observations,
            rewards and flags for each of the ``T`` steps.  A stochastic
            environment in fast noise mode consumes the rollout's
            time-parallel draws (:meth:`_collect_fast_noise`), the stream the
            kernel of :meth:`collect_fused` takes.
        """
        env = self.env
        if env._has_noise and env._noise_mode == "fast":
            return self._collect_fast_noise(state, actions)
        props = env.env_properties
        obs, flags = [], []
        for t in range(actions.shape[1]):
            o, state = env.vmap_step(state, actions[:, t])
            obs.append(o)
            flags.append(self._flags(state, actions[:, t], props))
        return self._batch(obs, actions, flags), state

    def _collect_fast_noise(self, state, actions):
        """:meth:`collect` for ``noise_mode="fast"``: the whole rollout's
        draws first (:meth:`CoreEnvironment._noise_slabs`), then a loop that
        consumes them; the final state carries the advanced keys."""
        env = self.env
        n_steps = actions.shape[1]
        eps_proc, eps_obs, _, final_keys = env._noise_slabs(env._require_noise_key(state), n_steps, 1)
        props = env.env_properties
        obs, flags = [], []
        for t in range(n_steps):
            state = env._fast_noise_advance_eps(state, actions[:, t], props, None if eps_proc is None else eps_proc[t])
            obs.append(env._fast_noise_observe_eps(state, props, None if eps_obs is None else eps_obs[t]))
            flags.append(self._flags(state, actions[:, t], props))
        return self._batch(obs, actions, flags), structures.replace(state, PRNGKey=final_keys)

    def collect_fused(self, state, actions):
        """Open-loop collection through the rollout kernels, with the contract
        of :meth:`collect`: one launch of the stepper kernel (``"fused"``) or
        the PMSM kernel (``"pmsm_fused"``) per call.

        On a PMSM drive inside
        :func:`~exciting_environments_torch.ops.kernels.pmsm_stepper.supports_collect_epilogue`
        (the class's own observation, reward and flags, the current reward of
        ``control_state = ["i_d", "i_q"]``, no observation noise), on CUDA
        tensors and where autograd does not record the call, the observations,
        rewards and flags come out of the kernel itself, written at each step
        by its epilogue (:func:`~exciting_environments_torch.ops.kernels.pmsm_stepper.pmsm_fused_collect`),
        bit for bit with the eager path.  Otherwise, and on CPU tensors (the
        kernels' plain versions), the kernel saves the state of every step and
        the observations, rewards and flags are evaluated on those states.
        ``pmsm_stepper.COLLECT_PATHS`` counts a drive's collections by path.

        The dispatch is :func:`~exciting_environments_torch.ops.kernels.rollout_path`,
        the environment's kernel scope: an environment outside it (``"scan"``)
        goes to :meth:`collect`.  An environment inside it never does: on CUDA
        tensors a kernel that fails to build or launch raises.
        """
        from exciting_environments_torch.ops.kernels import pmsm_stepper as pk
        from exciting_environments_torch.ops.kernels import rollout_path, traj_rollout

        path = rollout_path(self.env)
        if path == "scan":
            return self.collect(state, actions)
        if path == "pmsm_fused":
            if pk.collect_epilogue_engages(self.env, state, actions):
                pk.COLLECT_PATHS["epilogue"] += 1
                obs, reward, terminated, truncated, final_state = pk.pmsm_fused_collect(self.env, state, actions)
                with annotate("ee.collect.assemble"):
                    batch = TrajectoryBatch(observations=obs, actions=actions, rewards=reward,
                                            terminated=terminated, truncated=truncated)
                return batch, final_state
            pk.COLLECT_PATHS["eager"] += 1
        obs, traj_state, final_state = traj_rollout(self.env)(self.env, state, actions, obs_stride=1,
                                                              return_traj_states=True)
        return self._assemble_batch(obs, actions, traj_state, final_state)

    def collect_policy(self, policy, state, rng, n_steps: int):
        """Closed-loop collection with an eager policy.

        Args:
            policy: ``policy(obs, key) -> action``, from the batched
                observation ``(B, obs_dim)`` and one key of
                :mod:`~exciting_environments_torch.ops.random` to normalized
                actions ``(B, A)``.
            state: batched state (from ``vmap_reset``).
            rng: a key; step ``t`` gets ``split(rng, n_steps)[t]``.
            n_steps: horizon.

        Returns:
            ``(TrajectoryBatch, final_state)`` with the policy's actions.
        """
        env = self.env
        props = env.env_properties
        o = env.generate_observation(state, props)
        keys = prng.split(rng, n_steps)
        obs, acts, flags = [], [], []
        for t in range(n_steps):
            action = policy(o, keys[t])
            o, state = env.vmap_step(state, action)
            obs.append(o)
            acts.append(action)
            flags.append(self._flags(state, action, props))
        return self._batch(obs, torch.stack(acts, dim=1), flags), state

    def _assemble_batch(self, obs, actions, traj_state, final_state):
        """Rewards and flags on the per-step states ``(B, T)`` of a
        trajectory, then the :class:`TrajectoryBatch` (the span
        ``ee.collect.assemble`` under a profiler)."""
        env = self.env
        with annotate("ee.collect.assemble"):
            reward, terminated, truncated = self._flags(traj_state, actions, env._props_for(env.env_properties, 1))
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
        The environment's own ``fused_closed_loop`` picks the kernel (a PMSM
        drive its own, a batch split one launch per shard;
        :func:`~exciting_environments_torch.ops.kernels.closed_loop_path`)
        and raises when the environment is out of the kernels' scope."""
        out = self.env.fused_closed_loop(state, policy_tile, n_steps, obs_stride=1, return_traj_states=True,
                                         policy_params=policy_params, policy_carry=policy_carry)
        obs, actions, traj_state, final_state = out[:4]
        assembled = self._assemble_batch(obs, actions, traj_state, final_state)
        return assembled + (out[4],) if policy_carry is not None else assembled
