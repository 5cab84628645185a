"""A :class:`gymnasium.vector.VectorEnv` over the batched environment API
(counterpart of ``exciting_environments_tpu/wrappers/gymnasium_vector.py``).

* ``single_observation_space`` / ``single_action_space`` Boxes (normalized
  action bounds [-1, 1]; observations nominally [-1, 1] but unbounded — the
  engine truncates on ``|obs| > 1`` rather than clipping),
* Gymnasium's **NEXT_STEP autoreset** protocol (``metadata["autoreset_mode"]``)
  — a sub-environment that ended on step *t* ignores its action on step
  *t + 1* and returns its reset observation with ``reward = 0``,
* optional ``max_episode_steps`` time-limit truncation,
* per-episode random tracking references for ``control_state`` fields,
  drawn from the env's ``init_state`` distribution like
  ``GymWrapper.generate_new_ref`` (held constant within an episode).

The whole vector step (stepped branch, reset branch, per-instance select,
reward and flags, the time-limit counter) stays on the device, in
:func:`~exciting_environments_torch.utils.episodes._autoreset_step`, which
does not depend on gymnasium.  Whether any instance resets is read from the
host copy of the previous step's flags, which the previous ``step`` returned
as numpy, so the branch costs no device sync; the host converts the four
result tensors to numpy.  Keys are those of
:mod:`~exciting_environments_torch.ops.random`, so resets, references and
noise draws are the JAX package's from the same seeds.
"""

from __future__ import annotations

import numpy as np
import torch

from gymnasium import spaces as gym_spaces
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes


class GymnasiumVectorEnv(VectorEnv):
    """Vectorized Gymnasium facade over a batched ``CoreEnvironment``.

    Args:
        env: a batched environment (its ``batch_size`` becomes ``num_envs``).
        seed: seed of the adapter's key chain (resets, episode references).
        max_episode_steps: truncate every episode after this many steps
            (``None`` disables the time limit).
    """

    metadata = {"autoreset_mode": AutoresetMode.NEXT_STEP, "render_modes": []}

    def __init__(self, env, seed: int = 0, max_episode_steps: int | None = None):
        from exciting_environments_torch.core.classic import ClassicODEEnvironment

        # classic default termination is reward == 0, and without tracked
        # references the tracking reward is identically zero — every step
        # would terminate, silently feeding degenerate 1-step episodes to
        # the RL library consuming this API
        if (
            isinstance(env, ClassicODEEnvironment)
            and not env.control_state
            and type(env).generate_terminated is ClassicODEEnvironment.generate_terminated
        ):
            import warnings

            warnings.warn(
                "this env has no control_state: its tracking reward is identically "
                "zero, so the default terminated rule (reward == 0) fires every "
                "step and every episode is 1 step long — construct it with "
                "control_state=[...] (per-episode random references are drawn "
                "automatically) or override generate_terminated",
                stacklevel=2,
            )
        self.env = env
        self.num_envs = env.batch_size
        self.max_episode_steps = max_episode_steps
        obs_dim = len(env.obs_description)
        act_dim = env.action_dim
        self.single_observation_space = gym_spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)
        self.single_action_space = gym_spaces.Box(-1.0, 1.0, (act_dim,), np.float32)
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        self.render_mode = None
        self.spec = None
        self._key = prng.PRNGKey(seed, env.device)
        self._state = None
        self._clear_episodes()

    def _clear_episodes(self):
        self._autoreset = torch.zeros(self.num_envs, dtype=torch.bool, device=self.env.device)
        self._any_reset = False  # the host copy of self._autoreset.any()
        self._elapsed = torch.zeros(self.num_envs, dtype=torch.int32, device=self.env.device)

    @classmethod
    def from_registry(cls, env_id, num_envs: int, seed: int = 0,
                      max_episode_steps: int | None = None, **env_kwargs):
        """Build the adapter around a freshly constructed registry env, e.g.
        ``GymnasiumVectorEnv.from_registry(EnvironmentRegistry.PENDULUM,
        num_envs=128, control_state=["theta"], device="cuda")``."""
        return cls(
            env_id.make(batch_size=num_envs, **env_kwargs),
            seed=seed, max_episode_steps=max_episode_steps,
        )

    # -- Gymnasium API -------------------------------------------------------

    def reset(self, *, seed: int | None = None, options=None):
        if seed is not None:
            self._key = prng.PRNGKey(seed, self.env.device)
        self._key, k = prng.split(self._key)
        obs, self._state = episodes.reset_with_references(self.env, k)
        self._clear_episodes()
        return obs.cpu().numpy().astype(np.float32), {}

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("step() called before reset()")
        action = torch.as_tensor(np.asarray(actions), dtype=self.env.dtype).to(self.env.device).reshape(
            self.num_envs, self.env.action_dim
        )
        self._key, k = prng.split(self._key)
        obs, reward, term, trunc, self._state, self._autoreset, self._elapsed = episodes._autoreset_step(
            self.env, self._state, self._autoreset, self._any_reset, self._elapsed, action, k,
            self.max_episode_steps,
        )
        term, trunc = term.cpu().numpy(), trunc.cpu().numpy()
        self._any_reset = bool((term | trunc).any())
        return (
            obs.cpu().numpy().astype(np.float32),
            reward.cpu().numpy().astype(np.float32),
            term.astype(bool),
            trunc.astype(bool),
            {},
        )

    def render(self):
        return None

    def close_extras(self, **kwargs):
        pass
