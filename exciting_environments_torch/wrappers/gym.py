"""Stateful Gymnasium-style facade over the batched environment API
(counterpart of ``exciting_environments_tpu/wrappers/gym.py``).

The wrapper stores the flattened batched state between calls, steps it with
``vmap_step`` plus the reward/terminated/truncated hooks, and can draw random
piecewise-constant tracking references with a per-batch hold-steps counter.
References and hold steps come from the keys of
:mod:`~exciting_environments_torch.ops.random`, so they are the JAX
package's bit for bit from the same keys.  The hooks, the default ones and
any passed in, are called on the whole batch (the port's environment
methods work elementwise over the batch).
"""

from __future__ import annotations

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.registration import EnvironmentRegistry
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.utils import episodes


class GymWrapper:
    """Wrap a :class:`CoreEnvironment` into a stateful ``step``/``reset`` loop."""

    def __init__(
        self,
        env,
        control_state=None,
        generate_reward=None,
        generate_terminated=None,
        generate_truncated=None,
        ref_params=None,
    ):
        self.env = env

        if control_state is None:
            print(f"No chosen control state in the GymWrapper. Control state is set to {self.env.control_state}.")
            self.control_state = self.env.control_state
        else:
            assert type(control_state) == list, "Control state has to be a list."
            valid = [f.name for f in structures.fields(self.env.PhysicalState)]
            for i in control_state:
                assert i in valid, f"Given control state {i} is no valid physical state {valid}."
            self.control_state = control_state
            self.env.control_state = control_state

        self.ref_gen = False

        _, init_state = self.env.vmap_reset()

        if not ref_params:
            ref_params = {
                "hold_steps_min": 10,
                "hold_steps_max": 1000,
            }
        self.ref_params = ref_params
        self.reference_hold_steps = torch.zeros((self.env.batch_size, 1), dtype=self.env.dtype,
                                                device=self.env.device)

        self.state = structures.leaves(init_state)
        self.state_tree_struct = init_state

        self.generate_reward = generate_reward or self.env.generate_reward
        self.generate_truncated = generate_truncated or self.env.generate_truncated
        self.generate_terminated = generate_terminated or self.env.generate_terminated

    @classmethod
    def from_env(cls, env_type: EnvironmentRegistry, **env_kwargs):
        """Create a GymWrapper around a freshly constructed registry env."""
        env = env_type.make(**env_kwargs)
        return cls(env)

    def step(self, action):
        """One simulation step for all batches.

        Returns ``(observation, reward, terminated, truncated)`` with shapes
        ``(batch_size, obs_dim)`` / ``(batch_size, 1)`` / ``(batch_size, 1)`` /
        ``(batch_size, obs_dim)``.
        """
        obs, reward, terminated, truncated, self.state, self.reference_hold_steps = self.gym_step(
            action, self.state, self.reference_hold_steps, bool(self.ref_gen and len(self.control_state))
        )
        return obs, reward, terminated, truncated

    def gym_step(self, action, state, reference_hold_steps, ref_active):
        """The core of :meth:`step`: environment step, optional reference
        update, reward/flag computation, state re-flattening.  The
        observation is the step's, taken before a renewed reference.

        ``ref_active`` is read on every call (the JAX package passes it as a
        static argument so that its compiled step never goes stale)."""
        state = structures.unflatten(self.state_tree_struct, state)
        props = self.env.env_properties

        obs, state = self.env.vmap_step(state, action)

        if ref_active:
            state, reference_hold_steps = self.update_ref(state, props, reference_hold_steps)

        reward = self.generate_reward(state, action, props)
        terminated = self.generate_terminated(state, reward, props)
        truncated = self.generate_truncated(state, props)
        return obs, reward, terminated, truncated, structures.leaves(state), reference_hold_steps

    def reset(self, rng_env=None, rng_ref=None, initial_state=None):
        """Reset all batches; optionally (re)seed the reference generator.

        ``rng_env`` is ``(batch_size, 2)`` keys (or ``None`` for the default
        state), ``rng_ref`` one key, split over the batch, or ``(batch_size,
        2)`` keys; ``initial_state`` a flattened state as :attr:`state`
        holds it."""
        if initial_state is not None:
            obs, state = self.env.vmap_reset(initial_state=structures.unflatten(self.state_tree_struct,
                                                                                initial_state))
        else:
            _, state = self.env.vmap_reset(rng_env)

        if rng_ref is not None:
            if rng_ref.ndim == 1:
                key = prng.split(rng_ref, self.env.batch_size)
            else:
                key = rng_ref
                assert rng_ref.shape[0] == self.env.batch_size

            with structures.copy_and_mutate(state, validate=False) as state:
                state.PRNGKey = key

            self.ref_gen = True
            state, self.reference_hold_steps = self.generate_new_ref(
                state, self.env.env_properties, torch.zeros(self.env.batch_size, device=key.device)
            )
        else:
            self.ref_gen = False
            print("Since no PRNGKey for reference was provided, reference generation is deactivated.")

        self.state = structures.leaves(state)
        obs = self.env.generate_observation(state, self.env.env_properties)
        return obs, {}

    def update_ref(self, state, env_properties, hold_steps):
        """Draw a fresh reference where the hold counter has run out, then
        count every counter down."""
        expired = hold_steps[:, 0] == 0
        new_state, new_hold = self.generate_new_ref(state, env_properties, hold_steps)
        state = episodes.tree_where(expired, new_state, state)
        hold_steps = torch.where(expired[:, None], new_hold, hold_steps)
        hold_steps = hold_steps - 1
        return state, hold_steps

    def generate_new_ref(self, state, env_properties, hold_steps):
        """New random references from the env's ``init_state`` distribution
        plus random hold durations ``(batch_size, 1)``, from each instance's
        key (which advances)."""
        del hold_steps  # every instance draws a new one
        batch = state.PRNGKey.shape[:-1]
        with structures.copy_and_mutate(state, validate=False) as new_state:
            init = self.env.init_state(env_properties, state.PRNGKey, batch_shape=tuple(batch))
            for name in self.control_state:
                setattr(new_state.reference, name, getattr(init.physical_state, name))
            pair = prng.split(init.PRNGKey)
            key, subkey = pair[..., 0, :], pair[..., 1, :]
            hold_steps = prng.randint(
                subkey,
                (1,),
                minval=self.ref_params["hold_steps_min"],
                maxval=self.ref_params["hold_steps_max"],
            )
            new_state.PRNGKey = key
        return new_state, hold_steps

    def render(self, *_, **__):
        """Visualization is not implemented."""
        raise NotImplementedError("To be implemented!")

    def close(self):
        """Teardown is not implemented."""
        raise NotImplementedError("To be implemented!")
