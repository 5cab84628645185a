"""Shared implementation layer for the classical ODE environments (counterpart
of ``exciting_environments_tpu/core/classic.py``).

A concrete environment declares its dataclasses, default normalizations,
static parameters and ``tau``, the vector field ``_ode`` and small metadata
(angle fields, soft-constrained fields, sin/cos reward fields).  Semantics
follow the JAX package: the same normalized observation layout, reward shape
``(..., 1)``, ``truncated``/``terminated`` rules, NaN-reference convention
and stochastic-simulation options.
"""

from __future__ import annotations

import math
from dataclasses import fields
from typing import Callable

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import CoreEnvironment, is_key
from exciting_environments_torch.ops import fastmath
from exciting_environments_torch.ops import random as prng


def svm_circle(u_dc: float):
    """The inverter limit of the induction machine and the EESM as an
    action-constraint hook (:attr:`CoreEnvironment._constrain_action_tuple`):
    the physical pair ``(u_d, u_q)``, components 0 and 1, is scaled into the
    inscribed circle of the hexagon, ``|u| <= u_dc / sqrt(3)`` (the linear
    region of space-vector modulation); further components pass unchanged.
    The hook carries its radius as ``svm_limit``, by which the stepper and
    closed-loop kernels recognise it and compute it in place
    (``ops/kernels/stepper.py::kernel_svm_limit``)."""
    lim = float(u_dc) / float(np.sqrt(3.0))

    def hook(comps):
        u_d, u_q = comps[0], comps[1]
        mag = torch.sqrt(u_d * u_d + u_q * u_q)
        scale = torch.clamp(lim / torch.clamp(mag, min=1e-12), max=1.0)
        return (u_d * scale, u_q * scale) + tuple(comps[2:])

    hook.svm_limit = lim
    return hook


class ClassicODEEnvironment(CoreEnvironment):
    """Base class for the hand-written physics models."""

    _default_batch_size: int = 8
    _default_tau: float = 1e-4
    #: lower bound of the uniform normalized random reset draw
    _init_uniform_minval: float = -1.0
    _sincos_reward_fields: tuple = ()
    _soft_constrained_fields: tuple = ()
    _default_init_norm: dict = {}
    #: index of the environment's vector field in ``csrc/stepper.cu``
    #: (``None``: no kernel functor, the fused entry points fall back)
    _kernel_env_id: int = None
    #: static-parameter names in the order the kernel functor reads them
    _kernel_params: tuple = ()

    @classmethod
    def _default_physical_normalizations(cls) -> dict:
        raise NotImplementedError

    @classmethod
    def _default_action_normalizations(cls) -> dict:
        raise NotImplementedError

    @classmethod
    def _default_static_params(cls) -> dict:
        raise NotImplementedError

    def __init__(
        self,
        batch_size: int = None,
        physical_normalizations: dict = None,
        action_normalizations: dict = None,
        soft_constraints: Callable = None,
        static_params: dict = None,
        control_state: list = None,
        solver=None,
        tau: float = None,
        fast_math: bool = False,
        process_noise: dict = None,
        observation_noise: dict = None,
        noise_mode: str = "exact",
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        """
        Args:
            batch_size: Number of parallel environment simulations.
            physical_normalizations: ``MinMaxNormalization`` per physical field.
            action_normalizations: ``MinMaxNormalization`` per action field.
            soft_constraints: Function returning soft-constraint values.
            static_params: Parameters that do not change during simulation;
                Python scalars or ``(batch_size,)`` arrays.
            control_state: Physical-state components tracked by the reward.
            solver: ODE solver instance or registry name (default Euler).
            tau: Duration of one control step in seconds.
            fast_math: Replace ``sin``/``cos``/``sign`` in the vector field
                and the solver step's angle wrap by their fast-math
                counterparts (``ops/fastmath.py``); tolerance-gated against
                the exact path, never exact.
            process_noise: Optional ``{field: sigma}`` additive diffusion on
                integrated fields (sigma in physical units per sqrt-second):
                each step adds ``sigma * sqrt(tau) * N(0, 1)`` drawn from the
                per-instance key in ``State.PRNGKey`` (reset with keys,
                :meth:`~exciting_environments_torch.core.env.CoreEnvironment.vmap_init_state`).
                ``step``/``vmap_rollout``, the fused step-mode and closed-loop
                kernels (the same draws, streamed as slabs) and, for one-stage
                solvers, ``sim_ahead`` (Euler-Maruyama) are stochastic.
            observation_noise: Optional ``{field: sigma}`` Gaussian sensor
                noise on the observed physical components (sigma in physical
                units, scaled by the field's normalization span); the state
                stays exact.
            noise_mode: ``"exact"`` (default): the per-step ``split(key, 3)``
                chain, the same draws for chained steps, the loop and the
                kernels.  ``"fast"``: step ``t`` draws from ``fold_in(key,
                t)``, time-parallel; a T-step rollout and T chained ``step``
                calls then use different streams.
            device: Torch device (default CUDA; raises without a GPU).
            dtype: Floating dtype of the states the environment makes.
        """
        self.fast_math = bool(fast_math)
        if self.fast_math:
            self._sin = fastmath.sin_wrapped
            self._cos = fastmath.poly_cos
            self._sign = fastmath.fast_sign
        else:
            self._sin = torch.sin
            self._cos = torch.cos
            self._sign = torch.sign

        if batch_size is None:
            batch_size = self._default_batch_size
        if tau is None:
            tau = self._default_tau
        if not physical_normalizations:
            physical_normalizations = self._default_physical_normalizations()
        if not action_normalizations:
            action_normalizations = self._default_action_normalizations()
        if not static_params:
            static_params = self._default_static_params()
        if not soft_constraints:
            soft_constraints = self.default_soft_constraints
        if not control_state:
            control_state = []

        self.control_state = control_state
        self.soft_constraints = soft_constraints
        self._configure_noise(process_noise, observation_noise, noise_mode,
                              process_fields=self._ode_state_fields,
                              observation_fields=tuple(f.name for f in fields(self.PhysicalState)))
        env_properties = self.EnvProperties(
            physical_normalizations=self.PhysicalState(**physical_normalizations),
            action_normalizations=self.Action(**action_normalizations),
            static_params=self.StaticParams(**static_params),
        )
        super().__init__(batch_size, env_properties=env_properties, tau=tau, solver=solver,
                         device=device, dtype=dtype)

    def _wrap_angles(self, y):
        if not self.fast_math:
            return super()._wrap_angles(y)
        y = list(y)
        for name in self._angle_fields:
            i = self._ode_state_fields.index(name)
            y[i] = fastmath.wrap_angle_fast(y[i])
        return tuple(y)

    @property
    def _physical_field_names(self):
        return tuple(f.name for f in fields(self.PhysicalState))

    def init_state(self, env_properties, rng=None, batch_shape=()):
        """Default or random initial state, drawn (or taken from
        ``_default_init_norm``) in normalized coordinates and denormalized.
        ``rng``: ``None``, a ``torch.Generator``, or keys ``batch_shape +
        (2,)``: then ``uniform(key)`` gives the state and ``split(key)[1]``
        becomes its key, as in the JAX package."""
        names = self._physical_field_names
        key = self._full(batch_shape, math.nan)
        if rng is None:
            phys = self.PhysicalState(
                **{n: self._full(batch_shape, self._default_init_norm.get(n, 0.0)) for n in names}
            )
        else:
            if is_key(rng):
                state_norm = prng.uniform(rng, len(names), self.dtype, self._init_uniform_minval, 1.0)
                key = prng.split(rng)[..., 1, :]
            else:
                u = torch.rand(tuple(batch_shape) + (len(names),), generator=rng, dtype=self.dtype,
                               device=self.device)
                state_norm = u * (1 - self._init_uniform_minval) + self._init_uniform_minval
            phys = self.PhysicalState(**{n: state_norm[..., i] for i, n in enumerate(names)})
        norm_state = self.State(
            physical_state=phys,
            PRNGKey=key,
            additions=self._init_solver_additions(env_properties, phys),
            reference=self._nan_reference(batch_shape),
        )
        return self.denormalize_state(norm_state, env_properties)

    def generate_observation(self, state, env_properties):
        """Normalized physical state, then any tracked reference components,
        along the last axis."""
        norm_state = self.normalize_state(state, env_properties)
        cols = [getattr(norm_state.physical_state, n) for n in self._physical_field_names]
        cols += [getattr(norm_state.reference, n) for n in self.control_state]
        return torch.stack(cols, dim=-1)

    def generate_state_from_observation(self, obs, env_properties, key=None):
        """Inverse of :meth:`generate_observation` (bijective for these envs)."""
        names = self._physical_field_names
        batch_shape = tuple(obs.shape[:-1])
        phys = self.PhysicalState(**{n: obs[..., i] for i, n in enumerate(names)})
        ref = self._nan_reference(batch_shape)
        for pos, name in enumerate(self.control_state):
            setattr(ref, name, obs[..., len(names) + pos])
        norm_state = self.State(
            physical_state=phys,
            PRNGKey=key if key is not None else self._full(batch_shape, math.nan),
            additions=self._init_solver_additions(env_properties, phys),
            reference=ref,
        )
        return self.denormalize_state(norm_state, env_properties)

    def generate_reward(self, state, action, env_properties):
        """Negative squared tracking error over the controlled components;
        angle components use the sin/cos distance."""
        reward = 0
        norm_state = self.normalize_state(state, env_properties)
        for name in self.control_state:
            if name in self._sincos_reward_fields:
                theta = getattr(state.physical_state, name)
                theta_ref = getattr(state.reference, name)
                reward += -(
                    (torch.sin(theta) - torch.sin(theta_ref)) ** 2 + (torch.cos(theta) - torch.cos(theta_ref)) ** 2
                )
            else:
                reward += -(
                    (getattr(norm_state.physical_state, name) - getattr(norm_state.reference, name)) ** 2
                )
        if not isinstance(reward, torch.Tensor):
            leaf = structures.leaves(state.physical_state)[0]
            reward = torch.full(leaf.shape, float(reward), dtype=leaf.dtype, device=leaf.device)
        return reward[..., None]

    def default_soft_constraints(self, state, action_norm, env_properties):
        """ReLU(|x|-1) soft constraints on the declared fields plus the action."""
        physical_state_norm = self.normalize_state(state, env_properties).physical_state
        with structures.copy_and_mutate(physical_state_norm) as phys_soft_const:
            for field in fields(phys_soft_const):
                value = getattr(physical_state_norm, field.name)
                if field.name in self._soft_constrained_fields:
                    setattr(phys_soft_const, field.name, torch.relu(torch.abs(value) - 1.0))
                else:
                    setattr(phys_soft_const, field.name, torch.full_like(value, math.nan))
        return phys_soft_const, torch.relu(torch.abs(action_norm) - 1.0)

    def generate_truncated(self, state, env_properties):
        """Flag per observation component: left the normalized band."""
        return torch.abs(self.generate_observation(state, env_properties)) > 1

    def generate_terminated(self, state, reward, env_properties):
        """Terminal when the tracking reward is exactly zero."""
        return reward == 0

    @property
    def obs_description(self):
        return np.hstack(
            [
                np.array(list(self._physical_field_names)),
                np.array([name + "_ref" for name in self.control_state]),
            ]
        )

    @property
    def action_description(self):
        return np.array([f.name for f in fields(self.Action)])
