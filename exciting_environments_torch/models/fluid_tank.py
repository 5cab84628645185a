"""Fluid tank after Torricelli's principle (counterpart of
``exciting_environments_tpu/models/fluid_tank.py``; ex. 7.3.2, p. 355 of
"System Dynamics", Palm, William III): the height is clipped to be
non-negative inside the ODE and again after each solver step."""

from __future__ import annotations

import math

import numpy as np
import torch

from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class FluidTank(ClassicODEEnvironment):
    """
    State Variables:
        ``['height']``

    Action Variable:
        ``['inflow']``

    Dynamics:
        ``dh/dt = inflow/A - c_d * A_o / A * sqrt(2 g h)`` with ``h`` clipped
        to be non-negative; the solver output is clipped again because a
        discrete step can undershoot an empty tank.
    """

    _default_batch_size = 1
    _default_tau = 1e-3
    _ode_state_fields = ("height",)
    _angle_fields = ()
    _sincos_reward_fields = ()
    _soft_constrained_fields = ()
    _default_init_norm = {"height": 0.0}
    # random resets draw the normalized height from [0, 1]: a tank cannot be
    # "negatively full"
    _init_uniform_minval = 0.0
    _kernel_env_id = 4
    _kernel_params = ("base_area", "orifice_area", "c_d", "g")

    @classmethod
    def _default_physical_normalizations(cls):
        return {"height": MinMaxNormalization(min=0, max=3)}

    @classmethod
    def _default_action_normalizations(cls):
        return {"inflow": MinMaxNormalization(min=0, max=0.2)}

    @classmethod
    def _default_static_params(cls):
        # c_d = 0.6 typical value for water [Palm2010]
        return {
            "base_area": math.pi,
            "orifice_area": math.pi * 0.1**2,
            "c_d": 0.6,
            "g": 9.81,
        }

    @dataclass
    class PhysicalState:
        """Physical state of the environment."""

        height: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class StaticParams:
        """Static parameters of the environment."""

        base_area: object
        orifice_area: object
        c_d: object
        g: object

    @dataclass
    class Action:
        """Action applicable to the environment."""

        inflow: object

    def _ode(self, t, y, args, action):
        h = y[0]
        params = args
        h = torch.clamp(h, min=0)
        dh_dt = action(t)[0] / params.base_area - params.c_d * params.orifice_area / params.base_area * torch.sqrt(
            2 * params.g * h
        )
        return (dh_dt,)

    def _clip_state(self, y):
        # a tank cannot be more empty than empty; a discrete solver step may
        # overshoot below zero
        return (torch.clamp(y[0], min=0),)

    def generate_truncated(self, state, env_properties):
        """The tank never truncates: 0 per state."""
        shape = tuple(state.physical_state.height.shape) + (1,)
        return torch.zeros(shape, dtype=torch.int64, device=state.physical_state.height.device)

    def generate_terminated(self, state, reward, env_properties):
        """The tank never terminates."""
        return torch.zeros(tuple(reward.shape[:-1]) + (1,), dtype=torch.bool, device=reward.device)

    @property
    def states_description(self):
        return np.array(["fluid height"])

    @property
    def obs_description(self):
        return np.hstack(
            [
                self.states_description,
                np.array([name + "_ref" for name in self.control_state]),
            ]
        )
