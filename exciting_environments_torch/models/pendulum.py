"""Torque-actuated nonlinear pendulum (counterpart of
``exciting_environments_tpu/models/pendulum.py``)."""

from __future__ import annotations

import math

from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class Pendulum(ClassicODEEnvironment):
    """
    State Variables:
        ``['theta', 'omega']``

    Action Variable:
        ``['torque']``

    Initial State:
        Unless chosen otherwise, ``theta=pi`` and ``omega=0``.

    Dynamics (point mass ``m`` on a massless rod of length ``l``):
        ``d_omega = (torque + l*m*g*sin(theta)) / (m*l^2)``

    Example:
        >>> import torch
        >>> import exciting_environments_torch as excenvs
        >>> env = excenvs.Pendulum(batch_size=4, device="cpu")
        >>> obs, state = env.vmap_reset()
        >>> obs, state = env.vmap_step(state, torch.zeros((4, 1)))
    """

    _default_batch_size = 8
    _default_tau = 1e-4
    _ode_state_fields = ("theta", "omega")
    _angle_fields = ("theta",)
    _sincos_reward_fields = ("theta",)
    _soft_constrained_fields = ("omega",)
    _default_init_norm = {"theta": 1.0, "omega": 0.0}
    _kernel_env_id = 0
    _kernel_params = ("l", "m", "g")

    @classmethod
    def _default_physical_normalizations(cls):
        return {
            "theta": MinMaxNormalization(min=-math.pi, max=math.pi),
            "omega": MinMaxNormalization(min=-10, max=10),
        }

    @classmethod
    def _default_action_normalizations(cls):
        return {"torque": MinMaxNormalization(min=-20, max=20)}

    @classmethod
    def _default_static_params(cls):
        return {"g": 9.81, "l": 2, "m": 1}

    @dataclass
    class PhysicalState:
        """Physical state of the environment."""

        theta: object
        omega: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class StaticParams:
        """Static parameters of the environment."""

        g: object
        l: object
        m: object

    @dataclass
    class Action:
        """Action applicable to the environment."""

        torque: object

    def _ode(self, t, y, args, action):
        theta, omega = y
        params = args
        d_omega = (action(t)[0] + params.l * params.m * params.g * self._sin(theta)) / (
            params.m * (params.l) ** 2
        )
        d_theta = omega
        return d_theta, d_omega
