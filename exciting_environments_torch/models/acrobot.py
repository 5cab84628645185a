"""Acrobot: a two-link underactuated arm with torque on the second joint
(counterpart of ``exciting_environments_tpu/models/acrobot.py``).

The soft constraints act on the fields ``omega_1`` and ``omega_2``, as in the
JAX package (its documented fix of the original's reference to a
nonexistent ``"omega"`` field).  The vector field goes through
``self._cos``/``self._sin``, so ``fast_math=True`` applies.
"""

from __future__ import annotations

import math

from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class Acrobot(ClassicODEEnvironment):
    """
    State Variables:
        ``['theta_1', 'theta_2', 'omega_1', 'omega_2']``

    Action Variable:
        ``['torque']`` (applied at the elbow joint)

    Initial State:
        Unless chosen otherwise, ``theta_1=pi`` (hanging down) and all other
        components zero.

    Dynamics: the two-link manipulator equations with inertia entries
    ``d_11``/``d_12``/``d_22``, Coriolis and centrifugal terms
    ``h_1``/``h_2`` and gravity terms ``phi_1``/``phi_2``.
    """

    _default_batch_size = 8
    _default_tau = 1e-3
    _ode_state_fields = ("theta_1", "theta_2", "omega_1", "omega_2")
    _angle_fields = ("theta_1", "theta_2")
    _sincos_reward_fields = ("theta_1", "theta_2")
    _soft_constrained_fields = ("omega_1", "omega_2")
    _default_init_norm = {"theta_1": 1.0, "theta_2": 0.0, "omega_1": 0.0, "omega_2": 0.0}
    _kernel_env_id = 5
    _kernel_params = ("g", "l_1", "l_2", "m_1", "m_2", "l_c1", "l_c2", "I_1", "I_2")

    @classmethod
    def _default_physical_normalizations(cls):
        return {
            "theta_1": MinMaxNormalization(min=-math.pi, max=math.pi),
            "theta_2": MinMaxNormalization(min=-math.pi, max=math.pi),
            "omega_1": MinMaxNormalization(min=-10, max=10),
            "omega_2": MinMaxNormalization(min=-10, max=10),
        }

    @classmethod
    def _default_action_normalizations(cls):
        return {"torque": MinMaxNormalization(min=-20, max=20)}

    @classmethod
    def _default_static_params(cls):
        return {"g": 9.81, "l_1": 2, "l_2": 2, "m_1": 1, "m_2": 1, "l_c1": 1, "l_c2": 1, "I_1": 1.3, "I_2": 1.3}

    @dataclass
    class PhysicalState:
        """Physical state of the environment."""

        theta_1: object
        theta_2: object
        omega_1: object
        omega_2: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class StaticParams:
        """Static parameters of the environment."""

        g: object
        l_1: object
        l_2: object
        m_1: object
        m_2: object
        l_c1: object
        l_c2: object
        I_1: object
        I_2: object

    @dataclass
    class Action:
        """Action applicable to the environment."""

        torque: object

    def _ode(self, t, y, args, action):
        theta_1, theta_2, omega_1, omega_2 = y
        params = args
        d_11 = (
            params.m_1 * params.l_c1**2
            + params.m_2
            * (params.l_1**2 + params.l_c2**2 + 2 * params.l_1 * params.l_c2 * self._cos(theta_2))
            + params.I_1
            + params.I_2
        )
        d_12 = params.m_2 * (params.l_c2**2 + params.l_1 * params.l_c2 * self._cos(theta_2)) + params.I_2
        d_22 = params.m_2 * params.l_c2**2 + params.I_2
        h_1 = (
            -params.m_2 * params.l_1 * params.l_c2 * self._sin(theta_2) * omega_2**2
            - 2 * params.m_2 * params.l_1 * params.l_c2 * self._sin(theta_2) * omega_1 * omega_2
        )
        h_2 = params.m_2 * params.l_1 * params.l_c2 * self._sin(theta_2) * omega_1**2
        phi_1 = (params.m_1 * params.l_c1 + params.m_2 * params.l_1) * params.g * self._cos(
            theta_1 + math.pi / 2
        ) + params.m_2 * params.l_c2 * params.g * self._cos(theta_1 + theta_2 + math.pi / 2)
        phi_2 = params.m_2 * params.l_c2 * params.g * self._cos(theta_1 + theta_2 + math.pi / 2)
        d_omega_1 = (
            1 / (d_12 - d_22 / d_12 * d_11) * (action(t)[0] + d_22 / d_12 * (h_1 + phi_1) - h_2 - phi_2)
        )
        d_omega_2 = (-d_11 * d_omega_1 - h_1 - phi_1) / d_12
        d_theta_1 = omega_1
        d_theta_2 = omega_2
        return d_theta_1, d_theta_2, d_omega_1, d_omega_2
