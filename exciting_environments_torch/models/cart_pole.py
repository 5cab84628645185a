"""Cart-pole with pole/cart friction (Barto, Sutton & Anderson 1983,
DOI 10.1109/TSMC.1983.6313077); counterpart of
``exciting_environments_tpu/models/cart_pole.py``."""

from __future__ import annotations

import math

from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class CartPole(ClassicODEEnvironment):
    """
    State Variables:
        ``['deflection', 'velocity', 'theta', 'omega']``

    Action Variable:
        ``['force']``

    Initial State:
        Unless chosen otherwise, deflection, velocity and omega are zero and
        theta is pi (pole hanging down).

    Dynamics: the underactuated cart-pole equations with Coulomb cart
    friction ``mu_c`` and viscous pole friction ``mu_p``.
    """

    _default_batch_size = 8
    _default_tau = 2e-2
    _ode_state_fields = ("deflection", "velocity", "theta", "omega")
    _angle_fields = ("theta",)
    _sincos_reward_fields = ("theta",)
    _soft_constrained_fields = ("deflection", "velocity", "omega")
    _default_init_norm = {"deflection": 0.0, "velocity": 0.0, "theta": 1.0, "omega": 0.0}
    _kernel_env_id = 2
    _kernel_params = ("mu_p", "mu_c", "l", "m_p", "m_c", "g")

    @classmethod
    def _default_physical_normalizations(cls):
        return {
            "deflection": MinMaxNormalization(min=-2.4, max=2.4),
            "velocity": MinMaxNormalization(min=-8, max=8),
            "theta": MinMaxNormalization(min=-math.pi, max=math.pi),
            "omega": MinMaxNormalization(min=-8, max=8),
        }

    @classmethod
    def _default_action_normalizations(cls):
        return {"force": MinMaxNormalization(min=-20, max=20)}

    @classmethod
    def _default_static_params(cls):
        # typical values from DOI 10.1109/TSMC.1983.6313077
        return {"mu_p": 0.000002, "mu_c": 0.0005, "l": 0.5, "m_p": 0.1, "m_c": 1, "g": 9.81}

    @dataclass
    class PhysicalState:
        """Physical state of the environment."""

        deflection: object
        velocity: object
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

        mu_p: object
        mu_c: object
        l: object
        m_p: object
        m_c: object
        g: object

    @dataclass
    class Action:
        """Action applicable to the environment."""

        force: object

    def _ode(self, t, y, args, action):
        deflection, velocity, theta, omega = y
        params = args
        d_omega = (
            params.g * self._sin(theta)
            + self._cos(theta)
            * (
                (
                    -action(t)[0]
                    - params.m_p * params.l * (omega**2) * self._sin(theta)
                    + params.mu_c * self._sign(velocity)
                )
                / (params.m_c + params.m_p)
            )
            - (params.mu_p * omega) / (params.m_p * params.l)
        ) / (params.l * (4 / 3 - (params.m_p * (self._cos(theta)) ** 2) / (params.m_c + params.m_p)))

        d_velocity = (
            action(t)[0]
            + params.m_p * params.l * ((omega**2) * self._sin(theta) - d_omega * self._cos(theta))
            - params.mu_c * self._sign(velocity)
        ) / (params.m_c + params.m_p)
        d_theta = omega
        d_deflection = velocity
        return d_deflection, d_velocity, d_theta, d_omega
