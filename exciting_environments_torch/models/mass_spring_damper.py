"""Linear mass-spring-damper oscillator (counterpart of
``exciting_environments_tpu/models/mass_spring_damper.py``)."""

from __future__ import annotations

from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class MassSpringDamper(ClassicODEEnvironment):
    """
    State Variables:
        ``['deflection', 'velocity']``

    Action Variable:
        ``['force']``

    Initial State:
        Unless chosen otherwise, deflection and velocity are zero.

    Dynamics:
        ``d_velocity = (force - d*velocity - k*deflection) / m``
    """

    _default_batch_size = 8
    _default_tau = 1e-4
    _ode_state_fields = ("deflection", "velocity")
    _angle_fields = ()
    _sincos_reward_fields = ()
    _soft_constrained_fields = ("deflection", "velocity")
    _default_init_norm = {"deflection": 0.0, "velocity": 0.0}
    _kernel_env_id = 1
    _kernel_params = ("d", "k", "m")

    @classmethod
    def _default_physical_normalizations(cls):
        return {
            "deflection": MinMaxNormalization(min=-10, max=10),
            "velocity": MinMaxNormalization(min=-10, max=10),
        }

    @classmethod
    def _default_action_normalizations(cls):
        return {"force": MinMaxNormalization(min=-20, max=20)}

    @classmethod
    def _default_static_params(cls):
        return {"k": 100, "d": 1, "m": 1}

    @dataclass
    class PhysicalState:
        """Physical state of the environment."""

        deflection: object
        velocity: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class StaticParams:
        """Static parameters of the environment."""

        d: object
        k: object
        m: object

    @dataclass
    class Action:
        """Action applicable to the environment."""

        force: object

    def _ode(self, t, y, args, action):
        deflection, velocity = y
        params = args
        d_velocity = (action(t)[0] - params.d * velocity - params.k * deflection) / params.m
        d_deflection = velocity
        return d_deflection, d_velocity
