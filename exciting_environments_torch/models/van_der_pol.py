"""Forced Van der Pol oscillator (counterpart of
``exciting_environments_tpu/models/van_der_pol.py``): a stiffness benchmark
whose damping nonlinearity ``mu (1 - x^2) v`` stiffens as ``mu`` grows;
per-batch ``mu`` gives a heterogeneous stiffness sweep in one rollout."""

from __future__ import annotations

from exciting_environments_torch.core.classic import ClassicODEEnvironment
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class VanDerPol(ClassicODEEnvironment):
    """
    State Variables:
        ``['position', 'velocity']``

    Action Variable:
        ``['force']``

    Initial State:
        Unless chosen otherwise, ``position = 1`` and ``velocity = 0``.

    Dynamics:
        ``d_position = velocity``
        ``d_velocity = mu * (1 - position^2) * velocity - position + force``
    """

    _default_batch_size = 8
    _default_tau = 1e-4
    _ode_state_fields = ("position", "velocity")
    _angle_fields = ()
    _sincos_reward_fields = ()
    _soft_constrained_fields = ("position", "velocity")
    _default_init_norm = {"position": 0.25, "velocity": 0.0}
    _kernel_env_id = 3
    _kernel_params = ("mu",)

    @classmethod
    def _default_physical_normalizations(cls):
        return {
            "position": MinMaxNormalization(min=-4, max=4),
            "velocity": MinMaxNormalization(min=-15, max=15),
        }

    @classmethod
    def _default_action_normalizations(cls):
        return {"force": MinMaxNormalization(min=-5, max=5)}

    @classmethod
    def _default_static_params(cls):
        return {"mu": 5.0}

    @dataclass
    class PhysicalState:
        """Physical state of the environment."""

        position: object
        velocity: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class StaticParams:
        """Static parameters of the environment."""

        mu: object

    @dataclass
    class Action:
        """Action applicable to the environment."""

        force: object

    def _ode(self, t, y, args, action):
        position, velocity = y
        params = args
        d_position = velocity
        d_velocity = params.mu * (1 - position * position) * velocity - position + action(t)[0]
        return d_position, d_velocity
