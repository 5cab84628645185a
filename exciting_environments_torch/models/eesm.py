"""Externally excited synchronous machine (EESM), rotor-frame dq model
(counterpart of ``exciting_environments_tpu/models/eesm.py``).

With the field winding referred to the stator, the flux linkages are
``psi_d = L_d i_d + L_m i_f``, ``psi_q = L_q i_q`` and ``psi_f = L_f i_f +
L_m i_d``; at frozen electrical speed ``omega_el`` the currents follow a
linear ODE through the inverse of the constant inductance matrix (d/f block
determinant ``D = L_d L_f - L_m^2``).  Three inputs: ``u_d``, ``u_q`` and
the field voltage ``u_f``.  ``u_dc=`` limits ``(u_d, u_q)`` to the
inscribed circle of the inverter's hexagon
(:func:`~exciting_environments_torch.core.classic.svm_circle`); ``u_f`` keeps
its own band.
"""

from __future__ import annotations

from exciting_environments_torch.core.classic import ClassicODEEnvironment, svm_circle
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class EESM(ClassicODEEnvironment):
    """
    State Variables:
        ``['i_d', 'i_q', 'i_f']``: stator currents in the rotor dq frame and
        the (stator-referred) field current.

    Action Variables:
        ``['u_d', 'u_q', 'u_f']``: stator dq voltages and the field voltage.

    Initial State:
        Unless chosen otherwise, all zeros.

    Dynamics (``D = l_d*l_f - l_m**2``):
        ``p_d   = u_d - r_s*i_d + omega_el*l_q*i_q``
        ``p_q   = u_q - r_s*i_q - omega_el*(l_d*i_d + l_m*i_f)``
        ``p_f   = u_f - r_f*i_f``
        ``d_i_d = (l_f*p_d - l_m*p_f) / D``
        ``d_i_q = p_q / l_q``
        ``d_i_f = (l_d*p_f - l_m*p_d) / D``
    """

    _default_batch_size = 8
    _default_tau = 1e-4
    _ode_state_fields = ("i_d", "i_q", "i_f")
    _angle_fields = ()
    _sincos_reward_fields = ()
    _soft_constrained_fields = ("i_d", "i_q", "i_f")
    _default_init_norm = {"i_d": 0.0, "i_q": 0.0, "i_f": 0.0}
    _kernel_env_id = 7
    _kernel_params = ("r_s", "r_f", "l_d", "l_q", "l_f", "l_m", "p", "omega_el")

    def __init__(self, *args, u_dc: float = None, **kwargs):
        """All :class:`ClassicODEEnvironment` arguments, plus:

        Args:
            u_dc: optional DC-link voltage [V]: the physical ``(u_d, u_q)``
                command is then limited to the circle ``|u_dq| <= u_dc /
                sqrt(3)`` (the linear region of space-vector modulation) on
                every path, the kernels included; ``u_f`` keeps its own
                band.  Default ``None``: no constraint.
        """
        super().__init__(*args, **kwargs)
        if u_dc is not None:
            self._u_dc = float(u_dc)
            self._constrain_action_tuple = svm_circle(self._u_dc)

    @classmethod
    def _default_physical_normalizations(cls):
        return {
            "i_d": MinMaxNormalization(min=-20.0, max=20.0),
            "i_q": MinMaxNormalization(min=-20.0, max=20.0),
            "i_f": MinMaxNormalization(min=-20.0, max=20.0),
        }

    @classmethod
    def _default_action_normalizations(cls):
        # stator legs off a 400 V DC link (~325 V peak phase); field chopper
        return {
            "u_d": MinMaxNormalization(min=-325.0, max=325.0),
            "u_q": MinMaxNormalization(min=-325.0, max=325.0),
            "u_f": MinMaxNormalization(min=-60.0, max=60.0),
        }

    @classmethod
    def _default_static_params(cls):
        return {
            "r_s": 0.25,
            "r_f": 2.0,
            "l_d": 3.0e-3,
            "l_q": 4.0e-3,
            "l_f": 120.0e-3,
            "l_m": 15.0e-3,
            "p": 3.0,
            "omega_el": 2.0 * 3.141592653589793 * 50.0,  # electrical rad/s, frozen
        }

    @dataclass
    class PhysicalState:
        """Physical state of the machine."""

        i_d: object
        i_q: object
        i_f: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class StaticParams:
        """Electrical parameters (``omega_el``: frozen electrical speed)."""

        r_s: object
        r_f: object
        l_d: object
        l_q: object
        l_f: object
        l_m: object
        p: object
        omega_el: object

    @dataclass
    class Action:
        """Stator dq voltages and the field voltage."""

        u_d: object
        u_q: object
        u_f: object

    def _ode(self, t, y, args, action):
        i_d, i_q, i_f = y
        params = args
        u = action(t)
        det = params.l_d * params.l_f - params.l_m * params.l_m
        p_d = u[0] - params.r_s * i_d + params.omega_el * params.l_q * i_q
        p_q = u[1] - params.r_s * i_q - params.omega_el * (params.l_d * i_d + params.l_m * i_f)
        p_f = u[2] - params.r_f * i_f
        d_i_d = (params.l_f * p_d - params.l_m * p_f) / det
        d_i_q = p_q / params.l_q
        d_i_f = (params.l_d * p_f - params.l_m * p_d) / det
        return d_i_d, d_i_q, d_i_f

    def torque(self, state, env_properties=None):
        """Electromagnetic torque of (a batch of) states:
        ``1.5 p (l_m i_f i_q + (l_d - l_q) i_d i_q)``, the excitation plus
        the reluctance component."""
        params = (env_properties or self.env_properties).static_params
        phys = state.physical_state
        return 1.5 * params.p * (params.l_m * phys.i_f * phys.i_q + (params.l_d - params.l_q) * phys.i_d * phys.i_q)
