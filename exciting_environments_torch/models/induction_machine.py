"""Squirrel-cage induction machine, stationary-frame dq model (counterpart of
``exciting_environments_tpu/models/induction_machine.py``).

At frozen electrical rotor speed ``omega`` the current and flux dynamics are
a linear ODE:

    sigma L_s di_s/dt = u_s - R_sig i_s + (L_m R_r / L_r^2) psi_r - j omega (L_m / L_r) psi_r
    dpsi_r/dt         = (R_r / L_r) (L_m i_s - psi_r) + j omega psi_r

written out in real d/q components, with ``sigma L_s = L_s - L_m^2 / L_r``
and ``R_sig = R_s + (L_m / L_r)^2 R_r``.  Default parameters model a small
industrial two-pole-pair machine (R_s = 2.9 Ohm, R_r = 2.3 Ohm, L_m = 225
mH, L_s = L_r = 236 mH).  ``u_dc=`` limits the stator voltage to the
inscribed circle of the inverter's hexagon (:func:`~exciting_environments_torch.core.classic.svm_circle`).
"""

from __future__ import annotations

from exciting_environments_torch.core.classic import ClassicODEEnvironment, svm_circle
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.utils import MinMaxNormalization


class InductionMachine(ClassicODEEnvironment):
    """
    State Variables:
        ``['i_sd', 'i_sq', 'psi_rd', 'psi_rq']``: stator currents and rotor
        flux linkages in the stationary dq (alpha/beta) frame.

    Action Variables:
        ``['u_sd', 'u_sq']``: stator voltages in the same frame.

    Initial State:
        Unless chosen otherwise, all zeros.

    Dynamics (``omega`` the electrical rotor speed, a frozen static
    parameter; ``k_r = L_m / L_r``):
        ``d_i_sd   = (u_sd - R_sig*i_sd + k_r*(R_r/L_r*psi_rd + omega*psi_rq)) / (sigma*L_s)``
        ``d_i_sq   = (u_sq - R_sig*i_sq + k_r*(R_r/L_r*psi_rq - omega*psi_rd)) / (sigma*L_s)``
        ``d_psi_rd = R_r/L_r*(L_m*i_sd - psi_rd) - omega*psi_rq``
        ``d_psi_rq = R_r/L_r*(L_m*i_sq - psi_rq) + omega*psi_rd``
    """

    _default_batch_size = 8
    _default_tau = 1e-4
    _ode_state_fields = ("i_sd", "i_sq", "psi_rd", "psi_rq")
    _angle_fields = ()
    _sincos_reward_fields = ()
    _soft_constrained_fields = ("i_sd", "i_sq", "psi_rd", "psi_rq")
    _default_init_norm = {"i_sd": 0.0, "i_sq": 0.0, "psi_rd": 0.0, "psi_rq": 0.0}
    _kernel_env_id = 6
    _kernel_params = ("r_s", "r_r", "l_m", "l_s", "l_r", "p", "omega")

    def __init__(self, *args, u_dc: float = None, **kwargs):
        """All :class:`ClassicODEEnvironment` arguments, plus:

        Args:
            u_dc: optional DC-link voltage [V]: the physical ``(u_sd, u_sq)``
                command is then limited to the circle ``|u_s| <= u_dc /
                sqrt(3)`` (the linear region of space-vector modulation) on
                every path, the kernels included.  Default ``None``: no
                constraint.
        """
        super().__init__(*args, **kwargs)
        if u_dc is not None:
            self._u_dc = float(u_dc)
            self._constrain_action_tuple = svm_circle(self._u_dc)

    @classmethod
    def _default_physical_normalizations(cls):
        return {
            "i_sd": MinMaxNormalization(min=-20.0, max=20.0),
            "i_sq": MinMaxNormalization(min=-20.0, max=20.0),
            "psi_rd": MinMaxNormalization(min=-1.5, max=1.5),
            "psi_rq": MinMaxNormalization(min=-1.5, max=1.5),
        }

    @classmethod
    def _default_action_normalizations(cls):
        # one inverter-leg amplitude per axis (400 V DC link, ~325 V peak phase)
        return {
            "u_sd": MinMaxNormalization(min=-325.0, max=325.0),
            "u_sq": MinMaxNormalization(min=-325.0, max=325.0),
        }

    @classmethod
    def _default_static_params(cls):
        return {
            "r_s": 2.9,
            "r_r": 2.3,
            "l_m": 0.225,
            "l_s": 0.236,
            "l_r": 0.236,
            "p": 2.0,
            "omega": 2.0 * 3.141592653589793 * 48.0,  # electrical rad/s, frozen
        }

    @dataclass
    class PhysicalState:
        """Physical state of the machine."""

        i_sd: object
        i_sq: object
        psi_rd: object
        psi_rq: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class StaticParams:
        """Electrical parameters (``omega``: frozen electrical speed)."""

        r_s: object
        r_r: object
        l_m: object
        l_s: object
        l_r: object
        p: object
        omega: object

    @dataclass
    class Action:
        """Stator voltage command in the stationary dq frame."""

        u_sd: object
        u_sq: object

    def _ode(self, t, y, args, action):
        i_sd, i_sq, psi_rd, psi_rq = y
        params = args
        u = action(t)
        k_r = params.l_m / params.l_r
        r_over_l = params.r_r / params.l_r
        sigma_l_s = params.l_s - params.l_m * k_r  # sigma * L_s
        r_sig = params.r_s + k_r * k_r * params.r_r
        d_i_sd = (u[0] - r_sig * i_sd + k_r * (r_over_l * psi_rd + params.omega * psi_rq)) / sigma_l_s
        d_i_sq = (u[1] - r_sig * i_sq + k_r * (r_over_l * psi_rq - params.omega * psi_rd)) / sigma_l_s
        d_psi_rd = r_over_l * (params.l_m * i_sd - psi_rd) - params.omega * psi_rq
        d_psi_rq = r_over_l * (params.l_m * i_sq - psi_rq) + params.omega * psi_rd
        return d_i_sd, d_i_sq, d_psi_rd, d_psi_rq

    def torque(self, state, env_properties=None):
        """Electromagnetic torque of (a batch of) states:
        ``1.5 p (L_m/L_r) (psi_rd i_sq - psi_rq i_sd)``."""
        params = (env_properties or self.env_properties).static_params
        phys = state.physical_state
        return 1.5 * params.p * (params.l_m / params.l_r) * (phys.psi_rd * phys.i_sq - phys.psi_rq * phys.i_sd)
