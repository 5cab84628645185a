"""Sensorless current control of the PMSM drive inside the closed-loop kernel
(counterpart of the PMSM tiles of ``exciting_environments_tpu/utils/foc.py``).

Two policy families of ``csrc/pmsm_closed_loop.cu``, each a
:class:`~exciting_environments_torch.ops.policies.KernelPolicy` whose
``forward`` follows the JAX tile operation for operation:

* :func:`make_pmsm_sensorless_current_tile` (:class:`SensorlessPolicy`): a
  stationary Kalman current observer on the noisy normalized current
  measurements and a decoupled PI on its belief, for the LINEAR-magnetics
  drive, whose current subsystem at frozen speed is affine;
* :func:`make_pmsm_saturated_sensorless_current_tile`
  (:class:`ScheduledSensorlessPolicy`): the gain-scheduled observer and PI of
  the SATURATED drive, whose Kalman gains and magnetics the closed loop
  gathers from a :class:`~exciting_environments_torch.ops.lut.ScheduledLUT`
  at the belief currents every step.

The tile factories linearize with ``torch.func`` in float64 on the CPU and iterate
the Riccati equation in numpy float64, as the JAX package's factories do.  The
observer's process and sensor levels are the drive's own ``process_noise`` and
``observation_noise``, each field overridable by ``process_std=`` and
``measurement_std=`` as in the JAX package; a noisy drive's closed loop streams
its draws into the kernel (``PMSM.fused_closed_loop``).  The induction-machine
and EESM tiles wait for those environments.
"""

from __future__ import annotations

import numpy as np
import torch

from exciting_environments_torch.ops.kernels.stepper import _lincomb, _stage_rows
from exciting_environments_torch.ops.lut import ScheduledLUT, bilinear_gather
from exciting_environments_torch.ops.policies import KernelPolicy, KernelSpec

_SENSOR_LEVELS = (
    "the observer needs current-sensor noise levels: configure observation_noise={'i_d': ..., 'i_q': ...} "
    "on the model or pass measurement_std"
)


def _vector_scale(u_d, u_q, u_lim):
    """The inscribed-circle vector limit's scale
    ``min(1, u_lim / max(|u|, 1e-9))``."""
    u_mag = torch.sqrt(u_d * u_d + u_q * u_q)
    return torch.clamp(u_lim / torch.clamp(u_mag, min=1e-9), max=1.0)


class _SensorlessBase(KernelPolicy):
    """A sensorless tile: Python-float constants, ``n_obs`` observation
    columns, and (``delayed``, deadtime 1) the previous command carried as
    two extra leaves.  ``SLOTS`` names the flat vector's entries in the
    order of the functor's enum in ``csrc/pmsm_closed_loop.cu``."""

    SLOTS: tuple = ()

    def __init__(self, consts: dict, n_obs: int, delayed: bool):
        super().__init__()
        self.consts = dict(consts)
        self.n_obs = int(n_obs)
        self.delayed = bool(delayed)
        self.n_carry = 6 if self.delayed else 4

    def _slot_values(self) -> dict:
        raise NotImplementedError

    def kernel_spec(self, dtype, device, params=None) -> KernelSpec:
        if params is not None:
            raise ValueError(f"{type(self).__name__} takes no policy_params")
        values = self._slot_values()
        flat = torch.tensor([values[name] for name in self.SLOTS], dtype=torch.float64)
        return KernelSpec(self.policy_id, self.n_obs, {"delayed": int(self.delayed)},
                          flat.to(dtype=dtype, device=device).contiguous())

    def extra_repr(self) -> str:
        return f"n_obs={self.n_obs}, delayed={self.delayed}"


class SensorlessPolicy(_SensorlessBase):
    """The tile of :func:`make_pmsm_sensorless_current_tile`: carry = the
    normalized belief ``(i_d, i_q)``, the PI integrators [V] and (delayed)
    the previous normalized command."""

    policy_id = 2
    SLOTS = ("K00", "K01", "K10", "K11", "A00", "A01", "A10", "A11", "B00", "B01", "B10", "B11", "C0", "C1",
             "SPAN_D", "MN_D", "SPAN_Q", "MN_Q", "REF_D", "REF_Q", "KP_D", "KP_Q", "FF_D", "FF_Q", "W_LQ",
             "OMEGA", "L_D", "PSI_P", "U_LIM", "KITAU_D", "KITAU_Q", "AW_D", "AW_Q", "AMN_D", "AINV_D", "AMN_Q",
             "AINV_Q")

    def _slot_values(self):
        c = self.consts
        K, A, B, c_l = c["K"], c["A"], c["B"], c["c"]
        return {
            "K00": K[0][0], "K01": K[0][1], "K10": K[1][0], "K11": K[1][1],
            "A00": A[0][0], "A01": A[0][1], "A10": A[1][0], "A11": A[1][1],
            "B00": B[0][0], "B01": B[0][1], "B10": B[1][0], "B11": B[1][1],
            "C0": c_l[0], "C1": c_l[1],
            "SPAN_D": c["mx_d"] - c["mn_d"], "MN_D": c["mn_d"], "SPAN_Q": c["mx_q"] - c["mn_q"], "MN_Q": c["mn_q"],
            "REF_D": c["i_d_ref"], "REF_Q": c["i_q_ref"], "KP_D": c["kp_d"], "KP_Q": c["kp_q"],
            "FF_D": c["r_s"] * c["i_d_ref"], "FF_Q": c["r_s"] * c["i_q_ref"], "W_LQ": c["omega_el"] * c["l_q"],
            "OMEGA": c["omega_el"], "L_D": c["l_d"], "PSI_P": c["psi_p"], "U_LIM": c["u_lim"],
            "KITAU_D": c["ki_d"] * c["tau"], "KITAU_Q": c["ki_q"] * c["tau"],
            "AW_D": c["tau"] * c["ki_d"] / c["kp_d"], "AW_Q": c["tau"] * c["ki_q"] / c["kp_q"],
            "AMN_D": c["amn_d"], "AINV_D": 1.0 / (c["amx_d"] - c["amn_d"]),
            "AMN_Q": c["amn_q"], "AINV_Q": 1.0 / (c["amx_q"] - c["amn_q"]),
        }

    def forward(self, obs, t, carry, params=None):
        c = self.consts
        K, A_l, B_l, c_l = c["K"], c["A"], c["B"], c["c"]
        mn_d, mx_d, mn_q, mx_q = c["mn_d"], c["mx_d"], c["mn_q"], c["mx_q"]
        amn_d, amx_d, amn_q, amx_q = c["amn_d"], c["amx_d"], c["amn_q"], c["amx_q"]
        i_d_ref, i_q_ref, r_s, omega_el = c["i_d_ref"], c["i_q_ref"], c["r_s"], c["omega_el"]
        kp_d, kp_q, ki_d, ki_q, tau = c["kp_d"], c["kp_q"], c["ki_d"], c["ki_q"], c["tau"]
        l_d, l_q, psi_p = c["l_d"], c["l_q"], c["psi_p"]
        xh_d, xh_q, int_d, int_q = carry[:4]
        # assimilate the noisy normalized current measurements
        in_d = obs[0] - xh_d
        in_q = obs[1] - xh_q
        xc_d = xh_d + K[0][0] * in_d + K[0][1] * in_q
        xc_q = xh_q + K[1][0] * in_d + K[1][1] * in_q
        i_d = (xc_d + 1.0) / 2.0 * (mx_d - mn_d) + mn_d
        i_q = (xc_q + 1.0) / 2.0 * (mx_q - mn_q) + mn_q
        # decoupled PI on the belief
        e_d = i_d_ref - i_d
        e_q = i_q_ref - i_q
        u_d_unsat = kp_d * e_d + int_d + r_s * i_d_ref - omega_el * l_q * i_q
        u_q_unsat = kp_q * e_q + int_q + r_s * i_q_ref + omega_el * (l_d * i_d + psi_p)
        scale = _vector_scale(u_d_unsat, u_q_unsat, c["u_lim"])
        u_d = u_d_unsat * scale
        u_q = u_q_unsat * scale
        int_d1 = int_d + ki_d * tau * e_d + (tau * ki_d / kp_d) * (u_d - u_d_unsat)
        int_q1 = int_q + ki_q * tau * e_q + (tau * ki_q / kp_q) * (u_q - u_q_unsat)
        a_d = 2.0 * (u_d - amn_d) / (amx_d - amn_d) - 1.0
        a_q = 2.0 * (u_q - amn_q) / (amx_q - amn_q) - 1.0
        # the voltage applied this step is the previous command under deadtime
        ap_d, ap_q = (carry[4], carry[5]) if self.delayed else (a_d, a_q)
        xn_d = c_l[0] + A_l[0][0] * xc_d + A_l[0][1] * xc_q + B_l[0][0] * ap_d + B_l[0][1] * ap_q
        xn_q = c_l[1] + A_l[1][0] * xc_d + A_l[1][1] * xc_q + B_l[1][0] * ap_d + B_l[1][1] * ap_q
        new_carry = (xn_d, xn_q, int_d1, int_q1) + ((a_d, a_q) if self.delayed else ())
        return (a_d, a_q), new_carry


class ScheduledSensorlessPolicy(_SensorlessBase):
    """The tile of :func:`make_pmsm_saturated_sensorless_current_tile`: it
    reads the ten scheduled channels (six magnetics maps, four Kalman gains)
    after the ``n_base`` standard columns; carry as :class:`SensorlessPolicy`."""

    policy_id = 3
    SLOTS = ("SPAN_D", "MN_D", "SPAN_Q", "MN_Q", "BANDWIDTH", "INV_TI", "REF_D", "REF_Q", "FF_D", "FF_Q", "OMEGA",
             "U_LIM", "TAU", "TAU_TI", "AMN_D", "AINV_D", "AMN_Q", "AINV_Q", "ASPAN_D", "ASPAN_Q", "R_S",
             "INV_SPAN_D", "INV_SPAN_Q")

    def _slot_values(self):
        c = self.consts
        return {
            "SPAN_D": c["mx_d"] - c["mn_d"], "MN_D": c["mn_d"], "SPAN_Q": c["mx_q"] - c["mn_q"], "MN_Q": c["mn_q"],
            "BANDWIDTH": c["bandwidth"], "INV_TI": 1.0 / c["t_i"], "REF_D": c["i_d_ref"], "REF_Q": c["i_q_ref"],
            "FF_D": c["r_s"] * c["i_d_ref"], "FF_Q": c["r_s"] * c["i_q_ref"], "OMEGA": c["omega_el"],
            "U_LIM": c["u_lim"], "TAU": c["tau"], "TAU_TI": c["tau"] / c["t_i"],
            "AMN_D": c["amn_d"], "AINV_D": 1.0 / (c["amx_d"] - c["amn_d"]),
            "AMN_Q": c["amn_q"], "AINV_Q": 1.0 / (c["amx_q"] - c["amn_q"]),
            "ASPAN_D": c["amx_d"] - c["amn_d"], "ASPAN_Q": c["amx_q"] - c["amn_q"], "R_S": c["r_s"],
            "INV_SPAN_D": 1.0 / (c["mx_d"] - c["mn_d"]), "INV_SPAN_Q": 1.0 / (c["mx_q"] - c["mn_q"]),
        }

    def forward(self, obs, t, carry, params=None):
        c = self.consts
        mn_d, mx_d, mn_q, mx_q = c["mn_d"], c["mx_d"], c["mn_q"], c["mx_q"]
        amn_d, amx_d, amn_q, amx_q = c["amn_d"], c["amx_d"], c["amn_q"], c["amx_q"]
        i_d_ref, i_q_ref, r_s, omega_el = c["i_d_ref"], c["i_q_ref"], c["r_s"], c["omega_el"]
        bandwidth, t_i, tau = c["bandwidth"], c["t_i"], c["tau"]
        n_base = self.n_obs - 10
        xh_d, xh_q, int_d, int_q = carry[:4]
        (l_dd, l_dq, l_qd, l_qq, psi_d, psi_q, k00, k01, k10, k11) = obs[n_base : n_base + 10]
        # 1. assimilate with the operating-point gains
        in_d = obs[0] - xh_d
        in_q = obs[1] - xh_q
        xc_d = xh_d + k00 * in_d + k01 * in_q
        xc_q = xh_q + k10 * in_d + k11 * in_q
        i_d = (xc_d + 1.0) / 2.0 * (mx_d - mn_d) + mn_d
        i_q = (xc_q + 1.0) / 2.0 * (mx_q - mn_q) + mn_q
        # 2. constant-bandwidth PI with the saturated back-EMF feedforward
        kp_d = bandwidth * l_dd
        kp_q = bandwidth * l_qq
        ki_d = kp_d / t_i
        ki_q = kp_q / t_i
        e_d = i_d_ref - i_d
        e_q = i_q_ref - i_q
        u_d_unsat = kp_d * e_d + int_d + r_s * i_d_ref - omega_el * psi_q
        u_q_unsat = kp_q * e_q + int_q + r_s * i_q_ref + omega_el * psi_d
        # 3. inscribed-circle vector limit, back-calculation anti-windup
        scale = _vector_scale(u_d_unsat, u_q_unsat, c["u_lim"])
        u_d = u_d_unsat * scale
        u_q = u_q_unsat * scale
        int_d1 = int_d + ki_d * tau * e_d + (tau / t_i) * (u_d - u_d_unsat)
        int_q1 = int_q + ki_q * tau * e_q + (tau / t_i) * (u_q - u_q_unsat)
        a_d = 2.0 * (u_d - amn_d) / (amx_d - amn_d) - 1.0
        a_q = 2.0 * (u_q - amn_q) / (amx_q - amn_q) - 1.0
        ap_d, ap_q = (carry[4], carry[5]) if self.delayed else (a_d, a_q)
        # 4. predict: one Euler step of the saturated ODE with the gathered
        # channels at the applied (inscribed-circle, hence unconstrained) voltage
        u_ap_d = (ap_d + 1.0) / 2.0 * (amx_d - amn_d) + amn_d
        u_ap_q = (ap_q + 1.0) / 2.0 * (amx_q - amn_q) + amn_q
        det = l_dd * l_qq - l_dq * l_qd
        inv_dd, inv_dq = l_qq / det, -l_dq / det
        inv_qd, inv_qq = -l_qd / det, l_dd / det
        rhs_d = u_ap_d - r_s * i_d + omega_el * psi_q
        rhs_q = u_ap_q - r_s * i_q - omega_el * psi_d
        i_d1 = i_d + tau * (inv_dd * rhs_d + inv_dq * rhs_q)
        i_q1 = i_q + tau * (inv_qd * rhs_d + inv_qq * rhs_q)
        xn_d = 2.0 * (i_d1 - mn_d) / (mx_d - mn_d) - 1.0
        xn_q = 2.0 * (i_q1 - mn_q) / (mx_q - mn_q) - 1.0
        new_carry = (xn_d, xn_q, int_d1, int_q1) + ((a_d, a_q) if self.delayed else ())
        return (a_d, a_q), new_carry


# ---------------------------------------------------------------------------
# the tile factories
# ---------------------------------------------------------------------------


def _scalar_props(model, names, who):
    """The named static parameters as Python floats; per-batch ones refuse."""
    out = []
    for name in names:
        v = getattr(model.env_properties.static_params, name)
        if isinstance(v, torch.Tensor) and v.ndim != 0:
            raise ValueError(f"{who} needs scalar static params; {name} has shape {tuple(v.shape)}")
        out.append(float(v))
    return out


def _spans(model, who):
    """Scalar observation and action bands ``(spans, aspans)``."""
    props = model.env_properties
    pn, an = props.physical_normalizations, props.action_normalizations
    try:
        spans = {n: (float(getattr(pn, n).min), float(getattr(pn, n).max)) for n in ("i_d", "i_q", "omega_el")}
        aspans = {n: (float(getattr(an, n).min), float(getattr(an, n).max)) for n in ("u_d", "u_q")}
    except (TypeError, ValueError, RuntimeError) as e:
        raise ValueError(f"{who} needs scalar normalizations (the tile folds them into the program)") from e
    return spans, aspans


def _noise_levels(model, process_std, measurement_std):
    """The observer's ``{"i_d", "i_q"}`` levels: the model's noise options,
    overridden field by field by the explicit arguments."""
    pnoise = dict(model._process_noise or {})
    pnoise.update(process_std or {})
    mnoise = dict(model._observation_noise or {})
    mnoise.update(measurement_std or {})
    if not ("i_d" in mnoise and "i_q" in mnoise):
        raise ValueError(_SENSOR_LEVELS)
    return pnoise, mnoise


def _qr(spans, pnoise, mnoise, tau, q_floor):
    (mn_d, mx_d), (mn_q, mx_q) = spans["i_d"], spans["i_q"]
    s_d = 2.0 / (mx_d - mn_d)
    s_q = 2.0 / (mx_q - mn_q)
    Q = np.diag([
        (s_d * pnoise.get("i_d", 0.0) * np.sqrt(tau)) ** 2 + q_floor,
        (s_q * pnoise.get("i_q", 0.0) * np.sqrt(tau)) ** 2 + q_floor,
    ])
    R = np.diag([(s_d * mnoise["i_d"]) ** 2, (s_q * mnoise["i_q"]) ** 2])
    return Q, R


def _rk_step(ode, solver, y, u, tau):
    """One explicit RK step of ``ode(y, u)`` with the solvers' term order
    (zero weights skipped, unit weights not multiplied)."""
    a_rows, b = _stage_rows(solver)
    ks = [ode(y, u)]
    for row in a_rows:
        yi = tuple(_lincomb(yl, [k[j] for k in ks], row, tau) for j, yl in enumerate(y))
        ks.append(ode(yi, u))
    return tuple(_lincomb(yl, [k[j] for k in ks], b, tau) for j, yl in enumerate(y))


def _carry0(model, spans, aspans, deadtime):
    """Initial belief at the normalized 0 A, zero integrators and (deadtime)
    the reset buffer's 0 V as the previous normalized command."""
    (mn_d, mx_d), (mn_q, mx_q) = spans["i_d"], spans["i_q"]
    (amn_d, amx_d), (amn_q, amx_q) = aspans["u_d"], aspans["u_q"]
    full = lambda v: torch.full((model.batch_size,), float(v), dtype=model.dtype, device=model.device)
    carry0 = (full(2.0 * (0.0 - mn_d) / (mx_d - mn_d) - 1.0), full(2.0 * (0.0 - mn_q) / (mx_q - mn_q) - 1.0),
              full(0.0), full(0.0))
    if deadtime:
        carry0 += (full(2.0 * (0.0 - amn_d) / (amx_d - amn_d) - 1.0), full(2.0 * (0.0 - amn_q) / (amx_q - amn_q) - 1.0))
    return carry0


def _u_lim(aspans, u_dc):
    # hexagon inscribed circle: |u_dq| <= u_dc / sqrt(3) keeps the inverter
    # constraint inactive (command == applied voltage)
    u_max_d = min(abs(aspans["u_d"][0]), abs(aspans["u_d"][1]))
    u_max_q = min(abs(aspans["u_q"][0]), abs(aspans["u_q"][1]))
    return min(u_max_d, u_max_q, float(u_dc) / float(np.sqrt(3.0)))


def make_pmsm_sensorless_current_tile(model, *, i_d_ref: float, i_q_ref: float, omega_el: float = None,
                                      kp_d: float = None, kp_q: float = None, ki_d: float = None,
                                      ki_q: float = None, process_std: dict = None, measurement_std: dict = None,
                                      q_floor: float = 1e-6):
    """Sensorless current control of the LINEAR-magnetics PMSM drive inside
    the closed-loop kernel: a stationary Kalman current observer and a
    decoupled PI on its belief (``utils/foc.py:634`` of the JAX package).

    At frozen electrical speed the linear current subsystem is affine: one
    solver step of it, folded into normalized coordinates, is extracted with
    ``torch.func.jacrev`` in float64 (exact for any explicit RK method) and
    the Riccati recursion collapses to one gain.  The PI is limited to the
    hexagon's inscribed circle, where the inverter constraint is inactive,
    and under deadtime the previous command is carried.

    Args:
        model: a linear-magnetics PMSM with scalar properties, ``deadtime``
            in {0, 1}.
        i_d_ref, i_q_ref: current setpoints [A].
        omega_el: the frozen electrical speed [rad/s] (default mid-band).
        kp_d, kp_q, ki_d, ki_q: PI gains (default about 2 krad/s and an
            integral time of 5 ms).
        process_std, measurement_std: per-field overrides [physical units]
            of the model's ``process_noise``/``observation_noise``, the
            observer's Q and R; sensor levels for ``i_d`` and ``i_q`` are
            required from one or the other.
        q_floor: diagonal process-covariance floor (normalized units^2).

    Returns:
        ``(policy, carry0)``: a :class:`SensorlessPolicy` and its carry, the
        normalized belief, the integrators and (deadtime) the previous
        command, ``(B,)`` each in the model's dtype and device.
    """
    who = "make_pmsm_sensorless_current_tile"
    props = model.env_properties
    if bool(props.saturated):
        raise ValueError(
            "make_pmsm_sensorless_current_tile covers the LINEAR-magnetics drive only: with LUT saturation "
            "the differential inductance varies >3x over the operating range (BRUSA map), so no single "
            "stationary gain is uniformly correct - use make_pmsm_saturated_sensorless_current_tile, whose "
            "LUT-gathered gain SCHEDULE runs the required per-operating-point retuning fully in-kernel"
        )
    r_s, l_d, l_q, psi_p, u_dc, deadtime = _scalar_props(model, ("r_s", "l_d", "l_q", "psi_p", "u_dc", "deadtime"),
                                                         who)
    deadtime = int(deadtime)
    if deadtime not in (0, 1):
        raise ValueError("deadtime must be 0 or 1")
    tau = float(model.tau)
    spans, aspans = _spans(model, who)
    omega_el = float(0.5 * (spans["omega_el"][0] + spans["omega_el"][1]) if omega_el is None else omega_el)
    pnoise, mnoise = _noise_levels(model, process_std, measurement_std)
    solver = model._solver

    def ode(yy, act):
        i_d, i_q = yy
        return (
            (act[0] + omega_el * l_q * i_q - r_s * i_d) / l_d,
            (act[1] - omega_el * (l_d * i_d + psi_p) - r_s * i_q) / l_q,
        )

    def norm_map(v):
        x = tuple((v[i] + 1.0) / 2.0 * (mx - mn) + mn for i, (mn, mx) in enumerate((spans["i_d"], spans["i_q"])))
        u = tuple((v[2 + i] + 1.0) / 2.0 * (mx - mn) + mn for i, (mn, mx) in enumerate((aspans["u_d"], aspans["u_q"])))
        x1 = _rk_step(ode, solver, x, u, tau)
        return torch.stack([2.0 * (xi - mn) / (mx - mn) - 1.0 for xi, (mn, mx) in zip(x1, (spans["i_d"], spans["i_q"]))])

    v0 = torch.zeros(4, dtype=torch.float64)
    J = torch.func.jacrev(norm_map)(v0).numpy()
    c_n = norm_map(v0).numpy()
    A_n, B_n = J[:, :2], J[:, 2:]
    # linearity check at a probe: a nonlinear configuration must not slip through
    probe = np.array([0.31, -0.22, 0.17, -0.4])
    exact = norm_map(torch.as_tensor(probe)).numpy()
    tol = 1e4 * float(np.finfo(np.float64).eps)
    if not np.allclose(exact, c_n + J @ probe, rtol=tol, atol=tol):
        raise ValueError("PMSM current subsystem is not affine at this config")

    Q, R = _qr(spans, pnoise, mnoise, tau, q_floor)
    P = Q.copy()
    for _ in range(200_000):
        S = P + R
        Kp = P @ np.linalg.inv(S)
        P_next = A_n @ (P - Kp @ P) @ A_n.T + Q
        if np.max(np.abs(P_next - P)) < 1e-14:
            P = P_next
            break
        P = P_next
    else:
        raise ValueError(
            "stationary Riccati iteration did not converge to 1e-14 in 200000 steps - the Q/R configuration "
            "does not admit a stationary Kalman gain (check the noise levels and q_floor)"
        )
    K = P @ np.linalg.inv(P + R)

    kp_d = 2000.0 * l_d if kp_d is None else kp_d
    kp_q = 2000.0 * l_q if kp_q is None else kp_q
    ki_d = kp_d / 5e-3 if ki_d is None else ki_d
    ki_q = kp_q / 5e-3 if ki_q is None else ki_q
    (mn_d, mx_d), (mn_q, mx_q) = spans["i_d"], spans["i_q"]
    (amn_d, amx_d), (amn_q, amx_q) = aspans["u_d"], aspans["u_q"]
    consts = dict(
        K=[[float(v) for v in row] for row in K], A=[[float(v) for v in row] for row in A_n],
        B=[[float(v) for v in row] for row in B_n], c=[float(v) for v in c_n],
        mn_d=mn_d, mx_d=mx_d, mn_q=mn_q, mx_q=mx_q, amn_d=amn_d, amx_d=amx_d, amn_q=amn_q, amx_q=amx_q,
        i_d_ref=float(i_d_ref), i_q_ref=float(i_q_ref), r_s=r_s, omega_el=omega_el, l_d=l_d, l_q=l_q, psi_p=psi_p,
        kp_d=kp_d, kp_q=kp_q, ki_d=ki_d, ki_q=ki_q, tau=tau, u_lim=_u_lim(aspans, u_dc),
    )
    policy = SensorlessPolicy(consts, 8 + len(model.control_state), bool(deadtime))
    return policy, _carry0(model, spans, aspans, deadtime)


def make_pmsm_saturated_sensorless_current_tile(model, *, i_d_ref: float, i_q_ref: float, omega_el: float = None,
                                                bandwidth: float = 2000.0, t_i: float = 5e-3,
                                                process_std: dict = None, measurement_std: dict = None,
                                                q_floor: float = 1e-6, riccati_tol: float = 1e-13):
    """Gain-scheduled sensorless current control of the SATURATED PMSM drive
    inside the closed-loop kernel (``utils/foc.py:946`` of the JAX package).

    At every point of the drive's own LUT grid the normalized one-Euler-step
    current map is linearized through ``bilinear_gather`` (``torch.func.vjp``,
    float64) and the per-point stationary Riccati equation is iterated,
    giving four Kalman-gain maps on the magnetics grid.  Stacked with the six
    magnetics maps they form the :class:`ScheduledLUT` that the closed loop
    gathers at the belief currents every step; the tile assimilates with the
    gathered gains, runs a constant-bandwidth PI (``kp = bandwidth *
    L_diff``) with the saturated back-EMF feedforward, limits to the
    inscribed circle and predicts with one Euler step of the saturated ODE.

    Args:
        model: a saturated PMSM (LUT magnetics) with scalar properties,
            ``deadtime`` in {0, 1} and a one-stage solver.
        i_d_ref, i_q_ref: current setpoints [A].
        omega_el: frozen electrical speed [rad/s] (default mid-band).
        bandwidth: current-loop bandwidth [rad/s].
        t_i: PI integral time [s].
        process_std, measurement_std: observer noise levels, as in
            :func:`make_pmsm_sensorless_current_tile`.
        q_floor: diagonal process-covariance floor (normalized units^2).
        riccati_tol: per-grid-point fixed-point tolerance.

    Returns:
        ``(policy, carry0, sched_lut)``: pass all three to the closed loop
        (``policy_carry=carry0, sched_lut=sched_lut``); the carry is as in
        :func:`make_pmsm_sensorless_current_tile` and
        ``sched_lut.carry_idx == (0, 1)``.
    """
    who = "make_pmsm_saturated_sensorless_current_tile"
    props = model.env_properties
    if not bool(props.saturated) or model._lut is None:
        raise ValueError(
            "make_pmsm_saturated_sensorless_current_tile covers the LUT-magnetics drive; for linear magnetics "
            "use make_pmsm_sensorless_current_tile (one exact stationary gain, no gather needed)"
        )
    if not model._solver.one_stage:
        raise ValueError(
            "the gain schedule's per-point linearization and the tile's in-kernel predict are one Euler step "
            "of the saturated ODE - construct the drive with the one-stage default solver"
        )
    r_s, u_dc, deadtime = _scalar_props(model, ("r_s", "u_dc", "deadtime"), who)
    deadtime = int(deadtime)
    if deadtime not in (0, 1):
        raise ValueError("deadtime must be 0 or 1")
    tau = float(model.tau)
    lut = model._lut
    lut_vals = lut.values.detach().cpu().to(torch.float64)
    spans, aspans = _spans(model, who)
    omega_el = float(0.5 * (spans["omega_el"][0] + spans["omega_el"][1]) if omega_el is None else omega_el)
    pnoise, mnoise = _noise_levels(model, process_std, measurement_std)
    (mn_d, mx_d), (mn_q, mx_q) = spans["i_d"], spans["i_q"]

    def phys_f(i_d, i_q, u_d, u_q):
        vals = bilinear_gather(lut_vals, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, i_d, i_q)
        l_dd, l_dq, l_qd, l_qq, psi_d, psi_q = (vals[c] for c in range(6))
        det = l_dd * l_qq - l_dq * l_qd
        inv_dd, inv_dq = l_qq / det, -l_dq / det
        inv_qd, inv_qq = -l_qd / det, l_dd / det
        rhs_d = u_d - r_s * i_d + omega_el * psi_q
        rhs_q = u_q - r_s * i_q - omega_el * psi_d
        return (inv_dd * rhs_d + inv_dq * rhs_q, inv_qd * rhs_d + inv_qq * rhs_q)

    def norm_step(xn):  # (N, 2) -> (N, 2), pointwise
        i_d = (xn[:, 0] + 1.0) / 2.0 * (mx_d - mn_d) + mn_d
        i_q = (xn[:, 1] + 1.0) / 2.0 * (mx_q - mn_q) + mn_q
        f_d, f_q = phys_f(i_d, i_q, 0.0, 0.0)
        i_d1 = i_d + tau * f_d
        i_q1 = i_q + tau * f_q
        return torch.stack([2.0 * (i_d1 - mn_d) / (mx_d - mn_d) - 1.0, 2.0 * (i_q1 - mn_q) / (mx_q - mn_q) - 1.0],
                           dim=-1)

    gx = np.asarray(lut.x0) + np.asarray(lut.dx) * np.arange(lut.nx)
    gy = np.asarray(lut.y0) + np.asarray(lut.dy) * np.arange(lut.ny)
    gdn = 2.0 * (gx - mn_d) / (mx_d - mn_d) - 1.0
    gqn = 2.0 * (gy - mn_q) / (mx_q - mn_q) - 1.0
    pts = torch.as_tensor(np.stack([np.repeat(gdn, lut.ny), np.tile(gqn, lut.nx)], axis=-1))  # x-major
    # the map is pointwise, so one pullback per output row gives that row of
    # every point's 2x2 Jacobian
    _, pullback = torch.func.vjp(norm_step, pts)
    rows = []
    for i in range(2):
        e = torch.zeros_like(pts)
        e[:, i] = 1.0
        rows.append(pullback(e)[0])
    A = torch.stack(rows, dim=1).numpy()  # (N, 2, 2): A[n, i, j] = d out_i / d in_j

    Q, R = _qr(spans, pnoise, mnoise, tau, q_floor)

    def inv2(M):
        a, b = M[:, 0, 0], M[:, 0, 1]
        c, d = M[:, 1, 0], M[:, 1, 1]
        det = a * d - b * c
        out = np.empty_like(M)
        out[:, 0, 0] = d / det
        out[:, 0, 1] = -b / det
        out[:, 1, 0] = -c / det
        out[:, 1, 1] = a / det
        return out

    N = A.shape[0]
    At = np.transpose(A, (0, 2, 1))
    P = np.broadcast_to(Q, (N, 2, 2)).copy()
    for _ in range(200_000):
        Kp = P @ inv2(P + R[None])
        P_next = A @ (P - Kp @ P) @ At + Q
        if np.max(np.abs(P_next - P)) < riccati_tol:
            P = P_next
            break
        P = P_next
    else:
        raise ValueError(
            "per-grid-point stationary Riccati iteration did not converge - the Q/R configuration does not "
            "admit stationary gains on this operating range (check the noise levels and q_floor)"
        )
    K = P @ inv2(P + R[None])  # (N, 2, 2), normalized-coordinate gains
    k_maps = K.reshape(lut.nx, lut.ny, 2, 2).transpose(2, 3, 0, 1).reshape(4, lut.nx, lut.ny)
    sched_lut = ScheduledLUT(np.concatenate([lut_vals.numpy(), k_maps], axis=0), carry_idx=(0, 1))

    (amn_d, amx_d), (amn_q, amx_q) = aspans["u_d"], aspans["u_q"]
    consts = dict(
        mn_d=mn_d, mx_d=mx_d, mn_q=mn_q, mx_q=mx_q, amn_d=amn_d, amx_d=amx_d, amn_q=amn_q, amx_q=amx_q,
        i_d_ref=float(i_d_ref), i_q_ref=float(i_q_ref), r_s=r_s, omega_el=omega_el, bandwidth=float(bandwidth),
        t_i=float(t_i), tau=tau, u_lim=_u_lim(aspans, u_dc),
    )
    n_base = 8 + len(model.control_state)  # standard columns + tracked references
    policy = ScheduledSensorlessPolicy(consts, n_base + 10, bool(deadtime))
    return policy, _carry0(model, spans, aspans, deadtime), sched_lut
