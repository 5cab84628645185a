"""Drive control inside the closed-loop kernels (counterpart of
``exciting_environments_tpu/utils/foc.py``).

Two policy families of ``csrc/pmsm_closed_loop.cu`` for the PMSM drive, each
a :class:`~exciting_environments_torch.ops.policies.KernelPolicy` whose
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

The tile factories linearize with autograd in float64 on the CPU and iterate
the Riccati equation in numpy float64, as the JAX package's factories do.  The
observer's process and sensor levels are the drive's own ``process_noise`` and
``observation_noise``, each field overridable by ``process_std=`` and
``measurement_std=`` as in the JAX package; a noisy drive's closed loop streams
its draws into the kernel (``PMSM.fused_closed_loop``).

Three families of ``csrc/closed_loop.cu`` (functors in ``csrc/foc_laws.cuh``)
for the induction machine and the EESM:

* :func:`make_sensorless_foc` is the rotor-flux-oriented law of the
  induction machine over a belief state (flux orientation, a cascaded flux
  PI, magnetize-first torque gating, decoupled current PIs with
  back-calculation anti-windup, the voltage-vector limit), the controller
  that ``utils/ofc.py::run_output_feedback_controller`` runs on its EKF's
  belief;
  :func:`make_foc_tile` (:class:`FocPolicy`) runs it on the true state;
* :func:`make_sensorless_foc_tile` (:class:`SensorlessFocPolicy`) runs it on
  the belief of a stationary Kalman flux observer
  (``utils/estimate.py::stationary_kalman_gain``) that reads only the
  measured current columns;
* :func:`make_eesm_current_tile` (:class:`EesmCurrentPolicy`): the EESM's
  dq and field current PIs.

Each tile's ``forward`` is its plain version; on CUDA tensors the kernel
runs the functor, which folds the tile's Python-number constants into its
flat parameters.  The two FOC tiles also run a fleet whose drives each hold
their own operating point: a ``(B,)`` ``omega`` static parameter and a
``(B,)`` ``torque_ref`` reach the kernel as per-drive planes (with, for the
sensorless tile, one stationary Kalman filter per drive, at that drive's
speed), and every other constant stays folded.  Other per-batch constants
(``psi_ref``, field weakening at per-drive speeds, per-batch bands and
machine parameters) run through the plain tile on CPU tensors only.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops.kernels.stepper import _lincomb, _stage_rows
from exciting_environments_torch.ops.lut import ScheduledLUT, bilinear_gather
from exciting_environments_torch.ops.policies import KernelPolicy, KernelSpec, resolved_device
from exciting_environments_torch.utils.profiling import annotate

#: the stationary Kalman gains the tile factories solved in this process:
#: ``solves`` (one per tile, however many chunks it runs) and ``drives`` (the
#: instances they were solved for: one for a scalar solve, the fleet for a
#: per-drive one)
GAIN_SOLVES = {"solves": 0, "drives": 0}
#: the gain schedules the saturated tile factory solved in this process:
#: ``slices`` (one per distinct speed), ``points`` (grid points over those
#: slices) and ``drives`` (one for a scalar tile, the fleet for a per-drive
#: one)
SCHEDULE_SOLVES = {"slices": 0, "points": 0, "drives": 0}

_SENSOR_LEVELS = (
    "the observer needs current-sensor noise levels: configure observation_noise={'i_d': ..., 'i_q': ...} "
    "on the model or pass measurement_std"
)


def _vector_scale(u_d, u_q, u_lim):
    """The inscribed-circle vector limit's scale
    ``min(1, u_lim / max(|u|, 1e-9))``."""
    u_mag = torch.sqrt(u_d * u_d + u_q * u_q)
    return torch.clamp(u_lim / torch.clamp(u_mag, min=1e-9), max=1.0)


def _frozen(value):
    """``value`` with its lists as tuples: a constant held in a tile changes
    only by a set of one of the tile's attributes."""
    return tuple(_frozen(v) for v in value) if isinstance(value, (list, tuple)) else value


def _tokens(leaves) -> tuple:
    """``leaves`` as a packed spec's key compares them: a tensor by identity,
    ``_version`` and data pointer (the packed spec holds it, so no other
    tensor takes its identity), a Python number or tuple by value."""
    return tuple((id(t), t._version, t.data_ptr()) if isinstance(t, torch.Tensor) else t for t in leaves)


class _SlotTile(KernelPolicy):
    """A tile with Python-number constants and no ``policy_params``: its
    flat vector is ``SLOTS`` in order (the order of its functor's enum),
    valued by ``_slot_values()``, ``_options()`` gives its
    ``ClosedLoopArgs``/``PmsmClArgs`` fields and ``_planes()`` its per-drive
    planes (``PLANES`` in order), computed from the tensors of
    ``_plane_sources()``.

    The spec is packed once and handed out again while the working type,
    the device, the tile's constants and the plane sources (the same
    tensors, not written in place) stay as they were: a fleet loop's
    launches reuse it, and a constant changed between launches re-packs it
    (``spec_packs`` counts the packs).  Each launch checks this in O(1),
    without reading the slot values: every set of one of the tile's
    attributes counts in ``_edits``, its containers of constants are tuples,
    ``_constants()`` gives what it reads beyond its own attributes (a dict
    of constants' values, or a law's :meth:`FocLaw.constants`), compared by
    value, and ``_watched()`` the tensors it packs from, whose versions are
    compared (a counted set is the only way to replace one)."""

    SLOTS: tuple = ()
    #: the attributes whose sets change no constant
    _BOOKKEEPING = frozenset(("_packed", "_edits", "spec_packs"))

    def __init__(self):
        super().__init__()
        self.spec_packs = 0
        self._packed = None  # (key, (watched tensor, version, data pointer), spec)

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if name not in self._BOOKKEEPING:
            object.__setattr__(self, "_edits", self.__dict__.get("_edits", 0) + 1)

    def _slot_values(self) -> dict:
        raise NotImplementedError

    def _options(self) -> dict:
        return {}

    def _planes(self) -> tuple:
        return ()

    def _plane_sources(self) -> tuple:
        return ()

    def _constants(self) -> tuple:
        return ()

    def _watched(self) -> tuple:
        return self._plane_sources()

    def kernel_spec(self, dtype, device, params=None) -> KernelSpec:
        if params is not None:
            raise ValueError(f"{type(self).__name__} takes no policy_params")
        device = resolved_device(device)
        constants = self._constants()
        key = (dtype, device, self.__dict__.get("_edits", 0)) + _tokens(constants)
        packed = self._packed
        if packed is not None and packed[0] == key and all(
                t._version == version and t.data_ptr() == ptr for t, version, ptr in packed[1]):
            return packed[2]
        values = self._slot_values()
        flat = torch.tensor([float(values[name]) for name in self.SLOTS], dtype=torch.float64)
        planes = tuple(p.to(dtype=dtype, device=device).contiguous() for p in self._planes())
        spec = KernelSpec(self.policy_id, self.n_obs, self._options(),
                          flat.to(dtype=dtype, device=device).contiguous(), planes)
        watched = self._watched() + tuple(c for c in constants if isinstance(c, torch.Tensor))
        self._packed = (key, tuple((t, t._version, t.data_ptr()) for t in watched), spec)
        self.spec_packs += 1
        return spec

    def extra_repr(self) -> str:
        return f"n_obs={self.n_obs}"


class _SensorlessBase(_SlotTile):
    """A sensorless PMSM tile of ``csrc/pmsm_closed_loop.cu``: ``n_obs``
    observation columns and (``delayed``, deadtime 1) the previous command
    carried as two extra leaves."""

    def __init__(self, consts: dict, n_obs: int, delayed: bool):
        super().__init__()
        self.consts = {name: _frozen(v) for name, v in consts.items()}
        self.n_obs = int(n_obs)
        self.delayed = bool(delayed)
        self.n_carry = 6 if self.delayed else 4

    def _options(self):
        return {"delayed": int(self.delayed)}

    def _constants(self):
        return tuple(self.consts.values())

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
    after the ``n_base`` standard columns; carry as :class:`SensorlessPolicy`.

    Per drive (``per_drive``): the references ``i_d_ref``, ``i_q_ref``, the
    feedforwards ``ff_d = r_s * i_d_ref``, ``ff_q`` and ``omega_el`` are
    ``(B,)`` tensors, handed to the kernel as :data:`PLANES` (their slots
    hold 0.0), and the schedule is a per-drive :class:`ScheduledLUT`.  The
    tile holds its factory's schedule (``sched_lut``), which the closed loop
    gathers where it is given none."""

    policy_id = 3
    SLOTS = ("SPAN_D", "MN_D", "SPAN_Q", "MN_Q", "BANDWIDTH", "INV_TI", "REF_D", "REF_Q", "FF_D", "FF_Q", "OMEGA",
             "U_LIM", "TAU", "TAU_TI", "AMN_D", "AINV_D", "AMN_Q", "AINV_Q", "ASPAN_D", "ASPAN_Q", "R_S",
             "INV_SPAN_D", "INV_SPAN_Q")
    #: the per-drive tile's planes, in the order of ``ScheduledDriveLaw``'s
    PLANES = ("REF_D", "REF_Q", "FF_D", "FF_Q", "OMEGA")
    _PLANE_CONSTS = ("i_d_ref", "i_q_ref", "ff_d", "ff_q", "omega_el")

    def __init__(self, consts: dict, n_obs: int, delayed: bool, sched_lut: ScheduledLUT = None):
        super().__init__(consts, n_obs, delayed)
        self.per_drive = "ff_d" in self.consts
        self.sched_lut = sched_lut

    def _slot_values(self):
        c = self.consts
        out = {
            "SPAN_D": c["mx_d"] - c["mn_d"], "MN_D": c["mn_d"], "SPAN_Q": c["mx_q"] - c["mn_q"], "MN_Q": c["mn_q"],
            "BANDWIDTH": c["bandwidth"], "INV_TI": 1.0 / c["t_i"],
            "U_LIM": c["u_lim"], "TAU": c["tau"], "TAU_TI": c["tau"] / c["t_i"],
            "AMN_D": c["amn_d"], "AINV_D": 1.0 / (c["amx_d"] - c["amn_d"]),
            "AMN_Q": c["amn_q"], "AINV_Q": 1.0 / (c["amx_q"] - c["amn_q"]),
            "ASPAN_D": c["amx_d"] - c["amn_d"], "ASPAN_Q": c["amx_q"] - c["amn_q"], "R_S": c["r_s"],
            "INV_SPAN_D": 1.0 / (c["mx_d"] - c["mn_d"]), "INV_SPAN_Q": 1.0 / (c["mx_q"] - c["mn_q"]),
        }
        if self.per_drive:  # the functor reads these from the planes
            return {**out, **dict.fromkeys(self.PLANES, 0.0)}
        return {**out, "REF_D": c["i_d_ref"], "REF_Q": c["i_q_ref"], "FF_D": c["r_s"] * c["i_d_ref"],
                "FF_Q": c["r_s"] * c["i_q_ref"], "OMEGA": c["omega_el"]}

    def _planes(self):
        return self._plane_sources()

    def _plane_sources(self):
        return tuple(self.consts[n] for n in self._PLANE_CONSTS) if self.per_drive else ()

    def forward(self, obs, t, carry, params=None):
        c = self.consts
        mn_d, mx_d, mn_q, mx_q = c["mn_d"], c["mx_d"], c["mn_q"], c["mx_q"]
        amn_d, amx_d, amn_q, amx_q = c["amn_d"], c["amx_d"], c["amn_q"], c["amx_q"]
        i_d_ref, i_q_ref, r_s, omega_el = c["i_d_ref"], c["i_q_ref"], c["r_s"], c["omega_el"]
        bandwidth, t_i, tau = c["bandwidth"], c["t_i"], c["tau"]
        ff_d, ff_q = (c["ff_d"], c["ff_q"]) if self.per_drive else (r_s * i_d_ref, r_s * i_q_ref)
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
        u_d_unsat = kp_d * e_d + int_d + ff_d - omega_el * psi_q
        u_q_unsat = kp_q * e_q + int_q + ff_q + omega_el * psi_d
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


def _inv2(M):
    """The inverses of a stack of 2 x 2 matrices ``(..., 2, 2)``."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    out = np.empty_like(M)
    out[..., 0, 0] = d / det
    out[..., 0, 1] = -b / det
    out[..., 1, 0] = -c / det
    out[..., 1, 1] = a / det
    return out


def _schedule_gains(lut, lut_vals, spans, r_s, tau, omegas, Q, R, riccati_tol):
    """The normalized Kalman-gain maps ``(S, 4, nx, ny)`` of the saturated
    drive at each speed of ``omegas`` ``(S,)``: at every point of the LUT grid
    the normalized one-Euler-step current map, linearized through
    ``bilinear_gather`` (autograd, float64), and the per-point stationary
    Riccati equation iterated to a step below ``riccati_tol``.
    The map's Jacobian is affine in the speed, ``A0 + omega A1``: one speed
    takes it at that speed, several take ``A0`` and ``A1`` once.  Every slice
    and point is solved in one batch; a slice stops where its own step falls
    below the tolerance, as a scalar solve at its speed would."""
    (mn_d, mx_d), (mn_q, mx_q) = spans["i_d"], spans["i_q"]
    gx = np.asarray(lut.x0) + np.asarray(lut.dx) * np.arange(lut.nx)
    gy = np.asarray(lut.y0) + np.asarray(lut.dy) * np.arange(lut.ny)
    gdn = 2.0 * (gx - mn_d) / (mx_d - mn_d) - 1.0
    gqn = 2.0 * (gy - mn_q) / (mx_q - mn_q) - 1.0
    pts = torch.as_tensor(np.stack([np.repeat(gdn, lut.ny), np.tile(gqn, lut.nx)], axis=-1))  # x-major

    def jacobian(omega_el, speed_part=False):
        """The pointwise map's ``(N, 2, 2)`` Jacobian at ``omega_el``, or
        (``speed_part``) that of its term in ``omega_el`` per unit speed."""
        def norm_step(xn):  # (N, 2) -> (N, 2), pointwise
            i_d = (xn[:, 0] + 1.0) / 2.0 * (mx_d - mn_d) + mn_d
            i_q = (xn[:, 1] + 1.0) / 2.0 * (mx_q - mn_q) + mn_q
            vals = bilinear_gather(lut_vals, lut.x0, lut.dx, lut.y0, lut.dy, lut.nx, lut.ny, i_d, i_q)
            l_dd, l_dq, l_qd, l_qq, psi_d, psi_q = (vals[c] for c in range(6))
            det = l_dd * l_qq - l_dq * l_qd
            inv_dd, inv_dq = l_qq / det, -l_dq / det
            inv_qd, inv_qq = -l_qd / det, l_dd / det
            if speed_part:
                return torch.stack([2.0 * tau * (inv_dd * psi_q - inv_dq * psi_d) / (mx_d - mn_d),
                                    2.0 * tau * (inv_qd * psi_q - inv_qq * psi_d) / (mx_q - mn_q)], dim=-1)
            rhs_d = 0.0 - r_s * i_d + omega_el * psi_q
            rhs_q = 0.0 - r_s * i_q - omega_el * psi_d
            i_d1 = i_d + tau * (inv_dd * rhs_d + inv_dq * rhs_q)
            i_q1 = i_q + tau * (inv_qd * rhs_d + inv_qq * rhs_q)
            return torch.stack([2.0 * (i_d1 - mn_d) / (mx_d - mn_d) - 1.0,
                                2.0 * (i_q1 - mn_q) / (mx_q - mn_q) - 1.0], dim=-1)

        # the map is pointwise, so one pullback per output row gives that
        # row of every point's 2x2 Jacobian
        x = pts.clone().requires_grad_(True)
        with torch.enable_grad():
            out = norm_step(x)
            rows = [torch.autograd.grad(out[:, i].sum(), x, retain_graph=True)[0] for i in range(2)]
        return torch.stack(rows, dim=1).numpy()  # A[n, i, j] = d out_i / d in_j

    n_s, n_p = len(omegas), pts.shape[0]
    if n_s == 1:
        A = jacobian(float(omegas[0]))[None]
    else:
        A = jacobian(0.0)[None] + np.asarray(omegas, dtype=np.float64)[:, None, None, None] * jacobian(1.0, True)[None]
    At = np.swapaxes(A, -1, -2)
    P = np.broadcast_to(Q, A.shape).copy()
    live = np.ones(n_s, dtype=bool)
    for _ in range(200_000):
        Kp = P @ _inv2(P + R)
        P_next = A @ (P - Kp @ P) @ At + Q
        step = np.abs(P_next - P).reshape(n_s, -1).max(axis=1)
        P = np.where(live[:, None, None, None], P_next, P)
        live &= step >= riccati_tol
        if not live.any():
            break
    else:
        raise ValueError(
            "per-grid-point stationary Riccati iteration did not converge - the Q/R configuration does not "
            "admit stationary gains on this operating range (check the noise levels and q_floor)"
        )
    K = P @ _inv2(P + R)  # (S, N, 2, 2), normalized-coordinate gains
    return K.reshape(n_s, lut.nx, lut.ny, 2, 2).transpose(0, 3, 4, 1, 2).reshape(n_s, 4, lut.nx, lut.ny)


#: the most distinct speeds a per-drive schedule holds (one slice each)
MAX_SCHEDULE_SLICES = 256


def _drive_planes(model, who, **values):
    """The per-drive form's operating point: each value a Python number or a
    ``(B,)`` tensor on the model's dtype and device, as ``(B,)`` tensors."""
    out = {}
    for name, v in values.items():
        if isinstance(v, torch.Tensor) and v.ndim != 0:
            if (tuple(v.shape) != (model.batch_size,) or v.dtype != model.dtype
                    or resolved_device(v.device) != resolved_device(model.device)):
                raise ValueError(f"{who}: a per-drive {name} is a ({model.batch_size},) tensor of {model.dtype} on "
                                 f"{model.device}; got {v.dtype} {tuple(v.shape)} on {v.device}")
            out[name] = v.detach()
        else:
            out[name] = torch.full((model.batch_size,), float(v), dtype=model.dtype, device=model.device)
    return out


def make_pmsm_saturated_sensorless_current_tile(model, *, i_d_ref, i_q_ref, omega_el=None,
                                                bandwidth: float = 2000.0, t_i: float = 5e-3,
                                                process_std: dict = None, measurement_std: dict = None,
                                                q_floor: float = 1e-6, riccati_tol: float = 1e-13):
    """Gain-scheduled sensorless current control of the SATURATED PMSM drive
    inside the closed-loop kernel (``utils/foc.py:946`` of the JAX package).

    At every point of the drive's own LUT grid the normalized one-Euler-step
    current map is linearized through ``bilinear_gather`` (autograd, float64)
    and the per-point stationary Riccati equation is iterated,
    giving four Kalman-gain maps on the magnetics grid.  Stacked with the six
    magnetics maps they form the :class:`ScheduledLUT` that the closed loop
    gathers at the belief currents every step; the tile assimilates with the
    gathered gains, runs a constant-bandwidth PI (``kp = bandwidth *
    L_diff``) with the saturated back-EMF feedforward, limits to the
    inscribed circle and predicts with one Euler step of the saturated ODE.

    Per drive: where ``i_d_ref``, ``i_q_ref`` or ``omega_el`` is a ``(B,)``
    tensor (on the model's dtype and device; the others then hold for every
    drive), each drive runs at its own operating point.  The gain maps
    depend on the speed through the observer's transition, so the schedule
    is solved once for each DISTINCT speed (at most
    :data:`MAX_SCHEDULE_SLICES`, all in one batch, the span
    ``ee.sched.solve``, counted in :data:`SCHEDULE_SOLVES`) and the
    :class:`ScheduledLUT` holds one slice of ten maps per speed, ``(S, 10,
    nx, ny)``, with ``slices``, the ``(B,)`` int32 plane of each drive's
    slice.  Each slice equals the scalar factory's maps at its speed: the
    gains are exact at the speeds the fleet holds and are not interpolated
    between them, so a fleet whose speeds lie on a grid keeps the slices
    few.  The references, the feedforwards ``r_s * i_ref`` and the speed
    reach the kernel as per-drive planes.

    Args:
        model: a saturated PMSM (LUT magnetics) with scalar properties,
            ``deadtime`` in {0, 1} and a one-stage solver.
        i_d_ref, i_q_ref: current setpoints [A], numbers or ``(B,)``.
        omega_el: frozen electrical speed [rad/s], a number or ``(B,)``
            (default mid-band).
        bandwidth: current-loop bandwidth [rad/s].
        t_i: PI integral time [s].
        process_std, measurement_std: observer noise levels, as in
            :func:`make_pmsm_sensorless_current_tile`.
        q_floor: diagonal process-covariance floor (normalized units^2).
        riccati_tol: per-grid-point fixed-point tolerance.

    Returns:
        ``(policy, carry0, sched_lut)``: pass all three to the closed loop
        (``policy_carry=carry0, sched_lut=sched_lut``; the policy holds
        ``sched_lut`` too, which the closed loop reads where it is given
        none, so ``FleetRunner.run_policy`` needs only the carry); the carry is as in
        :func:`make_pmsm_sensorless_current_tile` and
        ``sched_lut.carry_idx == (0, 1)``.  Per drive the policy's
        ``per_drive`` is true and ``sched_lut.slices`` holds each drive's
        slice.
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
    if omega_el is None:
        omega_el = 0.5 * (spans["omega_el"][0] + spans["omega_el"][1])
    per_drive = any(isinstance(v, torch.Tensor) and v.ndim != 0 for v in (i_d_ref, i_q_ref, omega_el))
    pnoise, mnoise = _noise_levels(model, process_std, measurement_std)
    Q, R = _qr(spans, pnoise, mnoise, tau, q_floor)
    (mn_d, mx_d), (mn_q, mx_q) = spans["i_d"], spans["i_q"]
    (amn_d, amx_d), (amn_q, amx_q) = aspans["u_d"], aspans["u_q"]
    consts = dict(
        mn_d=mn_d, mx_d=mx_d, mn_q=mn_q, mx_q=mx_q, amn_d=amn_d, amx_d=amx_d, amn_q=amn_q, amx_q=amx_q,
        r_s=r_s, bandwidth=float(bandwidth), t_i=float(t_i), tau=tau, u_lim=_u_lim(aspans, u_dc),
    )
    if per_drive:
        planes = _drive_planes(model, who, i_d_ref=i_d_ref, i_q_ref=i_q_ref, omega_el=omega_el)
        speeds, slices = torch.unique(planes["omega_el"], return_inverse=True)
        if speeds.numel() > MAX_SCHEDULE_SLICES:
            raise ValueError(f"{who}: the fleet holds {speeds.numel()} distinct speeds, and a per-drive schedule "
                             f"holds at most {MAX_SCHEDULE_SLICES} (one slice of ten maps per speed): put the "
                             "drives' speeds on a grid")
        omegas = speeds.detach().cpu().to(torch.float64).numpy()
        # the feedforwards as the plain tile would compute them on the planes
        consts.update(planes, ff_d=r_s * planes["i_d_ref"], ff_q=r_s * planes["i_q_ref"])
    else:
        omegas = np.array([float(omega_el)])
        consts.update(i_d_ref=float(i_d_ref), i_q_ref=float(i_q_ref), omega_el=float(omega_el))
    with annotate("ee.sched.solve"):
        k_maps = _schedule_gains(lut, lut_vals, spans, r_s, tau, omegas, Q, R, riccati_tol)
    SCHEDULE_SOLVES["slices"] += len(omegas)
    SCHEDULE_SOLVES["points"] += k_maps[0, 0].size * len(omegas)
    SCHEDULE_SOLVES["drives"] += model.batch_size if per_drive else 1
    magnetics = np.broadcast_to(lut_vals.numpy(), (len(omegas),) + tuple(lut_vals.shape))
    values = np.concatenate([magnetics, k_maps], axis=1)
    if per_drive:
        sched_lut = ScheduledLUT(values, carry_idx=(0, 1), slices=slices.to(torch.int32))
    else:
        sched_lut = ScheduledLUT(values[0], carry_idx=(0, 1))

    n_base = 8 + len(model.control_state)  # standard columns + tracked references
    policy = ScheduledSensorlessPolicy(consts, n_base + 10, bool(deadtime), sched_lut)
    return policy, _carry0(model, spans, aspans, deadtime), sched_lut


# ---------------------------------------------------------------------------
# the induction machine's rotor-flux-oriented control and the EESM's current
# tile (closed_loop.cu, csrc/foc_laws.cuh)
# ---------------------------------------------------------------------------


def _is_batched(v) -> bool:
    return isinstance(v, torch.Tensor) and v.ndim != 0


def _maybe_scalar(v):
    """A scalar band or parameter as a Python float; a per-batch ``(B,)``
    tensor stays a tensor."""
    return v if _is_batched(v) else float(v)


def _minimum(a, b):
    if not (_is_batched(a) or _is_batched(b)):
        return min(a, b)
    if _is_batched(a) and _is_batched(b):
        return torch.minimum(a, b)
    t, s = (a, b) if _is_batched(a) else (b, a)
    return torch.clamp(t, max=s)


def _check_symmetric(model, axes, who, hint=""):
    """Refuse an asymmetric action band: the vector limit and the ``u /
    u_max`` normalization keep the command's direction only when the band is
    linear through zero (``min == -max``)."""
    as_np = lambda v: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    for ax in axes:
        norm = getattr(model.env_properties.action_normalizations, ax)
        if not np.allclose(as_np(norm.min), -as_np(norm.max)):
            raise ValueError(f"{who} needs a symmetric {ax} action band (min == -max){hint}; "
                             f"got min={norm.min}, max={norm.max}")


class FocLaw:
    """The rotor-flux-oriented law of :func:`make_sensorless_foc`, over the
    physical stator currents and rotor flux of a belief state:
    ``law(i_sd, i_sq, psi_rd, psi_rq, carry, k) -> ((a_sd, a_sq), carry)``
    with ``carry = (int_d, int_q, int_psi, free)``.  Its constants are Python
    floats, or ``(B,)`` tensors for per-batch bands and parameters (the law
    broadcasts).  ``SLOTS`` names the flat values the kernel's functor reads
    (``csrc/foc_laws.cuh::FocLaw``), in its order."""

    SLOTS = ("PSI_FLOOR", "PSI_STAR", "KP_PSI", "PSI_FF", "I_LO", "I_HI", "KIPSI_TAU", "AW_PSI", "I_MAX_SQ",
             "TORQUE_REF", "TQ_GAIN", "HALF_PSI", "INV_QUARTER_PSI", "L_M", "TAU_R", "OMEGA", "KP", "SIGMA_LS", "K_R",
             "U_LIM", "KI_TAU", "AW", "INV_UMAX_D", "INV_UMAX_Q")

    #: the machine parameters the functor's slots fold: :meth:`slot_values`
    #: reads them and :meth:`constants` watches them
    FOLDED_PARAMS = ("l_m", "l_r", "l_s", "r_r", "p", "omega")

    def __init__(self, params, *, tau, psi_star, torque_ref, kp, ki, kp_psi, ki_psi, psi_floor, i_max, u_lim,
                 u_max_d, u_max_q):
        self.params = params
        self.tau, self.psi_star, self.torque_ref = tau, psi_star, torque_ref
        self.kp, self.ki, self.kp_psi, self.ki_psi, self.psi_floor = kp, ki, kp_psi, ki_psi, psi_floor
        self.i_max, self.u_lim, self.u_max_d, self.u_max_q = i_max, u_lim, u_max_d, u_max_q

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name != "_edits":
            object.__setattr__(self, "_edits", self.__dict__.get("_edits", 0) + 1)

    def constants(self) -> tuple:
        """What the tiles' slot values, options and planes read of the law
        beyond its tensors: the count of its attribute sets and the machine
        parameters it folds (:data:`FOLDED_PARAMS`, read from a parameter set
        the environment shares, whose fields change without a set here)."""
        return (self._edits,) + tuple(getattr(self.params, n) for n in self.FOLDED_PARAMS)

    def tensors(self) -> tuple:
        """The law's tensor attributes: a write in place changes a slot or a
        plane without a set."""
        return tuple(v for v in vars(self).values() if isinstance(v, torch.Tensor))

    def __call__(self, i_sd_v, i_sq_v, psi_rd_v, psi_rq_v, carry, k):
        params, tau = self.params, self.tau
        psi_star, i_max, u_lim = self.psi_star, self.i_max, self.u_lim
        kp, ki, kp_psi, ki_psi, psi_floor = self.kp, self.ki, self.kp_psi, self.ki_psi, self.psi_floor
        k_r = params.l_m / params.l_r
        # 1. orientation from the ESTIMATED flux; below the flux floor a frame
        # rotating at the rotor speed (a static parameter)
        psi_mag = torch.sqrt(psi_rd_v * psi_rd_v + psi_rq_v * psi_rq_v)
        denom = torch.clamp(psi_mag, min=psi_floor)
        theta_f = params.omega * tau * k
        if not isinstance(theta_f, torch.Tensor):
            theta_f = torch.full_like(psi_mag, theta_f)
        use_est = psi_mag > psi_floor
        cos_rho = torch.where(use_est, psi_rd_v / denom, torch.cos(theta_f))
        sin_rho = torch.where(use_est, psi_rq_v / denom, torch.sin(theta_f))
        # 2. estimated currents into the flux frame
        i_d = cos_rho * i_sd_v + sin_rho * i_sq_v
        i_q = cos_rho * i_sq_v - sin_rho * i_sd_v
        # 3. current references: the outer flux PI and the torque relation,
        # limited to the command circle (flux priority)
        int_d, int_q, int_psi, free_c = carry
        free = free_c > 0  # a bool carry, or the tiles' 1.0/0.0 plane
        e_psi = psi_star - psi_mag
        i_d_raw = psi_star / params.l_m + kp_psi * e_psi + int_psi
        i_d_ref = torch.clamp(i_d_raw, -i_max, i_max)
        # directional conditional integration while the inverter is railed,
        # back-calculation against the achieved d-current
        unwind = e_psi * i_d_raw < 0.0
        int_psi = (int_psi + torch.where(free | unwind, ki_psi * tau * e_psi, 0.0)
                   + (tau * ki_psi / kp_psi) * (i_d - i_d_raw))
        i_q_cap = torch.sqrt(torch.clamp(i_max**2 - i_d_ref * i_d_ref, min=0.0))
        i_q_ref = torch.clamp(self.torque_ref / (1.5 * params.p * k_r * denom), -i_q_cap, i_q_cap)
        # 4. magnetize first: torque current once the estimated flux has built
        gate = torch.clamp((psi_mag - 0.5 * psi_star) / (0.25 * psi_star), 0.0, 1.0)
        i_q_ref = gate * i_q_ref
        # 5. PI with the decoupling feedforward at the slip-adjusted speed
        e_d = i_d_ref - i_d
        e_q = i_q_ref - i_q
        sigma_l_s = params.l_s - params.l_m * k_r
        omega_s = params.omega + params.l_m * i_q / ((params.l_r / params.r_r) * denom)
        u_d_unsat = kp * e_d + int_d - omega_s * sigma_l_s * i_q
        u_q_unsat = kp * e_q + int_q + omega_s * (sigma_l_s * i_d + k_r * psi_mag)
        # 6. voltage-vector limit, back-calculation anti-windup, back to the
        # stationary frame, normalized onto the action band
        u_mag = torch.sqrt(u_d_unsat * u_d_unsat + u_q_unsat * u_q_unsat)
        scale = torch.clamp(u_lim / torch.clamp(u_mag, min=1e-9), max=1.0)
        u_d = u_d_unsat * scale
        u_q = u_q_unsat * scale
        k_t = tau * ki / kp  # tracking gain: T_t = kp/ki (the PI's own T_i)
        int_d = int_d + ki * tau * e_d + k_t * (u_d - u_d_unsat)
        int_q = int_q + ki * tau * e_q + k_t * (u_q - u_q_unsat)
        u_sd = cos_rho * u_d - sin_rho * u_q
        u_sq = sin_rho * u_d + cos_rho * u_q
        flag = (u_mag <= u_lim).to(free_c.dtype)
        return (u_sd / self.u_max_d, u_sq / self.u_max_q), (int_d, int_q, int_psi, flag)

    PLANES = ("OMEGA", "TORQUE_REF", "FRAME_STEP")

    def per_drive(self) -> bool:
        """Whether the law reads its speed and torque setpoint per drive
        (the copy :func:`_drive_law` makes)."""
        return _is_batched(self.params.omega) and _is_batched(self.torque_ref)

    def slot_values(self, who) -> dict:
        """The functor's flat values (Python floats), folded as the plain law
        folds its Python numbers; per-batch constants refuse (the kernel
        folds them into its program), but for a per-drive law's speed and
        torque setpoint, which the functor reads from :meth:`planes` (their
        slots hold 0.0)."""
        p = self.params
        consts = dict(tau=self.tau, psi_star=self.psi_star, i_max=self.i_max, u_lim=self.u_lim,
                      u_max_d=self.u_max_d, u_max_q=self.u_max_q, torque_ref=self.torque_ref,
                      **{n: getattr(p, n) for n in self.FOLDED_PARAMS})
        if self.per_drive():
            consts.update(omega=0.0, torque_ref=0.0)
        batched = sorted(n for n, v in consts.items() if _is_batched(v))
        if batched:
            raise ValueError(f"{who} on CUDA tensors reads per drive only the speed (static param omega) and "
                             f"torque_ref; the kernel folds every other constant into its program, so per-batch "
                             f"psi_ref, field weakening at per-drive speeds, per-batch bands and per-batch machine "
                             f"parameters refuse there (per-batch: {batched}).  The plain law runs them on CPU "
                             "tensors")
        c = {n: float(v) for n, v in consts.items()}
        k_r = c["l_m"] / c["l_r"]
        tau, psi_star, i_max = c["tau"], c["psi_star"], c["i_max"]
        return {
            "PSI_FLOOR": self.psi_floor, "PSI_STAR": psi_star, "KP_PSI": self.kp_psi, "PSI_FF": psi_star / c["l_m"],
            "I_LO": -i_max, "I_HI": i_max, "KIPSI_TAU": self.ki_psi * tau, "AW_PSI": tau * self.ki_psi / self.kp_psi,
            "I_MAX_SQ": i_max**2, "TORQUE_REF": c["torque_ref"], "TQ_GAIN": 1.5 * c["p"] * k_r,
            "HALF_PSI": 0.5 * psi_star, "INV_QUARTER_PSI": 1.0 / (0.25 * psi_star), "L_M": c["l_m"],
            "TAU_R": c["l_r"] / c["r_r"], "OMEGA": c["omega"], "KP": self.kp, "SIGMA_LS": c["l_s"] - c["l_m"] * k_r,
            "K_R": k_r, "U_LIM": c["u_lim"], "KI_TAU": self.ki * tau, "AW": tau * self.ki / self.kp,
            "INV_UMAX_D": 1.0 / c["u_max_d"], "INV_UMAX_Q": 1.0 / c["u_max_q"],
        }

    def frame_step(self) -> float:
        """``omega * tau``, the fallback frame's angle per step, in double:
        the functor rounds ``frame_step * k`` to the working type (0.0 for a
        per-drive law, whose step is the plane ``FRAME_STEP``)."""
        return 0.0 if self.per_drive() else float(self.params.omega) * float(self.tau)

    def planes(self) -> tuple:
        """A per-drive law's planes (``PLANES``): each drive's speed, torque
        setpoint and ``omega * tau`` in the law's working type, as its plain
        version computes the fallback frame's step on tensors (``()`` for a
        folded law)."""
        if not self.per_drive():
            return ()
        return (self.params.omega, self.torque_ref, self.params.omega * self.tau)

    def plane_sources(self) -> tuple:
        """The tensors :meth:`planes` computes from."""
        return (self.params.omega, self.torque_ref) if self.per_drive() else ()


def _drive_law(law: FocLaw, model):
    """The tiles' copy of ``law`` for a fleet whose speed or torque setpoint
    differs per drive: both as ``(B,)`` leaves in the model's type on its
    device (a scalar broadcast), so that the plain tile computes what the
    per-drive functor computes; ``law`` itself where both are scalars."""
    p = law.params
    if not (_is_batched(p.omega) or _is_batched(law.torque_ref)):
        return law
    plane = lambda v: (v.to(dtype=model.dtype, device=model.device) if isinstance(v, torch.Tensor)
                       else torch.full((), float(v), dtype=model.dtype, device=model.device)
                       ).expand(model.batch_size).contiguous()
    out = copy.copy(law)
    out.params = structures.replace(p, omega=plane(p.omega))
    out.torque_ref = plane(law.torque_ref)
    return out


def make_sensorless_foc(model, *, psi_ref: float, torque_ref: float, kp: float = 40.0, ki: float = 8000.0,
                        kp_psi: float = 10.0, ki_psi: float = 200.0, psi_floor: float = 0.05, i_max: float = None,
                        field_weakening: bool = False, u_margin: float = 0.85):
    """Rotor-flux-oriented PI current control of the
    :class:`~exciting_environments_torch.models.induction_machine.InductionMachine`
    over a belief state (``utils/foc.py:102`` of the JAX package).

    The law (amplitude-invariant stationary-frame model): orientation on the
    estimated flux ``psi_r / |psi_r|`` (below ``psi_floor`` a frame rotating
    at the rotor speed), the stator current rotated into that frame, an outer
    flux PI ``i_d* = psi*/L_m + PI(psi* - |psi|)`` with directional
    conditional integration and back-calculation against the achieved
    d-current, the torque current ``i_q* = T* / (1.5 p (L_m/L_r)
    max(|psi|, psi_floor))`` limited to the remaining current circle and
    gated open once the flux has built (magnetize first), decoupled current
    PIs at the slip-adjusted synchronous speed with back-calculation
    anti-windup, and the voltage-VECTOR limit.

    Args:
        model: the deterministic InductionMachine twin (its static params
            give ``L_m``/``L_r``/``p``, its action band the voltage limit);
            per-batch parameters and symmetric per-batch bands broadcast.
        psi_ref: rotor-flux setpoint [Vs].
        torque_ref: electromagnetic-torque setpoint [Nm].
        kp / ki: current-loop PI gains [V/A], [V/(A s)].
        kp_psi / ki_psi: outer flux-loop PI gains [A/Vs], [A/(Vs s)].
        psi_floor: lower clamp [Vs] on the flux magnitude in the ``i_q*``
            division and the orientation.
        i_max: current-command limit [A] (default 90% of the ``i_sd`` band).
        field_weakening: derate the flux setpoint above base speed,
            ``psi* = min(psi_ref, u_margin * u_lim / (|omega| L_m/L_r))``.
        u_margin: share of the voltage limit the back-EMF may take under
            field weakening.

    Returns:
        ``(controller, carry0)``: ``controller(belief_state, carry, k) ->
        (normalized_action (B, 2), carry)`` with ``carry = (int_d, int_q,
        int_psi, free)`` (the integrators and the bool "voltage vector was
        unsaturated" flag), the contract of
        :func:`~exciting_environments_torch.utils.ofc.run_output_feedback_controller`.
        ``controller._law`` is the :class:`FocLaw` the tiles share.
    """
    params = model.env_properties.static_params
    tau = float(model.tau)
    act_norms = model.env_properties.action_normalizations
    _check_symmetric(model, ("u_sd", "u_sq"), "make_sensorless_foc",
                     " to keep the voltage-vector limit orientation-preserving")
    u_max_d = _maybe_scalar(act_norms.u_sd.max)
    u_max_q = _maybe_scalar(act_norms.u_sq.max)
    if i_max is None:
        i_norm = model.env_properties.physical_normalizations.i_sd
        lo, hi = _maybe_scalar(i_norm.min), _maybe_scalar(i_norm.max)
        if not (_is_batched(lo) or _is_batched(hi)):
            i_max = 0.9 * min(abs(lo), abs(hi))
        else:
            as_t = lambda v: v if _is_batched(v) else torch.full((model.batch_size,), v, dtype=model.dtype,
                                                                  device=model.device)
            i_max = 0.9 * torch.minimum(as_t(lo).abs(), as_t(hi).abs())
    else:
        i_max = _maybe_scalar(i_max)
    B = model.batch_size
    zeros = lambda: torch.zeros(B, dtype=model.dtype, device=model.device)
    carry0 = (zeros(), zeros(), zeros(), torch.ones(B, dtype=torch.bool, device=model.device))

    # stationary components of |u_dq| <= u_lim stay inside the band
    u_lim = _minimum(u_max_d, u_max_q)
    psi_star = psi_ref
    if field_weakening:
        omega, k_r0 = params.omega, params.l_m / params.l_r
        if not _is_batched(omega) and not _is_batched(u_lim):
            psi_star = min(psi_ref, u_margin * u_lim / (max(abs(float(omega)), 1e-6) * float(k_r0)))
        else:
            w = torch.clamp(omega.abs(), min=1e-6) if _is_batched(omega) else max(abs(float(omega)), 1e-6)
            psi_star = torch.clamp(u_margin * u_lim / (w * k_r0), max=psi_ref)

    law = FocLaw(params, tau=tau, psi_star=psi_star, torque_ref=torque_ref, kp=kp, ki=ki, kp_psi=kp_psi,
                 ki_psi=ki_psi, psi_floor=psi_floor, i_max=i_max, u_lim=u_lim, u_max_d=u_max_d, u_max_q=u_max_q)

    def controller(belief, carry, k):
        phys = belief.physical_state
        (a_d, a_q), carry = law(phys.i_sd, phys.i_sq, phys.psi_rd, phys.psi_rq, carry, k)
        return torch.stack([a_d, a_q], dim=-1), carry

    controller._law = law
    return controller, carry0


def _scalar_spans(model, what):
    """The four state fields' scalar ``(min, max)`` normalizations."""
    pn = model.env_properties.physical_normalizations
    spans = tuple((getattr(pn, n).min, getattr(pn, n).max) for n in ("i_sd", "i_sq", "psi_rd", "psi_rq"))
    if any(_is_batched(v) for span in spans for v in span):
        raise ValueError(
            f"{what} needs scalar physical normalizations (the fused closed-loop kernel folds them into the "
            "program); per-batch bands only work through the belief-space controller"
        )
    return tuple((float(mn), float(mx)) for mn, mx in spans)


def _denormalized(cols, spans):
    """``(o + 1) / 2 * (mx - mn) + mn`` per column, the tiles' order."""
    return tuple((o + 1) / 2 * (mx - mn) + mn for o, (mn, mx) in zip(cols, spans))


def _span_slots(spans) -> dict:
    out = {}
    for i, (mn, mx) in enumerate(spans):
        out[f"SPAN{i}"], out[f"MN{i}"] = mx - mn, mn
    return out


class FocPolicy(_SlotTile):
    """The tile of :func:`make_foc_tile`: the :class:`FocLaw` on the
    denormalized state columns; carry ``(int_d, int_q, int_psi, free)`` with
    the flag as a 1.0/0.0 plane.  A per-drive law (:func:`_drive_law`) hands
    the kernel its ``FocLaw.PLANES``."""

    policy_id = 4
    n_carry = 4
    env_ids = (6,)
    SLOTS = FocLaw.SLOTS + ("SPAN0", "MN0", "SPAN1", "MN1", "SPAN2", "MN2", "SPAN3", "MN3")
    PLANES = FocLaw.PLANES

    def __init__(self, law: FocLaw, spans, n_obs: int):
        super().__init__()
        self.law, self.spans, self.n_obs = law, _frozen(spans), int(n_obs)

    def _slot_values(self):
        return {**self.law.slot_values(type(self).__name__), **_span_slots(self.spans)}

    def _options(self):
        return {"frame_step": self.law.frame_step()}

    def _constants(self):
        return self.law.constants()

    def _watched(self):
        return self._plane_sources() + self.law.tensors()

    def _planes(self):
        return self.law.planes()

    def _plane_sources(self):
        return self.law.plane_sources()

    def forward(self, obs, t, carry, params=None):
        return self.law(*_denormalized(obs[:4], self.spans), tuple(carry), t)


def make_foc_tile(model, **law_kwargs):
    """The law of :func:`make_sensorless_foc` as a stateful tile policy of the
    closed-loop kernel, on the true state (``utils/foc.py:323`` of the JAX
    package): full-state FOC at fused closed-loop speed.

    Args:
        model: the :class:`InductionMachine` (scalar normalizations; on CUDA
            scalar static params but ``omega``, which may be per drive).
        **law_kwargs: forwarded to :func:`make_sensorless_foc`
            (``psi_ref``/``torque_ref`` required; ``torque_ref`` may be a
            ``(B,)`` tensor).

    Returns:
        ``(policy, carry0)`` for ``env.fused_closed_loop(...,
        policy_carry=carry0)`` and ``RolloutCollector.collect_policy_fused``:
        a :class:`FocPolicy` and ``(int_d, int_q, int_psi, free)``, the flag a
        1.0/0.0 plane (kernel carries are floating point).
    """
    controller, carry0 = make_sensorless_foc(model, **law_kwargs)
    spans = _scalar_spans(model, "make_foc_tile")
    policy = FocPolicy(_drive_law(controller._law, model), spans, 4 + len(model.control_state))
    return policy, carry0[:3] + (torch.ones(model.batch_size, dtype=model.dtype, device=model.device),)


class SensorlessFocPolicy(_SlotTile):
    """The tile of :func:`make_sensorless_foc_tile`: a stationary Kalman
    observer on the measured columns, then the :class:`FocLaw` on its
    corrected belief.  Carry: the 4 normalized predicted-belief planes, then
    the law's 4 planes.  Terms whose gain, ``A`` or ``B`` coefficient is
    exactly 0.0 (for every drive) are skipped (the kernel reads them from
    ``K_MASK``, ``A_MASK`` and ``B_MASK``), and the sums start from 0.0 in
    index order, as in the JAX tile.

    Per drive (a per-drive law, one filter per drive): ``K`` ``(B, 4,
    n_meas)`` and ``A`` ``(B, 4, 4)``, whose entries :data:`DRIVE_A` (the
    speed's cross terms) are planes and every other entry one value for the
    fleet; ``B`` and ``c`` are one for the fleet.  The planes are the law's
    ``FocLaw.PLANES``, then ``K_PLANES``, then ``A_PLANES``."""

    policy_id = 5
    n_carry = 8
    env_ids = (6,)
    MAX_MEAS = 4
    #: the per-drive tile's measured fields at most, and its ``A`` entries
    #: that the speed moves (row, column)
    MAX_DRIVE_MEAS = 2
    DRIVE_A = ((0, 3), (1, 2), (2, 3), (3, 2))
    _MIDX_SLOTS = tuple(f"MIDX{k}" for k in range(4))
    _ZCOL_SLOTS = tuple(f"ZCOL{k}" for k in range(4))
    _K_SLOTS = tuple(f"K{i}{k}" for i in range(4) for k in range(4))
    _A_SLOTS = tuple(f"A{i}{j}" for i in range(4) for j in range(4))
    _B_SLOTS = tuple(f"B{i}{k}" for i in range(4) for k in range(2))
    _C_SLOTS = tuple(f"C{i}" for i in range(4))
    SLOTS = (FocLaw.SLOTS + ("SPAN0", "MN0", "SPAN1", "MN1", "SPAN2", "MN2", "SPAN3", "MN3", "N_MEAS") + _MIDX_SLOTS
             + _ZCOL_SLOTS + _K_SLOTS + _A_SLOTS + _B_SLOTS + _C_SLOTS + ("K_MASK", "A_MASK", "B_MASK"))
    K_PLANES = ("K00", "K01", "K10", "K11", "K20", "K21", "K30", "K31")
    A_PLANES = ("A03", "A12", "A23", "A32")
    PLANES = FocLaw.PLANES + K_PLANES + A_PLANES

    def __init__(self, law: FocLaw, spans, n_obs: int, A, B, c, K, midx, zcols):
        super().__init__()
        self.law, self.spans, self.n_obs = law, _frozen(spans), int(n_obs)
        self.midx, self.zcols = tuple(int(v) for v in midx), tuple(int(v) for v in zcols)
        if len(self.midx) > self.MAX_MEAS:
            raise ValueError(f"at most {self.MAX_MEAS} measured fields")
        A, B, c, K = (np.asarray(m, dtype=np.float64) for m in (A, B, c, K))
        self.drive = law.per_drive()
        if not self.drive:
            self.A = tuple(tuple(float(v) for v in row) for row in A)
            self.B = tuple(tuple(float(v) for v in row) for row in B)
            self.c = tuple(float(v) for v in c)
            self.K = tuple(tuple(float(v) for v in row) for row in K)
            nz = lambda m: tuple(tuple(v != 0.0 for v in row) for row in m)
            self.k_nz, self.a_nz, self.b_nz = nz(self.K), nz(self.A), nz(self.B)
            return
        # one filter per drive: K and the speed's A entries become planes in
        # the law's working type on its device, the rest one value
        if len(self.midx) > self.MAX_DRIVE_MEAS:
            raise ValueError(f"the per-drive sensorless tile measures at most {self.MAX_DRIVE_MEAS} fields")
        omega = law.params.omega
        n_drive = omega.shape[0]
        A, B, c, K = (np.broadcast_to(m, (n_drive,) + m.shape[-nd:]) for m, nd in ((A, 2), (B, 2), (c, 1), (K, 2)))
        plane = lambda v: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float64).to(dtype=omega.dtype,
                                                                                            device=omega.device)
        shared = np.ones((4, 4), dtype=bool)
        for i, j in self.DRIVE_A:
            shared[i, j] = False
        for name, m, mask in (("A", A, shared), ("B", B, None), ("c", c, None)):
            fixed = m if mask is None else m[:, mask]
            if not (fixed == fixed[:1]).all():
                raise ValueError(f"the per-drive sensorless tile folds the observer's {name} but for the speed's "
                                 f"cross terms {self.DRIVE_A}: it differs between drives here (only omega may be "
                                 "per drive, and only explicit Euler's transition moves no other entry with it)")
        self.A = tuple(tuple(plane(A[:, i, j]) if not shared[i, j] else float(A[0, i, j]) for j in range(4))
                       for i in range(4))
        self.B = tuple(tuple(float(v) for v in row) for row in B[0])
        self.c = tuple(float(v) for v in c[0])
        self.K = tuple(tuple(plane(K[:, i, k]) for k in range(K.shape[-1])) for i in range(4))
        self.k_nz = tuple(tuple(bool((K[:, i, k] != 0.0).any()) for k in range(K.shape[-1])) for i in range(4))
        self.a_nz = tuple(tuple(bool((A[:, i, j] != 0.0).any()) for j in range(4)) for i in range(4))
        self.b_nz = tuple(tuple(v != 0.0 for v in row) for row in self.B)

    def _slot_values(self):
        n_meas = len(self.midx)
        pad = (0,) * (4 - n_meas)
        out = {**self.law.slot_values(type(self).__name__), **_span_slots(self.spans), "N_MEAS": n_meas}
        out.update(zip(self._MIDX_SLOTS, (*self.midx, *pad)))
        out.update(zip(self._ZCOL_SLOTS, (*self.zcols, *pad)))
        # a per-drive coefficient's slot holds 0.0: the functor reads its plane
        fold = lambda v: v if isinstance(v, float) else 0.0
        out.update(zip(self._K_SLOTS, [fold(row[k]) if k < n_meas else 0.0 for row in self.K for k in range(4)]))
        out.update(zip(self._A_SLOTS, [fold(v) for row in self.A for v in row]))
        out.update(zip(self._B_SLOTS, [v for row in self.B for v in row]))
        out.update(zip(self._C_SLOTS, self.c))
        # the non-zero terms as bit masks (bit 4 i + k, 4 i + j, 2 i + k),
        # taken from the Python doubles (per drive: non-zero for some drive);
        # below 2**16, exact in float32
        bits = lambda flags: sum(1 << b for b, v in enumerate(flags) if v)
        out["K_MASK"] = bits([k < n_meas and row[k] for row in self.k_nz for k in range(4)])
        out["A_MASK"] = bits([v for row in self.a_nz for v in row])
        out["B_MASK"] = bits([v for row in self.b_nz for v in row])
        return out

    def _options(self):
        return {"frame_step": self.law.frame_step()}

    def _constants(self):
        return self.law.constants()

    def _watched(self):
        return self._plane_sources() + self.law.tensors()

    def _planes(self):
        if not self.drive:
            return ()
        zero = torch.zeros_like(self.law.params.omega)
        n_meas = len(self.midx)
        k_planes = tuple(self.K[i][k] if k < n_meas else zero for i in range(4) for k in range(self.MAX_DRIVE_MEAS))
        return self.law.planes() + k_planes + tuple(self.A[i][j] for i, j in self.DRIVE_A)

    def _plane_sources(self):
        if not self.drive:
            return ()
        return self.law.plane_sources() + tuple(k for row in self.K for k in row) + tuple(
            self.A[i][j] for i, j in self.DRIVE_A)

    def forward(self, obs, t, carry, params=None):
        K, A, Bm, cv, midx, zcols = self.K, self.A, self.B, self.c, self.midx, self.zcols
        n, n_meas = 4, len(midx)
        xh = carry[:n]  # predicted normalized belief x(t | t-1)
        innov = tuple(obs[zcols[k]] - xh[midx[k]] for k in range(n_meas))
        xc = tuple(xh[i] + sum((K[i][k] * innov[k] for k in range(n_meas) if self.k_nz[i][k]), 0.0)
                   for i in range(n))
        (a_d, a_q), foc_c = self.law(*_denormalized(xc, self.spans), tuple(carry[n:]), t)
        # predict with the action the kernel is about to apply (normalized,
        # what the observer's B was linearized against)
        acts = (a_d, a_q)
        xn = []
        for i in range(n):
            v = (cv[i] + sum((A[i][j] * xc[j] for j in range(n) if self.a_nz[i][j]), 0.0)
                 + sum((Bm[i][k] * acts[k] for k in range(2) if self.b_nz[i][k]), 0.0))
            xn.append(v if isinstance(v, torch.Tensor) else torch.full_like(a_d, v))
        return acts, tuple(xn) + tuple(foc_c)


def make_sensorless_foc_tile(model, *, measured_fields=("i_sd", "i_sq"), process_std=None, measurement_std=None,
                             q_floor: float = 1e-8, **law_kwargs):
    """Sensorless FOC inside the closed-loop kernel: a stationary Kalman flux
    observer and the rotor-flux-oriented law in one stateful tile
    (``utils/foc.py:382`` of the JAX package).

    The tile reads only the measured observation columns (on a plant with
    ``observation_noise`` the noisy sensor values the kernel streams),
    corrects its predicted belief with the constant gain of
    :func:`~exciting_environments_torch.utils.estimate.stationary_kalman_gain`,
    runs the law on the corrected belief and predicts with ``A x + B u + c``
    at the action it emits.  On a fleet whose ``omega`` is a ``(B,)`` static
    parameter every drive gets its own filter at its own speed
    (:func:`~exciting_environments_torch.utils.estimate.stationary_kalman_gains`,
    solved once here); with it, or with a ``(B,)`` ``torque_ref``, the
    kernel reads each drive's operating point from per-drive planes.

    Args:
        model: the :class:`InductionMachine` the loop runs on; its noise
            configuration is the observer's Q and R.  Scalar normalizations
            and static params but ``omega``, which may be per drive.
        measured_fields: the observation columns the tile reads (at most two
            with per-drive planes, which also need explicit Euler: another
            solver's transition moves every entry of ``A`` with the speed).
        process_std / measurement_std / q_floor: observer overrides, see
            :func:`~exciting_environments_torch.utils.estimate.stationary_kalman_gain`.
        **law_kwargs: forwarded to :func:`make_sensorless_foc`.

    Returns:
        ``(policy, carry0)``: a :class:`SensorlessFocPolicy` and its 8 carry
        planes (the 4 normalized observer planes, then the law's 4).
    """
    from exciting_environments_torch.utils.estimate import stationary_kalman_gain, stationary_kalman_gains

    controller, carry0 = make_sensorless_foc(model, **law_kwargs)
    spans = _scalar_spans(model, "make_sensorless_foc_tile")
    static = model.env_properties.static_params
    per_drive = [f for f in ("r_s", "r_r", "l_m", "l_s", "l_r", "p", "omega") if _is_batched(getattr(static, f))]
    solve = stationary_kalman_gains if per_drive == ["omega"] else stationary_kalman_gain
    sk = solve(model, measured_fields=tuple(measured_fields), process_std=process_std,
               measurement_std=measurement_std, q_floor=q_floor)
    GAIN_SOLVES["solves"] += 1
    GAIN_SOLVES["drives"] += model.batch_size if solve is stationary_kalman_gains else 1
    if sk.names != ("i_sd", "i_sq", "psi_rd", "psi_rq"):
        raise ValueError("make_sensorless_foc_tile expects the InductionMachine state order "
                         f"('i_sd', 'i_sq', 'psi_rd', 'psi_rq'); got {sk.names}")
    policy = SensorlessFocPolicy(_drive_law(controller._law, model), spans, 4 + len(model.control_state), sk.A,
                                 sk.B, sk.c, sk.K, sk.midx, sk.zidx)
    full = lambda v: torch.full((model.batch_size,), v, dtype=model.dtype, device=model.device)
    return policy, tuple(full(0.0) for _ in range(4)) + carry0[:3] + (full(1.0),)


class EesmCurrentPolicy(_SlotTile):
    """The tile of :func:`make_eesm_current_tile`: dq and field current PIs
    with the decoupling feedforward, the stator voltage-vector limit and the
    field voltage clip; carry ``(int_d, int_q, int_f)``."""

    policy_id = 6
    n_carry = 3
    env_ids = (7,)
    SLOTS = ("SPAN0", "MN0", "SPAN1", "MN1", "SPAN2", "MN2", "REF_D", "REF_Q", "REF_F", "KP", "KP_F", "FF_D", "FF_Q",
             "FF_F", "W_LQ", "OMEGA", "L_D", "L_M", "U_LIM", "UF_LO", "UF_HI", "KI_TAU", "KIF_TAU", "AW", "AW_F",
             "INV_UMAX_D", "INV_UMAX_Q", "INV_UMAX_F")

    def __init__(self, consts: dict, spans, n_obs: int):
        super().__init__()
        self.consts, self.spans, self.n_obs = dict(consts), _frozen(spans), int(n_obs)

    def _constants(self):
        return tuple(self.consts.values())

    def _slot_values(self):
        c = self.consts
        tau = c["tau"]
        return {
            **_span_slots(self.spans), "REF_D": c["i_d_ref"], "REF_Q": c["i_q_ref"], "REF_F": c["i_f_ref"],
            "KP": c["kp"], "KP_F": c["kp_f"], "FF_D": c["r_s"] * c["i_d_ref"], "FF_Q": c["r_s"] * c["i_q_ref"],
            "FF_F": c["r_f"] * c["i_f_ref"], "W_LQ": c["omega_el"] * c["l_q"], "OMEGA": c["omega_el"],
            "L_D": c["l_d"], "L_M": c["l_m"], "U_LIM": c["u_lim"], "UF_LO": -c["u_max_f"], "UF_HI": c["u_max_f"],
            "KI_TAU": c["ki"] * tau, "KIF_TAU": c["ki_f"] * tau, "AW": tau * c["ki"] / c["kp"],
            "AW_F": tau * c["ki_f"] / c["kp_f"], "INV_UMAX_D": 1.0 / c["u_max_d"], "INV_UMAX_Q": 1.0 / c["u_max_q"],
            "INV_UMAX_F": 1.0 / c["u_max_f"],
        }

    def forward(self, obs, t, carry, params=None):
        c = self.consts
        i_d_ref, i_q_ref, i_f_ref, r_s, r_f = c["i_d_ref"], c["i_q_ref"], c["i_f_ref"], c["r_s"], c["r_f"]
        kp, ki, kp_f, ki_f, tau = c["kp"], c["ki"], c["kp_f"], c["ki_f"], c["tau"]
        omega_el, l_d, l_q, l_m, u_max_f = c["omega_el"], c["l_d"], c["l_q"], c["l_m"], c["u_max_f"]
        i_d, i_q, i_f = _denormalized(obs[:3], self.spans)
        int_d, int_q, int_f = carry
        e_d = i_d_ref - i_d
        e_q = i_q_ref - i_q
        e_f = i_f_ref - i_f
        # decoupling feedforward: resistive drop at the setpoint, speed
        # cross-terms on the measured currents
        u_d_unsat = kp * e_d + int_d + r_s * i_d_ref - omega_el * l_q * i_q
        u_q_unsat = kp * e_q + int_q + r_s * i_q_ref + omega_el * (l_d * i_d + l_m * i_f)
        u_f_unsat = kp_f * e_f + int_f + r_f * i_f_ref
        # stator voltage-vector limit, field per-axis clip
        u_mag = torch.sqrt(u_d_unsat * u_d_unsat + u_q_unsat * u_q_unsat)
        scale = torch.clamp(c["u_lim"] / torch.clamp(u_mag, min=1e-9), max=1.0)
        u_d = u_d_unsat * scale
        u_q = u_q_unsat * scale
        u_f = torch.clamp(u_f_unsat, -u_max_f, u_max_f)
        # back-calculation anti-windup (tracking time = the PI's own T_i)
        int_d = int_d + ki * tau * e_d + (tau * ki / kp) * (u_d - u_d_unsat)
        int_q = int_q + ki * tau * e_q + (tau * ki / kp) * (u_q - u_q_unsat)
        int_f = int_f + ki_f * tau * e_f + (tau * ki_f / kp_f) * (u_f - u_f_unsat)
        return (u_d / c["u_max_d"], u_q / c["u_max_q"], u_f / u_max_f), (int_d, int_q, int_f)


def make_eesm_current_tile(model, *, i_d_ref: float, i_q_ref: float, i_f_ref: float, kp: float = None,
                           ki: float = None, kp_f: float = None, ki_f: float = None):
    """dq and field PI current control of the
    :class:`~exciting_environments_torch.models.eesm.EESM` as a stateful tile
    policy of the closed-loop kernel (``utils/foc.py:494`` of the JAX
    package).

    The rotor-frame model needs no orientation step; the q-axis feedforward
    carries the field's back-EMF ``omega_el l_m i_f`` beside the speed
    cross-terms.  Three PI integrators ride carry planes; the stator pair is
    limited as a voltage vector and the field voltage per axis, both with
    back-calculation anti-windup.  Default gains: ``kp = 2000 sigma_l_d``,
    ``kp_f = 400 sigma_l_f`` with ``sigma_l_d = D / l_f``, ``sigma_l_f = D /
    l_d``, integral times 5 ms and 20 ms.

    Args:
        model: the :class:`EESM` (scalar normalizations and static params).
        i_d_ref / i_q_ref / i_f_ref: scalar current setpoints [A].
        kp / ki, kp_f / ki_f: stator and field PI gains.

    Returns:
        ``(policy, carry0)``: an :class:`EesmCurrentPolicy` and ``(int_d,
        int_q, int_f)`` zero planes.
    """
    who = "make_eesm_current_tile"

    def _scalar(name):
        v = getattr(model.env_properties.static_params, name)
        if _is_batched(v):
            raise ValueError(
                f"{who} needs scalar static params (the kernel folds them into the program); {name} has shape "
                f"{tuple(v.shape)} — run per-batch machines through vmap_step with a host-side law instead"
            )
        return float(v)

    for _name, _v in (("i_d_ref", i_d_ref), ("i_q_ref", i_q_ref), ("i_f_ref", i_f_ref)):
        if np.ndim(_v) != 0:
            raise ValueError(f"{who} needs scalar setpoints (the kernel closes over them); {_name} has shape "
                             f"{np.shape(_v)}")
    r_s, r_f = _scalar("r_s"), _scalar("r_f")
    l_d, l_q, l_f, l_m = _scalar("l_d"), _scalar("l_q"), _scalar("l_f"), _scalar("l_m")
    omega_el = _scalar("omega_el")
    tau = float(model.tau)
    det = l_d * l_f - l_m * l_m
    sigma_l_d, sigma_l_f = det / l_f, det / l_d
    kp = 2000.0 * sigma_l_d if kp is None else kp
    ki = kp / 5e-3 if ki is None else ki
    kp_f = 400.0 * sigma_l_f if kp_f is None else kp_f
    ki_f = kp_f / 20e-3 if ki_f is None else ki_f

    _check_symmetric(model, ("u_d", "u_q", "u_f"), who)
    an = model.env_properties.action_normalizations
    u_max_d, u_max_q, u_max_f = float(an.u_d.max), float(an.u_q.max), float(an.u_f.max)
    pn = model.env_properties.physical_normalizations
    spans = tuple((getattr(pn, n).min, getattr(pn, n).max) for n in ("i_d", "i_q", "i_f"))
    if any(_is_batched(v) for span in spans for v in span):
        raise ValueError(f"{who} needs scalar physical normalizations (the fused closed-loop kernel folds them "
                         "into the program)")
    spans = tuple((float(mn), float(mx)) for mn, mx in spans)
    consts = dict(i_d_ref=float(i_d_ref), i_q_ref=float(i_q_ref), i_f_ref=float(i_f_ref), r_s=r_s, r_f=r_f, l_d=l_d,
                  l_q=l_q, l_m=l_m, omega_el=omega_el, tau=tau, kp=float(kp), ki=float(ki), kp_f=float(kp_f),
                  ki_f=float(ki_f), u_max_d=u_max_d, u_max_q=u_max_q, u_max_f=u_max_f, u_lim=min(u_max_d, u_max_q))
    policy = EesmCurrentPolicy(consts, spans, 3 + len(model.control_state))
    zeros = lambda: torch.zeros(model.batch_size, dtype=model.dtype, device=model.device)
    return policy, (zeros(), zeros(), zeros())
