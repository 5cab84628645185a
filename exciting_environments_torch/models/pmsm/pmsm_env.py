"""Permanent-magnet synchronous motor (PMSM) drive environment (counterpart
of ``exciting_environments_tpu/models/pmsm/pmsm_env.py``), with its
stochastic simulation (process noise on the currents, sensor noise on the
measured columns).

A 7-component dq-frame physical state (``u_d_buffer``, ``u_q_buffer``,
``epsilon``, ``i_d``, ``i_q``, ``torque``, ``omega_el``), one step of
actuation deadtime, the inverter voltage hexagon applied at the
deadtime-advanced electrical angle, and either linear magnetics or the
measured saturation tables of a motor variant.  The electrical subsystem
``(i_d, i_q, epsilon)`` is integrated with ``omega_el`` frozen.

Methods are elementwise over tensors, so one code path serves a single
instance, a batch ``(B,)`` and time-major trajectories ``(T, B)``.  The fused
entry points run the current integration through the hand-written CUDA
kernel ``csrc/pmsm_stepper.cu`` (see
:mod:`exciting_environments_torch.ops.kernels.pmsm_stepper`), the closed
loop through ``csrc/pmsm_closed_loop.cu`` (see
:mod:`exciting_environments_torch.ops.kernels.pmsm_closed_loop`), and the
trig-free fast rollout through ``csrc/pmsm_fast.cu`` (see
:mod:`exciting_environments_torch.ops.kernels.pmsm_fast_kernel`).
"""

from __future__ import annotations

import math
from dataclasses import fields
from types import MethodType
from typing import Callable

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import CoreEnvironment, _Components, is_key, resolve_device
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.models.pmsm.motor_parameters import MotorVariant
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.ops.lut import SATURATED_QUANTITIES, build_pmsm_lut
from exciting_environments_torch.ops.rollout import solve_trajectory, zoh_action
from exciting_environments_torch.ops.transforms import albet2dq, apply_hex_constraint, dq2albet, step_eps


def wrap_angle(eps):
    """The solver step's wrap into [-pi, pi): ``((x + pi) % 2 pi) - pi``."""
    return ((eps + math.pi) % (2 * math.pi)) - math.pi


def extrapolation_offsets(tau: float, n: int, dtype, device):
    """``linspace(0, tau * (n - 1), n)`` as an ``(n,)`` tensor, computed on
    the host in ``dtype`` with ``jnp.linspace``'s formula, op by op
    (``start * (1 - s) + stop * s`` with ``s = i / (n - 1)``, then the exact
    endpoint); ``torch.linspace`` fills its upper half another way."""
    dt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    start, stop = dt(0.0), dt(tau * (n - 1))
    if n > 1:
        step = np.arange(n - 1, dtype=dt) / dt(n - 1)
        offsets = np.concatenate([start * (dt(1) - step) + stop * step, [stop]])
    else:
        offsets = np.full(n, start)
    return torch.as_tensor(offsets.astype(dt), device=device)


def extrapolated_angles(eps0, omega, tau: float, n: int):
    """``eps0 + linspace(0, tau * (n - 1), n) * omega`` over a new leading
    time axis: the angles at which ``sim_ahead`` applies the hexagon
    constraint, from :func:`extrapolation_offsets`.  ``sim_ahead`` and the
    fused path's plain version call this one helper; the fused kernel takes
    the same offsets."""
    offsets = extrapolation_offsets(tau, n, eps0.dtype, eps0.device).reshape((n,) + (1,) * eps0.ndim)
    return eps0 + offsets * omega


class PMSM(CoreEnvironment):
    """dq-frame PMSM drive with deadtime buffering and hexagon voltage limits.

    State Variables:
        ``['u_d_buffer', 'u_q_buffer', 'epsilon', 'i_d', 'i_q', 'torque', 'omega_el']``

    Action Variables:
        ``['u_d', 'u_q']`` (dq-frame voltages, normalized)

    Example:
        >>> import torch
        >>> import exciting_environments_torch as excenvs
        >>> env = excenvs.PMSM(batch_size=4, saturated=True,
        ...                    motor_variant=excenvs.MotorVariant.BRUSA, device="cpu")
        >>> obs, state = env.vmap_reset()
        >>> obs, state = env.vmap_step(state, torch.zeros((4, 2)))
    """

    #: circular physical field (the PMSM wraps ``epsilon`` in its own step;
    #: ``_ode_state_fields`` stays empty, so no generic wrap runs on it)
    _angle_fields = ("epsilon",)
    #: the observation columns that take sensor noise (the observation
    #: re-encodes epsilon as cos/sin, so the generic head layout does not apply)
    _obs_noise_layout = ((0, "i_d"), (1, "i_q"), (2, "omega_el"), (3, "torque"))
    #: process noise perturbs the integrated currents, in the kernels' order
    _process_fields = ("i_d", "i_q")

    def __init__(
        self,
        batch_size: int = 8,
        saturated=False,
        motor_variant: MotorVariant = MotorVariant.DEFAULT,
        physical_normalizations: dict = None,
        action_normalizations: dict = None,
        soft_constraints: Callable = None,
        static_params: dict = None,
        control_state: list = None,
        solver=None,
        tau: float = 1e-4,
        process_noise: dict = None,
        observation_noise: dict = None,
        noise_mode: str = "exact",
        device=None,
        dtype: torch.dtype = torch.float32,
    ):
        """
        Args:
            batch_size: Number of parallel environment simulations.
            saturated: Use the measured flux-linkage/inductance tables instead
                of the linear magnetics model.
            motor_variant: Preset supplying default normalizations, static
                parameters, soft constraints and (BRUSA/SEW) the tables.
            physical_normalizations: Min/max per physical-state component.
            action_normalizations: Min/max per action component.
            soft_constraints: Soft-constraint function for state/action.
            static_params: p, r_s, l_d, l_q, psi_p, u_dc, deadtime; Python
                scalars or ``(batch_size,)`` arrays.
            control_state: Physical-state components tracked by references.
            solver: ODE solver instance or registry name (default Euler).
            tau: Control/simulation step duration in seconds.
            process_noise: Optional ``{"i_d" | "i_q": sigma}`` Euler-Maruyama
                current disturbance (A per sqrt-second) after each step, the
                torque recomputed from the perturbed currents; same key
                semantics as the classic environments.
            observation_noise: Optional ``{field: sigma}`` sensor noise on the
                measured columns ``i_d``, ``i_q``, ``omega_el``, ``torque``.
            noise_mode: ``"exact"`` (per-step ``split(key, 3)`` chain) or
                ``"fast"`` (counter-style ``fold_in(key, t)`` draws).
            device: Torch device (default CUDA; raises without a GPU).
            dtype: Floating dtype of the states and of the tables.
        """
        device = resolve_device(device)
        motor_params = motor_variant.get_params()
        default_physical_normalizations = motor_params.physical_normalizations.__dict__
        default_action_normalizations = motor_params.action_normalizations.__dict__
        default_static_params = dict(motor_params.static_params.__dict__)
        default_soft_constraints = MethodType(motor_params.default_soft_constraints, self)

        nan_interpolators = {q: (lambda x: torch.tensor([math.nan])) for q in SATURATED_QUANTITIES}
        self._lut = None
        if motor_variant != MotorVariant.DEFAULT:
            if saturated:
                # linear parameters are meaningless in the saturated model
                default_static_params.update(l_d=math.nan, l_q=math.nan, psi_p=math.nan)
                self._lut, self.pmsm_lut = build_pmsm_lut(motor_params.pmsm_lut, device=device, dtype=dtype)
                self.LUT_interpolators = self._lut.as_dict()
            else:
                self.pmsm_lut = motor_params.pmsm_lut
                self.LUT_interpolators = nan_interpolators
        else:
            if saturated:
                raise ValueError(
                    f"MotorVariant '{motor_variant.value}' is not allowed for saturated LUTs. "
                    "Use a specific motor variant. DEFAULT is only valid for saturated=False."
                )
            self.pmsm_lut = motor_params.pmsm_lut
            self.LUT_interpolators = nan_interpolators

        if not static_params:
            static_params = default_static_params
        if not physical_normalizations:
            physical_normalizations = default_physical_normalizations
        else:
            for name in ("i_d", "i_q"):
                lims, def_lims = physical_normalizations[name], default_physical_normalizations[name]
                if float(torch.as_tensor(lims.min).min()) < def_lims.min or float(
                    torch.as_tensor(lims.max).max()
                ) > def_lims.max:
                    print(
                        f"The defined permitted range of {name} ({lims}) exceeds the limits of the "
                        f"LUT ({def_lims}). Values outside this range are extrapolated."
                    )
        if not action_normalizations:
            action_normalizations = default_action_normalizations
        if not control_state:
            control_state = []
        if not soft_constraints:
            soft_constraints = default_soft_constraints

        self.control_state = control_state
        self.soft_constraints = soft_constraints
        self._configure_noise(process_noise, observation_noise, noise_mode, process_fields=self._process_fields,
                              observation_fields=tuple(name for _col, name in self._obs_noise_layout))
        env_properties = self.EnvProperties(
            saturated=saturated,
            physical_normalizations=self.PhysicalState(**physical_normalizations),
            action_normalizations=self.Action(**action_normalizations),
            static_params=self.StaticParams(**static_params),
        )
        super().__init__(batch_size, env_properties=env_properties, tau=tau, solver=solver,
                         device=device, dtype=dtype)
        self._action_description = ["u_d", "u_q"]
        # the column order of generate_observation
        self._obs_description = ["i_d", "i_q", "omega_el", "torque", "cos_eps", "sin_eps", "u_d_buffer", "u_q_buffer"]

    # ------------------------------------------------------------------
    # containers
    # ------------------------------------------------------------------

    @dataclass
    class StaticParams:
        """Electrical parameters of the drive."""

        p: object
        r_s: object
        l_d: object
        l_q: object
        psi_p: object
        u_dc: object
        deadtime: object

    @dataclass
    class PhysicalState:
        """Physical state of the drive."""

        u_d_buffer: object
        u_q_buffer: object
        epsilon: object
        i_d: object
        i_q: object
        torque: object
        omega_el: object

    @dataclass
    class Additions:
        """Solver carry threaded between steps."""

        solver_state: tuple
        active_solver_state: object

    @dataclass
    class Action:
        """dq-frame voltage action."""

        u_d: object
        u_q: object

    @dataclass
    class EnvProperties:
        """Constant-per-simulation properties (adds the ``saturated`` flag)."""

        saturated: bool
        physical_normalizations: object
        action_normalizations: object
        static_params: object

    # ------------------------------------------------------------------
    # magnetics
    # ------------------------------------------------------------------

    def currents_to_torque(self, i_d, i_q, env_properties):
        """Linear-magnetics torque: 1.5 p (psi_p + (l_d - l_q) i_d) i_q."""
        params = env_properties.static_params
        return 1.5 * params.p * (params.psi_p + (params.l_d - params.l_q) * i_d) * i_q

    def currents_to_torque_saturated(self, i_d, i_q, env_properties):
        """Saturated torque from the flux-linkage tables (NaN without them)."""
        if self._lut is None:
            return math.nan * (i_d + i_q)
        vals = self._lut.interpolate_all(i_d, i_q)
        psi_d, psi_q = vals[4], vals[5]
        return 3 / 2 * env_properties.static_params.p * (psi_d * i_q - psi_q * i_d)

    def _torque(self, i_d, i_q, env_properties):
        if env_properties.saturated:
            return self.currents_to_torque_saturated(i_d, i_q, env_properties)
        return self.currents_to_torque(i_d, i_q, env_properties)

    def nonlinear_ode(self, t, y, args, action):
        """Saturated electrical dynamics with the differential inductance
        matrix gathered from the tables and inverted in closed form
        (reference ``pmsm_env.py:487-507``)."""
        i_d, i_q, eps = y
        static_params, omega_el = args
        u_dq = action(t)
        vals = self._lut.interpolate_all(i_d, i_q)
        l_dd, l_dq, l_qd, l_qq = vals[0], vals[1], vals[2], vals[3]
        psi_d, psi_q = vals[4], vals[5]
        det = l_dd * l_qq - l_dq * l_qd
        inv_dd, inv_dq = l_qq / det, -l_dq / det
        inv_qd, inv_qq = -l_qd / det, l_dd / det
        # di/dt = L_diff^-1 (u - r_s i - omega_el J psi), J = [[0, -1], [1, 0]]
        rhs_d = u_dq[0] - static_params.r_s * i_d + omega_el * psi_q
        rhs_q = u_dq[1] - static_params.r_s * i_q - omega_el * psi_d
        i_d_diff = inv_dd * rhs_d + inv_dq * rhs_q
        i_q_diff = inv_qd * rhs_d + inv_qq * rhs_q
        return i_d_diff, i_q_diff, omega_el

    def linear_ode(self, t, y, args, action):
        """Linear-magnetics electrical dynamics (reference ``pmsm_env.py:509-523``)."""
        i_d, i_q, eps = y
        params, omega_el = args
        u_dq = action(t)
        u_d, u_q = u_dq[0], u_dq[1]
        i_d_diff = (u_d + omega_el * params.l_q * i_q - params.r_s * i_d) / params.l_d
        i_q_diff = (u_q - omega_el * (params.l_d * i_d + params.psi_p) - params.r_s * i_q) / params.l_q
        return i_d_diff, i_q_diff, omega_el

    def _pmsm_vector_field(self, saturated, action_callable):
        ode = self.nonlinear_ode if saturated else self.linear_ode
        return lambda t, y, args: ode(t, y, args, lambda tt: _Components(action_callable(tt)))

    # ------------------------------------------------------------------
    # reset
    # ------------------------------------------------------------------

    def _fill(self, shape, value):
        if isinstance(value, torch.Tensor):
            return value.to(self.dtype).expand(shape).clone()
        return self._full(shape, value)

    def _ball(self, rng, shape):
        """Uniform draws in the unit disc, ``shape + (2,)``, with the
        construction of ``jax.random.ball`` (p = 2): a generalized normal
        (density ``exp(-|x|^2)``) over the root of its squared norm plus an
        exponential draw.  With keys ``shape + (2,)`` the two halves of
        ``split(key)`` draw them (``jax.random.ball``'s key use); the
        generalized normal is then ``normal * sqrt(1/2)``, the same law as the
        JAX package's gamma-based sampler but not its bits."""
        if is_key(rng):
            keys = prng.split(rng)
            g = prng.normal(keys[..., 0, :], 2, self.dtype) * math.sqrt(0.5)
            e = prng.exponential(keys[..., 1, :], 1, self.dtype)[..., 0]
        else:
            g = torch.randn(shape + (2,), generator=rng, dtype=self.dtype, device=self.device) * math.sqrt(0.5)
            e = torch.empty(shape, dtype=self.dtype, device=self.device).exponential_(generator=rng)
        return g / ((g.abs() ** 2).sum(-1) + e).sqrt()[..., None]

    def init_state(self, env_properties, rng=None, batch_shape=()):
        """Default or random initial state.  Random draws place ``i_dq``
        uniformly in the admissible current disc (rejected halves folded
        back, reference ``pmsm_env.py:402-427``) and derive the consistent
        torque from the active magnetics model.  ``rng``: ``None``, a
        ``torch.Generator``, or keys ``batch_shape + (2,)``, used as the JAX
        package uses them (two splits; the remaining key becomes the
        state's)."""
        norms = env_properties.physical_normalizations
        shape = tuple(batch_shape)
        zeros = lambda: self._full(shape, 0.0)
        key = self._full(shape, math.nan)
        if rng is None:
            phys = self.PhysicalState(
                u_d_buffer=zeros(),
                u_q_buffer=zeros(),
                epsilon=zeros(),
                i_d=self._fill(shape, (norms.i_d.min + norms.i_d.max) / 2),
                i_q=zeros(),
                torque=zeros(),
                omega_el=self._fill(shape, (norms.omega_el.min + norms.omega_el.max) / 2),
            )
        else:
            if is_key(rng):
                first = prng.split(rng)
                state_norm = prng.uniform(first[..., 1, :], 2, self.dtype, -1.0, 1.0)
                second = prng.split(first[..., 0, :])
                i_dq_norm = self._ball(second[..., 1, :], shape)
                key = second[..., 0, :]
            else:
                state_norm = torch.rand(shape + (2,), generator=rng, dtype=self.dtype, device=self.device) * 2 - 1
                i_dq_norm = self._ball(rng, shape)
            bounds = (norms.i_d.min, norms.i_d.max, norms.i_q.min, norms.i_q.max)
            i_max = torch.stack([self._fill(shape, abs(v)) for v in bounds]).amax(0)
            i_dq_rand = i_dq_norm * i_max[..., None]
            i_d = (
                i_dq_rand[..., 0]
                - 2 * torch.relu(i_dq_rand[..., 0] - norms.i_d.max)
                + 2 * torch.relu(-i_dq_rand[..., 0] + norms.i_d.min)
            )
            i_q = (
                i_dq_rand[..., 1]
                - 2 * torch.relu(i_dq_rand[..., 1] - norms.i_q.max)
                + 2 * torch.relu(-i_dq_rand[..., 1] + norms.i_q.min)
            )
            phys = self.PhysicalState(
                u_d_buffer=zeros(),
                u_q_buffer=zeros(),
                epsilon=norms.epsilon.denormalize(state_norm[..., 0]),
                i_d=i_d,
                i_q=i_q,
                torque=self._torque(i_d, i_q, env_properties),
                omega_el=norms.omega_el.denormalize(state_norm[..., 1]),
            )
        return self.State(
            physical_state=phys,
            PRNGKey=key,
            additions=self._pmsm_solver_additions(env_properties, phys),
            reference=self._nan_reference(shape),
        )

    def _pmsm_solver_additions(self, env_properties, phys):
        """NaN-poisoned solver carry for a fresh state (the PMSM integrates
        only the electrical subsystem ``(i_d, i_q, epsilon)``)."""
        zero_action = torch.zeros(self.action_dim, dtype=self.dtype, device=self.device)
        f = self._pmsm_vector_field(env_properties.saturated, lambda t: zero_action)
        args = (env_properties.static_params, phys.omega_el)
        solver_state = self._solver.init(f, 0.0, self.tau, (phys.i_d, phys.i_q, phys.epsilon), args)
        if solver_state is not None:
            solver_state = tuple(k * math.nan for k in solver_state)
        return self.Additions(solver_state=solver_state, active_solver_state=False)

    def _init_solver_additions(self, env_properties, physical_state, nan_fill=True):
        """The PMSM's own solver carry stands in for the generic one."""
        return self._pmsm_solver_additions(env_properties, physical_state)

    # ------------------------------------------------------------------
    # integration
    # ------------------------------------------------------------------

    def _ode_solver_step(self, state, u_dq, properties):
        """One electrical-subsystem step under the applied voltage ``u_dq``
        ``(..., 2)``; torque is recomputed from the new currents (reference
        ``pmsm_env.py:525-592``).  The solver carry is re-initialized against
        the current voltage every step."""
        system_state = state.physical_state
        f = self._pmsm_vector_field(properties.saturated, lambda t: u_dq)
        args = (properties.static_params, system_state.omega_el)
        y0 = (system_state.i_d, system_state.i_q, system_state.epsilon)
        carry = self._solver.init(f, 0.0, self.tau, y0, args)
        (i_d, i_q, eps), solver_state = self._solver.step(f, 0.0, self.tau, y0, args, carry)
        physical_state = structures.replace(
            system_state, epsilon=wrap_angle(eps), i_d=i_d, i_q=i_q, torque=self._torque(i_d, i_q, properties)
        )
        return structures.replace(
            state,
            physical_state=physical_state,
            additions=self.Additions(
                solver_state=solver_state,
                active_solver_state=torch.ones(i_d.shape, dtype=torch.bool, device=i_d.device),
            ),
        )

    def _ode_solver_simulate_ahead(self, init_state, actions, properties, obs_stepsize, action_stepsize):
        """Trajectory integration of the electrical subsystem with frozen
        ``omega_el`` over time-major physical voltages ``(n, ..., 2)``;
        returns a ``State`` with a leading ``n_steps + 1`` axis (reference
        ``pmsm_env.py:618-707``)."""
        init_phys = init_state.physical_state
        f = self._pmsm_vector_field(properties.saturated, zoh_action(actions, action_stepsize))
        args = (properties.static_params, init_phys.omega_el)
        y0 = (init_phys.i_d, init_phys.i_q, init_phys.epsilon)
        t1 = action_stepsize * actions.shape[0]
        n_steps = int(t1 / obs_stepsize)

        (i_d_t, i_q_t, eps_t), _ = solve_trajectory(self._solver, f, y0, args, n_steps, obs_stepsize)
        eps_t = wrap_angle(eps_t)
        obs_len = n_steps + 1
        shape = tuple(i_d_t.shape)
        phys = self.PhysicalState(
            u_d_buffer=self._full(shape, 0.0),
            u_q_buffer=self._full(shape, 0.0),
            epsilon=eps_t,
            i_d=i_d_t,
            i_q=i_q_t,
            torque=self._torque(i_d_t, i_q_t, properties),
            omega_el=self._tile_time(init_phys.omega_el, obs_len),
        )
        solver_state = self._solver.init(f, t1, t1 + self.tau, (i_d_t[-1], i_q_t[-1], eps_t[-1]), args)
        return self.State(
            physical_state=phys,
            PRNGKey=self._tile_time(init_state.PRNGKey, obs_len),
            additions=self.Additions(
                solver_state=self.repeat_values(solver_state, obs_len),
                active_solver_state=torch.ones(shape, dtype=torch.bool, device=i_d_t.device),
            ),
            reference=self.PhysicalState(**{f.name: self._full(shape, math.nan) for f in fields(self.PhysicalState)}),
        )

    def _pmsm_sde_simulate_ahead(self, init_state, actions, properties, obs_stepsize, action_stepsize):
        """Euler-Maruyama trajectory of the electrical subsystem (the
        stochastic counterpart of :meth:`_ode_solver_simulate_ahead`,
        one-stage solvers): :meth:`_sde_trajectory` with the current
        increments on the raw carry (the angle is never perturbed), then the
        angle wrapped and the torque of the perturbed currents at every save,
        each save carrying its step's advanced key.  Returns ``(states,
        eps_obs)``."""
        init_phys = init_state.physical_state
        f = self._pmsm_vector_field(properties.saturated, zoh_action(actions, action_stepsize))
        args = (properties.static_params, init_phys.omega_el)
        y0 = (init_phys.i_d, init_phys.i_q, init_phys.epsilon)
        t1 = action_stepsize * actions.shape[0]
        n_steps = int(t1 / obs_stepsize)
        (i_d_t, i_q_t, eps_t), keys, eps_obs = self._sde_trajectory(
            f, y0, args, self._require_noise_key(init_state), n_steps, obs_stepsize, self._noise_idx())
        eps_t = wrap_angle(eps_t)
        obs_len = n_steps + 1
        shape = tuple(i_d_t.shape)
        phys = self.PhysicalState(
            u_d_buffer=self._full(shape, 0.0),
            u_q_buffer=self._full(shape, 0.0),
            epsilon=eps_t,
            i_d=i_d_t,
            i_q=i_q_t,
            torque=self._torque(i_d_t, i_q_t, properties),
            omega_el=self._tile_time(init_phys.omega_el, obs_len),
        )
        solver_state = self._solver.init(f, t1, t1 + self.tau, (i_d_t[-1], i_q_t[-1], eps_t[-1]), args)
        states = self.State(
            physical_state=phys,
            PRNGKey=keys,
            additions=self.Additions(
                solver_state=self.repeat_values(solver_state, obs_len),
                active_solver_state=torch.ones(shape, dtype=torch.bool, device=i_d_t.device),
            ),
            reference=self.PhysicalState(**{f.name: self._full(shape, math.nan) for f in fields(self.PhysicalState)}),
        )
        return states, eps_obs

    def _state_from_normalized_physical(self, x_norm, env_properties, ref_norm=None):
        """The state from normalized physical fields, built directly (the
        observation re-encodes epsilon as cos/sin)."""
        names = tuple(f.name for f in fields(self.PhysicalState))
        batch_shape = tuple(x_norm.shape[:-1])
        phys = self.PhysicalState(**{name: x_norm[..., i] for i, name in enumerate(names)})
        ref = self._nan_reference(batch_shape)
        for pos, name in enumerate(self.control_state if ref_norm is not None else ()):
            setattr(ref, name, ref_norm[..., pos])
        norm_state = self.State(physical_state=phys, PRNGKey=self._full(batch_shape, math.nan),
                                additions=self._pmsm_solver_additions(env_properties, phys), reference=ref)
        return self.denormalize_state(norm_state, env_properties)

    def _apply_process_noise_eps(self, state, eps, env_properties):
        """Euler-Maruyama current disturbance: ``sigma * sqrt(tau) * xi`` on
        ``i_d``/``i_q``, and the torque recomputed from the perturbed currents
        (tables or linear magnetics)."""
        coef = self._noise_coef(self.tau)
        phys = state.physical_state
        cur = {"i_d": phys.i_d, "i_q": phys.i_q}
        for j, (name, _) in enumerate(self._process_items):
            cur[name] = cur[name] + coef[j] * eps[..., j]
        torque = self._torque(cur["i_d"], cur["i_q"], env_properties)
        return structures.replace(state, physical_state=structures.replace(phys, torque=torque, **cur))

    def fused_rollout(self, init_state, actions, obs_stride: int = None,
                      time_major: bool = False, strict: bool = False):
        """:meth:`vmap_rollout` through the PMSM drive kernel
        (``csrc/pmsm_stepper.cu``: the angle, the constraint, the deadtime
        buffer and the current integration in one launch; its plain version
        on CPU tensors).  Out of kernel scope it takes the loop, or raises
        with ``strict=True``."""
        from exciting_environments_torch.ops.kernels.pmsm_stepper import pmsm_fused_rollout

        return pmsm_fused_rollout(self, init_state, actions, obs_stride=obs_stride,
                                  time_major=time_major, strict=strict)

    def fused_sim_ahead(self, init_state, actions, obs_stepsize, action_stepsize,
                        obs_stride: int = 1, time_major: bool = False, strict: bool = False):
        """:meth:`vmap_sim_ahead` semantics through the drive kernel for
        ``obs_stepsize == action_stepsize``; returns ``(observations,
        last_state)``.  Otherwise the loop, or a raise with ``strict=True``."""
        from exciting_environments_torch.ops.kernels.pmsm_stepper import pmsm_fused_sim_ahead

        obs, last = pmsm_fused_sim_ahead(self, init_state, actions, obs_stepsize, action_stepsize,
                                         time_major=time_major, strict=strict)
        return (obs[:, ::obs_stride] if obs_stride != 1 else obs), last

    def fast_rollout(self, init_state, actions, time_major: bool = False):
        """Trig-free fast-math rollout (rotation-carry semantics of
        ``ops/pmsm_fast.py``) in one launch of the kernel ``csrc/pmsm_fast.cu``
        (either action layout read in place), its plain version on CPU
        tensors; returns the final ``State``.  Tolerance
        against :meth:`fused_rollout`: 1e-4 of the current scale over 32
        steps.  Scope: scalar parameters, Euler, deadtime 0 or 1 (else
        ``ValueError``).  See
        :func:`~exciting_environments_torch.ops.kernels.pmsm_fast_kernel.pmsm_fast_fused_rollout`."""
        from exciting_environments_torch.ops.kernels.pmsm_fast_kernel import pmsm_fast_fused_rollout

        return pmsm_fast_fused_rollout(self, init_state, actions, time_major=time_major)

    def fused_closed_loop(self, init_state, policy, n_steps: int, obs_stride: int = None,
                          policy_params=None, return_traj_states: bool = False, policy_carry=None,
                          sched_lut=None):
        """Closed loop with the policy inside the PMSM closed-loop kernel
        (``csrc/pmsm_closed_loop.cu``; its plain version on CPU tensors):
        observation -> policy -> hexagon at the deadtime-advanced angle ->
        deadtime buffer -> LUT step, ``n_steps`` times in one launch.  On CUDA
        the policy is an ``AffinePolicy`` or a sensorless tile of
        ``utils/foc.py``; on the CPU any callable with the tile contract.
        ``policy_carry`` makes the policy stateful (every return shape then
        ends with the final carry) and ``sched_lut`` appends the scheduled
        gather at the belief currents to the observation.  Raises out of
        kernel scope.  See
        :func:`~exciting_environments_torch.ops.kernels.pmsm_closed_loop.pmsm_fused_closed_loop`."""
        from exciting_environments_torch.ops.kernels.pmsm_closed_loop import pmsm_fused_closed_loop

        return pmsm_fused_closed_loop(
            self, init_state, policy, n_steps, obs_stride=obs_stride, return_traj_states=return_traj_states,
            policy_params=policy_params, policy_carry=policy_carry, sched_lut=sched_lut,
        )

    # ------------------------------------------------------------------
    # inverter constraint + deadtime
    # ------------------------------------------------------------------

    def _constrain(self, u_dq_norm, eps, omega_el, env_properties):
        """Denormalize ``u_dq_norm`` ``(..., 2)`` and clip it into the voltage
        hexagon at the deadtime-advanced angle of ``eps`` ``(...)``.  The
        ``(d, q)`` components stay separate until the end, so that per-batch
        ``(B,)`` parameters broadcast against time-major ``(T, B)`` slabs."""
        params = env_properties.static_params
        u_dq = self.denormalize_action(u_dq_norm, env_properties)
        scale = 1 / (params.u_dc / 2)
        u_norm = torch.stack([u_dq[..., 0] * scale, u_dq[..., 1] * scale], dim=-1)
        advanced_angle = step_eps(eps, omega_el, self.tau, params.deadtime + 0.5)
        u_albet_clip = apply_hex_constraint(dq2albet(u_norm, advanced_angle))
        u_dq_clip = albet2dq(u_albet_clip, advanced_angle)
        half_dc = params.u_dc / 2
        return torch.stack([u_dq_clip[..., 0] * half_dc, u_dq_clip[..., 1] * half_dc], dim=-1)

    def constraint_denormalization(self, u_dq_norm, system_state, env_properties):
        """Denormalize ``u_dq`` and clip it into the voltage hexagon at the
        deadtime-advanced electrical angle (reference ``pmsm_env.py:594-616``)."""
        phys = system_state.physical_state
        return self._constrain(u_dq_norm, phys.epsilon, phys.omega_el, env_properties)

    def constraint_denormalization_ahead(self, actions, init_state, env_properties):
        """The hexagon constraint over a time-major action sequence ``(n, ...,
        2)``, with the angle extrapolated linearly from the initial state
        (reference ``pmsm_env.py:709-744``).  The extrapolation uses
        ``self.tau`` whatever step the caller integrates with: the
        reference's hard-coded ``tau``, kept on purpose."""
        phys = init_state.physical_state
        eps = extrapolated_angles(phys.epsilon, phys.omega_el, self.tau, actions.shape[0])
        return self._constrain(actions, eps, phys.omega_el, env_properties)

    def _delayed_voltages(self, init_state, actions_con, deadtime):
        """``(acts_buf, actions_dead)``: the initial buffer repeated
        ``deadtime`` times, and the constrained sequence shifted behind it."""
        phys = init_state.physical_state
        buf = torch.stack([phys.u_d_buffer, phys.u_q_buffer], dim=-1)
        acts_buf = buf.expand((deadtime,) + tuple(buf.shape))
        n = actions_con.shape[0]
        return acts_buf, torch.cat([acts_buf, actions_con[: n - deadtime]], dim=0)

    def _sim_ahead(self, init_state, actions_tm, env_properties, obs_stepsize, action_stepsize):
        """Trajectory simulation with the hexagon constraint and the deadtime
        shift of the action sequence (reference ``pmsm_env.py:746-801``) over
        time-major normalized actions; returns time-major ``(observations,
        states, last_state)``.  A stochastic drive integrates the SDE
        (:meth:`_pmsm_sde_simulate_ahead`; one-stage solvers only), the
        constraint and the deadtime shift unchanged."""
        actions = self.constraint_denormalization_ahead(actions_tm, init_state, env_properties)
        deadtime = env_properties.static_params.deadtime
        acts_buf, actions_dead = self._delayed_voltages(init_state, actions, deadtime)
        if self._has_noise:
            self._check_sde_solver()
            states, eps_obs = self._pmsm_sde_simulate_ahead(init_state, actions_dead, env_properties, obs_stepsize,
                                                            action_stepsize)
        else:
            states = self._ode_solver_simulate_ahead(init_state, actions_dead, env_properties, obs_stepsize,
                                                     action_stepsize)
            eps_obs = None

        with structures.copy_and_mutate(states) as states:
            # the reference's buffer patch, inverted ratio included: only
            # obs_stepsize == action_stepsize gives consistent lengths with
            # deadtime > 0 (pmsm_env.py:785-791), kept on purpose
            acts_m = torch.cat([acts_buf, actions], dim=0)
            acts_m = torch.repeat_interleave(acts_m, int(obs_stepsize / action_stepsize), dim=0)
            if deadtime == 0:
                acts_m = self._full((actions.shape[0] + 1,) + tuple(actions.shape[1:]), 0.0)
            states.physical_state.u_d_buffer = acts_m[..., 0]
            states.physical_state.u_q_buffer = acts_m[..., 1]

        observations = self._noisy_trajectory_observations(
            self.generate_observation(states, env_properties), env_properties, eps_obs)
        return observations, states, self._index_time(states, -1)

    def _rew_trunc_term(self, states_tm, actions_tm, env_properties):
        """Reward/flags for a time-major ``sim_ahead`` trajectory, with the
        hexagon constraint and deadtime shift (reference ``pmsm_env.py:803-849``)."""
        deadtime = env_properties.static_params.deadtime
        obs_len = structures.leaves(states_tm.physical_state)[0].shape[0]
        states_without_init_state = self._index_time(states_tm, slice(1, None))
        states_without_last_state = self._index_time(states_tm, slice(None, -1))
        actions = self.constraint_denormalization(actions_tm, states_without_last_state, env_properties)
        first = self._index_time(states_tm, 0)
        _, actions_dead = self._delayed_voltages(first, actions, deadtime)
        reward = self.generate_reward(
            states_without_init_state,
            torch.repeat_interleave(actions_dead, int((obs_len - 1) / actions_dead.shape[0]), dim=0),
            env_properties,
        )
        truncated = self.generate_truncated(states_tm, env_properties)
        terminated = self.generate_terminated(states_without_init_state, reward, env_properties)
        return reward, truncated, terminated

    def _advance_state(self, state, action, env_properties):
        """Deterministic drive update of one control step: the constrained
        action enters the buffer while the buffered voltage drives the plant
        (reference ``pmsm_env.py:851-883``).  :meth:`CoreEnvironment._step`'s
        noise hooks compose around it."""
        action = self.constraint_denormalization(action, state, env_properties)
        phys = state.physical_state
        action_buffer = torch.stack([phys.u_d_buffer, phys.u_q_buffer], dim=-1)
        deadtime = env_properties.static_params.deadtime
        if isinstance(deadtime, torch.Tensor):
            delayed = (deadtime > 0)[..., None]
            u_dq = torch.where(delayed, action_buffer, action)
            updated_buffer = torch.where(delayed, action, action_buffer)
        elif deadtime > 0:
            u_dq, updated_buffer = action_buffer, action
        else:
            u_dq, updated_buffer = action, action_buffer
        next_state = self._ode_solver_step(state, u_dq, env_properties)
        return structures.replace(
            next_state,
            physical_state=structures.replace(
                next_state.physical_state, u_d_buffer=updated_buffer[..., 0], u_q_buffer=updated_buffer[..., 1]
            ),
        )

    # ------------------------------------------------------------------
    # observation / reconstruction / reward
    # ------------------------------------------------------------------

    @property
    def action_description(self):
        return self._action_description

    @property
    def obs_description(self):
        return np.hstack([np.array(self._obs_description), np.array([name + "_ref" for name in self.control_state])])

    def generate_observation(self, system_state, env_properties):
        """Normalized (i_d, i_q, omega_el, torque), cos/sin of the angle, the
        normalized buffers, then any tracked reference components."""
        eps = system_state.physical_state.epsilon
        norm_state = self.normalize_state(system_state, env_properties)
        p = norm_state.physical_state
        cols = [p.i_d, p.i_q, p.omega_el, p.torque, torch.cos(eps), torch.sin(eps), p.u_d_buffer, p.u_q_buffer]
        cols += [getattr(norm_state.reference, name) for name in self.control_state]
        return torch.stack(cols, dim=-1)

    def generate_state_from_observation(self, obs, env_properties, key=None):
        """Rebuild the full state from an observation; the electrical angle is
        recovered from its cos/sin pair."""
        batch_shape = tuple(obs.shape[:-1])
        phys = self.PhysicalState(
            u_d_buffer=obs[..., 6],
            u_q_buffer=obs[..., 7],
            epsilon=torch.atan2(obs[..., 5], obs[..., 4]) / math.pi,
            i_d=obs[..., 0],
            i_q=obs[..., 1],
            torque=obs[..., 3],
            omega_el=obs[..., 2],
        )
        ref = self._nan_reference(batch_shape)
        for pos, name in enumerate(self.control_state):
            setattr(ref, name, obs[..., 8 + pos])
        norm_state = self.State(
            physical_state=phys,
            PRNGKey=key if key is not None else self._full(batch_shape, math.nan),
            additions=self._pmsm_solver_additions(env_properties, phys),
            reference=ref,
        )
        return self.denormalize_state(norm_state, env_properties)

    def generate_truncated(self, system_state, env_properties):
        """Truncate when the normalized current magnitude exceeds 1."""
        state_norm = self.normalize_state(system_state, env_properties).physical_state
        i_s = torch.sqrt(state_norm.i_d**2 + state_norm.i_q**2)
        return (i_s > 1)[..., None]

    def generate_terminated(self, system_state, reward, env_properties):
        """Terminal iff truncated (current limit violation)."""
        return self.generate_truncated(system_state, env_properties)

    def generate_reward(self, state, action, env_properties):
        """Current-tracking and/or torque-tracking reward, depending on the
        configured ``control_state``; shape ``(..., 1)``."""
        state_norm = self.normalize_state(state, env_properties)
        phys, ref = state_norm.physical_state, state_norm.reference
        reward = 0
        if "i_d" in self.control_state and "i_q" in self.control_state:
            reward += self.current_reward_func(phys.i_d, phys.i_q, ref.i_d, ref.i_q, 0.85)
        if "torque" in self.control_state:
            reward += self.torque_reward_func(phys.i_d, phys.i_q, phys.torque, ref.torque, 1, 0.85)
        if not isinstance(reward, torch.Tensor):
            reward = torch.full(phys.i_d.shape, float(reward), dtype=phys.i_d.dtype, device=phys.i_d.device)
        return reward[..., None]

    def current_reward_func(self, i_d, i_q, i_d_ref, i_q_ref, gamma):
        mse = 0.5 * (i_d - i_d_ref) ** 2 + 0.5 * (i_q - i_q_ref) ** 2
        return -1 * (mse * (1 - gamma))

    def torque_reward_func(self, i_d, i_q, torque, torque_ref, i_lim_multiplier, gamma):
        """Piecewise MTPA-shaped torque-tracking reward (reference
        ``pmsm_env.py:1014-1037``)."""
        i_s = torch.sqrt(i_d**2 + i_q**2)
        i_n = 1 / i_lim_multiplier
        i_d_plus = 0.2 * i_n
        torque_tol = 0.01
        rew = torch.zeros_like(torque_ref)
        rew = torch.where(i_s > 1, -1 * torch.abs(i_s), rew)
        rew = torch.where((i_s < 1.0) & (i_s > i_n), 0.5 * (1 - (i_s - i_n) / (1 - i_n)) - 1, rew)
        rew = torch.where((i_s < i_n) & (i_d > i_d_plus), -0.5 * ((i_d - i_d_plus) / (i_n - i_d_plus)), rew)
        rew = torch.where(
            (i_s < i_n) & (i_d < i_d_plus) & (torch.abs(torque - torque_ref) > torque_tol),
            0.5 * (1 - torch.abs((torque_ref - torque) / 2)),
            rew,
        )
        rew = torch.where(
            (i_s < i_n) & (i_d < i_d_plus) & (torch.abs(torque - torque_ref) < torque_tol),
            1 - 0.5 * i_s,
            rew,
        )
        return rew * (1 - gamma)
