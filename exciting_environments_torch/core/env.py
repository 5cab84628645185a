"""Core batched ODE-environment runtime (counterpart of
``exciting_environments_tpu/core/env.py``), with its stochastic simulation.

The JAX package writes single-instance methods and ``vmap``s them; here every
method is written elementwise over tensors, so the same code serves one
instance (0-dim leaves) and a batch (``(batch_size,)`` leaves).  Per-batch
``(batch_size,)`` parameter and normalization leaves broadcast against the
batch dimension directly; for batch-major trajectories ``(B, T)`` they are
viewed as ``(B, 1)`` (:meth:`CoreEnvironment._props_for`).  A Python loop
takes the place of ``lax.scan``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a GPU and without that explicit choice the
constructor raises.

Stochastic simulation (``process_noise``/``observation_noise``) draws from a
per-instance key in ``State.PRNGKey``: an int64 ``(B, 2)`` tensor of
:mod:`exciting_environments_torch.ops.random`, which carries the JAX
package's threefry keys and streams, so that the same keys give the same
draws as there.  Reset with keys to use it:
``env.vmap_reset(random.split(random.PRNGKey(seed, device), env.batch_size))``.
"""

from __future__ import annotations

import math
from dataclasses import fields

import numpy as np
import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.structures import dataclass
from exciting_environments_torch.ops import random as prng
from exciting_environments_torch.ops.rollout import solve_trajectory, zoh_action
from exciting_environments_torch.ops.solvers import Euler, ExplicitRungeKutta, make_solver


def resolve_device(device) -> torch.device:
    """The device an environment runs on: CUDA unless ``device`` says
    otherwise.  Never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    return torch.device(device)


class _Components:
    """Indexable view of an action ``(..., A)``: ``[i]`` is component ``i``
    over all leading dimensions (the env ODEs index ``action(t)[dim]``)."""

    def __init__(self, action):
        self._action = action

    def __getitem__(self, i):
        return self._action[..., i]


def is_key(rng) -> bool:
    """Whether ``rng`` is a key tensor of :mod:`~exciting_environments_torch.ops.random`
    (int64, last axis 2) rather than a ``torch.Generator`` or ``None``."""
    return isinstance(rng, torch.Tensor) and rng.dtype == torch.int64 and rng.shape[-1:] == (2,)


def _state_shape(physical_state):
    """Shape of the stacked physical state with the field axis last."""
    stacked = torch.stack([torch.as_tensor(leaf) for leaf in structures.leaves(physical_state)])
    return tuple(stacked.shape[1:]) + (stacked.shape[0],)


class CoreEnvironment:
    """Base class for batched physical-simulation environments.

    Subclasses provide the ``PhysicalState``, ``Additions``, ``StaticParams``
    and ``Action`` dataclasses, the vector field ``_ode(t, y, args, action)``
    over a tuple state ``y``, ``_ode_state_fields``, optionally
    ``_angle_fields`` and ``_clip_state``, and the observation/reward/reset
    hooks.
    """

    _ode_state_fields: tuple = ()
    _angle_fields: tuple = ()
    #: stochastic simulation: ``{field: sigma}`` (``None`` when off) and the
    #: draw-stream mode, set by :meth:`_configure_noise`
    _process_noise = None
    _observation_noise = None
    _noise_mode = "exact"
    #: fast-mode slabs are drawn in pieces of at most this many (step,
    #: instance) pairs, which bounds the cipher's int64 temporaries
    _fast_chunk_elems = 1 << 25

    def __init__(self, batch_size: int, env_properties, tau: float = 1e-4, solver=None,
                 device=None, dtype: torch.dtype = torch.float32):
        """
        Args:
            batch_size: Number of parallel environment instances.
            env_properties: ``EnvProperties`` with all normalizations and
                static parameters.  Leaves are Python scalars or
                ``(batch_size,)`` arrays; arrays move to ``device`` in
                ``dtype``.
            tau: Duration of one control step in seconds.
            solver: An ``ODESolver`` instance or registry name (default Euler).
            device: Torch device; ``None`` means CUDA, and raises without it.
            dtype: Floating dtype of states made by the environment.
        """
        self.batch_size = batch_size
        self.tau = tau
        self.device = resolve_device(device)
        self.dtype = dtype
        self._solver = make_solver(solver) if solver is not None else Euler()
        self.env_properties = self._place_properties(env_properties)
        self.action_dim = len(fields(self.Action))
        self.physical_state_dim = len(fields(self.PhysicalState))

    @dataclass
    class State:
        """Full environment state: physical state + key placeholder + solver
        carry + tracking reference."""

        physical_state: object
        PRNGKey: object
        additions: object
        reference: object

    @dataclass
    class EnvProperties:
        """Constant-per-simulation properties."""

        physical_normalizations: object
        action_normalizations: object
        static_params: object

    # ------------------------------------------------------------------
    # per-batch property leaves (the JAX package infers vmap in-axes here)
    # ------------------------------------------------------------------

    def _place_properties(self, obj, name="env_properties"):
        """Validate property leaves and move array leaves to the device.

        Scalars stay Python numbers (numpy and 0-dim scalars become Python
        floats) so that products of scalar parameters fold in float64 before
        they meet a tensor, as they do in the JAX package.
        """
        if structures.is_dataclass(obj):
            new = object.__new__(type(obj))
            for f in fields(obj):
                object.__setattr__(new, f.name, self._place_properties(getattr(obj, f.name), f.name))
            return new
        if obj is None or isinstance(obj, (bool, int, float)):
            return obj
        if isinstance(obj, list):
            raise ValueError(
                f'Passed env property "{name}" needs to be a tensor to have '
                "different setting per batch, but list is given."
            )
        if isinstance(obj, (np.ndarray, np.generic, torch.Tensor)):
            if np.ndim(obj) == 0:
                return float(obj)
            if tuple(np.shape(obj)) != (self.batch_size,):
                raise ValueError(
                    f'Passed env property "{name}" must be a scalar or of shape '
                    f"(batch_size,) = {(self.batch_size,)}, but {tuple(np.shape(obj))} is given."
                )
            return torch.as_tensor(np.asarray(obj) if not isinstance(obj, torch.Tensor) else obj,
                                   dtype=self.dtype).to(self.device)
        raise ValueError(
            f'Passed env property "{name}" needs to be a scalar, tensor or '
            f"dataclass, but {type(obj)} is given."
        )

    @staticmethod
    def _props_for(props, trailing: int):
        """``props`` with each per-batch ``(B,)`` leaf viewed as
        ``(B,) + (1,) * trailing`` — for batch-major ``(B, T, ...)`` data."""
        if trailing == 0:
            return props
        return structures.map_leaves(
            lambda leaf: leaf.reshape(leaf.shape + (1,) * trailing)
            if isinstance(leaf, torch.Tensor) and leaf.ndim == 1 else leaf,
            props,
        )

    def _full(self, shape, value):
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def repeat_values(self, x, n_repeat):
        """Tile a solver carry (``None`` or a tuple of tensors) over a new
        leading time axis of length ``n_repeat``."""
        if x is None:
            return None
        if isinstance(x, tuple):
            return tuple(self.repeat_values(i, n_repeat) for i in x)
        if isinstance(x, torch.Tensor):
            return x.expand((n_repeat,) + tuple(x.shape))
        raise ValueError(f"State needs to consist of tensors or tuples, but {type(x)} is given.")

    def _tile_time(self, x, n):
        """Broadcast a leaf of any shape to a new leading time axis of length ``n``."""
        x = torch.as_tensor(x, device=self.device)
        return x.expand((n,) + tuple(x.shape))

    @staticmethod
    def _index_time(states, idx):
        """Index every tensor leaf of a time-major ``State`` along its time axis."""
        return structures.map_leaves(lambda leaf: leaf[idx] if isinstance(leaf, torch.Tensor) else leaf, states)

    # ------------------------------------------------------------------
    # normalization
    # ------------------------------------------------------------------

    def normalize_state(self, state, env_properties):
        """Map physical state and reference into the normalized [-1, 1] band."""
        norms = env_properties.physical_normalizations
        with structures.copy_and_mutate(state) as norm_state:
            for field in fields(norm_state.physical_state):
                name = field.name
                norm = getattr(norms, name)
                setattr(norm_state.physical_state, name, norm.normalize(getattr(state.physical_state, name)))
                setattr(norm_state.reference, name, norm.normalize(getattr(state.reference, name)))
        return norm_state

    def denormalize_state(self, norm_state, env_properties):
        """Inverse of :meth:`normalize_state`."""
        norms = env_properties.physical_normalizations
        with structures.copy_and_mutate(norm_state) as state:
            for field in fields(state.physical_state):
                name = field.name
                norm = getattr(norms, name)
                setattr(state.physical_state, name, norm.denormalize(getattr(norm_state.physical_state, name)))
                setattr(state.reference, name, norm.denormalize(getattr(norm_state.reference, name)))
        return state

    def denormalize_action(self, action_norm, env_properties):
        """Denormalize an action ``(..., action_dim)`` component-wise."""
        normalizations = env_properties.action_normalizations
        comps = [
            getattr(normalizations, field.name).denormalize(action_norm[..., i])
            for i, field in enumerate(fields(normalizations))
        ]
        return torch.stack(comps, dim=-1)

    # ------------------------------------------------------------------
    # generic ODE integration
    # ------------------------------------------------------------------

    def _ode(self, t, y, args, action):
        """Vector field ``dy/dt``; provided by the environment."""
        raise NotImplementedError

    def _clip_state(self, y):
        """Optional post-step saturation of the integrated tuple state."""
        return y

    def _vector_field(self, action_callable):
        return lambda t, y, args: self._ode(t, y, args, lambda tt: _Components(action_callable(tt)))

    def _physical_to_y(self, physical_state):
        return tuple(getattr(physical_state, name) for name in self._ode_state_fields)

    def _wrap_angles(self, y):
        if not self._angle_fields:
            return y
        y = list(y)
        for name in self._angle_fields:
            i = self._ode_state_fields.index(name)
            y[i] = ((y[i] + math.pi) % (2 * math.pi)) - math.pi
        return tuple(y)

    def _ode_solver_step(self, state, action, static_params):
        """One fixed-step integration over ``[0, tau]``.  The solver carry is
        re-initialized against the CURRENT action every step (the reference's
        net behavior), so ``k1`` is always a fresh evaluation."""
        f = self._vector_field(lambda t: action)
        y0 = self._physical_to_y(state.physical_state)
        args = static_params
        carry = self._solver.init(f, 0.0, self.tau, y0, args)
        y1, solver_state = self._solver.step(f, 0.0, self.tau, y0, args, carry)
        y1 = self._clip_state(self._wrap_angles(y1))
        return structures.replace(
            state,
            physical_state=self.PhysicalState(**dict(zip(self._ode_state_fields, y1))),
            additions=self.Additions(
                solver_state=solver_state,
                active_solver_state=torch.ones(y1[0].shape, dtype=torch.bool, device=y1[0].device),
            ),
        )

    def _ode_solver_simulate_ahead(self, init_state, actions, static_params, obs_stepsize, action_stepsize):
        """Trajectory integration over time-major physical ``actions``
        ``(n_action_steps, ..., action_dim)``; returns a ``State`` whose
        leaves carry a leading ``obs_len`` axis."""
        f = self._vector_field(zoh_action(actions, action_stepsize))
        y0 = self._physical_to_y(init_state.physical_state)
        args = static_params
        t1 = action_stepsize * actions.shape[0]
        n_steps = int(t1 / obs_stepsize)

        ys, _ = solve_trajectory(self._solver, f, y0, args, n_steps, obs_stepsize)
        ys = self._clip_state(self._wrap_angles(ys))
        obs_len = n_steps + 1

        def tile(leaf):
            leaf = torch.as_tensor(leaf, device=ys[0].device)
            return leaf.expand((obs_len,) + leaf.shape)

        y_last = tuple(leaf[-1] for leaf in ys)
        solver_state = self._solver.init(f, t1, t1 + self.tau, y_last, args)
        return self.State(
            physical_state=self.PhysicalState(**dict(zip(self._ode_state_fields, ys))),
            PRNGKey=tile(init_state.PRNGKey),
            additions=self.Additions(
                solver_state=None if solver_state is None else tuple(tile(k) for k in solver_state),
                active_solver_state=torch.ones(ys[0].shape, dtype=torch.bool, device=ys[0].device),
            ),
            reference=structures.map_leaves(tile, init_state.reference),
        )

    def _init_solver_additions(self, env_properties, physical_state, nan_fill=True):
        """The ``Additions`` carry of a fresh state: the solver carry under a
        zero action, NaN-poisoned so a first ``step`` visibly re-initializes."""
        zero_action = torch.zeros(self.action_dim, dtype=self.dtype, device=self.device)
        f = self._vector_field(lambda t: zero_action)
        y0 = self._physical_to_y(physical_state)
        solver_state = self._solver.init(f, 0.0, self.tau, y0, env_properties.static_params)
        if nan_fill and solver_state is not None:
            solver_state = tuple(k * math.nan for k in solver_state)
        return self.Additions(solver_state=solver_state, active_solver_state=False)

    def _nan_reference(self, batch_shape=()):
        """NaN-filled reference ``PhysicalState`` (no tracking target)."""
        return self.PhysicalState(**{f.name: self._full(batch_shape, math.nan) for f in fields(self.PhysicalState)})

    # ------------------------------------------------------------------
    # stochastic simulation (JAX core/env.py: _validated_noise ...
    # _vmap_rollout_fast_noise)
    # ------------------------------------------------------------------

    @property
    def _has_noise(self) -> bool:
        return bool(self._process_noise) or bool(self._observation_noise)

    @staticmethod
    def _validated_noise(noise: dict, valid_fields: tuple, what: str):
        if not noise:
            return None
        for name, sigma in noise.items():
            if name not in valid_fields:
                raise ValueError(f"{what} field {name!r} is not one of {sorted(valid_fields)}")
            if not (np.isscalar(sigma) and float(sigma) >= 0.0):
                raise ValueError(f"{what}[{name!r}] must be a non-negative scalar std, got {sigma!r}")
        return {k: float(v) for k, v in noise.items() if float(v) > 0.0} or None

    def _configure_noise(self, process_noise, observation_noise, noise_mode, process_fields, observation_fields):
        """Validate and store the stochastic-simulation constructor arguments
        (shared by the classic environments and the PMSM)."""
        self._process_noise = self._validated_noise(process_noise, process_fields, "process_noise")
        self._observation_noise = self._validated_noise(observation_noise, observation_fields, "observation_noise")
        if noise_mode not in ("exact", "fast"):
            raise ValueError(f'noise_mode must be "exact" or "fast", got {noise_mode!r}')
        self._noise_mode = noise_mode

    def _require_noise_key(self, state):
        """The per-instance keys of ``state``; a key-less reset stores a NaN
        placeholder, which cannot drive noise draws."""
        key = state.PRNGKey
        if not is_key(key):
            raise ValueError(
                "process/observation noise draws from the per-instance PRNG key in State.PRNGKey, but this "
                "state carries the NaN placeholder of a key-less reset: reset with "
                "env.vmap_reset(random.split(random.PRNGKey(seed, device), env.batch_size)) "
                "(exciting_environments_torch.ops.random)"
            )
        return key

    @property
    def _process_items(self):
        """``[(field, sigma), ...]`` in sorted field order: the order of the
        process draws."""
        return sorted(self._process_noise.items()) if self._process_noise else []

    @property
    def _process_fields(self) -> tuple:
        """The fields the integrator carries, in the order of its leaves."""
        return self._ode_state_fields

    def _noise_coef(self, dt: float):
        """``sigma * sqrt(dt)`` per process field, an ``(n_p,)`` tensor of the
        state dtype: made once per ``dt``, then multiplied into the draws and
        added, the same two roundings on every path (step, loop, kernel
        slab)."""
        cache = self.__dict__.setdefault("_noise_coefs", {})
        if dt not in cache:
            sigmas = torch.tensor([s for _, s in self._process_items], dtype=self.dtype, device=self.device)
            cache[dt] = sigmas * math.sqrt(dt)
        return cache[dt]

    def _noise_idx(self) -> tuple:
        """The process fields' positions among :attr:`_process_fields`."""
        return tuple(self._process_fields.index(n) for n, _ in self._process_items)

    def _process_noise_slab(self, eps_proc_tm):
        """``(noise_tm, noise_idx)``: the pre-scaled time-major process slab
        ``coef * eps`` ``(T, B, n_p)`` a kernel adds, and the leaves it adds
        to; ``(None, ())`` without process draws."""
        if eps_proc_tm is None:
            return None, ()
        return self._noise_coef(self.tau) * eps_proc_tm, self._noise_idx()

    def _noise_streams(self, init_state, n_steps: int, stride: int):
        """What a fused kernel streams for a stochastic environment:
        ``(noise_tm, noise_idx, eps_obs, keys_saves, final_keys)`` from
        :meth:`_noise_slabs` and :meth:`_process_noise_slab`; all ``None``
        (and ``()``) for a deterministic one."""
        if not self._has_noise:
            return None, (), None, None, None
        eps_proc, eps_obs, keys_saves, final_keys = self._noise_slabs(self._require_noise_key(init_state), n_steps,
                                                                      stride)
        noise_tm, noise_idx = self._process_noise_slab(eps_proc)
        return noise_tm, noise_idx, eps_obs, keys_saves, final_keys

    def _apply_process_noise_eps(self, state, eps, env_properties):
        """One Euler-Maruyama increment ``x += sigma * sqrt(tau) * xi`` per
        configured field, with the standard-normal draws ``eps`` ``(..., n_p)``
        (sorted-field order) from the caller; the angle wrap and the clip
        re-apply to the perturbed state."""
        coef = self._noise_coef(self.tau)
        names = self._ode_state_fields
        y = list(self._physical_to_y(state.physical_state))
        for j, i in enumerate(self._noise_idx()):
            y[i] = y[i] + coef[j] * eps[..., j]
        y = self._clip_state(self._wrap_angles(tuple(y)))
        return structures.replace(state, physical_state=self.PhysicalState(**dict(zip(names, y))))

    @property
    def _obs_noise_layout(self):
        """``(obs_column, field_name)`` pairs eligible for sensor noise: the
        physical components at the head of the observation by default."""
        return tuple((i, f.name) for i, f in enumerate(fields(self.PhysicalState)))

    def _obs_noise_sigma_norm(self, env_properties):
        """Per layout entry the sensor std in normalized units, ``2 * sigma /
        span`` (a ``(B,)`` tensor for a per-batch span), ``0.0`` for a field
        without sensor noise."""
        pn = env_properties.physical_normalizations
        return tuple(
            2.0 * self._observation_noise[name] / (getattr(pn, name).max - getattr(pn, name).min)
            if name in self._observation_noise else 0.0
            for _col, name in self._obs_noise_layout
        )

    def _apply_observation_noise_eps(self, obs, env_properties, eps, batch_major: bool = False):
        """Additive sensor noise on the observed physical columns of ``obs``
        ``(..., obs_dim)`` from the standard-normal draws ``eps`` ``(...,
        len(layout))``.  A per-batch span ``(B,)`` meets ``(..., B)`` leading
        axes, or ``(B, S)`` ones with ``batch_major``.  Other columns stay
        exact."""
        sigmas = self._obs_noise_sigma_norm(env_properties)
        cols = list(obs.unbind(-1))
        for k, (col, name) in enumerate(self._obs_noise_layout):
            if name not in self._observation_noise:
                continue
            sigma = sigmas[k]
            if isinstance(sigma, torch.Tensor) and batch_major and eps.ndim == 3:
                sigma = sigma[:, None]
            cols[col] = cols[col] + sigma * eps[..., k]
        return torch.stack(cols, dim=-1)

    def _noise_step_keys(self, base):
        """``(new_key, k_proc, k_obs)`` of one control step: ``split(key, 3)``
        in exact mode; in fast mode the T = 1 rollout of the counter stream
        (``fold_in(key, 1)``, ``fold_in(fold_in(key, 0), 0 | 1)``)."""
        if self._noise_mode == "fast":
            k_step = prng.fold_in(base, 0)
            return prng.fold_in(base, 1), prng.fold_in(k_step, 0), prng.fold_in(k_step, 1)
        keys = prng.split(base, 3)
        return keys[..., 0, :], keys[..., 1, :], keys[..., 2, :]

    def _noise_slabs(self, keys0, n_steps: int, stride: int):
        """Whole-rollout draws for all instances, time-major: the one source
        of the rollout draw stream, shared by :meth:`vmap_rollout`'s fast
        mode, the fused kernels' slabs and the collector.

        Returns ``(eps_proc, eps_obs, keys_saves, final_keys)``: process
        draws ``(T, B, n_p)`` (``None`` without process noise), sensor draws
        ``(S, B, len(layout))`` at the ``S = T // stride`` save positions
        (``None`` without sensor noise), the state keys after each save
        ``(S, B, 2)`` and the final keys ``(B, 2)``.

        ``"exact"``: the per-step ``split(key, 3)`` chain of :meth:`step`
        (chained steps, the loop and the kernels consume the same draws).
        The chain ``key_{t+1} = split(key_t)[0]`` is sequential, one cipher
        evaluation over ``(B,)`` per step; the draw keys and the normals of
        all steps follow vectorized over ``(T, B)``.  ``"fast"``: step ``t``
        draws from ``fold_in(fold_in(key, t), 0 | 1)`` and the state key
        after step ``t`` is ``fold_in(key, t + 1)``, all time-parallel (in
        pieces of :attr:`_fast_chunk_elems` pairs)."""
        if n_steps % stride:
            raise ValueError("n_steps must be divisible by obs_stride")
        n_p = len(self._process_items)
        want_obs = bool(self._observation_noise)
        n_l = len(self._obs_noise_layout)
        device = keys0.device
        save_t = torch.arange(1, n_steps // stride + 1, device=device) * stride - 1

        if self._noise_mode == "fast":
            eps_proc = None
            if n_p:
                chunk = max(1, self._fast_chunk_elems // max(1, keys0.shape[0] * n_p))
                pieces = []
                for t0 in range(0, n_steps, chunk):
                    t = torch.arange(t0, min(t0 + chunk, n_steps), device=device)
                    k_t = prng.fold_in(keys0[None], t[:, None])
                    pieces.append(prng.normal(prng.fold_in(k_t, 0), n_p, self.dtype))
                eps_proc = torch.cat(pieces)
            eps_obs = None
            if want_obs:
                eps_obs = prng.normal(prng.fold_in(prng.fold_in(keys0[None], save_t[:, None]), 1), n_l, self.dtype)
            keys_saves = prng.fold_in(keys0[None], save_t[:, None] + 1)
            return eps_proc, eps_obs, keys_saves, keys_saves[-1]

        chain = [keys0]
        for _ in range(n_steps):
            chain.append(prng.fold_in(chain[-1], 0))  # split(key, 3)[0]
        keys = torch.stack(chain)  # (T + 1, B, 2): the state key before step t, then the final one
        eps_proc = prng.normal(prng.fold_in(keys[:-1], 1), n_p, self.dtype) if n_p else None
        eps_obs = prng.normal(prng.fold_in(keys[save_t], 2), n_l, self.dtype) if want_obs else None
        return eps_proc, eps_obs, keys[save_t + 1], keys[-1]

    def _state_from_normalized_physical(self, x_norm, env_properties, ref_norm=None):
        """The state whose physical fields take the normalized values
        ``x_norm`` ``(..., n_fields)`` (``PhysicalState`` order), with a fresh
        solver carry and the key placeholder; ``ref_norm`` ``(..., n_refs)``
        gives the normalized ``control_state`` references (NaN otherwise).
        The inverse of :meth:`normalize_state` on the physical fields, through
        :meth:`generate_state_from_observation` for the classic layout (the
        PMSM builds its state directly)."""
        n_ref = len(self.control_state)
        if ref_norm is None:
            ref_norm = torch.full(tuple(x_norm.shape[:-1]) + (n_ref,), math.nan, dtype=x_norm.dtype,
                                  device=x_norm.device)
        return self.generate_state_from_observation(torch.cat([x_norm, ref_norm], dim=-1), env_properties)

    #: optional state-independent constraint of the physical action: a
    #: callable ``(action components tuple) -> tuple`` applied after the
    #: denormalization on every path (step, sim_ahead, the rewards, the
    #: fused rollouts and closed loops).  The kernels compute the inverter
    #: circle of :func:`~exciting_environments_torch.core.classic.svm_circle`
    #: themselves; the plain versions run any hook, on CPU tensors.
    _constrain_action_tuple = None

    def _constrained_phys_action(self, action):
        """:attr:`_constrain_action_tuple` applied to a physical action whose
        last axis is the action dimension."""
        hook = self._constrain_action_tuple
        if hook is None:
            return action
        return torch.stack(hook(tuple(action[..., i] for i in range(self.action_dim))), dim=-1)

    def _advance_state(self, state, action_norm, env_properties):
        """The deterministic state update of one control step: denormalize
        and integrate one ``tau``.  Environments with their own actuation
        (the PMSM's constraint and deadtime) override it; :meth:`step`, the
        fast-mode loop and the collector advance through it."""
        action = self._constrained_phys_action(self.denormalize_action(action_norm, env_properties))
        return self._ode_solver_step(state, action, env_properties.static_params)

    def _fast_noise_advance_eps(self, state, action_norm, env_properties, eps_p):
        """The state half of a slab-consuming step: advance, then the
        caller's process draws ``(B, n_p)``."""
        state = self._advance_state(state, action_norm, env_properties)
        if self._process_noise:
            state = self._apply_process_noise_eps(state, eps_p, env_properties)
        return state

    def _fast_noise_observe_eps(self, state, env_properties, eps_o):
        """The observation half: observe, then the caller's sensor draws."""
        obs = self.generate_observation(state, env_properties)
        if self._observation_noise:
            obs = self._apply_observation_noise_eps(obs, env_properties, eps_o)
        return obs

    def _vmap_rollout_fast_noise(self, init_state, actions, obs_stride: int):
        """:meth:`vmap_rollout` in fast mode: the whole rollout's draws first
        (:meth:`_noise_slabs`), then a loop that consumes them, draw for
        draw the fused kernel's stream."""
        n_steps = actions.shape[1]
        keys0 = self._require_noise_key(init_state)
        eps_proc, eps_obs, _, final_keys = self._noise_slabs(keys0, n_steps, obs_stride)
        props = self.env_properties
        state, saved = init_state, []
        for t in range(n_steps):
            state = self._fast_noise_advance_eps(state, actions[:, t], props,
                                                 None if eps_proc is None else eps_proc[t])
            if (t + 1) % obs_stride == 0:
                s = (t + 1) // obs_stride - 1
                saved.append(self._fast_noise_observe_eps(state, props, None if eps_obs is None else eps_obs[s]))
        return torch.stack(saved, dim=1), structures.replace(state, PRNGKey=final_keys)

    def _check_sde_solver(self):
        if not (isinstance(self._solver, ExplicitRungeKutta) and self._solver.one_stage):
            raise ValueError(
                "stochastic sim_ahead is defined for one-stage solvers only (Euler-Maruyama on the "
                "observation grid); multistage tableaus have no agreed SDE semantics: integrate with "
                'solver="euler" or step through vmap_step / vmap_rollout.'
            )

    def _sde_trajectory(self, f, y0, args, key0, n_steps: int, dt: float, noise_leaves: tuple):
        """Euler-Maruyama on the observation grid: per step the one-stage
        drift update ``y + dt * f`` under the zero-order-hold action, then
        ``sigma * sqrt(dt) * xi`` on the leaves ``noise_leaves`` of the raw
        carry, the keys advancing by :meth:`_noise_step_keys` (at ``dt ==
        tau`` the stream of chained :meth:`step` calls, in both modes).
        Returns the time-major leaves ``(n_steps + 1, ...)``, the keys
        ``(n_steps + 1, B, 2)`` and the sensor draws ``(n_steps, B,
        len(layout))`` (``None`` without sensor noise)."""
        n_p = len(self._process_items)
        coef = self._noise_coef(dt) if n_p else None
        want_obs = bool(self._observation_noise)
        n_l = len(self._obs_noise_layout)
        ys, keys, eps_obs = [tuple(y0)], [key0], []
        y, key = tuple(y0), key0
        # host-side float64 step-start times, as the JAX package's scan
        for t in np.arange(n_steps, dtype=np.float64) * dt:
            new_key, k_p, k_o = self._noise_step_keys(key)
            dy = f(t, y, args)
            y1 = [yl + dt * dyl for yl, dyl in zip(y, dy)]
            if n_p:
                eps = prng.normal(k_p, n_p, self.dtype)
                for j, i in enumerate(noise_leaves):
                    y1[i] = y1[i] + coef[j] * eps[..., j]
            if want_obs:
                eps_obs.append(prng.normal(k_o, n_l, self.dtype))
            y, key = tuple(y1), new_key
            ys.append(y)
            keys.append(key)
        leaves = tuple(torch.stack([torch.as_tensor(leaf) for leaf in group]) for group in zip(*ys))
        return leaves, torch.stack(keys), (torch.stack(eps_obs) if want_obs else None)

    def _sde_simulate_ahead(self, init_state, actions, env_properties, obs_stepsize, action_stepsize):
        """The stochastic counterpart of :meth:`_ode_solver_simulate_ahead`
        (one-stage solvers): :meth:`_sde_trajectory`, then the saves wrapped
        and clipped, each carrying its step's advanced key.  Returns
        ``(states, eps_obs)``."""
        f = self._vector_field(zoh_action(actions, action_stepsize))
        y0 = self._physical_to_y(init_state.physical_state)
        args = env_properties.static_params
        t1 = action_stepsize * actions.shape[0]
        n_steps = int(t1 / obs_stepsize)
        ys, keys, eps_obs = self._sde_trajectory(f, y0, args, self._require_noise_key(init_state), n_steps,
                                                 obs_stepsize, self._noise_idx())
        ys = self._clip_state(self._wrap_angles(ys))
        obs_len = n_steps + 1
        tile = lambda leaf: torch.as_tensor(leaf, device=ys[0].device).expand((obs_len,) + tuple(np.shape(leaf)))
        solver_state = self._solver.init(f, t1, t1 + self.tau, tuple(leaf[-1] for leaf in ys), args)
        states = self.State(
            physical_state=self.PhysicalState(**dict(zip(self._ode_state_fields, ys))),
            PRNGKey=keys,
            additions=self.Additions(
                solver_state=None if solver_state is None else tuple(tile(k) for k in solver_state),
                active_solver_state=torch.ones(ys[0].shape, dtype=torch.bool, device=ys[0].device),
            ),
            reference=structures.map_leaves(tile, init_state.reference),
        )
        return states, eps_obs

    def _noisy_trajectory_observations(self, observations, env_properties, eps_obs):
        """Sensor draws on the post-step rows of a time-major trajectory's
        observations; the initial row is the exact state (no draw yet)."""
        if eps_obs is None:
            return observations
        tail = self._apply_observation_noise_eps(observations[1:], env_properties, eps_obs)
        return torch.cat([observations[:1], tail], dim=0)

    # ------------------------------------------------------------------
    # reset / step / sim_ahead
    # ------------------------------------------------------------------

    def reset(self, env_properties, rng=None, initial_state=None):
        """Reset to the default, a random, or a caller-provided initial state."""
        if initial_state is not None:
            assert structures.structure(self.init_state(env_properties)) == structures.structure(
                initial_state
            ), "initial_state should have the same dataclass structure as init_state()"
            state = initial_state
        else:
            state = self.init_state(env_properties, rng)
        return self.generate_observation(state, env_properties), state

    def _step(self, state, action_norm, env_properties):
        """Shape-agnostic body of :meth:`step` and :meth:`vmap_step`: the
        deterministic advance and, when configured, the process and sensor
        draws of this step from the state's keys, which advance."""
        if not self._has_noise:
            state = self._advance_state(state, action_norm, env_properties)
            return self.generate_observation(state, env_properties), state
        new_key, k_proc, k_obs = self._noise_step_keys(self._require_noise_key(state))
        state = self._advance_state(structures.replace(state, PRNGKey=new_key), action_norm, env_properties)
        if self._process_noise:
            eps = prng.normal(k_proc, len(self._process_items), self.dtype)
            state = self._apply_process_noise_eps(state, eps, env_properties)
        obs = self.generate_observation(state, env_properties)
        if self._observation_noise:
            eps = prng.normal(k_obs, len(self._obs_noise_layout), self.dtype)
            obs = self._apply_observation_noise_eps(obs, env_properties, eps)
        return obs, state

    def step(self, state, action_norm, env_properties):
        """One control step for a single environment instance; returns
        ``(observation, next_state)``.  Actions arrive normalized."""
        assert tuple(action_norm.shape) == (self.action_dim,), (
            "The action needs to be of shape (action_dim,) which is "
            f"{(self.action_dim,)}, but {tuple(action_norm.shape)} is given"
        )
        physical_state_shape = _state_shape(state.physical_state)
        assert physical_state_shape == (self.physical_state_dim,), (
            "The physical state needs to be of shape (physical_state_dim,) which is "
            f"{(self.physical_state_dim,)}, but {physical_state_shape} is given"
        )
        return self._step(state, action_norm, env_properties)

    def _sim_ahead(self, init_state, actions_tm, env_properties, obs_stepsize, action_stepsize):
        """Shape-agnostic sim-ahead over time-major normalized actions;
        returns time-major ``(observations, states, last_state)``."""
        actions = self._constrained_phys_action(self.denormalize_action(actions_tm, env_properties))
        if self._has_noise:
            self._check_sde_solver()
            states, eps_obs = self._sde_simulate_ahead(init_state, actions, env_properties, obs_stepsize,
                                                       action_stepsize)
        else:
            states = self._ode_solver_simulate_ahead(
                init_state, actions, env_properties.static_params, obs_stepsize, action_stepsize
            )
            eps_obs = None
        observations = self._noisy_trajectory_observations(
            self.generate_observation(states, env_properties), env_properties, eps_obs)
        last_state = structures.map_leaves(lambda leaf: leaf[-1], states)
        return observations, states, last_state

    def sim_ahead(self, init_state, actions, env_properties, obs_stepsize, action_stepsize):
        """Integrate a whole action sequence ``(n_action_steps, action_dim)``
        for one instance (zero-order hold).  Multistage solvers read future
        actions in their late stages, so this equals repeated ``step`` calls
        for Euler only.  Returns ``(observations, states, last_state)``.

        A stochastic environment integrates the SDE by Euler-Maruyama on the
        observation grid (one-stage solvers only; others raise), each saved
        observation with its own sensor draw and each saved state with its
        step's advanced key: at ``obs_stepsize == action_stepsize`` the draws
        of chained :meth:`step` calls."""
        assert actions.ndim == 2, "The actions need to have two dimensions: (n_action_steps, action_dim)"
        assert actions.shape[-1] == self.action_dim, (
            f"The last dimension does not correspond to the action dim which is "
            f"{self.action_dim}, but {actions.shape[-1]} is given"
        )
        init_physical_state_shape = _state_shape(init_state.physical_state)
        assert init_physical_state_shape == (self.physical_state_dim,), (
            "The initial physical state needs to be of shape (env.physical_state_dim,) which is "
            f"{(self.physical_state_dim,)}, but {init_physical_state_shape} is given"
        )
        return self._sim_ahead(init_state, actions, env_properties, obs_stepsize, action_stepsize)

    def _rew_trunc_term(self, states_tm, actions_tm, env_properties):
        """Rewards/flags over a time-major trajectory and its actions."""
        actions = self._constrained_phys_action(self.denormalize_action(actions_tm, env_properties))
        obs_len = structures.leaves(states_tm.physical_state)[0].shape[0]
        states_wo_init = structures.map_leaves(lambda leaf: leaf[1:], states_tm)
        repeats = int((obs_len - 1) / actions.shape[0])
        reward = self.generate_reward(states_wo_init, torch.repeat_interleave(actions, repeats, dim=0), env_properties)
        truncated = self.generate_truncated(states_tm, env_properties)
        terminated = self.generate_terminated(states_wo_init, reward, env_properties)
        return reward, truncated, terminated

    def generate_rew_trunc_term_ahead(self, states, actions, env_properties):
        """Rewards/truncated/terminated flags for a ``sim_ahead`` trajectory."""
        assert actions.ndim == 2, "The actions need to have two dimensions: (n_action_steps, action_dim)"
        assert actions.shape[-1] == self.action_dim, (
            f"The last dimension does not correspond to the action dim which is "
            f"{self.action_dim}, but {actions.shape[-1]} is given"
        )
        return self._rew_trunc_term(states, actions, env_properties)

    # ------------------------------------------------------------------
    # batched API
    # ------------------------------------------------------------------

    def vmap_step(self, state, action):
        """One control step for all ``batch_size`` instances."""
        assert tuple(action.shape) == (self.batch_size, self.action_dim), (
            "The action needs to be of shape (batch_size, action_dim) which is "
            f"{(self.batch_size, self.action_dim)}, but {tuple(action.shape)} is given"
        )
        physical_state_shape = _state_shape(state.physical_state)
        assert physical_state_shape == (self.batch_size, self.physical_state_dim), (
            "The physical state needs to be of shape (batch_size, physical_state_dim) which is "
            f"{(self.batch_size, self.physical_state_dim)}, but {physical_state_shape} is given"
        )
        return self._step(state, action, self.env_properties)

    def vmap_sim_ahead(self, init_state, actions, obs_stepsize, action_stepsize):
        """Trajectory integration for all batches; ``actions`` of shape
        ``(batch_size, n_action_steps, action_dim)``.  Returns batch-major
        ``(observations, states, last_state)``."""
        assert obs_stepsize <= action_stepsize, (
            "The action stepsize should be greater or equal to the observation stepsize."
        )
        assert actions.ndim == 3, (
            "The actions need to have three dimensions: (batch_size, n_action_steps, action_dim)"
        )
        assert actions.shape[0] == self.batch_size, (
            f"The first dimension does not correspond to the batch size which is "
            f"{self.batch_size}, but {actions.shape[0]} is given"
        )
        assert actions.shape[-1] == self.action_dim, (
            f"The last dimension does not correspond to the action dim which is "
            f"{self.action_dim}, but {actions.shape[-1]} is given"
        )
        init_physical_state_shape = _state_shape(init_state.physical_state)
        assert init_physical_state_shape == (self.batch_size, self.physical_state_dim), (
            "The initial physical state needs to be of shape (batch_size, physical_state_dim,) which is "
            f"{(self.batch_size, self.physical_state_dim)}, but {init_physical_state_shape} is given"
        )
        obs, states, last_state = self._sim_ahead(
            init_state, actions.transpose(0, 1), self.env_properties, obs_stepsize, action_stepsize
        )
        to_batch_major = lambda leaf: leaf.movedim(0, 1) if isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 else leaf
        return obs.movedim(0, 1), structures.map_leaves(to_batch_major, states), last_state

    def vmap_rollout(self, init_state, actions, obs_stride: int = 1):
        """Multi-step batched rollout: exactly a loop of :meth:`vmap_step`
        (in fast noise mode a loop over the rollout's time-parallel draws,
        :meth:`_vmap_rollout_fast_noise`).

        Args:
            init_state: batched initial state.
            actions: normalized actions ``(batch_size, n_steps, action_dim)``.
            obs_stride: keep every ``obs_stride``-th observation; ``n_steps``
                must be divisible by it.

        Returns:
            ``(observations, final_state)`` with observations of shape
            ``(batch_size, n_steps // obs_stride, obs_dim)``.
        """
        assert actions.ndim == 3 and actions.shape[0] == self.batch_size and actions.shape[2] == self.action_dim, (
            "The actions need shape (batch_size, n_steps, action_dim) = "
            f"{(self.batch_size, 'T', self.action_dim)}, but {tuple(actions.shape)} is given"
        )
        n_steps = actions.shape[1]
        assert n_steps % obs_stride == 0, "n_steps must be divisible by obs_stride"
        if self._has_noise and self._noise_mode == "fast":
            return self._vmap_rollout_fast_noise(init_state, actions, obs_stride)
        state = init_state
        saved = []
        for t in range(n_steps):
            obs, state = self._step(state, actions[:, t], self.env_properties)
            if (t + 1) % obs_stride == 0:
                saved.append(obs)
        return torch.stack(saved, dim=1), state

    def fused_rollout(self, init_state, actions, obs_stride: int = None,
                      time_major: bool = False, strict: bool = False):
        """:meth:`vmap_rollout` through the hand-written stepper kernel when
        the environment is in its scope (falls back to the loop otherwise;
        ``strict=True`` raises instead).  Returns ``(obs, final_state)``
        with ``obs`` of shape ``(B, obs_dim)``, or ``(B, n_steps //
        obs_stride, obs_dim)`` with ``obs_stride`` set."""
        from exciting_environments_torch.ops.kernels.stepper import env_fused_rollout

        return env_fused_rollout(self, init_state, actions, obs_stride=obs_stride,
                                 time_major=time_major, strict=strict)

    def fused_sim_ahead(self, init_state, actions, obs_stepsize, action_stepsize,
                        obs_stride: int = 1, time_major: bool = False, strict: bool = False):
        """:meth:`vmap_sim_ahead` semantics through the stepper kernel in
        sim-ahead mode for any integral ``action_stepsize / obs_stepsize``;
        returns ``(observations, last_state)``."""
        from exciting_environments_torch.ops.kernels.stepper import env_fused_sim_ahead

        return env_fused_sim_ahead(self, init_state, actions, obs_stepsize, action_stepsize,
                                   obs_stride=obs_stride, time_major=time_major, strict=strict)

    def fused_closed_loop(self, init_state, policy, n_steps: int, obs_stride: int = None,
                          policy_params=None, return_traj_states: bool = False, policy_carry=None):
        """Closed loop with the policy inside the hand-written closed-loop
        kernel (``csrc/closed_loop.cu``; its plain version on CPU tensors):
        observation -> ``policy(obs, step[, carry][, params])`` -> action ->
        step, ``n_steps`` times in one launch.  On CUDA the policy is an
        ``AffinePolicy`` or the actor of ``make_actor_tile``; on the CPU any
        callable with that contract.  ``policy_carry`` (tuple of ``(B,)``
        leaves) makes the policy stateful, and every return shape then gains
        the final carry as its last element.  Raises out of kernel scope (a
        closed loop has no open-loop fallback).  See
        :func:`~exciting_environments_torch.ops.kernels.closed_loop.env_fused_closed_loop`."""
        from exciting_environments_torch.ops.kernels.closed_loop import env_fused_closed_loop

        return env_fused_closed_loop(
            self, init_state, policy, n_steps, obs_stride=obs_stride,
            return_traj_states=return_traj_states, policy_params=policy_params, policy_carry=policy_carry,
        )

    def vmap_generate_rew_trunc_term_ahead(self, states, actions):
        """Batched :meth:`generate_rew_trunc_term_ahead` over the batch-major
        output of :meth:`vmap_sim_ahead`."""
        assert actions.ndim == 3, (
            "The actions need to have three dimensions: (batch_size, n_action_steps, action_dim)"
        )
        assert actions.shape[0] == self.batch_size, (
            f"The first dimension does not correspond to the batch size which is "
            f"{self.batch_size}, but {actions.shape[0]} is given"
        )
        assert actions.shape[-1] == self.action_dim, (
            f"The last dimension does not correspond to the action dim which is "
            f"{self.action_dim}, but {actions.shape[-1]} is given"
        )
        to_time_major = lambda leaf: leaf.movedim(1, 0) if isinstance(leaf, torch.Tensor) and leaf.ndim >= 2 else leaf
        reward, truncated, terminated = self._rew_trunc_term(
            structures.map_leaves(to_time_major, states), actions.transpose(0, 1), self.env_properties
        )
        return reward.movedim(0, 1), truncated.movedim(0, 1), terminated.movedim(0, 1)

    def vmap_init_state(self, rng=None):
        """Default or random initial state for all batches.  ``rng`` is a
        ``torch.Generator`` on the environment's device (the state keeps the
        NaN key placeholder), or ``(batch_size, 2)`` keys of
        :mod:`~exciting_environments_torch.ops.random`, the counterpart of
        ``jax.random.split(key, batch_size)``: the draws then follow the JAX
        package's ``init_state`` and the state carries its keys."""
        if is_key(rng) and tuple(rng.shape) != (self.batch_size, 2):
            raise ValueError(f"keys must be of shape (batch_size, 2) = {(self.batch_size, 2)}, got {tuple(rng.shape)}")
        return self.init_state(self.env_properties, rng, batch_shape=(self.batch_size,))

    def vmap_reset(self, rng=None, initial_state=None):
        """Batched :meth:`reset`.  ``rng`` as in :meth:`vmap_init_state`."""
        if initial_state is not None:
            assert structures.structure(self.vmap_init_state()) == structures.structure(
                initial_state
            ), "initial_state should have the same dataclass structure as self.vmap_init_state()"
            return self.generate_observation(initial_state, self.env_properties), initial_state
        state = self.vmap_init_state(rng)
        return self.generate_observation(state, self.env_properties), state

    def vmap_generate_state_from_observation(self, obs, key=None):
        """Batched observation -> state reconstruction; ``key`` (``(batch_size,
        2)`` keys of :mod:`~exciting_environments_torch.ops.random`) becomes
        the rebuilt state's ``PRNGKey``, so a noisy rollout can continue
        from it."""
        return self.generate_state_from_observation(obs, self.env_properties, key)

    # ------------------------------------------------------------------
    # abstract observation/reward hooks
    # ------------------------------------------------------------------

    def init_state(self, env_properties, rng=None, batch_shape=()):
        raise NotImplementedError

    def generate_observation(self, state, env_properties):
        raise NotImplementedError

    def generate_state_from_observation(self, obs, env_properties, key=None):
        raise NotImplementedError

    def generate_reward(self, state, action, env_properties):
        raise NotImplementedError

    def generate_truncated(self, state, env_properties):
        raise NotImplementedError

    def generate_terminated(self, state, reward, env_properties):
        raise NotImplementedError
