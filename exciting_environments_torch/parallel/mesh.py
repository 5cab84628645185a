"""Batch split over devices (counterpart of
``exciting_environments_tpu/parallel/mesh.py``).

Environment steps are independent across the batch, so a batch of ``B``
instances splits into ``n`` shards of ``B / n`` that run on their own.  The
JAX package lays the batch axis over a ``jax.sharding.Mesh`` and runs each
shard under ``shard_map``; PyTorch has no single-process sharded tensor, so
here one process drives every shard:

* a mesh is a tuple of ``torch.device``s plus the axis name
  (:func:`make_batch_mesh` takes every CUDA device and never the CPU on its
  own; a list such as ``["cuda:0"] * 4`` puts several shards on one card);
* :class:`ShardedEnv` builds one shadow environment per shard (``batch_size
  = B / n``, on the shard's device, each per-batch ``(B,)`` property tensor
  sliced to the shard), splits every batch-leading input with ``narrow``
  (along axis 1 for a time-major ``(T, B, A)`` slab), runs the shadow's own
  entry point on each shard, and concatenates the outputs on the mesh's
  first device.  ``fused_rollout``/``fused_sim_ahead`` launch the stepper
  kernel (``csrc/stepper.cu``) or the PMSM kernel (``csrc/pmsm_stepper.cu``)
  once per shard, ``fused_closed_loop`` the closed-loop kernel
  (``csrc/closed_loop.cu`` or ``csrc/pmsm_closed_loop.cu``) once per shard.

Each instance is computed on its own in every kernel, so a split call equals
the unsplit call bit for bit on the card.  There is no collective: metrics
over the shards merge with
:func:`~exciting_environments_torch.parallel.metrics.across_mesh`.

Usage::

    mesh = make_batch_mesh(["cuda:0"] * 4)
    env = Pendulum(batch_size=65536)
    senv = ShardedEnv(env, mesh)
    obs, state = senv.vmap_reset()
    obs, last = senv.fused_rollout(state, actions)   # four launches
"""

from __future__ import annotations

import copy
from dataclasses import fields
from typing import NamedTuple

import torch

from exciting_environments_torch.core import structures

BATCH_AXIS = "batch"


class Mesh(NamedTuple):
    """A 1-D mesh: one device per shard, and the name of the split axis."""

    devices: tuple
    axis_names: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


class Placement(NamedTuple):
    """Where a tree goes on a mesh: its batch axis split over ``axis_name``,
    or replicated (``axis_name=None``).  A :class:`ShardedEnv` keeps whole
    trees on the mesh's first device and splits them at each call."""

    mesh: Mesh
    axis_name: str = None


def _canonical(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_batch_mesh(devices=None, axis_name: str = BATCH_AXIS) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every CUDA device; raises
    without one, since the port never picks the CPU on its own).  A device
    may repeat: ``["cuda:0"] * 4`` makes four shards on one card, and the
    tests run ``["cpu"] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=[...] (e.g. ['cpu'] * 8) to split over "
                "other devices explicitly"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_canonical(d) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = BATCH_AXIS) -> Placement:
    """The placement that splits the leading (batch) axis over the mesh."""
    return Placement(mesh, axis_name)


def replicated_sharding(mesh: Mesh) -> Placement:
    """The placement that keeps a tree whole."""
    return Placement(mesh, None)


def _to(tree, device):
    """Every tensor leaf of ``tree`` (dataclasses, tuples, lists and dicts)
    on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return structures.map_leaves(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)


def shard_batched_tree(tree, batch_size: int, mesh: Mesh, axis_name: str = BATCH_AXIS):
    """Place a tree on the mesh: every tensor leaf on its first device, where
    a :class:`ShardedEnv` splits the leaves whose leading dimension is
    ``batch_size`` at each call; Python scalars stay Python scalars."""
    del batch_size, axis_name  # the split happens per call
    return _to(tree, mesh.devices[0])


def _on_device(env, device):
    """A shallow copy of ``env`` on ``device``: its property tensors, its
    magnetics table and its other tensor attributes moved there, and its
    device-bound noise-coefficient cache dropped."""
    device = _canonical(device)
    shadow = object.__new__(type(env))
    shadow.__dict__.update(env.__dict__)
    shadow.__dict__.pop("_noise_coefs", None)
    if device == _canonical(env.device):
        return shadow
    shadow.device = device
    for name, value in env.__dict__.items():
        if isinstance(value, torch.Tensor):
            setattr(shadow, name, value.to(device))
    shadow.env_properties = _to(env.env_properties, device)
    lut = env.__dict__.get("_lut")
    if lut is not None:
        lut = copy.copy(lut)
        lut.values = lut.values.to(device)
        lut._interleaved = None
        shadow._lut = lut
        shadow.LUT_interpolators = lut.as_dict()
    return shadow


def _concat(parts, device):
    """The per-shard outputs ``parts`` joined along their leading (batch)
    axis on ``device``; leaves that are not per-instance tensors (Python
    scalars, ``None``) come from the first shard."""
    first = parts[0]
    if first is None:
        return None
    if structures.is_dataclass(first):
        new = object.__new__(type(first))
        for f in fields(first):
            object.__setattr__(new, f.name, _concat([getattr(p, f.name) for p in parts], device))
        return new
    if isinstance(first, tuple):
        items = [_concat([p[k] for p in parts], device) for k in range(len(first))]
        return type(first)(*items) if hasattr(first, "_fields") else tuple(items)
    if isinstance(first, list):
        return [_concat([p[k] for p in parts], device) for k in range(len(first))]
    if isinstance(first, torch.Tensor) and first.ndim >= 1:
        return torch.cat([p.to(device) for p in parts])
    return first


class ShardedEnv:
    """Batch split of a :class:`~exciting_environments_torch.core.env.CoreEnvironment`
    over a mesh.

    The batched methods take and return whole-batch trees; each call splits
    them over the shards, runs every shard's shadow environment, and joins
    the outputs on the mesh's first device.  The wrapped environment is not
    modified.
    """

    def __init__(self, env, mesh: Mesh = None, axis_name: str = BATCH_AXIS):
        if mesh is None:
            mesh = make_batch_mesh(axis_name=axis_name)
        if env.batch_size % mesh.size != 0:
            raise ValueError(f"batch_size {env.batch_size} must be divisible by the mesh size {mesh.size}")
        self.mesh = mesh
        self.axis_name = axis_name
        # a shallow copy on the mesh's first device, where the whole-batch
        # trees live; the caller's environment object stays untouched
        self.env = _on_device(env, mesh.devices[0])
        self._shadows = None

    # -- placement helpers -------------------------------------------------

    def shard(self, tree):
        """Place a whole-batch tree (state, actions, observations) on the
        mesh's first device."""
        return shard_batched_tree(tree, self.env.batch_size, self.mesh, self.axis_name)

    def _local_shadows(self):
        """One shadow environment per shard (``batch_size = B / n``, on the
        shard's device, the per-batch ``(B,)`` property tensors sliced to
        the shard), built once and cached."""
        if self._shadows is None:
            B, n = self.env.batch_size, self.mesh.size
            b = B // n
            shadows = []
            for i, device in enumerate(self.mesh.devices):
                shadow = _on_device(self.env, device)
                shadow.batch_size = b
                shadow.env_properties = structures.map_leaves(
                    lambda leaf: leaf.narrow(0, i * b, b)
                    if isinstance(leaf, torch.Tensor) and tuple(leaf.shape) == (B,) else leaf,
                    shadow.env_properties,
                )
                shadows.append(shadow)
            self._shadows = shadows
        return self._shadows

    def _local_shadow(self):
        """The first shard's shadow environment (the per-shard scope and
        shape questions are asked of it)."""
        return self._local_shadows()[0]

    def _split(self, tree, i, dim=0):
        """Shard ``i`` of a whole-batch tree: each tensor leaf whose axis
        ``dim`` has the batch size narrowed to the shard's rows, every tensor
        leaf on the shard's device."""
        B, n = self.env.batch_size, self.mesh.size
        b = B // n
        device = self.mesh.devices[i]

        def piece(leaf):
            if not isinstance(leaf, torch.Tensor):
                return leaf
            if leaf.ndim > dim and leaf.shape[dim] == B:
                leaf = leaf.narrow(dim, i * b, b)
            return leaf.to(device)

        return structures.map_leaves(piece, tree)

    def _per_shard(self, fn, *inputs, dims=None):
        """``fn(shadow, *shard_inputs)`` on every shard, outputs joined on the
        first device; ``dims`` gives each input's batch axis (default 0)."""
        dims = dims or (0,) * len(inputs)
        outs = [
            fn(shadow, *(self._split(x, i, d) for x, d in zip(inputs, dims)))
            for i, shadow in enumerate(self._local_shadows())
        ]
        return _concat(outs, self.mesh.devices[0])

    # -- forwarded batched API --------------------------------------------

    def vmap_reset(self, rng=None, initial_state=None):
        if rng is not None and not isinstance(rng, torch.Tensor):
            # a torch.Generator draws the whole batch in one stream
            return self.shard(self.env.vmap_reset(rng, initial_state))
        return self._per_shard(lambda s, r, st: s.vmap_reset(r, st), rng, initial_state)

    def vmap_step(self, state, action):
        return self._per_shard(lambda s, st, a: s.vmap_step(st, a), state, action)

    def vmap_sim_ahead(self, init_state, actions, obs_stepsize, action_stepsize):
        return self._per_shard(lambda s, st, a: s.vmap_sim_ahead(st, a, obs_stepsize, action_stepsize),
                               init_state, actions)

    def vmap_rollout(self, init_state, actions, obs_stride: int = 1):
        return self._per_shard(lambda s, st, a: s.vmap_rollout(st, a, obs_stride), init_state, actions)

    def vmap_generate_rew_trunc_term_ahead(self, states, actions):
        return self._per_shard(lambda s, st, a: s.vmap_generate_rew_trunc_term_ahead(st, a), states, actions)

    def _fused_in_scope(self, obs_stepsize=None, action_stepsize=None) -> bool:
        """Whether the open-loop kernels cover this environment per shard.
        Every scope rule reads shapes or holds instance by instance, so the
        whole batch is in scope exactly when each shard is; the port has no
        per-shard batch-tiling rule."""
        from exciting_environments_torch.ops.kernels import rollout_path

        return rollout_path(self.env, obs_stepsize, action_stepsize) != "scan"

    def fused_rollout(self, init_state, actions_norm, obs_stride: int = None, time_major: bool = False,
                      strict: bool = False, return_traj_states: bool = False):
        """The fused rollout per shard: one launch of the stepper or PMSM
        kernel on each shard (their plain versions on CPU tensors), with
        :func:`~exciting_environments_torch.ops.kernels.stepper.env_fused_rollout`'s
        contract.  Out of kernel scope the split loop runs instead
        (``strict=True`` raises)."""
        from exciting_environments_torch.ops.kernels import traj_rollout

        n_steps = actions_norm.shape[0] if time_major else actions_norm.shape[1]
        if not self._fused_in_scope():
            if strict:
                raise ValueError(
                    "fused_rollout out of scope for this sharded env (kernel scope); strict=True forbids "
                    "the split loop fallback"
                )
            if return_traj_states:
                raise ValueError("return_traj_states requires the fused kernel path; this sharded env is out "
                                 "of kernel scope")
            if time_major:
                actions_norm = actions_norm.transpose(0, 1)
            obs, last = self.vmap_rollout(init_state, actions_norm, obs_stride or n_steps)
            return (obs if obs_stride is not None else obs[:, -1]), last
        launch = traj_rollout(self.env)
        return self._per_shard(
            lambda s, st, a: launch(s, st, a, obs_stride=obs_stride, time_major=time_major, strict=True,
                                    return_traj_states=return_traj_states),
            init_state, actions_norm, dims=(0, 1 if time_major else 0),
        )

    def fused_sim_ahead(self, init_state, actions_norm, obs_stepsize: float, action_stepsize: float,
                        obs_stride: int = 1, time_major: bool = False, strict: bool = False):
        """The fused trajectory solve per shard (``vmap_sim_ahead``
        semantics, ``(observations, last_state)``).  Out of scope the split
        ``vmap_sim_ahead`` runs instead (``strict=True`` raises)."""
        if not self._fused_in_scope(obs_stepsize, action_stepsize):
            if strict:
                raise ValueError("fused_sim_ahead out of scope for this sharded env; strict=True forbids the "
                                 "split loop fallback")
            if time_major:
                actions_norm = actions_norm.transpose(0, 1)
            obs, _, last = self.vmap_sim_ahead(init_state, actions_norm, obs_stepsize, action_stepsize)
            return obs[:, ::obs_stride], last
        return self._per_shard(
            lambda s, st, a: s.fused_sim_ahead(st, a, obs_stepsize, action_stepsize, obs_stride=obs_stride,
                                               time_major=time_major, strict=True),
            init_state, actions_norm, dims=(0, 1 if time_major else 0),
        )

    def closed_loop_in_scope(self) -> bool:
        """Whether :meth:`fused_closed_loop` covers this environment per
        shard: the closed-loop kernels' scope
        (:func:`~exciting_environments_torch.ops.kernels.closed_loop_path`),
        which holds for every shard when it holds for the whole batch."""
        from exciting_environments_torch.ops.kernels import closed_loop_path

        return closed_loop_path(self.env) is not None

    def fused_closed_loop(self, init_state, policy, n_steps: int, obs_stride: int = None, policy_params=None,
                          return_traj_states: bool = False, policy_carry=None, sched_lut=None):
        """The policy-in-kernel closed loop per shard: one launch of the
        closed-loop kernel on each shard, each with its property slices and
        its rows of a stateful policy's ``policy_carry``.  Shared
        ``policy_params`` reach every shard (their gradients sum over the
        shards).  Raises out of scope: a closed loop has no open-loop
        fallback."""
        if not self.closed_loop_in_scope():
            raise ValueError("fused_closed_loop out of scope for this sharded env (closed-loop kernel scope)")
        # only the PMSM drive's entry point takes the scheduled gather
        sched = {} if sched_lut is None else dict(sched_lut=sched_lut)

        def launch(s, st, carry):
            return s.fused_closed_loop(st, policy, n_steps, obs_stride=obs_stride,
                                       policy_params=_to(policy_params, s.device),
                                       return_traj_states=return_traj_states, policy_carry=carry, **sched)

        carry = None if policy_carry is None else tuple(policy_carry)
        return self._per_shard(launch, init_state, carry)

    def adaptive_rollout(self, init_state, actions_norm, **kwargs):
        """Per-instance adaptive rollout per shard: each shard's step-size
        loop runs on its own (a stiff shard does not hold the others back
        between intervals), with its property slices."""
        from exciting_environments_torch.ops.adaptive import adaptive_rollout

        return self._per_shard(lambda s, st, a: adaptive_rollout(s, st, a, **kwargs), init_state, actions_norm)

    def __getattr__(self, name):
        if name in ("env", "mesh", "axis_name", "_shadows"):
            raise AttributeError(name)
        return getattr(self.env, name)
