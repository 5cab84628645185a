"""Policies that the closed-loop kernel runs inside the loop.

In the JAX package a closed-loop policy is any Python function over tiles,
which Pallas traces into the kernel body.  A hand-written CUDA kernel cannot
trace Python, so the port compiles the policy families the library's users
run into the closed-loop kernels (``csrc/closed_loop.cu``,
``csrc/pmsm_closed_loop.cu``) as functors.  Each family is an
``nn.Module`` here: its ``forward`` is the plain version under the JAX tile
contract, and :meth:`KernelPolicy.kernel_spec` gives the kernel its family
id, its options and its flat parameter vector.

The tile contract (``exciting_environments_tpu/ops/pallas/stepper.py::
fused_closed_loop``): ``policy(obs, step[, carry][, params])`` over a tuple
of ``(B,)`` observation columns returns a tuple of normalized action
columns, or ``(actions, carry)`` for a stateful policy (``n_carry > 0``).
Any callable with that contract runs the closed loop on CPU tensors; on CUDA
tensors only a :class:`KernelPolicy` does.

The families, by ``policy_id``: 0 :class:`AffinePolicy` here (PD and PI
tracking laws, in both kernels); 1 ``utils/rl_fused.py::ActorPolicy`` (the
PPO actor with counter-hash exploration, classic environments); 2 and 3 the
sensorless PMSM tiles of ``utils/foc.py`` (the PMSM drive); 4 and 5 the
induction machine's field-oriented tiles of ``utils/foc.py``
(``FocPolicy``, ``SensorlessFocPolicy`` with its stationary Kalman flux
observer); 6 the EESM's current tile (``EesmCurrentPolicy``).  Families 4-6
are compiled for their own environment only (``KernelPolicy.env_ids``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class KernelSpec(NamedTuple):
    """What the closed-loop kernel needs of a policy: its family id
    (``ClosedLoopArgs.policy_id``), the number of observation columns it
    reads, the values of the family's own ``ClosedLoopArgs`` fields, the
    flat parameter vector in the layout its functor reads, and the
    per-drive planes (``(B,)`` each, ``ClosedLoopArgs.policy_planes``) of a
    family that reads some constants per drive (empty for the others)."""

    policy_id: int
    n_obs: int
    options: dict
    flat: torch.Tensor
    planes: tuple = ()


def resolved_device(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``"cuda"`` is the
    current card), so that a spec asked for on ``cuda`` and launched on
    ``cuda:0`` is the same spec."""
    if type(device) is not torch.device:
        device = torch.device(device)
    if device.index is None and device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class KernelPolicy(nn.Module):
    """A policy family with a functor in a closed-loop kernel.

    Subclasses set ``policy_id`` and ``n_carry`` (the number of ``(B,)``
    carry leaves the policy threads from step to step), ``env_ids`` where
    the family is compiled for some environments only (their
    ``_kernel_env_id``; ``None``: every environment of the kernel), and
    implement ``forward`` (the plain version) and :meth:`kernel_spec`; one
    that keeps its spec counts each one it packs in ``spec_packs``.
    """

    policy_id: int = -1
    n_carry: int = 0
    env_ids: tuple = None
    #: how many specs :meth:`kernel_spec` has packed, for a family that
    #: hands out the spec it packed last while nothing it reads changed (a
    #: launch plan, ``ops/kernels/plans.py``, knows its spec by this count);
    #: ``None`` for a family that packs a new spec every launch
    spec_packs: int = None

    def kernel_spec(self, dtype: torch.dtype, device, params=None) -> KernelSpec:
        """The family id, options and flat parameters (in ``dtype`` on
        ``device``) for one launch; ``params`` is the ``policy_params``
        argument of the loop, or ``None``."""
        raise NotImplementedError

    def params_from_flat(self, flat: torch.Tensor, params=None):
        """The ``policy_params`` that :meth:`forward` takes, built as views of
        the flat vector of :meth:`kernel_spec` (``params`` gives the tree's
        shapes), so that autograd carries the flat vector's cotangent into
        the tree.  ``None`` for a family that takes no parameters."""
        return None

    def _split_args(self, args):
        """``(carry, params)`` from the contract's trailing arguments."""
        if self.n_carry:
            return args[0], (args[1] if len(args) > 1 else None)
        return None, (args[0] if args else None)


class AffinePolicy(KernelPolicy):
    """The affine tracking law ``a_j = b_j + sum_i K[j][i] * obs_i``.

    With ``Ki`` it carries one integrator per action,
    ``c_j <- c_j + sum_i Ki[j][i] * obs_i``, and adds it: ``a_j += c_j``
    (a PI law; the carry is ``n_action`` leaves).  With ``clip`` the action
    is clamped to ``[-clip, clip]``.  Sums run left to right from ``b_j``
    (resp. ``c_j``), the order of ``utils/rl_fused.py::_tile_mlp``.

    Args:
        K: ``(n_action, n_obs)`` gains over the observation columns (the
            normalized state, then the normalized references).
        b: ``(n_action,)`` offsets (default zeros).
        Ki: optional ``(n_action, n_obs)`` integrator gains.
        clip: optional clamp bound.

    ``K``, ``b`` and ``Ki`` may instead come from the loop's
    ``policy_params``: a flat vector ``[K.ravel(), b, Ki.ravel()]`` of the
    same sizes (the kernel's layout), which makes the loop differentiable in
    them on the CPU.

    :meth:`kernel_spec` keeps one spec per working type and device, its
    flat gains placed there, and packs again only where the buffers or the
    ``policy_params`` tensor (by identity and ``_version``) or ``clip``
    changed; gains that autograd records, or ``policy_params`` that is no
    tensor, are packed every launch.
    """

    policy_id = 0

    def __init__(self, K, b=None, Ki=None, clip: float = None):
        super().__init__()
        K = torch.as_tensor(np.asarray(K, dtype=np.float64))
        if K.ndim != 2:
            raise ValueError(f"K must be (n_action, n_obs), got shape {tuple(K.shape)}")
        n_action, n_obs = K.shape
        b = torch.zeros(n_action, dtype=torch.float64) if b is None else torch.as_tensor(
            np.asarray(b, dtype=np.float64))
        if tuple(b.shape) != (n_action,):
            raise ValueError(f"b must be ({n_action},), got shape {tuple(b.shape)}")
        self.register_buffer("K", K)
        self.register_buffer("b", b)
        if Ki is not None:
            Ki = torch.as_tensor(np.asarray(Ki, dtype=np.float64))
            if tuple(Ki.shape) != (n_action, n_obs):
                raise ValueError(f"Ki must be {(n_action, n_obs)}, got shape {tuple(Ki.shape)}")
        self.register_buffer("Ki", Ki)
        self.n_action, self.n_obs = n_action, n_obs
        self.n_carry = n_action if Ki is not None else 0
        self.clip = None if clip is None else float(clip)
        self.spec_packs = 0
        self._specs = {}  # (dtype, device) -> (key, sources, spec)

    def flat_params(self) -> torch.Tensor:
        """The constructor's gains as the flat ``policy_params`` vector."""
        parts = [self.K.reshape(-1), self.b] + ([self.Ki.reshape(-1)] if self.Ki is not None else [])
        return torch.cat(parts)

    def _flat(self, params, dtype, device):
        """The flat gains (the constructor's, or ``params``), checked for size."""
        flat = self.flat_params() if params is None else torch.as_tensor(params)
        n = self.n_action * self.n_obs
        expected = n + self.n_action + (n if self.Ki is not None else 0)
        if tuple(flat.shape) != (expected,):
            raise ValueError(f"policy_params must be a flat vector of {expected} values, got {tuple(flat.shape)}")
        return flat.to(dtype=dtype, device=device)

    def _gains(self, params, dtype, device):
        flat = self._flat(params, dtype, device)
        n = self.n_action * self.n_obs
        K = flat[:n].reshape(self.n_action, self.n_obs)
        b = flat[n : n + self.n_action]
        Ki = flat[n + self.n_action :].reshape(self.n_action, self.n_obs) if self.Ki is not None else None
        return K, b, Ki

    def forward(self, obs, step, *args):
        carry, params = self._split_args(args)
        if len(obs) != self.n_obs:
            raise ValueError(f"AffinePolicy has gains for {self.n_obs} observation columns, got {len(obs)}")
        K, b, Ki = self._gains(params, obs[0].dtype, obs[0].device)
        actions, new_carry = [], []
        for j in range(self.n_action):
            acc = b[j]
            for i in range(self.n_obs):
                acc = acc + K[j, i] * obs[i]
            if Ki is not None:
                c = carry[j]
                for i in range(self.n_obs):
                    c = c + Ki[j, i] * obs[i]
                new_carry.append(c)
                acc = acc + c
            if self.clip is not None:
                acc = torch.clamp(acc, -self.clip, self.clip)
            actions.append(acc)
        return (tuple(actions), tuple(new_carry)) if Ki is not None else tuple(actions)

    def params_from_flat(self, flat, params=None):
        return flat

    def kernel_spec(self, dtype, device, params=None) -> KernelSpec:
        device = resolved_device(device)
        sources = (self.K, self.b, self.Ki) if params is None else (params,)
        keeps = (params is None or isinstance(params, torch.Tensor)) and not (
            torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in sources))
        if keeps:
            key = (self.clip,) + tuple(None if t is None else (t._version, t.data_ptr()) for t in sources)
            kept = self._specs.get((dtype, device))
            if kept is not None and kept[0] == key and all(a is b for a, b in zip(kept[1], sources)):
                return kept[2]
        options = {
            "has_integral": int(self.Ki is not None),
            "has_clip": int(self.clip is not None),
            "clip": 0.0 if self.clip is None else self.clip,
        }
        spec = KernelSpec(self.policy_id, self.n_obs, options, self._flat(params, dtype, device).contiguous())
        self.spec_packs += 1
        if keeps:
            self._specs[(dtype, device)] = (key, sources, spec)
        return spec

    def extra_repr(self) -> str:
        return (f"n_action={self.n_action}, n_obs={self.n_obs}, integral={self.Ki is not None}, "
                f"clip={self.clip}")
