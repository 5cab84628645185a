"""Excitation signals for system identification and data collection
(counterpart of ``exciting_environments_tpu/ops/signals.py``).

Batched generators of normalized action slabs ``(batch_size, n_steps,
action_dim)``, ready for ``vmap_rollout``, ``fused_rollout`` and
:meth:`~exciting_environments_torch.utils.collect.RolloutCollector.collect_fused`:

* :func:`aprbs`: amplitude-modulated pseudo-random hold sequence (random
  levels held for random durations);
* :func:`chirp`: linear frequency sweep;
* :func:`multisine`: random-phase multisine with a flat harmonic spectrum;
* :func:`white_uniform`: i.i.d. uniform noise.

The random signals draw from a key of :mod:`exciting_environments_torch.ops.random`
and run on its device; :func:`chirp` takes its device.  ``dtype`` stands
for the JAX package's default dtypes: float64 draws the float64 and 64-bit
integer streams of ``jax_enable_x64``, float32 the float32 and 32-bit ones
(the bits differ between the two).

The random signals come back contiguous in ``(B, T, A)``, a slab the
rollout kernels read in place; :func:`to_time_major` makes the time-major
copy for callers that want one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from exciting_environments_torch.ops import random as prng


def to_time_major(actions):
    """Relayout a ``(B, n_steps, A)`` slab to ``(n_steps, B, A)`` (a copy)."""
    return actions.transpose(0, 1).contiguous()


def _int_dtype(dtype: torch.dtype) -> torch.dtype:
    """The integer width that goes with a float width in JAX's defaults."""
    return torch.int64 if dtype == torch.float64 else torch.int32


def white_uniform(key, batch_size: int, n_steps: int, action_dim: int, minval=-1.0, maxval=1.0,
                  dtype: torch.dtype = torch.float32):
    """I.i.d. uniform noise in ``[minval, maxval)``."""
    return prng.uniform(key, (batch_size, n_steps, action_dim), dtype, minval, maxval)


def aprbs(key, batch_size: int, n_steps: int, action_dim: int, hold_min: int = 10, hold_max: int = 100,
          minval=-1.0, maxval=1.0, dtype: torch.dtype = torch.float32):
    """Amplitude-modulated pseudo-random hold sequence.

    Each (batch, action-dim) channel holds a uniformly drawn level for a
    uniformly drawn duration in ``[hold_min, hold_max)`` steps, then jumps to
    a fresh level: ``n_steps // hold_min + 2`` levels and durations per
    channel, the durations' running sum as segment ends, and a right-sided
    ``searchsorted`` of every step in them (one call over the ``(B, A, S)``
    layout)."""
    k_levels, k_holds = prng.split(key).unbind(-2)
    max_segments = n_steps // hold_min + 2
    shape = (batch_size, max_segments, action_dim)
    levels = prng.uniform(k_levels, shape, dtype, minval, maxval)
    durations = prng.randint(k_holds, shape, hold_min, hold_max, _int_dtype(dtype))
    ends = torch.cumsum(durations.long(), dim=1).transpose(1, 2).contiguous()  # (B, A, S)
    t = torch.arange(n_steps, device=key.device).expand(batch_size, action_dim, n_steps).contiguous()
    idx = torch.searchsorted(ends, t, right=True).clamp_(0, max_segments - 1)
    return torch.gather(levels, 1, idx.transpose(1, 2))  # contiguous (B, T, A)


def _times(n_steps: int, tau: float, dtype, device):
    """``arange(n_steps) * tau`` in ``dtype``."""
    return torch.arange(n_steps, dtype=dtype, device=device) * tau


def chirp(batch_size: int, n_steps: int, action_dim: int, tau: float, f0: float, f1: float,
          amplitude: float = 1.0, device=None, dtype: torch.dtype = torch.float32):
    """Linear chirp from ``f0`` to ``f1`` Hz over the horizon, the same in
    every batch entry and action dimension (a broadcast view).  ``device``
    defaults to CUDA and raises without a GPU."""
    from exciting_environments_torch.core.env import resolve_device

    t = _times(n_steps, tau, dtype, resolve_device(device))
    t1 = n_steps * tau
    phase = 2 * math.pi * (f0 * t + 0.5 * (f1 - f0) / t1 * (t * t))
    sig = amplitude * torch.sin(phase)
    return sig[None, :, None].expand(batch_size, n_steps, action_dim)


def _linspace(start: float, stop: float, num: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` by its formula, on the host in
    ``dtype``: ``start * (1 - s) + stop * s`` with ``s = i / (num - 1)``,
    then the exact endpoint."""
    dt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    lo, hi = dt(start), dt(stop)
    if num > 1:
        s = np.arange(num - 1, dtype=dt) / dt(num - 1)
        out = np.concatenate([lo * (dt(1) - s) + hi * s, [hi]])
    else:
        out = np.full(num, lo)
    return torch.as_tensor(out.astype(dt), device=device)


def multisine(key, batch_size: int, n_steps: int, action_dim: int, tau: float, f_min: float, f_max: float,
              n_harmonics: int = 16, amplitude: float = 1.0, dtype: torch.dtype = torch.float32):
    """Random-phase multisine: ``n_harmonics`` equally spaced frequencies in
    ``[f_min, f_max]`` with i.i.d. uniform phases per (batch, dim) channel,
    normalized to the requested peak amplitude."""
    freqs = _linspace(f_min, f_max, n_harmonics, dtype, key.device)
    phases = prng.uniform(key, (batch_size, action_dim, n_harmonics), dtype, 0.0, 2 * math.pi)
    t = _times(n_steps, tau, dtype, key.device)
    angles = 2 * math.pi * freqs[None, None, :, None] * t[None, None, None, :] + phases[..., None]
    sig = torch.sin(angles).sum(dim=2)  # (B, A, T)
    sig = sig / sig.abs().amax(dim=-1, keepdim=True) * amplitude
    return sig.transpose(1, 2).contiguous()
