"""Streaming and windowed fleet metrics (counterpart of
``exciting_environments_tpu/parallel/metrics.py``).

* :class:`RunningStats`: an O(1)-state Welford/Chan accumulator (count,
  mean, M2, min, max) that stays on the device, is updated once per rollout
  chunk (:func:`running_update`) and merges exactly, pairwise
  (:func:`merge`) or over every shard at once (:func:`across_mesh`);
* :class:`Window`: a fixed-size ring buffer for windowed means, mins and
  maxes.

One process drives every shard of a
:class:`~exciting_environments_torch.parallel.mesh.ShardedEnv`, so there is
no collective: :func:`across_mesh` merges the per-shard accumulators, given
as a list or stacked along a leading shard axis, with the Chan formula the
JAX package applies through ``psum`` (count-weighted mean, then each
shard's M2 plus its count times its mean's squared distance from the
global mean).
"""

from __future__ import annotations

import math

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.core.env import resolve_device
from exciting_environments_torch.core.structures import dataclass


@dataclass
class RunningStats:
    """Streaming count/mean/variance/min/max accumulator state."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    min: torch.Tensor
    max: torch.Tensor


def running_init(shape=(), dtype=torch.float32, device=None) -> RunningStats:
    """A fresh accumulator; ``shape`` adds per-metric leading dimensions."""
    device = resolve_device(device)
    z = torch.zeros(shape, dtype=dtype, device=device)
    return RunningStats(
        count=z,
        mean=z,
        m2=z,
        min=torch.full(shape, math.inf, dtype=dtype, device=device),
        max=torch.full(shape, -math.inf, dtype=dtype, device=device),
    )


def running_update(stats: RunningStats, values, axis=None) -> RunningStats:
    """Fold a batch of ``values`` into the accumulator (batched Welford).

    ``axis`` selects which axes of ``values`` are the sample axes (default:
    all leading axes beyond the accumulator's); the remaining axes must
    broadcast against the accumulator shape.
    """
    values = torch.as_tensor(values, dtype=stats.mean.dtype, device=stats.mean.device)
    if axis is None:
        axis = tuple(range(values.ndim - stats.mean.ndim))
    ax = axis if isinstance(axis, tuple) else (axis,)
    if not ax:
        ax = (0,) if values.ndim > stats.mean.ndim else ()
    if ax:
        n_b = float(math.prod(values.shape[a] for a in ax))
        mean_k = torch.mean(values, dim=ax, keepdim=True)
        m2_b = torch.sum((values - mean_k) ** 2, dim=ax)
        mean_b = mean_k.squeeze(ax)
        mn, mx = torch.amin(values, dim=ax), torch.amax(values, dim=ax)
    else:  # a single sample
        n_b, mean_b, m2_b, mn, mx = 1.0, values, torch.zeros_like(values), values, values
    batch = RunningStats(
        count=torch.full_like(stats.count, n_b),
        mean=mean_b,
        m2=m2_b,
        min=mn,
        max=mx,
    )
    return merge(stats, batch)


def merge(a: RunningStats, b: RunningStats) -> RunningStats:
    """Exact pairwise merge (Chan et al.); safe when either side is empty."""
    n = a.count + b.count
    safe_n = torch.where(n > 0, n, 1)
    delta = b.mean - a.mean
    mean = a.mean + delta * (b.count / safe_n)
    m2 = a.m2 + b.m2 + delta * delta * (a.count * b.count / safe_n)
    return RunningStats(
        count=n,
        mean=torch.where(n > 0, mean, 0.0),
        m2=torch.where(n > 0, m2, 0.0),
        min=torch.minimum(a.min, b.min),
        max=torch.maximum(a.max, b.max),
    )


def _stacked(stats):
    """Per-shard accumulators as one :class:`RunningStats` with a leading
    shard axis, on the first shard's device."""
    if isinstance(stats, RunningStats):
        return stats
    stats = list(stats)
    device = stats[0].count.device
    return RunningStats(**{
        name: torch.stack([getattr(s, name).to(device) for s in stats])
        for name in ("count", "mean", "m2", "min", "max")
    })


def across_mesh(stats) -> RunningStats:
    """Merge per-shard accumulators into the global one.

    ``stats`` is a list of per-shard :class:`RunningStats`, or one whose
    leaves carry a leading shard axis.  The global count, the count-weighted
    mean, and the Chan-corrected M2 (each shard adds the dispersion of its
    mean around the global mean), as the JAX package's ``psum`` round
    computes them; the result lives on the first shard's device.
    """
    s = _stacked(stats)
    n = s.count.sum(0)
    safe_n = torch.where(n > 0, n, 1)
    mean = (s.count * s.mean).sum(0) / safe_n
    m2 = (s.m2 + s.count * (s.mean - mean) ** 2).sum(0)
    return RunningStats(
        count=n,
        mean=torch.where(n > 0, mean, 0.0),
        m2=torch.where(n > 0, m2, 0.0),
        min=s.min.amin(0),
        max=s.max.amax(0),
    )


def running_summary(stats: RunningStats) -> dict:
    """Readout: mean / std (population) / min / max / count."""
    var = stats.m2 / torch.where(stats.count > 0, stats.count, 1)
    return {
        "count": stats.count,
        "mean": stats.mean,
        "std": torch.sqrt(var),
        "min": stats.min,
        "max": stats.max,
    }


@dataclass
class Window:
    """Fixed-size ring buffer of scalar (or per-metric) samples."""

    buffer: torch.Tensor  # (capacity, ...) samples, NaN-initialized
    index: torch.Tensor  # next write slot
    filled: torch.Tensor  # number of valid entries (saturates at capacity)


def window_init(capacity: int, shape=(), dtype=torch.float32, device=None) -> Window:
    device = resolve_device(device)
    return Window(
        buffer=torch.full((capacity,) + tuple(shape), math.nan, dtype=dtype, device=device),
        index=torch.zeros((), dtype=torch.int32, device=device),
        filled=torch.zeros((), dtype=torch.int32, device=device),
    )


def window_push(w: Window, value) -> Window:
    capacity = w.buffer.shape[0]
    buffer = w.buffer.clone()
    buffer[w.index.long()] = torch.as_tensor(value, dtype=w.buffer.dtype, device=w.buffer.device)
    return Window(
        buffer=buffer,
        index=(w.index + 1) % capacity,
        filled=torch.clamp(w.filled + 1, max=capacity),
    )


def _masked(w: Window):
    capacity = w.buffer.shape[0]
    mask = torch.arange(capacity, device=w.buffer.device) < w.filled
    return mask.reshape((capacity,) + (1,) * (w.buffer.ndim - 1))


def window_mean(w: Window):
    total = torch.sum(torch.where(_masked(w), w.buffer, 0.0), dim=0)
    return total / torch.clamp(w.filled, min=1)


def window_min(w: Window):
    return torch.amin(torch.where(_masked(w), w.buffer, math.inf), dim=0)


def window_max(w: Window):
    return torch.amax(torch.where(_masked(w), w.buffer, -math.inf), dim=0)


# ---------------------------------------------------------------------------
# One-shot reductions.  A ShardedEnv returns its outputs whole on the mesh's
# first device, so these are plain reductions there; per-shard values (a
# list, or a leading shard axis) reduce through psum_across.
# ---------------------------------------------------------------------------


def mean_metric(values):
    """Mean of a per-environment metric."""
    return torch.mean(values)


def sum_metric(values):
    """Sum of a per-environment metric."""
    return torch.sum(values)


def violation_fraction(truncated):
    """Fraction of environments currently out of bounds (float32)."""
    return torch.mean(truncated.reshape(truncated.shape[0], -1).any(dim=1).to(torch.float32))


def gather_to_host(tree):
    """Copy every tensor leaf of a tree to host memory."""
    return structures.map_leaves(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, tree)


def psum_across():
    """A reduction that sums per-shard values (a list, or a leading shard
    axis) onto the first shard's device: the counterpart of ``psum`` inside
    the JAX package's ``shard_map`` bodies."""

    def reduce(x):
        if isinstance(x, torch.Tensor):
            return x.sum(0)
        return torch.stack([v.to(x[0].device) for v in x]).sum(0)

    return reduce
