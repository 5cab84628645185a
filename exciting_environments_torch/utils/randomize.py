"""Domain randomization: per-batch sampling of static environment parameters
(counterpart of ``exciting_environments_tpu/utils/randomize.py``).

Any static parameter may be a ``(batch_size,)`` tensor; a fleet of
differently parameterized instances then steps as one batch, through the
loops and through the kernels, which take such leaves as per-batch planes.
This module draws those leaves:

* distribution specs: :class:`Uniform`, :class:`LogUniform`,
  :class:`Normal`, :class:`Choice`, a plain ``(low, high)`` tuple, or any
  ``callable(key, batch_size) -> (batch_size,)`` tensor;
* :func:`sample_static_params`: a constructor-ready params dict;
* :func:`randomize_env`: a randomized fleet in one call;
* :func:`resample_env_properties`: a redraw of the randomized leaves of an
  environment's ``EnvProperties``.

Keys are those of :mod:`exciting_environments_torch.ops.random`; the draws
run on the key's device, in the dtype asked for (the environment's own in
:func:`randomize_env` and :func:`resample_env_properties`).  Every field
draws from ``fold_in(key, crc32(name) & 0x7FFFFFFF)``, so the ``Uniform``
and ``Choice`` draws equal the JAX package's from the same key (float64
with ``jax_enable_x64``, float32 without); ``LogUniform`` draws the same
uniforms, and its ``exp`` is within one ulp of XLA's (which evaluates its
own polynomial on the CPU); ``Normal`` draws agree to ``erfinv``'s last
bits.

Resampling: the port compiles no program around an environment's
properties, so there is no cache to keep warm.  Set ``env.env_properties =
props`` before the next ``vmap_*``, ``fused_*``, collector or
``adaptive_rollout`` call: each reads the attribute when it is called
(``adaptive_rollout`` also takes ``env_properties=``).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import torch

from exciting_environments_torch.core import structures
from exciting_environments_torch.ops import random as prng

__all__ = [
    "Uniform",
    "LogUniform",
    "Normal",
    "Choice",
    "sample_field",
    "sample_static_params",
    "randomize_env",
    "resample_env_properties",
]


@dataclass(frozen=True)
class Uniform:
    """Uniform draw from ``[low, high)``."""

    low: float
    high: float

    def __call__(self, key, batch_size: int, dtype: torch.dtype = torch.float32):
        return prng.uniform(key, batch_size, dtype, self.low, self.high)


@dataclass(frozen=True)
class LogUniform:
    """Log-uniform draw from ``[low, high)``: uniform in ``log(x)``, for
    positive parameters whose plausible range spans decades."""

    low: float
    high: float

    def __post_init__(self):
        if not (0.0 < self.low < self.high):
            raise ValueError(f"LogUniform requires 0 < low < high, got ({self.low}, {self.high})")

    def __call__(self, key, batch_size: int, dtype: torch.dtype = torch.float32):
        lo, hi = (float(torch.log(torch.tensor(v, dtype=dtype))) for v in (self.low, self.high))
        return torch.exp(prng.uniform(key, batch_size, dtype, lo, hi))


@dataclass(frozen=True)
class Normal:
    """Gaussian draw ``mean + std * N(0, 1)``, optionally clipped to ``clip =
    (lo, hi)`` (clipping, not rejection: mass piles at the bounds)."""

    mean: float
    std: float
    clip: Optional[tuple] = None

    def __call__(self, key, batch_size: int, dtype: torch.dtype = torch.float32):
        x = prng.fma(prng.normal(key, batch_size, dtype), self.std, self.mean)
        if self.clip is not None:
            x = torch.clamp(x, self.clip[0], self.clip[1])
        return x


@dataclass(frozen=True)
class Choice:
    """Draw from a finite set ``values`` with optional probabilities ``p``."""

    values: Sequence[float]
    p: Optional[Sequence[float]] = None

    def __call__(self, key, batch_size: int, dtype: torch.dtype = torch.float32):
        values = torch.as_tensor(self.values, dtype=dtype, device=key.device)
        return prng.choice(key, values, batch_size, p=self.p)


SpecEntry = Union[Uniform, LogUniform, Normal, Choice, tuple, Callable]
_SPECS = (Uniform, LogUniform, Normal, Choice)


def _as_sampler(entry: SpecEntry) -> Callable:
    if isinstance(entry, tuple):
        if len(entry) != 2:
            raise ValueError(f"tuple spec entries must be (low, high), got {entry!r}")
        return Uniform(*entry)
    if callable(entry):
        return entry
    raise TypeError(
        "spec entries must be Uniform/LogUniform/Normal/Choice, a (low, high) "
        f"tuple, or callable(key, batch_size) -> tensor; got {type(entry)}"
    )


def sample_field(key, batch_size: int, entry: SpecEntry, dtype: torch.dtype = torch.float32):
    """Draw one ``(batch_size,)`` parameter tensor from a spec entry (the
    built-in specs in ``dtype``; a callable returns what it returns)."""
    sampler = _as_sampler(entry)
    out = sampler(key, batch_size, dtype) if isinstance(sampler, _SPECS) else sampler(key, batch_size)
    out = torch.as_tensor(out, device=key.device)
    if tuple(out.shape) != (batch_size,):
        raise ValueError(f"sampler returned shape {tuple(out.shape)}, expected ({batch_size},)")
    return out


def _split_over_spec(key, spec: dict) -> dict:
    # one subkey per field from a stable hash of its name: adding or removing
    # a field never shifts another field's draw, in any process
    return {name: prng.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF) for name in spec}


def sample_static_params(key, batch_size: int, spec: dict, defaults: dict = None,
                         dtype: torch.dtype = torch.float32) -> dict:
    """Draw a constructor-ready static-params dict.

    Args:
        key: a key of :mod:`~exciting_environments_torch.ops.random`.
        batch_size: fleet size; every randomized field becomes a
            ``(batch_size,)`` tensor.
        spec: mapping ``field name -> distribution``.
        defaults: base values for the other fields (e.g.
            ``EnvCls._default_static_params()``); drawn fields override.
            ``None`` skips the check of the field names.
        dtype: dtype of the draws.

    Returns:
        ``dict(defaults, **drawn)``, to pass as ``static_params=``.
    """
    keys = _split_over_spec(key, spec)
    drawn = {name: sample_field(keys[name], batch_size, entry, dtype) for name, entry in spec.items()}
    out = dict(defaults) if defaults is not None else {}
    unknown = set(drawn) - set(out) if defaults is not None else set()
    if unknown:
        raise ValueError(f"spec fields {sorted(unknown)} are not in defaults {sorted(out)}: typo, or pass defaults=None")
    out.update(drawn)
    return out


def randomize_env(env_cls, key, spec: dict, batch_size: int = None, defaults: dict = None, **env_kwargs):
    """Construct an environment fleet with per-batch randomized parameters.

    Args:
        env_cls: an environment class, or a registry id (``"Pendulum-v0"``).
        key: a key of :mod:`~exciting_environments_torch.ops.random`.
        spec: ``field name -> distribution``.
        batch_size: fleet size (default: the class default).
        defaults: base static params (default:
            ``env_cls._default_static_params()``; the PMSM takes its motor
            variant's, passed here).
        **env_kwargs: forwarded to the constructor (``tau``, ``solver``,
            ``control_state``, ``device``, ``dtype``, ...).  The draws are
            made in the environment's ``dtype`` and moved to its device.

    Returns:
        The constructed environment.
    """
    if isinstance(env_cls, str):
        from exciting_environments_torch.core import registration

        env_cls = registration.resolve(env_cls)
    if batch_size is None:
        batch_size = getattr(env_cls, "_default_batch_size", None)
        if batch_size is None:
            raise ValueError("batch_size is required for this env class")
    if defaults is None:
        getter = getattr(env_cls, "_default_static_params", None)
        if getter is None:
            raise ValueError(f"{env_cls.__name__} has no _default_static_params; pass defaults=")
        defaults = getter()
    params = sample_static_params(key, batch_size, spec, defaults, env_kwargs.get("dtype", torch.float32))
    return env_cls(batch_size=batch_size, static_params=params, **env_kwargs)


def resample_env_properties(env, key, spec: dict):
    """A redraw of the ``spec``'d static-parameter leaves of
    ``env.env_properties``: a new ``EnvProperties`` with the same structure
    and leaf shapes, the drawn leaves in the environment's dtype on its
    device (see the module docstring for how to use it).

    Raises if a ``spec`` field was a scalar at construction: construct the
    environment through :func:`randomize_env` first.
    """
    params = env.env_properties.static_params
    names = {f.name for f in structures.fields(params)}
    batch = env.batch_size
    keys = _split_over_spec(key, spec)
    changes = {}
    for name, entry in spec.items():
        if name not in names:
            raise ValueError(f"{type(params).__name__} has no field {name!r}")
        old = getattr(params, name)
        if not (isinstance(old, torch.Tensor) and tuple(old.shape) == (batch,)):
            raise ValueError(
                f"field {name!r} is not a ({batch},) per-batch leaf: construct the env with "
                "randomize_env/sample_static_params before resampling"
            )
        changes[name] = sample_field(keys[name], batch, entry, env.dtype).to(device=env.device, dtype=env.dtype)
    return structures.replace(env.env_properties, static_params=structures.replace(params, **changes))
