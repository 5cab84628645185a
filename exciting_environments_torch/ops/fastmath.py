"""Fast-math building blocks (counterpart of
``exciting_environments_tpu/ops/fastmath.py``).

Two primitives replace the transcendental ones in the opt-in fast paths
(``Pendulum(fast_math=True)``, the fast pendulum and PMSM kernels):

* :func:`poly_sin`: an odd degree-15 polynomial fit of ``sin`` on
  [-pi, pi], evaluated with a Horner scheme in ``x**2`` (max abs error
  ~2e-7, the float32 rounding level of the exact op);
* :func:`wrap_angle_fast`: the floored-modulo wrap
  ``x - 2 pi floor((x + pi) / (2 pi))``, equal to
  ``((x + pi) % 2 pi) - pi`` up to the last ulp.

Both are tolerance-gated against the exact paths, never exact.  The
coefficients are the JAX package's float32 values written as literals: the
JAX package fits them with numpy at import, and another numpy or LAPACK may
round that fit differently.  Every function is a chain of separate tensor
operations, so the CUDA kernels (``csrc/fastmath.cuh``, built with
``--fmad=false``) repeat it bit for bit on the card.

The division by ``2 pi`` is a Python-number division: on CUDA tensors
PyTorch multiplies by the reciprocal, on CPU tensors it divides.  An angle
next to a wrap boundary can therefore land 2 pi apart between the CPU and
the card; compare wrapped angles modulo 2 pi across devices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi

#: odd power-basis coefficients c1, c3, ..., c15 of the sine fit, float32
#: values (the JAX package's ``_SIN_ODD_COEFFS``)
SIN_ODD_COEFFS = tuple(
    float.fromhex(h)
    for h in ("0x1.0p+0", "-0x1.555556p-3", "0x1.11111p-7", "-0x1.a019e4p-13",
              "0x1.71db9ep-19", "-0x1.ae2152p-26", "0x1.5d4fb2p-33", "-0x1.726fcp-41")
)


def poly_sin(x):
    """Polynomial ``sin`` for ``x`` in [-pi, pi] (multiplies and adds only).
    A float64 input computes in float64 with the float32 coefficients."""
    x2 = x * x
    acc = SIN_ODD_COEFFS[-1]
    for c in SIN_ODD_COEFFS[-2::-1]:
        acc = acc * x2 + c
    return x * acc


def wrap_angle_fast(x):
    """Wrap to [-pi, pi) with an add, a multiply and ``floor`` (no remainder)."""
    return x - _TWO_PI * torch.floor((x + math.pi) / _TWO_PI)


def poly_sin_max_error() -> float:
    """Max abs deviation of :func:`poly_sin` from ``np.sin`` on [-pi, pi],
    evaluated in float64 on the host."""
    x = np.linspace(-np.pi, np.pi, 100001)
    x2 = x * x
    acc = np.float64(SIN_ODD_COEFFS[-1])
    for c in SIN_ODD_COEFFS[-2::-1]:
        acc = acc * x2 + np.float64(c)
    return float(np.max(np.abs(x * acc - np.sin(x))))


def sin_wrapped(x):
    """Polynomial ``sin`` for any argument: one fast wrap, then the polynomial."""
    return poly_sin(wrap_angle_fast(x))


def poly_cos(x):
    """Polynomial ``cos`` through the shifted sine: ``sin(wrap(x + pi / 2))``."""
    return poly_sin(wrap_angle_fast(x + 0.5 * math.pi))


def fast_sign(x):
    """``sign`` without a select: ``clamp(x * 1e30, -1, 1)`` with ``1e30`` in
    ``x``'s dtype.  Equals ``sign`` for 0 and any ``|x| >= 1e-30``; tinier
    magnitudes land strictly between -1 and 1."""
    return torch.clamp(x * 1e30, -1.0, 1.0)
