"""Electrical reference-frame transforms and the inverter voltage hexagon for
PMSM drives (counterpart of ``exciting_environments_tpu/ops/transforms.py``).

Vectors carry their components on the last axis, ``(..., 2)`` for dq and
alpha/beta, ``(..., 3)`` for abc; angles are ``(...)``.  Every function is
elementwise over the leading axes, so one call serves a single instance, a
batch ``(B,)`` and a time-major slab ``(T, B)``.

The 2x2 Park rotations are written out as products and sums in the order of
the JAX package's ``q @ u`` (``d`` term first), and the hexagon's sector
rotation reads the float32 table below by direct indexing (a gather is exact).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

_SQRT3 = np.sqrt(3.0)

# Clarke transform alpha/beta -> abc (2/3 convention), and abc -> alpha/beta
T32 = np.array([[1.0, 0.0], [-0.5, 0.5 * _SQRT3], [-0.5, -0.5 * _SQRT3]])
T23 = 2.0 / 3.0 * T32.T


def _build_rotation_table():
    """Sector rotations of :func:`apply_hex_constraint`, indexed by the three
    half-plane sign bits of the phasor; each entry rotates its sector onto the
    reference sector at the top of the hexagon.  float32 (real, imag) pairs:
    the component values of the reference's ``complex64`` table."""
    re = np.ones((2, 2, 2), dtype=np.float64)
    im = np.zeros((2, 2, 2), dtype=np.float64)
    entries = {
        (1, 0, 1): (0.5, 0.5 * _SQRT3),
        (1, 1, 0): (0.5, -0.5 * _SQRT3),
        (0, 1, 0): (-0.5, -0.5 * _SQRT3),
        (0, 1, 1): (-1.0, 0.0),
        (0, 0, 1): (-0.5, 0.5 * _SQRT3),
    }
    for idx, (r, i) in entries.items():
        re[idx] = r
        im[idx] = i
    return re.astype(np.float32), im.astype(np.float32)


ROTATION_RE, ROTATION_IM = _build_rotation_table()


@functools.lru_cache(maxsize=None)
def _rotation_tables(device: torch.device):
    """The rotation table on ``device``, copied there once."""
    return torch.as_tensor(ROTATION_RE, device=device), torch.as_tensor(ROTATION_IM, device=device)


def t_dq_alpha_beta(eps):
    """Rotation matrix between the dq and alpha/beta frames, ``(..., 2, 2)``."""
    cos, sin = torch.cos(eps), torch.sin(eps)
    return torch.stack([torch.stack([cos, sin], dim=-1), torch.stack([-sin, cos], dim=-1)], dim=-2)


def _rotate(u, eps):
    """``t_dq_alpha_beta(eps) @ u`` written out componentwise.  XLA's dot
    accumulates from ``+0``, so a zero phasor comes out as ``+0`` whatever
    the signs of its products; the ``+ 0.0`` does the same (it changes no
    other value).  The sign of that zero picks the hexagon sector through
    ``atan2`` in :func:`apply_hex_constraint`, and with it the constraint's
    derivative at the zero voltage."""
    cos, sin = torch.cos(eps), torch.sin(eps)
    a, b = u[..., 0], u[..., 1]
    return torch.stack([cos * a + sin * b + 0.0, -sin * a + cos * b + 0.0], dim=-1)


def dq2albet(u_dq, eps):
    """dq -> alpha/beta (inverse Park) at electrical angle ``eps``."""
    return _rotate(u_dq, -eps)


def albet2dq(u_albet, eps):
    """alpha/beta -> dq (Park) at electrical angle ``eps``."""
    return _rotate(u_albet, eps)


def dq2abc(u_dq, eps):
    """dq -> three-phase abc."""
    return dq2albet(u_dq, eps) @ torch.as_tensor(T32.T, dtype=u_dq.dtype, device=u_dq.device)


def abc2dq(u_abc, eps):
    """Three-phase abc -> dq."""
    return albet2dq(u_abc @ torch.as_tensor(T23.T, dtype=u_abc.dtype, device=u_abc.device), eps)


def step_eps(eps, omega_el, tau, tau_scale=1.0):
    """Advance the electrical angle by ``omega_el * tau * tau_scale`` and wrap
    it into (-pi, pi] with ``% 2 pi`` and a shift above pi.  (The solver step
    wraps with ``((x + pi) % 2 pi) - pi`` instead; the two stay apart.)"""
    eps = eps + omega_el * tau * tau_scale
    eps = eps % (2 * math.pi)
    # the bool-times-float product of the reference, in the angle's own dtype
    return eps + (eps > math.pi).to(eps.dtype) * (-2 * math.pi)


def _clip(x, lo: float, hi: float):
    """``jnp.clip`` with its derivative: ``minimum(maximum(x, lo), hi)``, so
    that a value exactly on a bound passes half its cotangent (JAX's
    ``max``/``min`` and ``torch.maximum``/``minimum`` split ties;
    ``torch.clamp`` passes all of it).  The zero voltage lies on the
    hexagon's lower edge, where the planners linearize a zero plan."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def apply_hex_constraint(u_albet):
    """Clip alpha/beta voltage phasors ``(..., 2)`` into the inverter hexagon;
    returns ``(..., 2)`` (the JAX function returns a ``(1, 2)`` row per phasor).

    The sector comes from the sign of ``sin(angle - k * 120 deg)`` for
    ``k in {0, 1, 2}``; the phasor is rotated onto the top sector, clipped to
    the rectangle covering it, and rotated back (reference
    ``pmsm_env.py:92-102``, complex products written as real rotations).
    """
    a, b = u_albet[..., 0], u_albet[..., 1]
    angle = torch.atan2(b, a)
    bits = [(torch.sin(angle - 2 / 3 * math.pi * k) >= 0).long() for k in range(3)]
    table_re, table_im = _rotation_tables(u_albet.device)
    rot_re = table_re[bits[0], bits[1], bits[2]]
    rot_im = table_im[bits[0], bits[1], bits[2]]
    ra = a * rot_re - b * rot_im
    rb = a * rot_im + b * rot_re
    ra = _clip(ra, -2 / 3, 2 / 3)
    rb = _clip(rb, 0, 2 / 3 * math.sqrt(3))
    oa = ra * rot_re + rb * rot_im
    ob = rb * rot_re - ra * rot_im
    return torch.stack([oa, ob], dim=-1)


def clip_in_abc_coordinates(u_dq, u_dc, omega_el, eps, tau):
    """Clip dq voltages phase-wise in abc coordinates and transform back."""
    eps_advanced = step_eps(eps, omega_el, tau, 0.5)
    u_abc = dq2abc(u_dq, eps_advanced)
    u_abc = torch.clamp(u_abc, -u_dc / 2.0, u_dc / 2.0)
    return abc2dq(u_abc, eps)
