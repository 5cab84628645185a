"""Plain reference of the pendulum fleet, in plain PyTorch.

The upstream model (ExcitingSystems/exciting-environments, ``pendulum.py``):
a point mass ``m`` on a massless rod of length ``l`` under gravity ``g``,
driven by a torque, ``d omega / dt = (u + l m g sin theta) / (m l^2)``,
``d theta / dt = omega``, integrated by explicit Euler with step ``tau``;
after each step the angle is wrapped into ``[-pi, pi)``.  Actions arrive
normalized in ``[-1, 1]`` and are denormalized into the torque band; the
observation is the state min-max normalized into ``[-1, 1]``.  Nothing here
imports the program: parameters and bands are the upstream defaults.
"""

from __future__ import annotations

import math

import torch

G, L, M = 9.81, 2.0, 1.0
TORQUE_BAND = (-20.0, 20.0)
THETA_BAND = (-math.pi, math.pi)
OMEGA_BAND = (-10.0, 10.0)


def denormalize(x, band):
    lo, hi = band
    return (x + 1) / 2 * (hi - lo) + lo


def normalize(x, band):
    lo, hi = band
    return 2 * (x - lo) / (hi - lo) - 1


def wrap(angle):
    """Into ``[-pi, pi)``."""
    return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def observe(theta, omega):
    """The observation ``(..., 2)``."""
    return torch.stack([normalize(theta, THETA_BAND), normalize(omega, OMEGA_BAND)], dim=-1)


def rollout(theta, omega, actions, tau: float, dtype: torch.dtype):
    """The final ``(theta, omega)`` after ``actions.shape[1]`` Euler steps
    from ``(theta, omega)`` ``(B,)`` under normalized actions ``(B, T, 1)``,
    computed in ``dtype``."""
    theta, omega = theta.to(dtype), omega.to(dtype)
    for t in range(actions.shape[1]):
        u = denormalize(actions[:, t, 0].to(dtype), TORQUE_BAND)
        d_omega = (u + L * M * G * torch.sin(theta)) / (M * L * L)
        theta, omega = wrap(theta + tau * omega), omega + tau * d_omega
    return theta, omega
