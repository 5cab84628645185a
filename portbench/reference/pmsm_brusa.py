"""Plain reference of the saturated BRUSA drive, in plain PyTorch.

The upstream model (ExcitingSystems/exciting-environments, ``pmsm_env.py``
and ``examples/pmsm_example.ipynb``), in the dq frame of a permanent-magnet
synchronous motor with ``p = 3`` pole pairs:

* magnetics: the measured flux linkages ``psi_d, psi_q`` and differential
  inductances ``L_dd, L_dq, L_qd, L_qq`` of the BRUSA machine, read from
  ``LUT_BRUSA.npz`` (a frozen copy of the upstream tables): missing points
  filled from the nearest measured point, the border duplicated once, and
  bilinear interpolation on the padded grid, the cell index clamped so that
  it extrapolates linearly beyond it;
* currents: ``di/dt = L^-1 (u - r_s i - omega_el J psi)`` with ``J = [[0,
  -1], [1, 0]]``, integrated by explicit Euler with the speed held;
  the torque ``1.5 p (psi_d i_q - psi_q i_d)``;
* the inverter: an action denormalized into volts, turned into the
  alpha/beta frame at the angle advanced by ``(deadtime + 0.5) tau
  omega_el``, clipped into the voltage hexagon of the DC link (the sector
  from the signs of ``sin(angle - k 120 deg)``, rotated onto the top
  sector, clipped to its rectangle and rotated back), and turned back;
* one step of deadtime: the clipped voltage enters a buffer and the
  buffered one drives the currents;
* the angle advances by ``tau omega_el`` and wraps into ``[-pi, pi)``;
* the observation: normalized ``i_d, i_q, omega_el, torque``, ``cos`` and
  ``sin`` of the angle, the normalized buffers, the normalized references;
  the reward of current tracking; truncated (and terminated) where the
  normalized current leaves the unit disc.

Nothing here imports the program; the constants are the upstream BRUSA
preset's.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

P, R_S, U_DC, DEADTIME = 3, 17.932e-3, 400.0, 1
U_MAX = 2 * U_DC / 3
BANDS = {
    "u": (-U_MAX, U_MAX),
    "i_d": (-250.0, 0.0),
    "i_q": (-250.0, 250.0),
    "omega_el": (0.0, 3 * 11000 * 2 * math.pi / 60),
    "torque": (-200.0, 200.0),
}
GAMMA = 0.85
TABLE_FILE = Path(__file__).resolve().parent / "LUT_BRUSA.npz"
CHANNELS = ("L_dd", "L_dq", "L_qd", "L_qq", "Psi_d", "Psi_q")


def normalize(x, band):
    lo, hi = band
    return 2 * (x - lo) / (hi - lo) - 1


def denormalize(x, band):
    lo, hi = band
    return (x + 1) / 2 * (hi - lo) + lo


def wrap(angle):
    """Into ``[-pi, pi)``."""
    return torch.remainder(angle + math.pi, 2 * math.pi) - math.pi


def _nearest_fill(grid):
    grid = np.array(grid, dtype=np.float64)
    missing = np.argwhere(np.isnan(grid))
    if len(missing):
        valid = np.argwhere(~np.isnan(grid))
        d2 = ((missing[:, None, :] - valid[None, :, :]) ** 2).sum(-1)
        near = valid[np.argmin(d2, axis=1)]
        grid[missing[:, 0], missing[:, 1]] = grid[near[:, 0], near[:, 1]]
    return grid


class Table:
    """The six BRUSA maps on their padded grid, in ``dtype`` on ``device``."""

    def __init__(self, dtype: torch.dtype, device):
        with np.load(TABLE_FILE) as raw:
            i_d = np.asarray(raw["i_d_vec"], dtype=np.float64).ravel()
            i_q = np.asarray(raw["i_q_vec"], dtype=np.float64).ravel()
            maps = []
            for name in CHANNELS:
                filled = _nearest_fill(raw[name])  # (n_iq, n_id)
                padded = np.pad(filled, 1, mode="edge")
                maps.append(padded.T)  # (n_id + 2, n_iq + 2)
        step_d = (i_d.max() - i_d.min()) / (len(i_d) - 1)
        step_q = (i_q.max() - i_q.min()) / (len(i_q) - 1)
        self.x0, self.dx, self.nx = i_d.min() - step_d, step_d, len(i_d) + 2
        self.y0, self.dy, self.ny = i_q.min() - step_q, step_q, len(i_q) + 2
        self.values = torch.as_tensor(np.stack(maps), dtype=dtype, device=device)

    def __call__(self, i_d, i_q):
        """Every channel at the currents: ``(6,) + i_d.shape``."""
        fx = (i_d - self.x0) / self.dx
        fy = (i_q - self.y0) / self.dy
        ix = torch.clamp(torch.floor(fx), 0, self.nx - 2).long()
        iy = torch.clamp(torch.floor(fy), 0, self.ny - 2).long()
        wx, wy = fx - ix, fy - iy
        v = self.values
        return (v[:, ix, iy] * (1 - wx) * (1 - wy) + v[:, ix, iy + 1] * (1 - wx) * wy
                + v[:, ix + 1, iy] * wx * (1 - wy) + v[:, ix + 1, iy + 1] * wx * wy)


def torque(maps, i_d, i_q):
    """The torque from the maps gathered at the currents."""
    return 1.5 * P * (maps[4] * i_q - maps[5] * i_d)


def euler_currents(maps, i_d, i_q, u_d, u_q, omega, r_s, tau):
    """One Euler step of the currents under the applied voltage, from the
    maps gathered at the currents."""
    l_dd, l_dq, l_qd, l_qq, psi_d, psi_q = maps
    rhs_d = u_d - r_s * i_d + omega * psi_q
    rhs_q = u_q - r_s * i_q - omega * psi_d
    det = l_dd * l_qq - l_dq * l_qd
    return i_d + tau * (l_qq * rhs_d - l_dq * rhs_q) / det, i_q + tau * (l_dd * rhs_q - l_qd * rhs_d) / det


_ROTATIONS = {(1, 0, 1): (0.5, 0.5 * math.sqrt(3)), (1, 1, 0): (0.5, -0.5 * math.sqrt(3)),
              (0, 1, 0): (-0.5, -0.5 * math.sqrt(3)), (0, 1, 1): (-1.0, 0.0), (0, 0, 1): (-0.5, 0.5 * math.sqrt(3))}


def _rotation_table(dtype, device):
    """The sector rotations by the three sign bits, with the upstream
    table's ``complex64`` values."""
    re, im = torch.ones((2, 2, 2), dtype=torch.float32), torch.zeros((2, 2, 2), dtype=torch.float32)
    for bits, (r, i) in _ROTATIONS.items():
        re[bits], im[bits] = r, i
    return re.to(device=device, dtype=dtype), im.to(device=device, dtype=dtype)


def constrain(a_d, a_q, eps, omega, tau, rotations):
    """Normalized actions to the voltages the inverter applies: denormalized,
    clipped into the hexagon at the deadtime-advanced angle."""
    scale = 2 / U_DC
    n_d, n_q = denormalize(a_d, BANDS["u"]) * scale, denormalize(a_q, BANDS["u"]) * scale
    adv = torch.remainder(eps + omega * tau * (DEADTIME + 0.5), 2 * math.pi)
    adv = torch.where(adv > math.pi, adv - 2 * math.pi, adv)
    c, s = torch.cos(adv), torch.sin(adv)
    alpha, beta = c * n_d - s * n_q, s * n_d + c * n_q
    angle = torch.atan2(beta, alpha)
    bits = [(torch.sin(angle - 2 * math.pi / 3 * k) >= 0).long() for k in range(3)]
    re, im = rotations[0][bits[0], bits[1], bits[2]], rotations[1][bits[0], bits[1], bits[2]]
    ra = torch.clamp(alpha * re - beta * im, -2 / 3, 2 / 3)
    rb = torch.clamp(alpha * im + beta * re, 0.0, 2 / math.sqrt(3))
    oa, ob = ra * re + rb * im, rb * re - ra * im
    half = U_DC / 2
    return (c * oa + s * ob) * half, (-s * oa + c * ob) * half


def observe(maps, i_d, i_q, eps, omega, buf_d, buf_q, ref_d, ref_q):
    """The observation ``(..., 10)``, from the maps gathered at the currents."""
    cols = [normalize(i_d, BANDS["i_d"]), normalize(i_q, BANDS["i_q"]), normalize(omega, BANDS["omega_el"]),
            normalize(torque(maps, i_d, i_q), BANDS["torque"]), torch.cos(eps), torch.sin(eps),
            normalize(buf_d, BANDS["u"]), normalize(buf_q, BANDS["u"]), normalize(ref_d, BANDS["i_d"]),
            normalize(ref_q, BANDS["i_q"])]
    return torch.stack(cols, dim=-1)


def reward_and_flag(i_d, i_q, ref_d, ref_q):
    """The current-tracking reward and the truncation flag (the normalized
    current magnitude above 1), with that magnitude."""
    n_d, n_q = normalize(i_d, BANDS["i_d"]), normalize(i_q, BANDS["i_q"])
    r_d, r_q = normalize(ref_d, BANDS["i_d"]), normalize(ref_q, BANDS["i_q"])
    reward = -(0.5 * (n_d - r_d) ** 2 + 0.5 * (n_q - r_q) ** 2) * (1 - GAMMA)
    magnitude = torch.sqrt(n_d * n_d + n_q * n_q)
    return reward, magnitude > 1, magnitude


def _cast(dtype, *xs):
    return [x.to(dtype) if isinstance(x, torch.Tensor) else x for x in xs]


def closed_loop(start, omega, refs, carry, K, Ki, n_steps: int, tau: float, dtype: torch.dtype):
    """The PI current loop ``a = K obs + c``, ``c <- c + Ki obs`` (the
    integrator updated before it is added) over ``n_steps`` steps.

    ``start``: ``(i_d, i_q, eps, buf_d, buf_q)`` ``(N,)``; ``refs``:
    ``(ref_d, ref_q)``; ``carry``: the two integrators; ``K``, ``Ki``:
    ``(2, 10)`` gains over the observation.  Returns ``(final, carry, obs)``
    with the final ``(i_d, i_q, eps, buf_d, buf_q)`` and the observation
    after the last step, all in ``dtype``."""
    device = start[0].device
    table, rotations = Table(dtype, device), _rotation_table(dtype, device)
    i_d, i_q, eps, buf_d, buf_q = _cast(dtype, *start)
    omega, ref_d, ref_q = _cast(dtype, omega, *refs)
    c = _cast(dtype, *carry)
    K, Ki = torch.as_tensor(K, dtype=torch.float64).tolist(), torch.as_tensor(Ki, dtype=torch.float64).tolist()
    for _ in range(n_steps):
        maps = table(i_d, i_q)
        obs = observe(maps, i_d, i_q, eps, omega, buf_d, buf_q, ref_d, ref_q).unbind(-1)
        action = []
        for j in range(2):
            c[j] = c[j] + sum(Ki[j][i] * obs[i] for i in range(10) if Ki[j][i])
            action.append(sum(K[j][i] * obs[i] for i in range(10) if K[j][i]) + c[j])
        u_d, u_q = constrain(action[0], action[1], eps, omega, tau, rotations)
        i_d, i_q = euler_currents(maps, i_d, i_q, buf_d, buf_q, omega, R_S, tau)
        buf_d, buf_q = u_d, u_q
        eps = wrap(eps + tau * omega)
    obs = observe(table(i_d, i_q), i_d, i_q, eps, omega, buf_d, buf_q, ref_d, ref_q)
    return (i_d, i_q, eps, buf_d, buf_q), tuple(c), obs


def open_loop(start, omega, refs, r_s, actions, tau: float, dtype: torch.dtype):
    """Open loop under normalized actions ``(N, T, 2)``, every step kept.

    Returns ``(final, per_step)``: the final ``(i_d, i_q, eps, buf_d,
    buf_q)`` and ``{"observations" (N, T, 10), "rewards" (N, T),
    "truncated" (N, T), "magnitude" (N, T)}``, in ``dtype``."""
    device = start[0].device
    table, rotations = Table(dtype, device), _rotation_table(dtype, device)
    i_d, i_q, eps, buf_d, buf_q = _cast(dtype, *start)
    omega, ref_d, ref_q, r_s = _cast(dtype, omega, *refs, r_s)
    obs, rewards, flags, mags = [], [], [], []
    maps = table(i_d, i_q)
    for t in range(actions.shape[1]):
        a = actions[:, t].to(dtype)
        u_d, u_q = constrain(a[:, 0], a[:, 1], eps, omega, tau, rotations)
        i_d, i_q = euler_currents(maps, i_d, i_q, buf_d, buf_q, omega, r_s, tau)
        buf_d, buf_q = u_d, u_q
        eps = wrap(eps + tau * omega)
        maps = table(i_d, i_q)
        obs.append(observe(maps, i_d, i_q, eps, omega, buf_d, buf_q, ref_d, ref_q))
        reward, flag, mag = reward_and_flag(i_d, i_q, ref_d, ref_q)
        rewards.append(reward)
        flags.append(flag)
        mags.append(mag)
    per_step = {"observations": torch.stack(obs, dim=1), "rewards": torch.stack(rewards, dim=1),
                "truncated": torch.stack(flags, dim=1), "magnitude": torch.stack(mags, dim=1)}
    return (i_d, i_q, eps, buf_d, buf_q), per_step
