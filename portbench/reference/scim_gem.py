"""Plain reference of gym-electric-motor's squirrel-cage induction motor
under flux-sensorless field-oriented torque control, in plain PyTorch.

The machine (gym-electric-motor, ``squirrel_cage_induction_motor.py``
defaults; ``p = 2`` pole pairs), in the stationary alpha/beta frame with the
rotor's electrical speed ``omega`` held, as the source's constant-speed load
holds it; ``k_r = L_m / L_r``, ``sigma L_s = L_s - L_m k_r``, ``R_sig = R_s
+ k_r^2 R_r``, ``J = [[0, -1], [1, 0]]``::

    sigma L_s di_s/dt = u_s - R_sig i_s + k_r (R_r / L_r psi_r - omega J psi_r)
    dpsi_r/dt         = R_r / L_r (L_m i_s - psi_r) + omega J psi_r

integrated by explicit Euler, the stator voltage first scaled into the
inverter's inscribed circle ``|u_s| <= u_dc / sqrt(3)``.  The observation is
the state normalized onto its bands, ``2 (x - lo) / (hi - lo) - 1``.

The controller reads only the two current columns.  Its observer is the
stationary Kalman filter of that Euler step in normalized coordinates
(derived here from the equations above), one per drive at the drive's
speed, with the gain of the filter-form Riccati equation solved by doubling
(:func:`kalman_gain`); it corrects its predicted belief with the measured
currents, and predicts with the action it emits.  The law on the corrected
belief, rotor-flux oriented (the port's documented law):

1. orientation on the estimated flux, ``rho = psi / |psi|``; below the flux
   floor a frame at the angle ``omega tau k`` (``k`` the step of the call);
2. the stator currents rotated into that frame;
3. a flux PI ``i_d* = psi*/L_m + kp_psi e + int`` (``e = psi* - |psi|``)
   clamped to ``+-i_max``, its integrator advanced by ``ki_psi tau e`` only
   while the last voltage vector was inside the limit or ``e`` and the raw
   command have opposite signs, and pulled by ``tau ki_psi / kp_psi (i_d -
   i_d_raw)`` toward the achieved current;
4. the torque current ``T* / (1.5 p k_r max(|psi|, floor))`` inside the
   circle that ``i_d*`` leaves of ``i_max``, gated open as the flux passes
   half its setpoint (fully at three quarters);
5. decoupled current PIs at the slip-adjusted speed ``omega + L_m i_q /
   (L_r / R_r max(|psi|, floor))`` with the feedforward ``-omega_s sigma L_s
   i_q`` and ``omega_s (sigma L_s i_d + k_r |psi|)``;
6. the voltage vector scaled into the limit, back-calculation on both
   current integrators (gain ``tau ki / kp``), the flag of an unscaled vector,
   and the vector turned back and normalized onto the action band.

Nothing here imports the program; the constants are the source's, the
port's default state bands and the configuration's assumptions.
"""

from __future__ import annotations

import math

import torch

R_S, R_R, L_M, L_SIG, P = 2.9338, 1.355, 0.14375, 0.00587, 2.0
L_S = L_R = L_M + L_SIG
U_DC = 560.0
U_LIM = U_DC / math.sqrt(3.0)
#: the state bands (the port's defaults) and the action band (the circle)
BANDS = {"i": 20.0, "psi": 1.5, "u": U_LIM}
TAU = 1e-4
#: the law and its observer, as the configuration assumes them
PSI_STAR, I_MAX, KP, KI, KP_PSI, KI_PSI, PSI_FLOOR = 0.4, 5.5, 40.0, 8000.0, 40.0, 800.0, 0.05
SENSOR_STD, Q_FLOOR = 0.055, 1e-8


def _machine():
    k_r = L_M / L_R
    return k_r, R_R / L_R, L_S - L_M * k_r, R_S + k_r * k_r * R_R


def observe(x):
    """The normalized observation ``(..., 4)`` of ``(i_sd, i_sq, psi_rd,
    psi_rq)``."""
    half = (BANDS["i"], BANDS["i"], BANDS["psi"], BANDS["psi"])
    return torch.stack([v / h for v, h in zip(x, half)], dim=-1)


def plant_step(x, u_d, u_q, omega):
    """One Euler step of the machine under the voltage ``(u_d, u_q)`` [V],
    scaled into the inverter circle first."""
    k_r, r_over_l, sigma_l_s, r_sig = _machine()
    mag = torch.sqrt(u_d * u_d + u_q * u_q)
    s = torch.clamp(U_LIM / torch.clamp(mag, min=1e-12), max=1.0)
    u_d, u_q = u_d * s, u_q * s
    i_d, i_q, p_d, p_q = x
    d_id = (u_d - r_sig * i_d + k_r * (r_over_l * p_d + omega * p_q)) / sigma_l_s
    d_iq = (u_q - r_sig * i_q + k_r * (r_over_l * p_q - omega * p_d)) / sigma_l_s
    d_pd = r_over_l * (L_M * i_d - p_d) - omega * p_q
    d_pq = r_over_l * (L_M * i_q - p_q) + omega * p_d
    return tuple(v + TAU * d for v, d in zip(x, (d_id, d_iq, d_pd, d_pq)))


def transition(omega):
    """The Euler step in normalized coordinates, ``x' = A x + B a`` (the
    bands are symmetric, so no offset), per drive: ``A`` ``(N, 4, 4)``, ``B``
    ``(N, 4, 2)``, in float64."""
    k_r, r_over_l, sigma_l_s, r_sig = _machine()
    n = omega.shape[0]
    w = omega.double()
    F = torch.zeros((n, 4, 4), dtype=torch.float64, device=omega.device)
    F[:, 0, 0] = F[:, 1, 1] = -r_sig / sigma_l_s
    F[:, 0, 2] = F[:, 1, 3] = k_r * r_over_l / sigma_l_s
    F[:, 0, 3] = k_r * w / sigma_l_s
    F[:, 1, 2] = -k_r * w / sigma_l_s
    F[:, 2, 0] = F[:, 3, 1] = r_over_l * L_M
    F[:, 2, 2] = F[:, 3, 3] = -r_over_l
    F[:, 2, 3] = -w
    F[:, 3, 2] = w
    half = torch.tensor([BANDS["i"], BANDS["i"], BANDS["psi"], BANDS["psi"]], dtype=torch.float64,
                        device=omega.device)
    eye = torch.eye(4, dtype=torch.float64, device=omega.device)
    A = (eye + TAU * F) * half[None, :] / half[:, None]
    B = torch.zeros((n, 4, 2), dtype=torch.float64, device=omega.device)
    B[:, 0, 0] = B[:, 1, 1] = TAU * BANDS["u"] / (sigma_l_s * BANDS["i"])
    return A, B


def kalman_gain(A):
    """The predicted-form stationary Kalman gain ``K`` ``(N, 4, 2)`` of the
    current measurements, from ``P = A (P - P H' S^-1 H P) A' + Q``, ``S = H
    P H' + R``, solved by doubling: ``X_{j+1} = X_j + Phi_j' X_j (I + G_j
    X_j)^-1 Phi_j`` with ``Phi = A'``, ``G = H' R^-1 H``, ``X_0 = Q``."""
    n, dev = A.shape[0], A.device
    r = (SENSOR_STD / BANDS["i"]) ** 2
    eye = torch.eye(4, dtype=torch.float64, device=dev).expand(n, 4, 4)
    Q = Q_FLOOR * eye
    G = torch.zeros((n, 4, 4), dtype=torch.float64, device=dev)
    G[:, 0, 0] = G[:, 1, 1] = 1.0 / r
    phi, X = A.transpose(1, 2), Q
    for _ in range(80):
        inv = torch.linalg.inv(eye + G @ X)
        X_next = X + phi.transpose(1, 2) @ X @ inv @ phi
        G = G + phi @ inv @ G @ phi.transpose(1, 2)
        phi = phi @ inv @ phi
        moved = float((X_next - X).abs().max()) / float(X_next.abs().max())
        X = X_next
        if moved < 1e-15:
            break
    P = 0.5 * (X + X.transpose(1, 2))
    S = P[:, :2, :2] + r * torch.eye(2, dtype=torch.float64, device=dev)
    return P[:, :, :2] @ torch.linalg.inv(S)


def law(i_sd, i_sq, p_d, p_q, carry, k, omega, torque):
    """The field-oriented law on a physical belief at step ``k``; ``carry =
    (int_d, int_q, int_psi, free)``.  Returns the normalized action and the
    new carry."""
    k_r, r_over_l, sigma_l_s, _ = _machine()
    int_d, int_q, int_psi, free = carry
    mag = torch.sqrt(p_d * p_d + p_q * p_q)
    denom = torch.clamp(mag, min=PSI_FLOOR)
    theta = omega * TAU * k
    estimated = mag > PSI_FLOOR
    c = torch.where(estimated, p_d / denom, torch.cos(theta))
    s = torch.where(estimated, p_q / denom, torch.sin(theta))
    i_d = c * i_sd + s * i_sq
    i_q = c * i_sq - s * i_sd
    e_psi = PSI_STAR - mag
    i_d_raw = PSI_STAR / L_M + KP_PSI * e_psi + int_psi
    i_d_ref = torch.clamp(i_d_raw, -I_MAX, I_MAX)
    integrate = (free > 0) | (e_psi * i_d_raw < 0)
    int_psi = int_psi + torch.where(integrate, KI_PSI * TAU * e_psi, 0.0) + TAU * KI_PSI / KP_PSI * (i_d - i_d_raw)
    cap = torch.sqrt(torch.clamp(I_MAX * I_MAX - i_d_ref * i_d_ref, min=0.0))
    i_q_ref = torch.minimum(torch.maximum(torque / (1.5 * P * k_r * denom), -cap), cap)
    i_q_ref = torch.clamp((mag - 0.5 * PSI_STAR) / (0.25 * PSI_STAR), 0.0, 1.0) * i_q_ref
    e_d, e_q = i_d_ref - i_d, i_q_ref - i_q
    omega_s = omega + L_M * i_q / (L_R / R_R * denom)
    u_d_raw = KP * e_d + int_d - omega_s * sigma_l_s * i_q
    u_q_raw = KP * e_q + int_q + omega_s * (sigma_l_s * i_d + k_r * mag)
    u_mag = torch.sqrt(u_d_raw * u_d_raw + u_q_raw * u_q_raw)
    scale = torch.clamp(U_LIM / torch.clamp(u_mag, min=1e-9), max=1.0)
    u_d, u_q = u_d_raw * scale, u_q_raw * scale
    int_d = int_d + KI * TAU * e_d + TAU * KI / KP * (u_d - u_d_raw)
    int_q = int_q + KI * TAU * e_q + TAU * KI / KP * (u_q - u_q_raw)
    flag = (u_mag <= U_LIM).to(u_d.dtype)
    return ((c * u_d - s * u_q) / U_LIM, (s * u_d + c * u_q) / U_LIM), (int_d, int_q, int_psi, flag)


def closed_loop(start, carry, omega, torque, n_steps: int, dtype: torch.dtype):
    """The sensorless drive over ``n_steps`` steps from ``start = (i_sd,
    i_sq, psi_rd, psi_rq)`` and ``carry`` (the 4 normalized predicted-belief
    planes, then the law's ``int_d, int_q, int_psi, free``), each drive at
    its ``omega`` and ``torque`` ``(N,)``.  The gains are solved in float64,
    everything else runs in ``dtype``.  Returns ``(final, carry, obs)``: the
    final state, the final carry and the observation after the last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    A64, B64 = transition(omega)
    K64 = kalman_gain(A64)
    A, B, K = (m.to(dtype) for m in (A64, B64, K64))
    x = tuple(v.to(dtype) for v in start)
    xh, lc = [v.to(dtype) for v in carry[:4]], tuple(v.to(dtype) for v in carry[4:])
    omega, torque = omega.to(dtype), torque.to(dtype)
    half = (BANDS["i"], BANDS["i"], BANDS["psi"], BANDS["psi"])
    for k in range(n_steps):
        z = observe(x)
        innov = (z[..., 0] - xh[0], z[..., 1] - xh[1])
        xc = [xh[i] + K[:, i, 0] * innov[0] + K[:, i, 1] * innov[1] for i in range(4)]
        (a_d, a_q), lc = law(*(v * h for v, h in zip(xc, half)), lc, k, omega, torque)
        xh = [sum(A[:, i, j] * xc[j] for j in range(4)) + B[:, i, 0] * a_d + B[:, i, 1] * a_q for i in range(4)]
        x = plant_step(x, a_d * U_LIM, a_q * U_LIM, omega)
    return x, tuple(xh) + tuple(lc), observe(x)
