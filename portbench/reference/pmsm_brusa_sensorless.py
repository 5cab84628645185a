"""Plain reference of the saturated BRUSA drive under gain-scheduled
observer-based current control, in plain PyTorch.

The plant is ``reference/pmsm_brusa.py``'s, loaded from its file beside
this one (a reference imports nothing of the harness or the program): the
measured BRUSA magnetics, one step of deadtime, the voltage hexagon,
explicit Euler at ``tau``, each drive's speed held.  The controller reads the two current columns of the
observation (normalized ``i_d``, ``i_q``, measured without noise) and holds,
per drive, a normalized belief of the currents:

1. the belief is corrected with the stationary Kalman gain ``K`` of the
   drive's speed, bilinearly interpolated at the belief on the magnetics
   grid: ``x_c = x + K (z - x)``;
2. a PI with the constant bandwidth ``w_b`` on the corrected currents:
   ``kp = w_b L_dd`` (d), ``w_b L_qq`` (q), ``ki = kp / t_i``, with the
   feedforwards ``r_s i*`` and the back-EMF ``-omega psi_q`` (d), ``+omega
   psi_d`` (q), the magnetics interpolated at the belief;
3. the voltage scaled into the circle ``|u| <= u_lim`` (the hexagon's
   inscribed circle, inside the action band), back-calculation on both
   integrators with the gain ``tau / t_i``;
4. the command normalized onto the action band; under deadtime the voltage
   applied this step is the previous command, which the controller carries;
5. the belief predicted one Euler step of the saturated current equation
   under that applied voltage, at the corrected currents.

The gains: at every grid point, the normalized one-Euler-step current map
(zero voltage) is linearized by autograd through this module's own
bilinear gather, at the grid point as the normalized coordinates give it
back; the stationary filter of that map with ``Q = q_floor I`` and ``R`` the
sensors' variance in normalized units solves ``P = A (P - P (P + R)^-1 P) A'
+ Q`` by doubling, and ``K = P (P + R)^-1``, for each distinct speed of the
fleet, in float64.

Nothing here imports the program; the plant's constants are the upstream
BRUSA preset's, the controller's the configuration's assumptions.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch


def _sibling(name: str):
    """The reference ``<name>.py`` beside this one, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}", Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


plant = _sibling("pmsm_brusa")
BANDS, TAU, R_S, U_DC = plant.BANDS, 1e-4, plant.R_S, plant.U_DC
#: the controller, as the configuration assumes it
BANDWIDTH, T_I, Q_FLOOR, SENSOR_STD = 2000.0, 5e-3, 1e-6, 2.5
#: the voltage circle: the hexagon's inscribed circle, inside the action band
U_LIM = min(BANDS["u"][1], U_DC / math.sqrt(3.0))


def _linearized(table, omegas):
    """``A`` ``(S, N, 2, 2)``: the Jacobian of the normalized one-Euler-step
    current map at zero voltage, at every grid point (x-major), per speed."""
    (mn_d, mx_d), (mn_q, mx_q) = BANDS["i_d"], BANDS["i_q"]
    dev = omegas.device
    k_d = torch.arange(table.nx, dtype=torch.float64, device=dev)
    k_q = torch.arange(table.ny, dtype=torch.float64, device=dev)
    n_d = plant.normalize(table.x0 + table.dx * k_d, BANDS["i_d"])
    n_q = plant.normalize(table.y0 + table.dy * k_q, BANDS["i_q"])
    n_s, n_p = omegas.shape[0], table.nx * table.ny
    z_d = n_d.repeat_interleave(table.ny).repeat(n_s).requires_grad_(True)
    z_q = n_q.repeat(table.nx).repeat(n_s).requires_grad_(True)
    w = omegas.repeat_interleave(n_p)
    with torch.enable_grad():
        i_d, i_q = plant.denormalize(z_d, (mn_d, mx_d)), plant.denormalize(z_q, (mn_q, mx_q))
        i_d1, i_q1 = plant.euler_currents(table(i_d, i_q), i_d, i_q, 0.0, 0.0, w, R_S, TAU)
        out = (plant.normalize(i_d1, BANDS["i_d"]), plant.normalize(i_q1, BANDS["i_q"]))
        rows = [torch.autograd.grad(o.sum(), (z_d, z_q), retain_graph=True) for o in out]
    A = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)  # A[.., i, j] = d out_i / d in_j
    return A.reshape(n_s, n_p, 2, 2)


def kalman_gains(table, omegas):
    """The gain maps ``(S, 4, nx, ny)`` (``K00, K01, K10, K11``) for the
    speeds ``omegas`` ``(S,)``, in float64: ``P`` by doubling, ``X_{j+1} =
    X_j + Phi_j' X_j (I + G_j X_j)^-1 Phi_j`` with ``Phi_0 = A'``, ``G_0 =
    R^-1``, ``X_0 = Q``."""
    A = _linearized(table, omegas).reshape(-1, 2, 2)
    n, dev = A.shape[0], A.device
    spans = [BANDS[f][1] - BANDS[f][0] for f in ("i_d", "i_q")]
    R = torch.diag(torch.tensor([(2.0 * SENSOR_STD / s) ** 2 for s in spans], dtype=torch.float64, device=dev))
    eye = torch.eye(2, dtype=torch.float64, device=dev).expand(n, 2, 2)
    X, G, phi = Q_FLOOR * eye, torch.linalg.inv(R).expand(n, 2, 2), A.transpose(1, 2)
    for _ in range(100):
        inv = torch.linalg.inv(eye + G @ X)
        X_next = X + phi.transpose(1, 2) @ X @ inv @ phi
        G = G + phi @ inv @ G @ phi.transpose(1, 2)
        phi = phi @ inv @ phi
        moved = float((X_next - X).abs().max()) / float(X_next.abs().max())
        X = X_next
        if moved < 1e-15:
            break
    P = 0.5 * (X + X.transpose(1, 2))
    K = P @ torch.linalg.inv(P + R)
    return K.reshape(omegas.shape[0], table.nx, table.ny, 4).permute(0, 3, 1, 2)


def _at(x):
    """``x`` with its entries that are not finite at 0, to index a table: a
    drive whose currents diverged (in a low-precision control) gathers
    somewhere, and its own state stays what it is."""
    return torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)


def _gather(values, slices, table, i_d, i_q):
    """The channels of each drive's slice of ``values`` ``(S, C, nx, ny)`` at
    its currents, bilinear on the magnetics grid: ``(C, N)``."""
    i_d, i_q = _at(i_d), _at(i_q)
    fx = (i_d - table.x0) / table.dx
    fy = (i_q - table.y0) / table.dy
    ix = torch.clamp(torch.floor(fx), 0, table.nx - 2).long()
    iy = torch.clamp(torch.floor(fy), 0, table.ny - 2).long()
    wx, wy = fx - ix, fy - iy
    v = lambda i, j: values[slices, :, i, j].T
    return (v(ix, iy) * (1 - wx) * (1 - wy) + v(ix, iy + 1) * (1 - wx) * wy + v(ix + 1, iy) * wx * (1 - wy)
            + v(ix + 1, iy + 1) * wx * wy)


def control(z_d, z_q, carry, sched, slices, table, ref_d, ref_q, omega):
    """One step of the controller: the normalized measured currents, the
    carry ``(belief d, belief q, int_d, int_q, previous command d, q)``.
    Returns the normalized command and the new carry."""
    x_d, x_q, int_d, int_q, prev_d, prev_q = carry
    s = _gather(sched, slices, table, plant.denormalize(x_d, BANDS["i_d"]), plant.denormalize(x_q, BANDS["i_q"]))
    l_dd, l_dq, l_qd, l_qq, psi_d, psi_q, k00, k01, k10, k11 = s.unbind(0)
    xc_d = x_d + k00 * (z_d - x_d) + k01 * (z_q - x_q)
    xc_q = x_q + k10 * (z_d - x_d) + k11 * (z_q - x_q)
    i_d, i_q = plant.denormalize(xc_d, BANDS["i_d"]), plant.denormalize(xc_q, BANDS["i_q"])
    kp_d, kp_q = BANDWIDTH * l_dd, BANDWIDTH * l_qq
    e_d, e_q = ref_d - i_d, ref_q - i_q
    u_d_raw = kp_d * e_d + int_d + R_S * ref_d - omega * psi_q
    u_q_raw = kp_q * e_q + int_q + R_S * ref_q + omega * psi_d
    scale = torch.clamp(U_LIM / torch.clamp(torch.sqrt(u_d_raw * u_d_raw + u_q_raw * u_q_raw), min=1e-9), max=1.0)
    u_d, u_q = u_d_raw * scale, u_q_raw * scale
    int_d = int_d + kp_d / T_I * TAU * e_d + TAU / T_I * (u_d - u_d_raw)
    int_q = int_q + kp_q / T_I * TAU * e_q + TAU / T_I * (u_q - u_q_raw)
    a_d, a_q = plant.normalize(u_d, BANDS["u"]), plant.normalize(u_q, BANDS["u"])
    # the predict, under the voltage the inverter applies this step
    magnetics = (l_dd, l_dq, l_qd, l_qq, psi_d, psi_q)
    i_d1, i_q1 = plant.euler_currents(magnetics, i_d, i_q, plant.denormalize(prev_d, BANDS["u"]),
                                      plant.denormalize(prev_q, BANDS["u"]), omega, R_S, TAU)
    belief = (plant.normalize(i_d1, BANDS["i_d"]), plant.normalize(i_q1, BANDS["i_q"]))
    return (a_d, a_q), belief + (int_d, int_q, a_d, a_q)


def closed_loop(start, carry, omega, refs, n_steps: int, dtype: torch.dtype):
    """The drive under the controller over ``n_steps`` steps from ``start =
    (i_d, i_q, eps, buf_d, buf_q)`` and ``carry`` (see :func:`control`), each
    drive at its ``omega`` and references ``refs = (ref_d, ref_q)`` ``(N,)``.
    The gains are solved in float64 for each distinct speed, everything else
    runs in ``dtype``.  Returns ``(final, carry, obs)``: the final ``(i_d,
    i_q, eps, buf_d, buf_q)``, the final carry and the observation after the
    last step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = start[0].device
    table64 = plant.Table(torch.float64, device)
    speeds, slices = torch.unique(omega.double(), return_inverse=True)
    gains = kalman_gains(table64, speeds)
    sched = torch.cat([table64.values.expand(speeds.shape[0], -1, -1, -1), gains], dim=1).to(dtype)
    table, rotations = plant.Table(dtype, device), plant._rotation_table(dtype, device)
    i_d, i_q, eps, buf_d, buf_q = plant._cast(dtype, *start)
    omega, ref_d, ref_q = plant._cast(dtype, omega, *refs)
    c = tuple(plant._cast(dtype, *carry))
    for _ in range(n_steps):
        maps = table(_at(i_d), _at(i_q))
        z_d, z_q = plant.normalize(i_d, BANDS["i_d"]), plant.normalize(i_q, BANDS["i_q"])
        (a_d, a_q), c = control(z_d, z_q, c, sched, slices, table, ref_d, ref_q, omega)
        u_d, u_q = plant.constrain(a_d, a_q, eps, omega, TAU, rotations)
        i_d, i_q = plant.euler_currents(maps, i_d, i_q, buf_d, buf_q, omega, R_S, TAU)
        buf_d, buf_q = u_d, u_q
        eps = plant.wrap(eps + TAU * omega)
    obs = plant.observe(table(_at(i_d), _at(i_q)), i_d, i_q, eps, omega, buf_d, buf_q, ref_d, ref_q)
    return (i_d, i_q, eps, buf_d, buf_q), c, obs
