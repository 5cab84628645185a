"""Plain reference of gradient-based tuning of a PI current law over the
saturated BRUSA fleet, in plain PyTorch.

The plant is ``reference/pmsm_brusa.py``'s, loaded from its file beside this
one (a reference imports nothing of the harness or the program): the
measured BRUSA magnetics, one step of deadtime, the voltage hexagon, explicit
Euler at ``tau``, each drive's speed held.  The law reads the whole
observation (normalized ``i_d, i_q, omega_el``, torque, ``cos`` and ``sin``
of the angle, the normalized buffers, the normalized references) with the
42 gains ``[K (2 x 10), b (2), Ki (2 x 10)]``: per action ``c_j <- c_j +
sum_i Ki[j][i] obs_i``, then ``a_j = b_j + sum_i K[j][i] obs_i + c_j``.

The loss is ``train_policy``'s default tracking loss over a rollout saved
every step: the mean over drives and steps of ``(normalized i_d after the
step - normalized i_d reference)^2``, plus the same of ``i_q``.  Its gradient
in the 42 gains comes from autograd through this loop, in blocks of drives
(each block's sum), the blocks summed in float64.

Nothing here imports the program; the plant's constants are the upstream
BRUSA preset's.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import torch


def _sibling(name: str):
    """The reference ``<name>.py`` beside this one, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}", Path(__file__).resolve().parent / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


plant = _sibling("pmsm_brusa")
BANDS = plant.BANDS
#: observation columns the law reads
N_OBS = 10
#: the gains: K, b, Ki
N_PARAMS = 4 * N_OBS + 2
#: drives of one block of the gradient (the cell's fleet in one)
BLOCK = 65536


def squared_errors(start, omega, refs, carry, params, n_steps: int, tau: float):
    """The sum over drives and steps of both squared tracking errors, in the
    dtype of ``params`` (differentiable in it).  ``start``: ``(i_d, i_q,
    eps, buf_d, buf_q)`` ``(N,)``; ``refs``: the physical references
    ``(ref_d, ref_q)``; ``carry``: the two integrators."""
    dtype, device = params.dtype, params.device
    table, rotations = plant.Table(dtype, device), plant._rotation_table(dtype, device)
    cast = lambda xs: [x.to(dtype) for x in xs]
    i_d, i_q, eps, buf_d, buf_q = cast(start)
    omega, ref_d, ref_q = cast((omega, *refs))
    c = cast(carry)
    K = params[: 2 * N_OBS].reshape(2, N_OBS)
    b = params[2 * N_OBS : 2 * N_OBS + 2]
    Ki = params[2 * N_OBS + 2 :].reshape(2, N_OBS)
    r_d, r_q = plant.normalize(ref_d, BANDS["i_d"]), plant.normalize(ref_q, BANDS["i_q"])
    total = 0
    for _ in range(n_steps):
        maps = table(i_d, i_q)
        obs = plant.observe(maps, i_d, i_q, eps, omega, buf_d, buf_q, ref_d, ref_q).unbind(-1)
        action = []
        for j in range(2):
            c[j] = c[j] + sum(Ki[j, i] * obs[i] for i in range(N_OBS))
            action.append(b[j] + sum(K[j, i] * obs[i] for i in range(N_OBS)) + c[j])
        u_d, u_q = plant.constrain(action[0], action[1], eps, omega, tau, rotations)
        i_d, i_q = plant.euler_currents(maps, i_d, i_q, buf_d, buf_q, omega, plant.R_S, tau)
        buf_d, buf_q = u_d, u_q
        eps = plant.wrap(eps + tau * omega)
        e_d, e_q = plant.normalize(i_d, BANDS["i_d"]) - r_d, plant.normalize(i_q, BANDS["i_q"]) - r_q
        total = total + (e_d * e_d).sum() + (e_q * e_q).sum()
    return total


def loss_and_grad(start, omega, refs, carry, params, n_steps: int, tau: float, dtype: torch.dtype,
                  block: int = BLOCK):
    """The tracking loss at the gains ``params`` ``(42,)`` and its gradient,
    computed in ``dtype`` in blocks of ``block`` drives: ``(loss, grad)``, a
    float64 scalar and ``(42,)``."""
    n = omega.shape[0]
    p = params.detach().to(dtype)
    total = torch.zeros((), dtype=torch.float64, device=omega.device)
    grad = torch.zeros(N_PARAMS, dtype=torch.float64, device=omega.device)
    for lo in range(0, n, block):
        rows = slice(lo, lo + block)
        with torch.enable_grad():
            leaf = p.clone().requires_grad_(True)
            s = squared_errors([x[rows] for x in start], omega[rows], [x[rows] for x in refs],
                               [x[rows] for x in carry], leaf, n_steps, tau)
            (g,) = torch.autograd.grad(s, leaf)
        total += s.detach().double()
        grad += g.double()
    return total / (n * n_steps), grad / (n * n_steps)
