"""Time the two ways of computing the Fisher information's sensitivities.

    python3 scripts/fim_methods.py [--device cpu|cuda] [--repeats N]

``J = d(trajectory)/d(theta)`` ``(n_obs * obs_dim, P)`` of a single
``sim_ahead`` trajectory, in ``log theta``, either

* forward mode: ``P`` passes of ``torch.autograd.forward_ad`` through the
  eager single-instance ``sim_ahead``, one tangent per parameter; or
* copies and one reverse pass: ``utils/sysid.py::_fim``, a batch of
  ``n_obs * obs_dim`` copies of the trajectory, each with its own parameter
  row and a one-hot cotangent on its own output, through ``fused_sim_ahead``
  (the kernels and their VJPs on the card, their plain versions on the CPU).

Cases: the Pendulum over 64 and 256 steps (``l``, ``m``) and the linear
PMSM over 64 steps (``r_s``, ``l_d``, ``l_q``), float64.  Prints per case
the best time of each method over ``--repeats`` runs (host clock; on CUDA
after a synchronize) and the two matrices' largest relative difference; the
last line is one JSON object with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
import torch.autograd.forward_ad as fwAD

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import exciting_environments_torch as P  # noqa: E402
from exciting_environments_torch.core import structures  # noqa: E402
from exciting_environments_torch.ops import random as R  # noqa: E402
from exciting_environments_torch.ops.signals import aprbs  # noqa: E402
from exciting_environments_torch.utils import sysid  # noqa: E402


def fim_forward_mode(env, names, values, init_state, actions, tau):
    """``JᵀJ`` from ``P`` forward-mode passes through the eager ``sim_ahead``."""
    theta = torch.log(values)
    cols = []
    for i in range(len(names)):
        with fwAD.dual_level():
            dual = torch.exp(fwAD.make_dual(theta, torch.eye(len(names), dtype=theta.dtype, device=theta.device)[i]))
            sp = structures.replace(env.env_properties.static_params, **{n: dual[j] for j, n in enumerate(names)})
            props = structures.replace(env.env_properties, static_params=sp)
            obs, _, _ = env.sim_ahead(init_state, actions, props, tau, tau)
            cols.append(fwAD.unpack_dual(obs).tangent.reshape(-1))
    jac = torch.nan_to_num(torch.stack(cols, dim=-1))
    return jac.mT @ jac


def best_of(fn, repeats, device):
    best, out = float("inf"), None
    for _ in range(repeats):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best, out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    rows = []
    for name, n_steps in (("Pendulum", 64), ("Pendulum", 256), ("PMSM", 64)):
        env = getattr(P, name)(batch_size=1, device=args.device, dtype=torch.float64)
        names = ("l", "m") if name == "Pendulum" else ("r_s", "l_d", "l_q")
        values = torch.tensor([float(getattr(env.env_properties.static_params, n)) for n in names],
                              dtype=torch.float64, device=args.device)
        acts = aprbs(R.PRNGKey(1, args.device), 1, n_steps, env.action_dim, hold_min=4, hold_max=12,
                     dtype=torch.float64)[0]
        s0 = env.init_state(env.env_properties)
        t_fwd, f_fwd = best_of(lambda: fim_forward_mode(env, names, values, s0, acts, env.tau), args.repeats,
                               args.device)
        t_rev, f_rev = best_of(lambda: sysid.fisher_information(env, acts, names).fim, args.repeats, args.device)
        dev = float((f_fwd - f_rev).abs().max() / f_rev.abs().max())
        rows.append({"case": f"{name} {n_steps} steps", "forward_mode_s": t_fwd, "copies_reverse_s": t_rev,
                     "relative_difference": dev})
        print(f"{name} {n_steps} steps, {len(names)} parameters, {args.device}: forward mode {t_fwd:.4f} s, "
              f"copies and one reverse pass {t_rev:.4f} s ({t_fwd / t_rev:.2f}x), matrices {dev:.2e} apart")
    print(json.dumps({"device": args.device, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
