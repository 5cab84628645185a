"""Driver ``fleet_run_foc``: ``FleetRunner.run_policy`` with the induction
machine's flux-sensorless field-oriented tile (``make_sensorless_foc_tile``)
and its 8 carry planes, over a fleet whose drives each hold their own speed
and torque setpoint, drawn from the seed at set-up and held for the run
(the closed-loop kernel ``csrc/closed_loop.cu``, one launch per chunk).
The drives start cold: zero currents and flux, a zero belief and
integrators, the flag of an unrailed voltage at 1, so the first warm-up
chunk, which the comparison re-runs, holds the magnetizing transient and
the fallback frame.  Reference: ``reference/<config>.py``'s
``closed_loop``, and the running statistics' fold."""

from __future__ import annotations

import time

import torch

from portbench.fleet_chain import FleetChain
from portbench.gaps import max_gap, split
from portbench.harness import HERE, load_module, start_state
from portbench.traffic import generator


def make_env(ex, cell, device, per_drive: dict):
    """The configuration's machine: its static parameters over the
    environment's defaults, the per-drive ones ``(B,)``, and its action band."""
    cfg = cell.config
    cls = getattr(ex, cfg["env"])
    params = {**vars(cls(batch_size=1, device="cpu").env_properties.static_params), **cfg["static_params"],
              **per_drive}
    bands = {name: ex.MinMaxNormalization(min=lo, max=hi) for name, (lo, hi) in cfg["action_normalizations"].items()}
    return cls(batch_size=cell.batch, device=device, dtype=cell.dtype, static_params=params,
               action_normalizations=bands, **cfg["kwargs"])


class Driver(FleetChain):
    def __init__(self, cell, seed: int, device):
        import exciting_environments_torch as ex
        from exciting_environments_torch.utils import foc
        from exciting_environments_torch.utils.fleet import FleetRunner

        mix, cfg = cell.traffic, cell.config
        self.cell = cell
        self.ref = load_module(HERE / "reference" / f"{cfg['reference']}.py")
        gen = generator.stream(seed, "inputs", device)
        self.params = generator.fields(gen, mix["params"], cell.batch, cell.dtype)
        self.setpoints = generator.fields(gen, mix["setpoints"], cell.batch, cell.dtype)
        self.env = make_env(ex, cell, device, self.params)
        # the program's count of gain solves, where it has one
        counter = getattr(foc, "GAIN_SOLVES", {})
        solves = dict(counter)
        t0 = time.perf_counter()
        self.policy, carry = ex.make_sensorless_foc_tile(self.env, torque_ref=self.setpoints["torque"],
                                                         measurement_std=cfg["sensor_std"], **cfg["law"])
        self.tile_s = time.perf_counter() - t0
        self.solved = {k: counter[k] - solves[k] for k in solves}
        zeros = {name: torch.zeros(cell.batch, dtype=cell.dtype, device=device) for name in self.env._ode_state_fields}
        self.state = (start_state(self.env, zeros), tuple(carry))
        self.runner = FleetRunner(self.env)
        self._init_chain(cell)

    def describe(self) -> str:
        return (f"make_sensorless_foc_tile (the per-drive Kalman gains solved within) {self.tile_s!r} s; gain solves "
                f"{self.solved}")

    def shapes(self) -> dict:
        spec = self.policy.kernel_spec(self.cell.dtype, self.env.device)
        return {"batch": self.cell.batch, "steps": self.cell.steps, "saves": 0,
                "itemsize": torch.tensor([], dtype=self.cell.dtype).element_size(), "per_drive_params": len(self.params),
                "references": 0, "state": len(self.env._ode_state_fields), "actions": self.env.action_dim,
                "policy": {"n_carry": self.policy.n_carry, "planes": len(spec.planes), "n_params": spec.flat.numel()}}

    def _run(self, n: int, hook):
        st, carry = self.state
        self.runner.run_policy(st, self.policy, n, self.cell.steps, metric_hook=hook, policy_carry=carry)

    def _leaves(self, state):
        st, carry = state
        p = st.physical_state
        return tuple(getattr(p, name) for name in self.env._ode_state_fields) + tuple(carry)

    def _outputs(self, obs, leaves):
        return leaves[:4], leaves[4:], obs

    def _reference(self, ks, befores, dtype):
        n = len(ks)
        start = tuple(torch.cat(parts) for parts in zip(*(b[:4] for b in befores)))
        carry = tuple(torch.cat(parts) for parts in zip(*(b[4:] for b in befores)))
        out = self.ref.closed_loop(start, carry, self.params["omega"].repeat(n), self.setpoints["torque"].repeat(n),
                                   self.cell.steps, dtype)
        return split(out, n)

    def _gaps(self, cand, truth) -> dict:
        """``final_gap``: the largest gap of the observation, the state (in
        its normalized units), the observer's 4 normalized planes, the
        current integrators (over the voltage limit), the flux integrator
        (over the current band's half) and the flag."""
        (leaves, carry, obs), (t_leaves, t_carry, t_obs) = cand, truth
        bands = self.ref.BANDS
        scales = (1 / bands["i"], 1 / bands["i"], 1 / bands["psi"], 1 / bands["psi"])
        c_scales = (1.0, 1.0, 1.0, 1.0, 1 / bands["u"], 1 / bands["u"], 1 / bands["i"], 1.0)
        gaps = [(obs.double() - t_obs).abs()]
        gaps += [(x.double() - t).abs() * s for x, t, s in zip(leaves, t_leaves, scales)]
        gaps += [(x.double() - t).abs() * s for x, t, s in zip(carry, t_carry, c_scales)]
        return {"final_gap": max_gap(*gaps)}
