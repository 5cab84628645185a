"""Driver ``fleet_run``: ``FleetRunner.run`` over an environment in the
stepper kernel's scope (``csrc/stepper.cu``), one launch per chunk, no sink
and no checkpoint.  The action source hands out a pool of APRBS slabs, made
at set-up from the seed, in turn.  Reference: ``reference/<config>.py``'s
``rollout`` and ``observe``, and the running statistics' fold."""

from __future__ import annotations

import math

import torch

from portbench.fleet_chain import FleetChain
from portbench.gaps import max_gap, split, wrapped_gap
from portbench.harness import load_module, make_env, start_state, HERE
from portbench.traffic import generator


class Driver(FleetChain):
    def __init__(self, cell, seed: int, device):
        import exciting_environments_torch as ex
        from exciting_environments_torch.utils.fleet import FleetRunner

        mix = cell.traffic
        self.cell = cell
        self.ref = load_module(HERE / "reference" / f"{cell.config['reference']}.py")
        self.env = make_env(ex, cell, device)
        gen = generator.stream(seed, "inputs", device)
        self.start = generator.fields(gen, mix["initial"], cell.batch, cell.dtype)
        self.pool = generator.action_pool(gen, mix, cell.batch, self.env.action_dim, cell.dtype)
        self.state = start_state(self.env, self.start)
        self.runner = FleetRunner(self.env)
        self._init_chain(cell)

    def shapes(self) -> dict:
        return {"batch": self.cell.batch, "steps": self.cell.steps, "saves": 0,
                "itemsize": torch.tensor([], dtype=self.cell.dtype).element_size()}

    def _run(self, n: int, hook):
        pool = self.pool
        self.runner.run(self.state, lambda k: pool[self.index % len(pool)], n, self.cell.steps, metric_hook=hook)

    @staticmethod
    def _leaves(state):
        return state.physical_state.theta, state.physical_state.omega

    def _outputs(self, obs, leaves):
        return (*leaves, obs)

    def _reference(self, ks, befores, dtype):
        theta = torch.cat([b[0] for b in befores])
        omega = torch.cat([b[1] for b in befores])
        actions = torch.cat([self.pool[k % len(self.pool)] for k in ks])
        theta, omega = self.ref.rollout(theta, omega, actions, self.env.tau, dtype)
        return split((theta, omega, self.ref.observe(theta, omega)), len(ks))

    def _gaps(self, cand, truth) -> dict:
        (theta, omega, obs), (t_theta, t_omega, t_obs) = cand, truth
        lo, hi = self.ref.OMEGA_BAND
        gaps = [wrapped_gap(theta, t_theta, 2 * math.pi) / math.pi, (omega.double() - t_omega).abs() * 2 / (hi - lo),
                wrapped_gap(obs[:, 0], t_obs[:, 0], 2.0), (obs[:, 1].double() - t_obs[:, 1]).abs()]
        return {"final_gap": max_gap(*gaps)}
