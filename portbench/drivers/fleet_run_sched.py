"""Driver ``fleet_run_sched``: ``FleetRunner.run_policy`` with the saturated
drive's gain-scheduled sensorless current tile
(``make_pmsm_saturated_sensorless_current_tile`` in its per-drive form) and
its 6 carry leaves, one launch of ``csrc/pmsm_closed_loop.cu`` per chunk.
Each drive holds its own operating point, drawn from the seed at set-up and
held for the run: its speed, one of the traffic's ``speed_grid`` (one slice
of the schedule each), and its current references.  The observer starts
from the tile's ``carry0`` (a belief at 0 A, zero integrators, the 0 V
command), so every drive starts with an observer error.  Reference:
``reference/<config>.py``'s ``closed_loop``, and the running statistics'
fold.

A chunk of 2,048 steps ends at the observer's fixed point, which on a plant
without noise is the measurement whatever the gains: the chunks' comparison
cannot see which slice of the schedule a drive gathered.  So the set-up also
makes one cold-start call of the same tile and schedule, through a runner
of its own, over :data:`TRANSIENT_STEPS` steps from the benchmark's start,
inside the observer's transient, where each drive's belief follows the
gains of its own speed; every reading of the comparison carries its
``transient_gap``."""

from __future__ import annotations

import math
import time

import torch

from portbench.fleet_chain import FleetChain
from portbench.gaps import max_gap, split, wrapped_gap
from portbench.harness import HERE, load_module, make_env, start_state
from portbench.traffic import generator

#: steps of the set-up's cold-start call: the observer's transient (its
#: gains are 0.04-0.29 a step over the speed grid)
TRANSIENT_STEPS = 40


class Driver(FleetChain):
    def __init__(self, cell, seed: int, device):
        import exciting_environments_torch as ex
        from exciting_environments_torch.utils import foc
        from exciting_environments_torch.utils.fleet import FleetRunner

        mix, cfg = cell.traffic, cell.config
        self.cell = cell
        self.ref = load_module(HERE / "reference" / f"{cfg['reference']}.py")
        self.env = make_env(ex, cell, device)
        gen = generator.stream(seed, "inputs", device)
        self.start = generator.fields(gen, mix["initial"], cell.batch, cell.dtype)
        self.refs = generator.fields(gen, mix["references"], cell.batch, cell.dtype)
        grid = mix["speed_grid"]
        speeds = torch.linspace(grid["lo"], grid["hi"], grid["n"], dtype=torch.float64, device=device)
        pick = torch.randint(0, grid["n"], (cell.batch,), generator=gen, device=device)
        self.omega = speeds[pick].to(cell.dtype)
        # the program's count of schedule solves, where it has one
        counter = getattr(foc, "SCHEDULE_SOLVES", {})
        solves = dict(counter)
        t0 = time.perf_counter()
        self.policy, carry, self.sched = ex.make_pmsm_saturated_sensorless_current_tile(
            self.env, i_d_ref=self.refs["i_d"], i_q_ref=self.refs["i_q"], omega_el=self.omega,
            measurement_std=cfg["sensor_std"], **cfg["law"])
        self.tile_s = time.perf_counter() - t0
        self.solved = {k: counter[k] - solves[k] for k in solves}
        self.state = (start_state(self.env, {**self.start, "omega_el": self.omega}, self.refs), tuple(carry))
        self.runner = FleetRunner(self.env)
        self.transient = self._cold_start(FleetRunner(self.env))
        self._init_chain(cell)

    def _cold_start(self, runner):
        """One call of :data:`TRANSIENT_STEPS` steps from the start through
        ``runner`` (the window's runner keeps its statistics to the chain):
        ``(leaves before, leaves after, final observation)``."""
        seen = {}
        st, carry = self.state
        final = runner.run_policy(st, self.policy, 1, TRANSIENT_STEPS, policy_carry=carry,
                                  metric_hook=lambda k, obs, state: seen.update(obs=obs))
        return self._leaves(self.state), self._leaves(final), seen["obs"]

    def describe(self) -> str:
        return (f"make_pmsm_saturated_sensorless_current_tile (the schedule solved within) {self.tile_s!r} s; "
                f"schedule solves {self.solved}")

    def shapes(self) -> dict:
        spec = self.policy.kernel_spec(self.cell.dtype, self.env.device)
        # the policy's own terms are in the configuration's drive count: no gain list
        return {"batch": self.cell.batch, "steps": self.cell.steps, "saves": 0,
                "itemsize": torch.tensor([], dtype=self.cell.dtype).element_size(),
                "per_drive_params": len(spec.planes) + 1, "references": len(self.refs),
                "policy": {"n_carry": self.policy.n_carry, "clip": 0, "n_params": spec.flat.numel(),
                           "nonzero_gains": [], "nonzero_integral_gains": []}}

    def _run(self, n: int, hook):
        st, carry = self.state
        self.runner.run_policy(st, self.policy, n, self.cell.steps, metric_hook=hook, policy_carry=carry)

    @staticmethod
    def _leaves(state):
        st, carry = state
        p = st.physical_state
        return (p.i_d, p.i_q, p.epsilon, p.u_d_buffer, p.u_q_buffer, *carry)

    def _outputs(self, obs, leaves):
        return leaves[:5], leaves[5:], obs

    def _reference(self, ks, befores, dtype, steps=None):
        n = len(ks)
        start = tuple(torch.cat(parts) for parts in zip(*(b[:5] for b in befores)))
        carry = tuple(torch.cat(parts) for parts in zip(*(b[5:] for b in befores)))
        refs = (self.refs["i_d"].repeat(n), self.refs["i_q"].repeat(n))
        out = self.ref.closed_loop(start, carry, self.omega.repeat(n), refs, steps or self.cell.steps, dtype)
        return split(out, n)

    def compare(self, dtype: torch.dtype = torch.float64, control: bool = False) -> list:
        """The chunks' readings, each with ``transient_gap``: the cold-start
        call's outputs (with ``control``, the reference's in bfloat16) against
        the reference's in ``dtype``, read as ``final_gap`` reads a chunk."""
        before, after, obs = self.transient
        truth = self._reference([0], [before], dtype, TRANSIENT_STEPS)[0]
        cand = (self._reference([0], [before], torch.bfloat16, TRANSIENT_STEPS)[0] if control
                else self._outputs(obs, after))
        gap = self._gaps(cand, truth)["final_gap"]
        return [{**r, "transient_gap": gap} for r in super().compare(dtype, control)]

    def _gaps(self, cand, truth) -> dict:
        """``final_gap``: the largest gap of the observation, the currents and
        buffers (normalized), the angle (on the circle, over pi), the
        observer's normalized belief, the integrators (over the voltage
        limit) and the carried normalized command."""
        (leaves, carry, obs), (t_leaves, t_carry, t_obs) = cand, truth
        bands = self.ref.BANDS
        span = lambda band: 2 / (band[1] - band[0])
        scales = (span(bands["i_d"]), span(bands["i_q"]), None, span(bands["u"]), span(bands["u"]))
        c_scales = (1.0, 1.0, 1 / self.ref.U_LIM, 1 / self.ref.U_LIM, 1.0, 1.0)
        gaps = [(obs.double() - t_obs).abs()]
        for leaf, t_leaf, scale in zip(leaves, t_leaves, scales):
            gaps.append(wrapped_gap(leaf, t_leaf, 2 * math.pi) / math.pi if scale is None
                        else (leaf.double() - t_leaf).abs() * scale)
        gaps += [(c.double() - t).abs() * s for c, t, s in zip(carry, t_carry, c_scales)]
        return {"final_gap": max_gap(*gaps)}
