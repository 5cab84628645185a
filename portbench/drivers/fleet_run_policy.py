"""Driver ``fleet_run_policy``: ``FleetRunner.run_policy`` with the affine
(PI) law of the traffic mix and its carry over a PMSM fleet in the
closed-loop kernel's scope (``csrc/pmsm_closed_loop.cu``), one launch per
chunk.  The drives' starting states and current references are drawn
from the seed at set-up; the integrators start at zero.  Reference:
``reference/<config>.py``'s ``closed_loop``, and the running statistics'
fold."""

from __future__ import annotations

import math

import torch

from portbench.fleet_chain import FleetChain
from portbench.gaps import max_gap, split, wrapped_gap
from portbench.harness import HERE, load_module, make_env, start_state
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
        self.refs = generator.fields(gen, mix["references"], cell.batch, cell.dtype)
        self.K, self.Ki = mix["policy"]["K"], mix["policy"]["Ki"]
        self.policy = ex.AffinePolicy(self.K, Ki=self.Ki)
        carry = tuple(torch.zeros(cell.batch, dtype=cell.dtype, device=device) for _ in range(len(self.K)))
        self.state = (start_state(self.env, self.start, self.refs), carry)
        self.runner = FleetRunner(self.env)
        self._init_chain(cell)

    def shapes(self) -> dict:
        n_action, n_obs = len(self.K), len(self.K[0])
        return {"batch": self.cell.batch, "steps": self.cell.steps, "saves": 0,
                "itemsize": torch.tensor([], dtype=self.cell.dtype).element_size(), "per_drive_params": 0,
                "references": len(self.refs),
                "policy": {"n_carry": n_action, "clip": 0, "n_params": 2 * n_action * n_obs + n_action,
                           "nonzero_gains": [sum(g != 0 for g in row) for row in self.K],
                           "nonzero_integral_gains": [sum(g != 0 for g in row) for row in self.Ki]}}

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

    def _reference(self, ks, befores, dtype):
        n = len(ks)
        start = tuple(torch.cat(parts) for parts in zip(*(b[:5] for b in befores)))
        carry = tuple(torch.cat(parts) for parts in zip(*(b[5:] for b in befores)))
        refs = (self.refs["i_d"].repeat(n), self.refs["i_q"].repeat(n))
        out = self.ref.closed_loop(start, self.start["omega_el"].repeat(n), refs, carry, self.K, self.Ki,
                                   self.cell.steps, self.env.tau, dtype)
        return split(out, n)

    def _gaps(self, cand, truth) -> dict:
        (leaves, carry, obs), (t_leaves, t_carry, t_obs) = cand, truth
        bands = self.ref.BANDS
        span = lambda band: 2 / (band[1] - band[0])
        scales = (span(bands["i_d"]), span(bands["i_q"]), None, span(bands["u"]), span(bands["u"]))
        gaps = [(obs.double() - t_obs).abs()]
        for leaf, t_leaf, scale in zip(leaves, t_leaves, scales):
            gaps.append(wrapped_gap(leaf, t_leaf, 2 * math.pi) / math.pi if scale is None
                        else (leaf.double() - t_leaf).abs() * scale)
        gaps += [(c.double() - t).abs() for c, t in zip(carry, t_carry)]
        return {"final_gap": max_gap(*gaps)}
