"""Driver ``collect_fused``: ``RolloutCollector.collect_fused`` over a PMSM
fleet with per-drive parameters drawn from the seed, one launch of
``csrc/pmsm_stepper.cu`` per call with a save every step, then the eager
passes that build the observations, rewards and flags.  Each call starts
where the last one ended; the action source hands out a pool of APRBS
slabs in turn.  A call runs from its start to a device synchronization
after it.  Of each checked call the comparison keeps the rows the traffic
mix draws from the seed, gathered after the call's completion into buffers
made before the window opens.  Reference:
``reference/<config>.py``'s ``open_loop``."""

from __future__ import annotations

import math

import torch

from portbench.gaps import max_gap, split, wrapped_gap
from portbench.harness import CHECKED_CALLS, HERE, load_module, make_env, start_state, sync
from portbench.traffic import generator

#: a flag counts as wrong only where the reference's normalized current
#: magnitude lies farther than this from the threshold 1
FLAG_MARGIN = 1e-3


class Driver:
    def __init__(self, cell, seed: int, device):
        import exciting_environments_torch as ex
        from exciting_environments_torch.utils.collect import RolloutCollector

        mix = cell.traffic
        self.cell, self.device = cell, device
        self.ref = load_module(HERE / "reference" / f"{cell.config['reference']}.py")
        gen = generator.stream(seed, "inputs", device)
        self.params = generator.fields(gen, mix["params"], cell.batch, cell.dtype)
        self.env = make_env(ex, cell, device, per_drive=self.params)
        self.start = generator.fields(gen, mix["initial"], cell.batch, cell.dtype)
        self.refs = generator.fields(gen, mix["references"], cell.batch, cell.dtype)
        self.pool = generator.action_pool(gen, mix, cell.batch, self.env.action_dim, cell.dtype)
        self.rows = generator.checked_rows(generator.stream(seed, "checked-rows", device), mix, cell.batch)
        self.state = start_state(self.env, self.start, self.refs)
        self.collector = RolloutCollector(self.env)
        self.steps_per_call = cell.batch * cell.steps
        self.index = self.warmed = 0
        self.samples, self.slots, self.first = {}, [], None

    def shapes(self) -> dict:
        return {"batch": self.cell.batch, "steps": self.cell.steps, "saves": self.cell.steps,
                "itemsize": torch.tensor([], dtype=self.cell.dtype).element_size(),
                "per_drive_params": len(self.params)}

    def describe(self) -> str:
        from portbench.work.peaks import least_seconds
        from portbench.work.pmsm_stepper import collect_call_bytes

        nbytes = collect_call_bytes(self.cell.config["work"]["pmsm_stepper"], self.shapes(),
                                    self.cell.config["observation_columns"])
        least, by = least_seconds(0, nbytes)
        return f"a whole collect_fused call moves {nbytes} bytes at least: {least * 1e3!r} ms ({by})"

    def _call(self):
        before = self.state
        batch, self.state = self.collector.collect_fused(before, self.pool[self.index % len(self.pool)])
        return before, batch

    def _rows(self, before, batch):
        """The tensors of one call the comparison reads, whole: its start,
        its outputs, its end (the checked rows are picked from them)."""
        fields = ("i_d", "i_q", "epsilon", "u_d_buffer", "u_q_buffer")
        start, end = before.physical_state, self.state.physical_state
        return ([getattr(start, f) for f in fields],
                [batch.observations, batch.rewards[..., 0], batch.terminated[..., 0], batch.truncated[..., 0]]
                + [getattr(end, f) for f in fields])

    def _keep(self, slot, before, batch):
        """Copy the checked rows of one call into the buffers of ``slot``
        (new ones for the first call)."""
        start, outputs = self._rows(before, batch)
        if slot is None:
            pick = lambda t: t.index_select(0, self.rows)
            return self.index, tuple(map(pick, start)), tuple(map(pick, outputs))
        _, start_buf, out_buf = self.slots[slot]
        for buf, t in zip(start_buf + out_buf, start + outputs):
            torch.index_select(t, 0, self.rows, out=buf)
        self.samples[slot] = (self.index, start_buf, out_buf)

    def warmup(self, n: int):
        for _ in range(n):
            before, batch = self._call()
            if self.first is None:
                self.first = self._keep(None, before, batch)
                like = lambda part: tuple(torch.empty_like(t) for t in part)
                self.slots = [(None, like(self.first[1]), like(self.first[2]))
                              for _ in range(CHECKED_CALLS)]
            self.index += 1
            del batch
        sync(self.device)
        self.warmed += n

    def run_window(self, window):
        ended = False
        while not ended:
            before, batch = self._call()
            sync(self.device)
            ended = window.complete()
            slot = window.keep()
            if slot is not None:
                self._keep(slot, before, batch)
            self.index += 1
            del before, batch
            if not ended:
                window.begin()

    def release(self):
        self.collector = self.state = None

    def _cases(self):
        cases = {e[0]: e for e in [self.first, *self.samples.values()]}
        return [cases[k] for k in sorted(cases)]

    def _reference(self, ks, starts, dtype):
        """The reference's outputs of calls ``ks`` from their checked rows'
        starting leaves, all at once; one ``(outputs, magnitude)`` a call."""
        n, pick = len(ks), lambda leaf: leaf.index_select(0, self.rows)
        start = tuple(torch.cat(parts) for parts in zip(*starts))
        rows = lambda leaf: pick(leaf).repeat(n)
        actions = torch.cat([pick(self.pool[k % len(self.pool)]) for k in ks])
        final, per_step = self.ref.open_loop(start, rows(self.start["omega_el"]),
                                             (rows(self.refs["i_d"]), rows(self.refs["i_q"])), rows(self.params["r_s"]),
                                             actions, self.env.tau, dtype)
        outputs = (per_step["observations"], per_step["rewards"], per_step["truncated"], per_step["truncated"], final)
        return list(zip(split(outputs, n), per_step["magnitude"].chunk(n)))

    def compare(self, dtype: torch.dtype = torch.float64, control: bool = False) -> list:
        """Per checked call, ``{number: reading}``: the program's outputs
        (with ``control``, the reference's in bfloat16 in their place)
        against the reference's in ``dtype``."""
        bands = self.ref.BANDS
        span = lambda band: 2 / (band[1] - band[0])
        scales = (span(bands["i_d"]), span(bands["i_q"]), None, span(bands["u"]), span(bands["u"]))
        cases = self._cases()
        truths = self._reference([c[0] for c in cases], [c[1] for c in cases], dtype)
        if control:
            cands = self._reference([c[0] for c in cases], [c[1] for c in cases], torch.bfloat16)
        readings = []
        for i, (k, start, outputs) in enumerate(cases):
            truth, magnitude = truths[i]
            cand = cands[i][0] if control else (*outputs[:4], outputs[4:])
            obs, rewards, terminated, truncated, final = cand
            t_obs, t_rewards, t_flag, _, t_final = truth
            gaps = [(obs.double() - t_obs).abs()]
            for leaf, t_leaf, scale in zip(final, t_final, scales):
                gaps.append(wrapped_gap(leaf, t_leaf, 2 * math.pi) / math.pi if scale is None
                            else (leaf.double() - t_leaf).abs() * scale)
            clear = (magnitude - 1).abs() > FLAG_MARGIN
            wrong = ((terminated != t_flag) | (truncated != t_flag)) & clear
            readings.append({"traj_gap": max_gap(*gaps), "reward_gap": max_gap((rewards.double() - t_rewards).abs()),
                             "flag_mismatch": float(wrong.sum())})
        return readings
