"""What the two fleet drivers share: ``FleetRunner``'s chunk loop driven
through its ``metric_hook``, the chain of chunks it keeps for the
comparison, and the check of the runner's running statistics.

A call is one chunk: it runs from the previous chunk's completion to its
own, read in the hook after the runner's per-chunk host read (the NaN
gate), so it holds the action source, the launch, the statistics' update
and the gate.  Every chunk records ``(index, state before, statistics
before, final observation, state after, statistics after)``, each a tuple
of the tensors the comparison reads.  The comparison re-runs the first
warm-up chunk (from the benchmark's own starting state and empty
statistics), the chunks the window drew and the window's last chunk, each
from the program's own state and statistics before it: a window of
thousands of chunks cannot be re-run whole.  A drawn chunk is copied into
buffers made before the window opens, so that keeping it allocates
nothing in the window.
"""

from __future__ import annotations

import torch

from portbench.harness import CHECKED_CALLS, WindowClosed
from portbench.reference import running_stats

STATS = ("count", "mean", "m2", "min", "max")


def stats_leaves(stats) -> tuple:
    return tuple(getattr(stats, f) for f in STATS)


class FleetChain:
    """Subclasses set ``self.runner`` and ``self.state`` and define
    :meth:`_run` (``runner.run`` or ``run_policy`` over ``n`` chunks with a
    hook), :meth:`_leaves` (the tensors of a state the comparison reads),
    :meth:`_outputs` (a chunk's outputs as the reference gives them, from
    the observation and those leaves), :meth:`_reference` (the reference's
    outputs of chunks ``ks`` from the leaves ``befores``, one tuple per
    chunk, the observation last) and :meth:`_gaps`."""

    def _init_chain(self, cell):
        self.steps_per_call = cell.batch * cell.steps
        self.n_checked = CHECKED_CALLS
        self.index = 0
        self.warmed = 0
        self.samples, self.slots = {}, []
        self.first = self.last = None
        self._before = (self._leaves(self.state), stats_leaves(self.runner.obs_stats))

    def _record(self, obs, state):
        after = (self._leaves(state), stats_leaves(self.runner.obs_stats))
        entry = (self.index, *self._before, obs, *after)
        self._before = after
        self.state = state
        self.index += 1
        self.last = entry
        if self.first is None:
            self.first = entry
        return entry

    def warmup(self, n: int):
        self._run(n, lambda k, obs, state: self._record(obs, state))
        self.warmed += n
        if not self.slots:
            like = lambda part: tuple(torch.empty_like(t) for t in part) if isinstance(part, tuple) \
                else torch.empty_like(part)
            self.slots = [tuple(like(part) for part in self.last[1:]) for _ in range(self.n_checked)]

    def _keep(self, slot: int, entry):
        """Copy ``entry`` into the buffers of ``slot``."""
        for buf, part in zip(self.slots[slot], entry[1:]):
            for b, t in zip(buf if isinstance(buf, tuple) else (buf,), part if isinstance(part, tuple) else (part,)):
                b.copy_(t)
        self.samples[slot] = (entry[0], *self.slots[slot])

    def run_window(self, window):
        def hook(k, obs, state):
            ended = window.complete(since_last=True)
            entry = self._record(obs, state)
            slot = window.keep()
            if slot is not None:
                self._keep(slot, entry)
            if ended:
                raise WindowClosed
            window.begin()

        try:
            self._run(1 << 62, hook)
        except WindowClosed:
            pass

    def release(self):
        """Drop the program's loop: the comparison keeps only the chain."""
        self.runner = None

    def _cases(self):
        cases = {e[0]: e for e in [self.first, *self.samples.values(), self.last]}
        return [cases[k] for k in sorted(cases)]

    def compare(self, dtype: torch.dtype = torch.float64, control: bool = False) -> list:
        """Per checked chunk, ``{number: reading}``: the program's outputs
        (with ``control``, the reference's in bfloat16 in their place)
        against the reference's in ``dtype``.  The reference runs every
        checked chunk at once, stacked along the batch."""
        cases = self._cases()
        truths = self._reference([c[0] for c in cases], [c[1] for c in cases], dtype)
        if control:
            cands = self._reference([c[0] for c in cases], [c[1] for c in cases], torch.bfloat16)
        readings = []
        for i, (k, before, stats_before, obs, after, stats_after) in enumerate(cases):
            truth = truths[i]
            if control:
                cand = (cands[i], _fold(stats_before, cands[i][-1], torch.bfloat16))
            else:
                cand = (self._outputs(obs, after), stats_after)
            gaps = self._gaps(cand[0], truth)
            gaps.update(_stats_gaps(cand[1], _fold(stats_before, truth[-1], dtype)))
            readings.append(gaps)
        return readings


def _fold(stats, obs, dtype):
    """The reference's fold of ``obs`` into the program's statistics before
    the chunk, in ``dtype``."""
    return running_stats.fold(*(t.to(dtype) for t in stats), obs.to(dtype))


def _stats_gaps(cand, truth) -> dict:
    """``count_gap``: the counts' difference; ``stats_gap``: the largest
    gap of mean, standard deviation, minimum and maximum, in the
    observation's normalized units."""
    c = [x.double() for x in cand]
    t = [x.double() for x in truth]
    std = lambda m2, n: torch.sqrt(torch.clamp(m2, min=0) / n)
    gaps = [(c[1] - t[1]).abs().max(), (std(c[2], c[0]) - std(t[2], t[0])).abs().max(),
            (c[3] - t[3]).abs().max(), (c[4] - t[4]).abs().max()]
    return {"count_gap": float((c[0] - t[0]).abs().max()), "stats_gap": float(torch.stack(gaps).max())}
