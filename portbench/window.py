"""The measured window: the clock, the calls it completes, their latencies,
the calls it keeps for the comparison, and the traced span of a traced run.

A call is complete when its result is ready on the host.  A driver tells
the window when one begins (:meth:`Window.begin`) and when it completes
(:meth:`Window.complete`); the window ends at the first completion after
its length.  Which calls the comparison checks is drawn from the seed by
reservoir sampling over all the window's calls (:meth:`Window.keep`), so
that every call is equally likely to be checked whatever the rate.
"""

from __future__ import annotations

import random
import time

import torch

CALL_SPAN = "portbench.call"


class Window:
    """Args:
        seconds: the window's length.
        seed: the run's seed; the checked calls are drawn from it.
        n_checked: how many of the window's calls the comparison keeps.
        profiler: a started ``torch.profiler.profile`` for a traced run.
        traced_calls: calls the profiler covers before it stops.
    """

    def __init__(self, seconds: float, seed: int, n_checked: int, profiler=None, traced_calls: int = 0):
        self.seconds = float(seconds)
        self.n_checked = int(n_checked)
        self._draws = random.Random(f"{int(seed)}:checked-calls")
        self.profiler = profiler
        self.traced_calls = int(traced_calls)
        self.calls = 0
        self.latencies = []
        self.completions = []
        self.t0 = self.t_last = self._t_begin = None
        self._span = None

    def open(self):
        """Start the clock; the first call begins now."""
        self.t0 = self.t_last = time.perf_counter()
        self.begin(self.t0)

    def begin(self, now: float = None):
        """A call begins (by default now)."""
        self._t_begin = time.perf_counter() if now is None else now
        if self.profiler is not None:
            self._span = torch.profiler.record_function(CALL_SPAN)
            self._span.__enter__()

    def complete(self, since_last: bool = False) -> bool:
        """The call that began last is complete; returns whether the window
        has ended.  Its latency runs from its beginning, or with
        ``since_last`` from the previous completion (a loop whose calls
        follow one another without a gap the benchmark could time)."""
        now = time.perf_counter()
        if self._span is not None:
            self._span.__exit__(None, None, None)
            self._span = None
            if self.calls + 1 >= self.traced_calls:
                self.profiler.stop()
                self.profiler = None
        self.latencies.append(now - (self.t_last if since_last else self._t_begin))
        self.completions.append(now - self.t0)
        self.t_last = now
        self.calls += 1
        return now - self.t0 >= self.seconds

    def keep(self):
        """The comparison's slot for the call that completed last, or
        ``None``: reservoir sampling (Algorithm R) with the seed's draws."""
        i = self.calls - 1
        if i < self.n_checked:
            return i
        j = self._draws.randrange(i + 1)
        return j if j < self.n_checked else None

    def tenths(self) -> list:
        """Calls completed in each tenth of the window."""
        counts = [0] * 10
        for t in self.completions:
            counts[min(int(10 * t / self.seconds), 9)] += 1
        return counts

    @property
    def elapsed(self) -> float:
        """Seconds from the window's start to its last completion."""
        return self.t_last - self.t0
