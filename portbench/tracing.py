"""The traced run's summary: the benchmark's call spans and the device
events of ``torch.profiler``, reduced to what the per-layer readers
(``layer_metrics/<metric>.py``) take.

Times are the profiler's microseconds, in which host spans and device
events share one clock.  A device event belongs to the call whose span
it overlaps most: every call ends in a host read of its result, so its
device work ends inside its span.  A kernel's roofline share is taken over
all of its events in the traced window, so that it does not rest on that
assignment.
"""

from __future__ import annotations

import bisect
import re

from portbench.window import CALL_SPAN


def _is_device(event) -> bool:
    return str(getattr(event, "device_type", "")).endswith("CUDA")


def _merge(intervals):
    """Disjoint, sorted union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """Args:
        events: the profiler's events (``prof.events()``).
        kernels: ``{library: (symbol, least_seconds_per_call)}`` of the
            kernels the cell launches, the first its main kernel.
    """

    def __init__(self, events, kernels: dict):
        self.kernels = kernels
        self.calls, self.device, self.host = [], [], []
        for ev in events:
            span = (ev.time_range.start, ev.time_range.end)
            if _is_device(ev):
                if not getattr(ev, "is_user_annotation", False) and not ev.name.startswith("portbench."):
                    self.device.append((*span, ev.name))
            else:
                self.host.append((*span, ev.name))
                if ev.name == CALL_SPAN:
                    self.calls.append(span)
        self.calls.sort()
        self.device.sort()
        self.per_call = [[] for _ in self.calls]
        self.outside = []
        starts = [s for s, _ in self.calls]
        for s, e, name in self.device:
            i = bisect.bisect_right(starts, s) - 1
            near = [j for j in (i, i + 1) if 0 <= j < len(self.calls)]
            overlap = lambda j: min(e, self.calls[j][1]) - max(s, self.calls[j][0])
            best = max(near, key=overlap, default=None)
            if best is not None and overlap(best) > 0:
                self.per_call[best].append((s, e, name))
            else:
                self.outside.append((s, e, name))
        if self.calls:
            self.t0, self.t1 = self.calls[0][0], self.calls[-1][1]
        else:
            self.t0 = self.t1 = 0.0
        inside = [(max(s, self.t0), min(e, self.t1)) for s, e, _ in self.device if e > self.t0 and s < self.t1]
        self.busy = _merge(inside)

    # -- the device's time -------------------------------------------------

    @property
    def window_s(self) -> float:
        """Seconds from the first traced call's start to the last one's end."""
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        """Seconds in the traced window in which an operation ran on the card."""
        return sum(e - s for s, e in self.busy) / 1e6

    def _is_kernel(self, library: str):
        return re.compile(rf"\b{re.escape(self.kernels[library][0])}\b").search

    def kernel_us(self, library: str):
        """The device microseconds of ``library``'s kernel in each traced
        call, or ``None`` where the cell does not launch it or the trace
        shows it in no call."""
        if library not in self.kernels:
            return None
        match = self._is_kernel(library)
        times = [sum(e - s for s, e, name in evs if match(name)) for evs in self.per_call]
        return times if any(times) else None

    def roofline_pct(self, library: str):
        """The least time of ``library``'s kernel over its mean device time
        per launch, in percent, over its launches in the traced window;
        ``None`` where there is none."""
        if library not in self.kernels:
            return None
        match = self._is_kernel(library)
        spans = [e - s for s, e, name in self.device if match(name) and e > self.t0 and s < self.t1]
        if not spans:
            return None
        return 100.0 * self.kernels[library][1] * 1e6 * len(spans) / sum(spans)

    def placement(self, library: str) -> dict:
        """How ``library``'s kernel events sit: ``{events in a call: calls}``
        and, under ``"outside"``, those in no call's span."""
        match = self._is_kernel(library)
        counts = {}
        for evs in self.per_call:
            n = sum(1 for *_, name in evs if match(name))
            counts[n] = counts.get(n, 0) + 1
        counts["outside"] = sum(1 for *_, name in self.outside if match(name))
        return counts

    def main_kernel(self) -> str:
        return next(iter(self.kernels))

    # -- the breakdown -----------------------------------------------------

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host span the host was in, in seconds."""
        by_name = {}
        for s, e, name in self.device:
            if e > self.t0 and s < self.t1:
                by_name[name] = by_name.get(name, 0.0) + (min(e, self.t1) - max(s, self.t0)) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, edge = [], self.t0
        for s, e in self.busy + [[self.t1, self.t1]]:
            if s > edge:
                gaps.append((s - edge, (s + edge) / 2))
            edge = max(edge, e)
        gaps.sort(key=lambda g: -g[0])
        named = [[self._host_at(mid), length / 1e6] for length, mid in gaps[:top]]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}

    def _host_at(self, t: float) -> str:
        inner = None
        for s, e, name in self.host:
            if s <= t <= e and (inner is None or s >= inner[0]):
                inner = (s, name)
        return inner[1] if inner else "outside the benchmark's spans"
