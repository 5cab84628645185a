"""``fleet_host_gap_ms``: the fleet loop's serialized host work between two
chunks, from the program's own spans: for each traced chunk after the
first, the host milliseconds from the end of the previous chunk's
``ee.fleet.gate`` span (the NaN gate's read, after which the device has
nothing queued) to the end of this chunk's launch of the cell's main kernel
(``ee.launch.<library>.<mode>``); the median.  ``None`` where the trace
holds no such pair (a program without the spans)."""

import statistics

GATE = "ee.fleet.gate"


def read(trace):
    if not trace.calls:
        return None
    t0, t1 = trace.calls[0][0], trace.calls[-1][1]
    launch = f"ee.launch.{trace.main_kernel()}."
    ends = sorted((e, name == GATE) for _, e, name in trace.host
                  if t0 <= e <= t1 and (name == GATE or name.startswith(launch)))
    gaps, gate_end = [], None
    for end, is_gate in ends:
        if is_gate:
            gate_end = end
        elif gate_end is not None:
            gaps.append((end - gate_end) / 1e3)
            gate_end = None
    return statistics.median(gaps) if gaps else None
