"""``dispatch_host_us``: per traced call, the host microseconds inside the
program's ``ee.rollout.prepare`` spans (a kernel entry point up to its
launch: checks, noise streams, layout and argument packing) and
``ee.launch.*`` spans (the ctypes launch, nested in the first), their union
within the call; the median over the calls that hold
them.  ``None`` where no call does (a program without the spans)."""

import statistics


def read(trace):
    spans = sorted((s, e) for s, e, name in trace.host
                   if name == "ee.rollout.prepare" or name.startswith("ee.launch."))
    per_call = []
    for cs, ce in trace.calls:
        total, edge = 0.0, cs
        for s, e in spans:
            s, e = max(s, edge), min(e, ce)
            if e > s:
                total += e - s
                edge = e
        if total > 0:
            per_call.append(total)
    return statistics.median(per_call) if per_call else None
