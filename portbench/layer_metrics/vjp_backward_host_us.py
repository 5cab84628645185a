"""``vjp_backward_host_us``: per traced call, the host microseconds inside the
program's ``ee.vjp.backward`` spans (a differentiable closed loop's backward:
its cotangents gathered and its adjoint launched, or its replay), their
union within the call; the median over the calls that hold them.  ``None``
where no call holds the span (a program without it)."""

import statistics


def read(trace):
    spans = sorted((s, e) for s, e, name in trace.host if name == "ee.vjp.backward")
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
