"""``launches_per_call``: device kernels, copies and fills per traced call,
from the profiler's device events."""


def read(trace):
    if not trace.calls or not trace.device:
        return None
    return sum(len(events) for events in trace.per_call) / len(trace.calls)
