"""``outside_kernel_ms``: per traced call, its span minus the device time of
the cell's main kernel in it; the median over the traced calls, in
milliseconds.  What the entry point and its eager passes add to the kernel."""

import statistics


def read(trace):
    times = trace.kernel_us(trace.main_kernel())
    if times is None:
        return None
    return statistics.median((e - s - k) / 1e3 for (s, e), k in zip(trace.calls, times))
