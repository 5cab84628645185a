"""``device_idle_pct``: the share of the traced window in which no
operation ran on the card, in percent."""


def read(trace):
    if not trace.calls or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
