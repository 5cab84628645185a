"""``call_ms_p95``: the 95th percentile of the latency of every call in the
window, by the host's clock, in milliseconds."""

from portbench.harness import percentile


def read(run) -> float:
    return percentile(run.latencies_s, 95) * 1e3
