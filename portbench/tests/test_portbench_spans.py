"""The readers of the program's own spans on a made-up trace:
``fleet_host_gap_ms`` pairs each chunk's launch of the main kernel with the
gate before it, ``dispatch_host_us`` sums the prepare and launch spans of
each call, and both read ``None`` where the program records no spans."""

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tracing import TraceSummary
from portbench.window import CALL_SPAN


def event(name, start, end, device=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type="DeviceType.CUDA" if device else "DeviceType.CPU", is_user_annotation=False)


KERNELS = {"stepper": ("stepper_kernel", 20e-6)}
# three calls of 1,000 us; each holds its chunk's prepare, launch and gate
CALLS = [event(CALL_SPAN, 1000 * i, 1000 * (i + 1)) for i in range(3)]
SPANS = [span for i in range(3) for span in (
    event("ee.rollout.prepare", 1000 * i + 100, 1000 * i + 130),
    event("ee.launch.stepper.step", 1000 * i + 130, 1000 * i + 140 + i),
    event("ee.rollout.rebuild", 1000 * i + 150, 1000 * i + 200),
    event("ee.fleet.gate", 1000 * i + 200, 1000 * i + 900),
)]


def reader(name):
    return harness.reader("layer_metrics", name).read


def test_fleet_host_gap_pairs_each_launch_with_the_gate_before_it():
    trace = TraceSummary(CALLS + SPANS + [event("ee.launch.pmsm_stepper.pmsm_step", 1500, 1510)], KERNELS)
    # gate ends 900, 1900; the next chunks' launches end 1141, 2142
    assert reader("fleet_host_gap_ms")(trace) == pytest.approx(0.2415)


def test_dispatch_host_us_is_the_union_of_prepare_and_launch_in_each_call():
    nested = [event("ee.rollout.prepare", 2100, 2120)]  # inside the third call's prepare: counted once
    trace = TraceSummary(CALLS + SPANS + nested, KERNELS)
    assert reader("dispatch_host_us")(trace) == pytest.approx(41.0)  # 40, 41, 42 us


@pytest.mark.parametrize("name", ["fleet_host_gap_ms", "dispatch_host_us"])
def test_a_program_without_spans_reads_none(name):
    bare = TraceSummary(CALLS + [event("aten::add", 100, 130), event("void stepper_kernel<P>(A)", 120, 600, True)],
                        KERNELS)
    assert reader(name)(bare) is None
    assert reader(name)(TraceSummary(SPANS, KERNELS)) is None  # no call spans
