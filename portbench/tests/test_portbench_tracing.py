"""The traced run's summary on a made-up trace: each device event goes to
the call it overlaps most, a kernel's roofline share is taken over all of
its launches in the traced window, and a reading with nothing to read is
``None``."""

from types import SimpleNamespace

import pytest

from portbench.tracing import TraceSummary
from portbench.window import CALL_SPAN


def event(name, start, end, device=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type="DeviceType.CUDA" if device else "DeviceType.CPU", is_user_annotation=False)


CALLS = [event(CALL_SPAN, 0, 100), event(CALL_SPAN, 100, 200), event(CALL_SPAN, 200, 300)]
KERNELS = {"stepper": ("stepper_kernel", 20e-6)}


def test_events_go_to_the_call_they_overlap_most():
    device = [event("void stepper_kernel<Pendulum>(Args)", 10, 50, True),
              event("void stepper_kernel<Pendulum>(Args)", 190, 240, True),  # more in the third call
              event("Memcpy DtoH", 60, 70, True),
              event("void stepper_kernel<Pendulum>(Args)", 310, 330, True)]  # after the last call
    trace = TraceSummary(CALLS + device, KERNELS)
    assert [len(evs) for evs in trace.per_call] == [2, 0, 1]
    assert trace.kernel_us("stepper") == [40, 0, 50]
    assert trace.placement("stepper") == {1: 2, 0: 1, "outside": 1}
    # 20 us least time over the two launches inside the window, 40 and 50 us
    assert trace.roofline_pct("stepper") == pytest.approx(100 * 20 * 2 / 90)


def test_nothing_to_read_is_none():
    trace = TraceSummary(CALLS + [event("Memcpy DtoH", 60, 70, True)], KERNELS)
    assert trace.kernel_us("stepper") is None and trace.roofline_pct("stepper") is None
    assert trace.roofline_pct("pmsm_stepper") is None
