"""``pmsm_stepper_roofline``: the least time of ``csrc/pmsm_stepper.cu``'s work per call
(``work/pmsm_stepper.py``, at the card's published peaks) over the kernel's
device time per call, over the traced calls, in percent."""


def read(trace):
    return trace.roofline_pct("pmsm_stepper")
