"""``pmsm_closed_loop_roofline``: the least time of ``csrc/pmsm_closed_loop.cu``'s work per call
(``work/pmsm_closed_loop.py``, at the card's published peaks) over the kernel's
device time per call, over the traced calls, in percent."""


def read(trace):
    return trace.roofline_pct("pmsm_closed_loop")
