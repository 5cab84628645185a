"""``closed_loop_roofline``: the least time of ``csrc/closed_loop.cu``'s work per call
(``work/closed_loop.py``, at the card's published peaks) over the kernel's
device time per call, over the traced calls, in percent."""


def read(trace):
    return trace.roofline_pct("closed_loop")
