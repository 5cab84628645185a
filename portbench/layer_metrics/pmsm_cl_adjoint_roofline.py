"""``pmsm_cl_adjoint_roofline``: the least time of ``csrc/pmsm_closed_loop_adjoint.cu``'s work per
call (``work/pmsm_closed_loop_adjoint.py``, at the card's published peaks) over the
kernel's device time per call, over the traced calls, in percent."""


def read(trace):
    return trace.roofline_pct("pmsm_closed_loop_adjoint")
