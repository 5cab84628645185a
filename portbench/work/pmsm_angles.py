"""Work of one launch of ``csrc/pmsm_angles.cu`` (the PMSM drive's angle
recurrence), counted from the kernel's code.

Operations per drive and step: the configuration's ``ops_per_step`` (the
add of the increment, then the wrap: an add, the floored remainder's
compares, a subtract), and one multiply a drive for the increment.  Bytes:
the start angle and the rate read once, every pre-step angle and the final
one written once."""

#: the kernel's name in a device trace
KERNEL_SYMBOL = "pmsm_angles_kernel"


def work(counts: dict, shapes: dict):
    """``(operations, bytes)`` of one launch."""
    batch, steps, itemsize = shapes["batch"], shapes["steps"], shapes["itemsize"]
    return (counts["ops_per_step"] * steps + 1) * batch, itemsize * batch * (2 + steps + 1)
