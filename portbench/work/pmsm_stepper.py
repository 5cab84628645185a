"""Work of one step-mode launch of ``csrc/pmsm_stepper.cu`` (the PMSM
drive's open loop), frozen from the bring-up's counts.

Operations per drive: ``ops_per_step`` each step (the hexagon constraint,
the angle, the table gather, the current ODE and the Euler combination),
``ops_per_save`` each saved step, ``ops_final`` once (the final torque's
gather).  Bytes: the two-column action slab, the starting leaves, the
per-drive parameters and the table read once; the final leaves and every
saved step (currents, torque, angle, buffers) written once."""

#: the kernel's name in a device trace
KERNEL_SYMBOL = "pmsm_kernel"


def work(counts: dict, shapes: dict):
    """``(operations, bytes)`` of one launch."""
    batch, steps, saves, itemsize = shapes["batch"], shapes["steps"], shapes["saves"], shapes["itemsize"]
    ops = (counts["ops_per_step"] * steps + counts["ops_per_save"] * saves + counts["ops_final"]) * batch
    nbytes = itemsize * (steps * batch * 2 + (counts["start_values"] + shapes["per_drive_params"]) * batch
                         + counts["table_values"] + counts["final_values"] * batch
                         + counts["values_per_save"] * saves * batch)
    return ops, nbytes


def collect_call_bytes(counts: dict, shapes: dict, observation_columns: int):
    """Bytes that a whole ``collect_fused`` call must move once: the action
    slab, the starting leaves, the per-drive parameters and the table read;
    the saved states, the observations and rewards (``itemsize`` each) and
    the two flags (a byte each) of every step written."""
    batch, steps, itemsize = shapes["batch"], shapes["steps"], shapes["itemsize"]
    read = itemsize * (steps * batch * 2 + (6 + shapes["per_drive_params"]) * batch + counts["table_values"])
    written = itemsize * batch * steps * (6 + observation_columns + 1) + 2 * batch * steps
    return read + written
