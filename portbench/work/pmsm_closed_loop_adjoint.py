"""Work of one launch of ``csrc/pmsm_closed_loop_adjoint.cu`` (the PMSM
closed loop's reverse sweep under the affine law), counted from the
kernel's code.

Operations per drive and step: the configuration's ``drive_ops_per_step``
(the gather with its slopes, the torque, the observation, the Euler step,
the buffers and the hexagon recomputed and pulled back, the angle's replay)
plus the law's, from its width: per observation column three for its
cotangent (two products and an add) and four for the two rows of ``K``'s
gradient; two for ``b``'s; with an integral part four more a column for
the cotangent through ``Ki``, four for ``Ki``'s gradient and four adds of
the carry's cotangents.  Once a drive: ``ops_final``, the final torque's
gather and pull-back.  Bytes: the six saves the sweep reads (currents,
constrained voltages, actions) and every cotangent plane the call hands
it, each read once; the start leaves, speed and references read once; the
cotangents of the start leaves and the carry written once; the table, the
gains and their gradient once.  The kernel's own scratch (the angles'
plane, the blocks' partial sums) is not counted."""

#: the kernel's name in a device trace (matched as a whole word: not
#: ``pmsm_closed_loop_kernel``, nor the launch's summing kernel)
KERNEL_SYMBOL = "pmsm_cl_adjoint_kernel"


def law_ops(n_obs: int, integral: bool) -> int:
    """The affine law's operations a drive and step."""
    return 7 * n_obs + 2 + (8 * n_obs + 4 if integral else 0)


def work(counts: dict, shapes: dict):
    """``(operations, bytes)`` of one launch."""
    batch, steps, itemsize = shapes["batch"], shapes["steps"], shapes["itemsize"]
    policy, n_refs = shapes["policy"], shapes["references"]
    n_obs = 8 + n_refs
    integral = policy["n_carry"] > 0
    ops = (counts["drive_ops_per_step"] + law_ops(n_obs, integral)) * batch * steps + counts["ops_final"] * batch
    per_drive = (5 + 1 + n_refs) + (5 + policy["n_carry"]) + shapes["final_cotangents"]
    planes = 6 + shapes["cotangent_planes"]
    nbytes = itemsize * (batch * steps * planes + batch * per_drive + 2 * policy["n_params"] + counts["table_values"])
    return ops, nbytes
