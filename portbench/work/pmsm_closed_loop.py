"""Work of one launch of ``csrc/pmsm_closed_loop.cu`` (the PMSM drive's
closed loop with the policy inside), frozen from the bring-up's counts.

Operations per drive and step: the configuration's ``drive_ops_per_step``
(the torque's table gather, the observation, the hexagon, the current ODE
with its gather and the Euler combination, the angle) plus the policy's,
counted from the gains these inputs hold and not from the law's dense
shape: per action, a multiply and an add for each nonzero proportional
gain; with an integral part, the same for each nonzero integral gain and
one add of the integrator; two compares with a clip.  Bytes: the starting leaves, speed,
references, carry and per-drive parameters read once, the policy's
parameters and the six maps read once, the final leaves and carry and every
saved step written once."""

#: the kernel's name in a device trace
KERNEL_SYMBOL = "pmsm_closed_loop_kernel"


def work(counts: dict, shapes: dict):
    """``(operations, bytes)`` of one launch."""
    batch, steps, saves, itemsize = shapes["batch"], shapes["steps"], shapes["saves"], shapes["itemsize"]
    policy = shapes["policy"]
    n_carry, n_refs = policy["n_carry"], shapes["references"]
    policy_ops = sum(2 * nk + (2 * nki + 1 if nki else 0) + 2 * policy["clip"]
                     for nk, nki in zip(policy["nonzero_gains"], policy["nonzero_integral_gains"]))
    ops = (counts["drive_ops_per_step"] + policy_ops) * batch * steps
    nbytes = itemsize * (batch * (6 + n_refs + 2 * n_carry + shapes["per_drive_params"] + 8)
                         + policy["n_params"] + counts["table_values"] + saves * batch * (7 + n_carry))
    return ops, nbytes
