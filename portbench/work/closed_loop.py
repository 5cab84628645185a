"""Work of one launch of ``csrc/closed_loop.cu`` (a classic environment's
closed loop with the policy inside), frozen from the bring-up's counts.

Operations per instance and step: the configuration's ``ops_per_step``
(the observation, the policy, the action's denormalization and the
inverter circle, the vector field and the solver's combination; each add,
multiply, division, square root, compare, select and clamp bound as one).
Bytes: the starting state, references, carry, per-instance parameters and
the policy's per-drive planes read once, its flat parameters read once, the
final state and carry and every saved step written once."""

#: the kernel's name in a device trace (matched as a whole word, so not
#: ``pmsm_closed_loop_kernel``)
KERNEL_SYMBOL = "closed_loop_kernel"


def work(counts: dict, shapes: dict):
    """``(operations, bytes)`` of one launch."""
    batch, steps, saves, itemsize = shapes["batch"], shapes["steps"], shapes["saves"], shapes["itemsize"]
    policy, n_state, n_action = shapes["policy"], shapes["state"], shapes["actions"]
    per_instance = (2 * n_state + shapes["references"] + 2 * policy["n_carry"] + shapes["per_drive_params"]
                    + policy["planes"])
    nbytes = itemsize * (batch * per_instance + policy["n_params"]
                         + saves * batch * (n_state + n_action + policy["n_carry"]))
    return counts["ops_per_step"] * batch * steps, nbytes
