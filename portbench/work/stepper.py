"""Work of one step-mode launch of ``csrc/stepper.cu`` (the classic
environments' rollout), frozen from the bring-up's counts.

Operations: the configuration's ``ops_per_step`` (each add, multiply,
divide, compare and each sin/cos/fmod counted as one: the action's
denormalization, the vector field, the solver's combinations and the angle
wrap) per step and instance.  Bytes: the action slab and the initial state
read once, the final state and every saved state written once."""

#: the kernel's name in a device trace
KERNEL_SYMBOL = "stepper_kernel"


def work(counts: dict, shapes: dict):
    """``(operations, bytes)`` of one launch."""
    batch, steps, saves, itemsize = shapes["batch"], shapes["steps"], shapes["saves"], shapes["itemsize"]
    n_state, n_action = counts["state"], counts["action"]
    nbytes = itemsize * (steps * batch * n_action + 2 * n_state * batch + saves * n_state * batch)
    return counts["ops_per_step"] * batch * steps, nbytes
