"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W limit): float32 outside the tensor cores, and HBM3 bandwidth."""

FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def least_seconds(ops: float, nbytes: float):
    """The least time the card could take for ``ops`` operations and
    ``nbytes`` bytes moved once, and which of the two bounds it."""
    t_ops, t_bytes = ops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
