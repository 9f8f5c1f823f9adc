"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at 700 W)."""

INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, ops_per_s: float = INT8_OPS_PER_S) -> float:
    """The least time the chip could take: the larger of the compute and
    the memory terms."""
    return max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)
