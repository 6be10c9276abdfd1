"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit).  A run prints the card's own power limit beside
every share, since a card set lower runs slower under load."""

PEAK_BF16_FLOPS = 989e12      # bf16 tensor-core rate, no sparsity
HBM_BYTES_PER_S = 3.35e12     # HBM3
MEMORY_BYTES = 80e9


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the HBM rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
