"""Published peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). A card set below
700 W runs slower under load; every result carries the card's power limit
beside it."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 495e12,
    "float32": 67e12,   # outside the tensor cores
    "float64": 67e12,   # the FP64 tensor cores
}


def bound_s(nbytes: float, flops: float, flops_key: str) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the compute peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[flops_key])
