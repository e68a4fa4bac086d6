"""Device milliseconds a step of the hs step's torch-op chain: the device
time of every operation in the traced window except the port's own CUDA
kernels (csrc/*.cu), over the window's optimizer steps."""

PORT_KERNELS = (
    "grad_core_", "band_core_", "slab_scatter_kernel", "overlap_add_kernel",
    "ordered_row_sum_kernel", "count_runs_kernel", "write_runs_kernel",
    "loss_reduce_kernel", "rows_reduce_kernel",
)


def read(rec):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    t = sum(v for k, v in rec.get("ops", {}).items() if not any(p in k for p in PORT_KERNELS))
    return 1e3 * t / rec["steps"]
