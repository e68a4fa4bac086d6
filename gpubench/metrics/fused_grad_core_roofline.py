"""fused_grad_core's share of its roofline, in %: the least time the
window's calls need (counts/work.py sgns_counts: their bytes at the HBM
rate or their operations at the compute type's peak, whichever is longer)
over the device time of the kernel's launches in the trace (the gradient
core and its loss reduction, csrc/fused_step.cu)."""

from gpubench.counts.peaks import bound_s

KERNELS = ("grad_core_tc_kernel", "grad_core_f32_kernel", "loss_reduce_kernel")


def read(rec):
    t = sum(v for k, v in rec.get("ops", {}).items() if any(n in k for n in KERNELS))
    w = rec.get("work", {})
    if t <= 0 or "core_bytes" not in w:
        return None
    return 100.0 * bound_s(w["core_bytes"], w["core_flops"], rec["compute_dtype"]) / t
