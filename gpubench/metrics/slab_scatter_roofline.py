"""fused_slab_scatter's share of its roofline, in %: the least time the
window's table updates need (counts/work.py: each live contribution read
once, each destination row read and written once; one float32 add an
element) over the device time of the scatter kernel's launches."""

from gpubench.counts.peaks import bound_s

KERNELS = ("slab_scatter_kernel",)


def read(rec):
    t = sum(v for k, v in rec.get("ops", {}).items() if any(n in k for n in KERNELS))
    w = rec.get("work", {})
    if t <= 0 or "scatter_bytes" not in w:
        return None
    return 100.0 * bound_s(w["scatter_bytes"], w["scatter_flops"], "float32") / t
