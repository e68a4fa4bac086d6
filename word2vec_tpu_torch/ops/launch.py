"""What every kernel wrapper of the port shares: launch counts, the device
rule and the input checks.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its CUDA kernel for tensors on one CUDA device, or raises; there
is no fallback. LAUNCHES counts kernel launches per wrapper; only a
launch adds to it, so a run that resets the counts, drives the trainer
and reads them shows which kernels carried it.
"""

from __future__ import annotations

from typing import Dict

import torch

#: kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    "fused_grad_core": 0,
    "fused_slab_scatter": 0,
    "overlap_add_slabs": 0,
    "band_core": 0,
    "ordered_row_sum": 0,
    "find_runs": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True for all-CUDA inputs, False for all-CPU ones; raises otherwise."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"{name}: inputs lie on different CUDA devices")
        return True
    raise ValueError(f"{name}: inputs lie on {sorted(types)}; need one device")


def check(name: str, t: torch.Tensor, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def stream(dev: torch.device) -> int:
    """The current CUDA stream of `dev`, as the integer a C entry point takes."""
    return torch.cuda.current_stream(dev).cuda_stream
