"""The slab-space overlap-add: wrapper, plain version, count.

Port of word2vec_tpu/ops/pallas_overlap.py. The TPU kernel becomes the
hand-written CUDA kernel of csrc/overlap.cu (its header note says what
bounds it on the H100 and how the design answers it). It carries
band_backend='pallas_oa': the XLA chain's context-side fan-out with its
overlap-add done by this kernel, so the per-token context gradients come
out in token order for the shared sorted scatter.

The wrapper takes the plain version (ops/banded._overlap_add, the XLA
chain's own pad/add/slice composition) for tensors on the CPU and launches
the kernel for tensors on a CUDA device, or raises. Both sum the same <= 2
slab slots per token row, so they agree bitwise.
"""

from __future__ import annotations

import torch

from .. import _build
from .banded import _overlap_add
from .launch import check, count, on_cuda, stream


def _check_geometry(y: torch.Tensor, W: int, S: int) -> None:
    if y.dim() != 4:
        raise ValueError(f"overlap_add_slabs: y must be [B, C, S+2W, d], got {tuple(y.shape)}")
    SK = y.shape[2]
    if SK != S + 2 * W:
        raise ValueError(f"slab width {SK} != S + 2W = {S + 2 * W}")
    if S < 2 * W:
        # a slab would overlap beyond its immediate neighbours and the
        # two-term reduction would drop contributions
        raise ValueError(f"S={S} < 2W={2 * W}: not a valid slab decomposition")


def overlap_add_slabs_plain(y: torch.Tensor, W: int, S: int) -> torch.Tensor:
    """[B, C, S+2W, d] -> [B, C*S, d] in plain torch ops."""
    _check_geometry(y, W, S)
    C = y.shape[1]
    return _overlap_add(y, S, 2 * W)[:, W : W + C * S]


def overlap_add_slabs(y: torch.Tensor, W: int, S: int) -> torch.Tensor:
    """[B, C, S+2W, d] float32 slab-space values -> [B, C*S, d] token-space
    sums: token row i = c*S + s sums every slab slot aliasing padded
    position i + W. Rows past the caller's L carry the reduction of padding
    slots and are the caller's to slice off (overlap_add_tokens does)."""
    if not on_cuda("overlap_add_slabs", y):
        return overlap_add_slabs_plain(y, W, S)
    _check_geometry(y, W, S)
    B, C, SK, d = y.shape
    check("overlap_add_slabs y", y, (B, C, SK, d), torch.float32)
    out = torch.empty((B, C * S, d), dtype=torch.float32, device=y.device)
    lib = _build.library("overlap")
    dev = y.device
    with torch.cuda.device(dev):
        err = lib.w2v_overlap_add(
            y.data_ptr(), out.data_ptr(), B, C, S, W, d, stream(dev)
        )
    _build.check(lib, err, "overlap_add_slabs launch")
    count("overlap_add_slabs")
    return out


def overlap_add_tokens(y: torch.Tensor, W: int, S: int, L: int) -> torch.Tensor:
    """Slab-space [B, C, S+2W, d] -> per-token [B, L, d] (band_vs's
    overlap-add tail) through overlap_add_slabs."""
    return overlap_add_slabs(y, W, S)[:, :L]
