"""What every kernel wrapper of the port shares: launch counts, the device
rule and the input checks.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its CUDA kernel for tensors on one CUDA device, or raises; there
is no fallback. LAUNCHES counts kernel launches per wrapper; only a
launch adds to it, so a run that resets the counts, drives the trainer
and reads them shows which kernels carried it.

A CUDA graph capture runs the wrappers without launching anything: inside
`recording()` a wrapper's count goes to the capture's record instead, and
every replay of the graph adds that record to LAUNCHES (`add_counts`), so
the counts say what ran, graphed or eager.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, Optional

import torch

#: kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    "fused_grad_core": 0,
    "fused_slab_scatter": 0,
    "overlap_add_slabs": 0,
    "band_core": 0,
    "ordered_row_sum": 0,
    "find_runs": 0,
    "row_sq_norms": 0,
    "gathered_slab_scatter": 0,
}


#: phases of the band cores' optional cycle record (csrc/band_tiles.cuh
#: enum Phase, in that order): one int64 count per phase and batch row
CORE_PHASES = ("rows", "masks", "logits", "neg", "center", "context", "tail")


def phase_record(name: str, phase_cycles, rows: int, dev) -> int:
    """The device pointer of a kernel's cycle record, 0 for none; the
    record must be an int64 [rows, len(CORE_PHASES)] tensor on `dev`."""
    if phase_cycles is None:
        return 0
    check(f"{name} phase_cycles", phase_cycles, (rows, len(CORE_PHASES)), torch.int64)
    if phase_cycles.device != dev:
        raise ValueError(f"{name}: phase_cycles must lie on {dev}")
    return phase_cycles.data_ptr()


#: the dynamic shared memory one block may opt into on the H100
#: (cudaDevAttrMaxSharedMemoryPerBlockOptin: 227 KiB); the planner's grid
#: reads it on the host, where no card can be asked
SMEM_PER_BLOCK = 232_448
#: warps of a band-core block (csrc/band_tiles.cuh kThreads / 32)
_CORE_WARPS = 16
#: the band cores' pieces (csrc/band_tiles.cuh kSc, kKPc, kDc, kKc):
#: centers, negative rows and columns the tiles hold at once, and the slab
#: slots of a center piece's band weights; a longer chunk, a wider pool or
#: row, a wider window is walked in pieces, so a block's shared memory
#: stops growing with S, KP, d and W past them: what bounds a block is
#: these four numbers alone
CORE_S_PIECE = 128
CORE_KP_PIECE = 64
CORE_D_PIECE = 304
CORE_K_PIECE = 160
#: bf16 columns of a row of the pieced bodies' band weights (kGpLd)
_CORE_GP_LD = CORE_K_PIECE + 8
#: slab ids the pieced and f32 bodies stage a center piece (kTokRoom)
_CORE_TOK_ROOM = 2048


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def core_pieced(S: int, W: int) -> bool:
    """A chunk of S centers past one center or slot piece: the tensor-core
    bodies' pieced instantiation (csrc/band_tiles.cuh chunk_pieced)."""
    return S > CORE_S_PIECE or S + 2 * W > CORE_K_PIECE


def core_smem_bytes(
    kernel: str, S: int, SK: int, KP: int, d: int, W: int, bf16: bool
) -> int:
    """Dynamic shared memory of a band core's launch, in bytes: the host
    copy of w2v_grad_core_smem_bytes (kernel "fused_grad_core",
    csrc/fused_step.cu) and w2v_band_core_smem_bytes ("band_core",
    csrc/band_core.cu). bf16 compute, the tensor-core body: a chunk of one
    piece, the bf16 tiles of band_tiles.cuh's TileLayout and f32 words
    that grow with its S + 2W <= 160 slots; a pieced chunk (core_pieced),
    the tiles, one slot piece of bf16 band weights and f32 words, the same
    at every W. f32 compute: f32 words, the band weights of one slot piece
    (band-compressed, 2W + 1 a center, while a center piece's slots fit
    one). SK = S + 2W (a center piece's slots follow from its centers;
    both keep the argument for the libraries' signature). Past one piece
    of the centers, the pool, the width and the slots it is constant: it
    never exceeds SMEM_PER_BLOCK. The card run holds it equal to the
    library's (chip_smoke.py phase 12)."""
    if kernel not in ("fused_grad_core", "band_core"):
        raise ValueError(f"no band core named {kernel!r}")
    Sc = min(S, CORE_S_PIECE)
    KPc = min(KP, CORE_KP_PIECE)
    if not bf16:
        gld = 2 * W + 1 if Sc + 2 * W <= CORE_K_PIECE else CORE_K_PIECE
        return 4 * (Sc * 4 + _CORE_TOK_ROOM + KPc + Sc * gld + Sc + Sc * KPc * 2
                    + 2 * _CORE_WARPS)
    SP, KPP = _round_up(Sc, 16), _round_up(KPc, 16)
    lda, ldg = _round_up(min(d, CORE_D_PIECE), 16) + 8, KPP + 8
    tiles = 2 * (SP * lda + KPP * lda + SP * ldg)
    if core_pieced(S, W):
        return tiles + 2 * SP * _CORE_GP_LD + 4 * (
            Sc * 4 + _CORE_TOK_ROOM + KPc + Sc + Sc * KPc + 2 * _CORE_WARPS)
    words = Sc * 4 + (Sc + 2 * W) * 2 + KPc + Sc * (2 * W + 1) + Sc + 2 * _CORE_WARPS
    if kernel == "fused_grad_core":
        words += 2 * W  # ctx_w's right overhang, two buffers
    return tiles + 4 * (words + Sc * KPc)


def core_workspaces(
    kernel: str, B: int, S: int, KP: int, d: int, W: int, bf16: bool, dev
):
    """The f32 device workspaces a band core's chunk of S centers hands
    from one center piece to the next (csrc/band_tiles.cuh): none (empty
    tensors) when the chunk is one center piece (slot pieces need none).
    fused_grad_core: its d_neg so far [B, KP, d] (the tensor-core body
    only: the f32 body carries d_neg in its output) and the context sums
    of the slots pieces share [B, 2, round_up(2W, 16), d] (two buffers, by
    piece parity; a slot reaches back 2W centers, through the middle
    pieces, so this grows with W: 0.62 GB at B 256, d 300, W 499);
    band_core: its d_neg and w_neg_sum so far, [B, KP, d] and [B, KP]."""
    f32 = dict(dtype=torch.float32, device=dev)
    if S <= CORE_S_PIECE:
        return torch.empty((0,), **f32), torch.empty((0,), **f32)
    fused = kernel == "fused_grad_core"
    dneg = (B, KP, d) if bf16 or not fused else (0,)
    second = (B, 2, _round_up(2 * W, 16), d) if fused else (B, KP)
    return torch.empty(dneg, **f32), torch.empty(second, **f32)


def check_smem(name: str, smem: int, dev: torch.device) -> None:
    """Refuse, before any launch, a shape whose shared memory exceeds what
    one block of `dev` may opt into (the kernel would fail to launch). The
    pieces bound a band core's block at every shape the JAX routes take
    (core_smem_bytes), so on an H100 this guards a smaller card only."""
    props = torch.cuda.get_device_properties(dev)
    limit = props.shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"{name}: this shape needs {smem} B of shared memory a block, "
            f"over the {limit} B one block of {props.name} may use"
        )


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_recording: Optional[Dict[str, int]] = None


def count(name: str) -> None:
    """One launch of `name`'s kernel (or, inside recording(), one captured
    launch that each replay will make)."""
    counts = LAUNCHES if _recording is None else _recording
    counts[name] += 1


@contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Counts of the launches captured inside the block, kept out of
    LAUNCHES (a capture launches nothing)."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a launch recording is already open")
    _recording = {k: 0 for k in LAUNCHES}
    try:
        yield _recording
    finally:
        _recording = None


def add_counts(counts: Dict[str, int]) -> None:
    """One replay of a graph whose capture recorded `counts`."""
    for k, v in counts.items():
        LAUNCHES[k] += v


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


def scalar_arg(name: str, x, dev: torch.device) -> torch.Tensor:
    """A float32 scalar for a kernel that reads it from device memory: `x`
    itself when it is a 0-d float32 tensor on `dev` (a captured graph then
    reads its value at every replay), else a new one holding float32(x)."""
    if isinstance(x, torch.Tensor):
        if x.dim() != 0 or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(
                f"{name}: need a 0-d float32 tensor on {dev}, got "
                f"{tuple(x.shape)} {x.dtype} on {x.device}"
            )
        return x
    return torch.full((), float(x), dtype=torch.float32, device=dev)


def stream(dev: torch.device) -> int:
    """The current CUDA stream of `dev`, as the integer a C entry point takes."""
    return torch.cuda.current_stream(dev).cuda_stream
