"""The run list of a sorted id array: wrapper, plain version, layout.

The two ordered sums of the step (ops/train_step.ordered_row_sum and
ops/fused_step.fused_slab_scatter) hand out their work per run of equal
sorted ids on the card, so they need the runs first. `find_runs` builds
them on the device with the prepass kernel of csrc/runs.cu (no host
sync: the counts stay on the device). Every sorted id array of the step
feeds one row sum and one scatter, so the step builds the list once per
array and passes it to both; each wrapper builds it itself when it is
given none.

Layout (int32 [HEADER + 4N + ceil(N / RUN_TILE)], csrc/runs.cuh; only
the used prefixes meaningful):
  [0] n_short, [1] n_long, [2:HEADER] zero (16-byte alignment)
  [HEADER : HEADER + 2N]        short runs as (start, end), end exclusive
  [HEADER + 2N : HEADER + 4N]   long runs (more than LONG_RUN terms)
  [HEADER + 4N :]               the prepass's per-tile counts (scratch)
in ascending id order. Ids < 0 (the -1 padding, a sorted prefix) belong to
no run.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import _build
from .launch import check, count, on_cuda, stream

#: runs longer than this take the consumers' staged long-run path; the
#: same constant as kLongRun in csrc/runs.cu (tests/test_torch_runs.py
#: holds the two together)
LONG_RUN = 32
#: positions per block of the prepass (kThreads * kPer in csrc/runs.cu)
RUN_TILE = 1024
#: words before the short runs (kHeader in csrc/runs.cuh)
HEADER = 4


def run_list_size(n: int) -> int:
    return HEADER + 4 * n + -(-n // RUN_TILE)


def find_runs_plain(idx: torch.Tensor) -> torch.Tensor:
    """The run list in plain torch ops (unused slots zero)."""
    n = idx.numel()
    runs = torch.zeros(run_list_size(n), dtype=torch.int32, device=idx.device)
    if n == 0:
        return runs
    i = idx.long()
    valid = i >= 0
    differs = i[1:] != i[:-1]
    yes = torch.ones(1, dtype=torch.bool, device=idx.device)
    start = valid & torch.cat([yes, differs])
    end = valid & torch.cat([differs, yes])
    s = torch.nonzero(start).flatten()
    e = torch.nonzero(end).flatten() + 1
    long_ = (e - s) > LONG_RUN
    pairs = torch.stack([s, e], dim=1).to(torch.int32)
    shorts, longs = pairs[~long_], pairs[long_]
    runs[0], runs[1] = shorts.shape[0], longs.shape[0]
    runs[HEADER : HEADER + 2 * shorts.shape[0]] = shorts.flatten()
    at = HEADER + 2 * n
    runs[at : at + 2 * longs.shape[0]] = longs.flatten()
    return runs


def unpack_runs(runs: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(short runs [n_short, 2], long runs [n_long, 2]) of a run list over
    n ids (reads the counts: a host sync on a CUDA list)."""
    ns, nl = int(runs[0]), int(runs[1])
    shorts = runs[HEADER : HEADER + 2 * ns].reshape(ns, 2)
    longs = runs[HEADER + 2 * n : HEADER + 2 * n + 2 * nl].reshape(nl, 2)
    return shorts, longs


def find_runs(idx: torch.Tensor) -> torch.Tensor:
    """The run list of ids sorted ascending ([N] int32)."""
    if not on_cuda("find_runs", idx):
        return find_runs_plain(idx)
    n = idx.numel()
    check("find_runs idx", idx, (n,), torch.int32)
    runs = torch.empty(run_list_size(n), dtype=torch.int32, device=idx.device)
    lib = _build.library("runs")
    dev = idx.device
    with torch.cuda.device(dev):
        err = lib.w2v_find_runs(
            idx.data_ptr(), n, runs.data_ptr(),
            runs.data_ptr() + 4 * (HEADER + 4 * n), stream(dev),
        )
    _build.check(lib, err, "find_runs launch")
    count("find_runs")
    return runs


def check_runs(runs: torch.Tensor, n: int, device: torch.device) -> None:
    """Raise unless `runs` is a run list over n ids on `device`."""
    check("runs", runs, (run_list_size(n),), torch.int32)
    if runs.device != device:
        raise ValueError(f"runs lie on {runs.device}, the ids on {device}")
