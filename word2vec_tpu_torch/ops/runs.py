"""The run list of a sorted id array: wrapper, plain version, layout.

The two ordered sums of the step (ops/train_step.ordered_row_sum and
ops/fused_step.fused_slab_scatter) hand out their work per run of equal
sorted ids on the card, so they need the runs first. `find_runs` builds
them on the device with the prepass kernel of csrc/runs.cu (no host
sync: the counts stay on the device). Every sorted id array of the step
feeds one row sum and one scatter, so the step builds the list once per
array and passes it to both; each wrapper builds it itself when it is
given none. `ordered_add_plain` is the plain version of both sums.

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

from typing import List, Tuple

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


def _rank_passes(idx: torch.Tensor) -> Tuple[torch.Tensor, List[int]]:
    """(perm, sizes) for ids sorted ascending: perm groups the positions by
    duplicate rank (the r-th term of each run in group r, ascending ids
    within), sizes[r] the group sizes (a host sync). Group r holds
    distinct rows, one term each, so adding the groups in turn adds each
    row's terms one by one in order."""
    n = idx.numel()
    pos = torch.arange(n, device=idx.device)
    start = torch.ones(n, dtype=torch.bool, device=idx.device)
    start[1:] = idx[1:] != idx[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    return torch.argsort(rank, stable=True), torch.bincount(rank).tolist()


def ordered_add_plain(dest: torch.Tensor, idx: torch.Tensor, v: torch.Tensor) -> None:
    """dest[idx[q]] += v[q] for q in order, in place, rounding to dest's
    dtype after every add: the plain version of both ordered sums (dest a
    [rows] or [rows, width] view, idx int64 sorted ascending, no -1).

    A term that is zero in every column adds nothing but a zero's sign
    (x + (+-0) == x for x != 0, (+-0) + y == y for y != 0), so such terms
    stay out of the ordered passes, which then walk only the longest run
    of nonzero terms, and the signs are restored: a zero result is -0.0
    exactly when the cell began at -0.0 and every term added there was
    -0.0 (round-to-nearest gives +0.0 for x + (-x) and -0.0 + +0.0)."""
    n = idx.numel()
    if n == 0:
        return
    start = torch.ones(n, dtype=torch.bool, device=idx.device)
    start[1:] = idx[1:] != idx[:-1]
    touched = idx[start]
    group = torch.cumsum(start, 0) - 1  # each term's row among `touched`
    init = dest[touched].clone()
    neg_zero = (v == 0) & torch.signbit(v)
    not_neg_zero = torch.zeros(
        (touched.numel(),) + tuple(v.shape[1:]), device=idx.device
    ).index_add_(0, group, (~neg_zero).float())
    live = (v != 0).reshape(n, -1).any(dim=1)
    li, lv = idx[live], v[live]
    if li.numel():
        perm, sizes = _rank_passes(li)
        at = 0
        for size in sizes:
            sel = perm[at:at + size]
            at += size
            ids = li[sel]
            dest[ids] = (dest[ids].float() + lv[sel].float()).to(dest.dtype)
    cur = dest[touched]
    neg = (init == 0) & torch.signbit(init) & (not_neg_zero == 0)
    dest[touched] = torch.where(cur == 0, torch.where(neg, -0.0, 0.0).to(cur.dtype), cur)


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
