"""Shared update helpers of the training step, in torch.

Port of word2vec_tpu/ops/train_step.py:41-165. jax.random's threefry
streams cannot be reproduced with torch generators, so every random draw
is an ARGUMENT here: the alias draw takes its bucket ints and coin
uniforms, and the stochastic-rounding cast takes its uniforms. The caller
(ops/band_step.draw) makes them with a torch.Generator; the parity tests
make them with the JAX package's own jax.random calls and hand the same
numbers to both packages.

Every per-row sum of the step (the scatter_mean counts, the clip norms)
goes through `ordered_row_sum`: each row's terms are added in the order
they appear, which is XLA's sequential `.at[idx].add` order, so the
result is bitwise the JAX helper's and the same on every run. On a CUDA
tensor it is the kernel of csrc/row_sum.cu (an unordered `index_add_`
adds in atomic order there, which changes from run to run), which hands
out its work per run of equal ids from the run list of ops/runs.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .launch import LAUNCHES, check, on_cuda, stream
from .runs import check_runs, find_runs


def _draw_negatives(
    bucket: torch.Tensor,
    coin: torch.Tensor,
    accept: torch.Tensor,
    alias: torch.Tensor,
) -> torch.Tensor:
    """Alias-method unigram^0.75 draws (replaces table lookup,
    Word2Vec.cpp:255): bucket j ~ U{0..V-1}, coin u ~ U[0, 1)."""
    j = bucket.long()
    return torch.where(coin < accept[j], bucket, alias[j].to(bucket.dtype))


def ordered_row_sum_plain(
    num_rows: int,
    idx: torch.Tensor,
    vals: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ordered_row_sum in plain torch ops, for ids sorted ascending: one
    pass per duplicate rank (the r-th term of every row in pass r), so
    each row adds its terms one by one in order, on any device."""
    if out is None:
        out = torch.zeros(num_rows, dtype=torch.float32, device=vals.device)
    n = idx.numel()
    if n == 0:
        return out
    idx = idx.long()
    v = vals.float()
    if bool((idx[1:] < idx[:-1]).any()):
        raise ValueError("ordered_row_sum: ids must be sorted ascending")
    pos = torch.arange(n, device=idx.device)
    start = torch.ones(n, dtype=torch.bool, device=idx.device)
    start[1:] = idx[1:] != idx[:-1]
    rank = pos - torch.cummax(torch.where(start, pos, 0), 0).values
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        ids = idx[sel]
        out[ids] = out[ids] + v[sel]
    return out


def ordered_row_sum(
    num_rows: int,
    idx: torch.Tensor,
    vals: torch.Tensor,
    out: Optional[torch.Tensor] = None,
    *,
    presorted: bool = False,
    runs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`out.at[idx].add(vals)` for [N] values in float32, out =
    zeros(num_rows) when None (updated in place otherwise), each row's
    terms added in the order they appear in `idx`.

    presorted=True promises ids sorted ascending (with the values in that
    order); otherwise ids and values pass through a STABLE argsort first,
    which keeps each row's terms in their original order. A chain
    `.at[i1].add(v1).at[i2].add(v2)` is two calls, the second with
    out= the first's result. `runs` is the run list of the sorted ids
    (ops/runs.find_runs; presorted ids only), built here when None; the
    CPU path does not need it. Ids < 0 are skipped on the card."""
    if not presorted:
        if runs is not None:
            raise ValueError("ordered_row_sum: runs= needs presorted ids")
        order = torch.argsort(idx, stable=True)
        idx, vals = idx[order], vals[order]
    if out is None:
        out = torch.zeros(num_rows, dtype=torch.float32, device=vals.device)
    if not on_cuda("ordered_row_sum", idx, vals, out):
        return ordered_row_sum_plain(num_rows, idx, vals, out)
    n = idx.numel()
    if n == 0:
        return out
    idx = idx.to(torch.int32).contiguous()
    vals = vals.to(torch.float32).contiguous()
    check("ordered_row_sum out", out, (num_rows,), torch.float32)
    check("ordered_row_sum vals", vals, (n,), torch.float32)
    if runs is None:
        runs = find_runs(idx)
    check_runs(runs, n, idx.device)
    lib = _build.library("row_sum")
    dev = out.device
    with torch.cuda.device(dev):
        err = lib.w2v_ordered_row_sum(
            out.data_ptr(), idx.data_ptr(), vals.data_ptr(), runs.data_ptr(),
            n, stream(dev),
        )
    _build.check(lib, err, "ordered_row_sum launch")
    LAUNCHES["ordered_row_sum"] += 1
    return out


def _row_clip_scale(
    num_rows: int,
    tau: float,
    *contribs: Tuple[torch.Tensor, torch.Tensor],
    presorted: bool = False,
    runs: Tuple[Optional[torch.Tensor], ...] = (),
) -> torch.Tensor:
    """Per-row trust-region scale for batched duplicate-summed updates:
    scale_r = tau / max(S_r, tau), S_r = sum_j ||vals_j|| over the row's
    contributions, each contribution one ordered_row_sum in turn
    (train_step.py:52-89; single device, no tp psum). `runs` gives each
    contribution's run list (presorted ids), built per call when absent."""
    s = None
    for j, (idx, vals) in enumerate(contribs):
        v = vals.float()
        s = ordered_row_sum(
            num_rows, idx, torch.sqrt(torch.sum(v * v, dim=-1)), s,
            presorted=presorted, runs=runs[j] if j < len(runs) else None,
        )
    return tau / torch.clamp_min(s, tau)


def _cast_update(
    vals: torch.Tensor,
    dtype: torch.dtype,
    u: Optional[torch.Tensor] = None,
    dest: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f32 update values -> table storage dtype.

    Plain cast (round-to-nearest) unless uniforms `u` are given and the
    target is bfloat16: then stochastic rounding against the DESTINATION
    row's ulp grid (train_step.py:92-141 explains why), with `u` playing
    the role of jax.random.uniform(key, vals.shape).
    """
    if u is None or dtype != torch.bfloat16:
        return vals.to(dtype)
    if dest is None:
        raise ValueError("stochastic rounding needs the destination rows")
    w = torch.abs(dest.float())
    # bf16 ulp(w) = 2^(exponent(w) - 7)
    ulp = torch.exp2(torch.floor(torch.log2(torch.clamp_min(w, 1e-7))) - 7.0)
    q = vals.float() / ulp
    qf = torch.floor(q)
    return ((qf + (u < q - qf).float()) * ulp).to(torch.bfloat16)


def _dup_mean_scale(
    num_rows: int,
    flat_idx: torch.Tensor,
    flat_weight: torch.Tensor,
    presorted: bool = False,
    runs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """1/duplicate-count scale per flattened index (config.scatter_mean)."""
    cnt = ordered_row_sum(
        num_rows, flat_idx, flat_weight, presorted=presorted, runs=runs
    )
    return (1.0 / torch.clamp_min(cnt, 1.0))[flat_idx.long()]
