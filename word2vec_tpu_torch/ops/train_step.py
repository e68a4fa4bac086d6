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

Also here: the pieces every step shares — the draws (`Draws`), the
subsample gate, the metrics tail and the update tail of the hs and pair
steps (`sorted_scatter`). The steps are ops/band_step, ops/hs_step and
ops/pair_step; ops/steps.make_step picks one for a config.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from .. import _build
from .fused_step import fused_slab_scatter
from .launch import check, count, on_cuda, stream
from .runs import check_runs, find_runs, ordered_add_plain

Metrics = Dict[str, torch.Tensor]
#: SR uniforms per update site (None for a site the step does not have)
SrDraws = Tuple[Optional[torch.Tensor], ...]


@dataclass
class Draws:
    """Every random draw of one step: the inputs that stand in for the
    JAX step's key (its threefry streams cannot be reproduced in torch)."""

    u_sub: torch.Tensor   # [B, L] f32 subsample uniforms
    w_eff: torch.Tensor   # [B, L] int32 shrunk window per center
    # negative ids, int32: the band step's shared pool, [B, KP] (row
    # scope) or [KP] (batch); the pair step's per-pair draws [P, K]; None
    # under hs
    negs: Optional[torch.Tensor]
    # SR uniforms per update site, None unless config.stochastic_rounding;
    # each step documents its sites and their shapes (`sr_rows`)
    sr: Optional[SrDraws] = None


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
    """ordered_row_sum in plain torch ops, for ids sorted ascending (ids
    < 0 skipped, as on the card): each row adds its terms one by one in
    order, on any device (ops/runs.ordered_add_plain)."""
    if out is None:
        out = torch.zeros(num_rows, dtype=torch.float32, device=vals.device)
    keep = idx >= 0
    idx = idx[keep].long()
    if bool((idx[1:] < idx[:-1]).any()):
        raise ValueError("ordered_row_sum: ids must be sorted ascending")
    ordered_add_plain(out, idx, vals.float()[keep])
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
    count("ordered_row_sum")
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


def make_chunk_runner(config, tables, *, fused=None, graphed: bool = True):
    """S sequential optimizer steps as one dispatch (make_chunk_runner of
    word2vec_tpu/ops/train_step.py:624-683, which scans the step under
    lax.scan):

        chunk(params, tokens [S, B, L], seed, step0, alphas [S], steps=None)
            -> {name: [S] for name in StepGraph.names (ops/graphs.py)}

    Step i applies the step on tokens[i] with the draws of step step0 + i
    (device.step_seed, the counterpart of fold_in(base_key, step0 + i))
    and LR alphas[i] — the exact per-step driver sequence, so chunked and
    per-step training produce identical parameter trajectories
    (tests/test_torch_chunk.py). On the card each step is one replay of a
    captured CUDA graph (ops/graphs.StepGraph), the S replays issued back
    to back with no host sync. The trailing partial chunk of an epoch is
    padded with all-PAD batches, provable no-ops, which the runner skips
    (`steps` = the real ones). With config.fused_tables (or fused=True)
    the ns tables are restacked to [V, 2, d] for the chunk's lifetime.
    See ops/graphs.ChunkRunner."""
    from .graphs import ChunkRunner

    return ChunkRunner(config, tables, fused=fused, graphed=graphed)


# ------------------------------------------------------- shared step tail
def gate(tokens: torch.Tensor, u_sub: torch.Tensor, keep_probs: torch.Tensor):
    """(valid, clamped ids, keep): the center-word subsample gate
    (Word2Vec.cpp:282,332), shared by every step."""
    valid = tokens >= 0
    tok = torch.where(valid, tokens, 0)
    keep = valid & (u_sub < keep_probs[tok.long()])
    return valid, tok, keep


def finish_metrics(m: Metrics) -> Metrics:
    """A step's metrics in the keys of ops/graphs.METRICS: adds
    nonfinite_loss (1.0 when loss_sum is not finite, the always-on
    tripwire that the JAX package's obs/health.instrument_step adds around
    its step) and hs_tail_dropped (0 on the steps that have no compacted
    hs tail scatter)."""
    m = dict(m)
    m["nonfinite_loss"] = (~torch.isfinite(m["loss_sum"])).float()
    if "hs_tail_dropped" not in m:
        m["hs_tail_dropped"] = torch.zeros_like(m["loss_sum"])
    return m


def sorted_scatter(
    table: torch.Tensor,
    idx: torch.Tensor,
    vals: torch.Tensor,
    weights: Optional[torch.Tensor],
    *,
    scatter_mean: bool,
    clip_tau: float,
    u: Optional[torch.Tensor] = None,
    u_sorted: bool = True,
) -> torch.Tensor:
    """`table.at[idx].add(cast(vals))` in place, with the scatter_mean
    normalization and the per-row trust region before it: the update tail
    of every table of the hs and pair steps (hs_step.py:295-326 and
    _score_and_update, train_step.py:215-231). Returns the clip count.

    Ids and values pass through one STABLE argsort (jnp.argsort is
    stable), so each row's terms keep the order they have in `idx`: that
    is the JAX sorted scatter's order, and also XLA's order for an
    unsorted `.at[idx].add`, which applies duplicates in update order.
    Every per-row sum is an ordered_row_sum and the update is the ordered
    scatter of ops/fused_step (a [V, d] table is a slab of one plane), so
    the result is bitwise on the card what it is on the CPU. `u` are the
    SR uniforms, [N, d] in sorted order (u_sorted, the hs step's sites) or
    in the order of `idx` (the pair step's, drawn before the JAX step
    sorts nothing)."""
    d = vals.shape[-1]
    order = torch.argsort(idx.reshape(-1), stable=True)
    sidx = idx.reshape(-1)[order].to(torch.int32).contiguous()
    vals = vals.reshape(-1, d)[order]
    if u is not None and not u_sorted:
        u = u[order]
    rows = table.shape[0]
    runs = find_runs(sidx) if sidx.is_cuda else None
    sl = sidx.long()
    if scatter_mean:
        w = weights.reshape(-1)[order]
        vals = vals * _dup_mean_scale(rows, sidx, w, presorted=True, runs=runs)[:, None]
    clip = torch.zeros((), dtype=torch.float32, device=vals.device)
    if clip_tau > 0.0:
        scale = _row_clip_scale(
            rows, clip_tau, (sidx, vals), presorted=True, runs=(runs,)
        )
        clip = torch.sum((scale < 1.0).float())
        vals = vals * scale[sl][:, None]
    sr = u is not None and table.dtype == torch.bfloat16
    v = _cast_update(vals, table.dtype, u if sr else None, table[sl] if sr else None)
    fused_slab_scatter(table, sidx, v.contiguous(), runs=runs)
    return clip


def _rc(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """x rounded to the compute dtype, held in float32: the operand of an
    einsum(..., preferred_element_type=float32) on cdt inputs (ops/banded
    .cdot); rounding once lets one operand feed several contractions."""
    return x.to(cdt).to(torch.float32)
