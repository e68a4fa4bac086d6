"""Tracing / profiling helpers and the analytic step-work counters.

A port of word2vec_tpu/utils/profiling.py:

  * `trace(logdir)` — context manager around `torch.profiler.profile`
    (CPU and, on the card, CUDA activity); the trace lands in `logdir` as
    Chrome-trace JSON, viewable in Perfetto / chrome://tracing.
  * `annotate(name)` — a named host-side region on that timeline
    (`torch.profiler.record_function`), for marking batcher / transfer /
    step phases (obs/phases.PhaseRecorder wraps every span in one).
  * `StepTimer` — steady-state step timing with percentile stats: each lap
    waits for the card (`torch.cuda.synchronize` of the result's device;
    nothing to wait for on the CPU) before reading the clock, so a lap is
    host overhead + device compute, not launch latency.
  * `step_geometry` / `step_flops` / `step_hbm_bytes` — the JAX package's
    analytic per-optimizer-step work accounting, over the port's
    ops/banded.resolve_chunk. The formulas are the JAX package's own (they
    price the JAX routes' programs, which the port's kernels replace one
    for one), so a record of either package carries the same numbers for
    the same config (tests/test_torch_profiling.py pins them equal).

Words/sec metering itself lives in the Trainer's log records
(utils/logging.py); this module is for *why is the step slow*, not *how
fast is it going*.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Dict, Iterator, List, Optional

import torch


def activities() -> list:
    """The profiler's activities: the host, and the card when there is one."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed region into
    `logdir`/trace_profile.json (CUDA activity included when a card is
    present)."""
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities()) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace_profile.json"))


def annotate(name: str):
    """Named region on the profiler timeline (host side)."""
    return torch.profiler.record_function(name)


def lap_stats(laps: List[float]) -> dict:
    """Percentile stats over a list of wall-clock laps (seconds -> ms).

    Shared by StepTimer and obs/phases.PhaseRecorder so the p50/p90 a bench
    reports and the p50/p90 a phase breakdown reports are the same math
    (nearest-rank percentile: ceil(q*n) - 1)."""
    if not laps:
        return {"laps": 0}
    laps = sorted(laps)
    n = len(laps)
    p90 = max(0, -(-9 * n // 10) - 1)
    return {
        "laps": n,
        "mean_ms": 1e3 * sum(laps) / n,
        "p50_ms": 1e3 * laps[n // 2],
        "p90_ms": 1e3 * laps[p90],
        "min_ms": 1e3 * laps[0],
        "max_ms": 1e3 * laps[-1],
    }


def _wait(result) -> None:
    """Wait for the device work behind `result` (a tensor, or a dict /
    sequence of them): synchronize each CUDA device they live on."""
    if isinstance(result, dict):
        result = list(result.values())
    if not isinstance(result, (list, tuple)):
        result = [result]
    devs = {
        x.device for x in result
        if isinstance(x, torch.Tensor) and x.is_cuda
    }
    for d in devs:
        torch.cuda.synchronize(d)


class StepTimer:
    """Steady-state step timing: call `lap(result)` once per step.

    `lap` blocks on the step's output before reading the clock, so each
    recorded lap is true wall time of (host overhead + device compute),
    not dispatch latency. Skips the first `warmup` laps (compile).
    """

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.laps: List[float] = []
        self._seen = 0
        self._t: Optional[float] = None

    def lap(self, result) -> None:
        _wait(result)
        now = time.perf_counter()
        if self._t is not None:
            self._seen += 1
            if self._seen > self.warmup:
                self.laps.append(now - self._t)
        self._t = now

    def stats(self) -> dict:
        return lap_stats(self.laps)


# --------------------------------------------------------------------------
# Analytic per-step work accounting (the planner's and the benchmark's counters)
# --------------------------------------------------------------------------

def _dtype_bytes(name: str) -> int:
    return 2 if name == "bfloat16" else 4


def step_geometry(config, vocab_size: int) -> Dict:
    """Resolved step-shape geometry for one dispatched optimizer step.

    Pure shape math: B rows x L positions, the band chunking
    (ops/banded.resolve_chunk) and the negative-pool shape, as the kernels
    will actually realize them. The planner, the cost model, and the benchmark
    all read step shapes from here so they can never disagree.
    """
    from ..ops.banded import resolve_chunk

    B, L, W = config.batch_rows, config.max_sentence_len, config.window
    S = resolve_chunk(L, W, config.band_chunk)
    if S == 0:
        C, slab, plane = 1, L, B * L * L
    else:
        C = -(-L // S)
        slab = S + 2 * W
        plane = B * C * S * slab
    NB = 1 if config.negative_scope == "batch" else B
    return {
        "B": B,
        "L": L,
        "W": W,
        "d": config.word_dim,
        "S": S,
        "C": C,
        "slab": slab,
        "plane": plane,
        "KP": config.shared_negatives,
        "NB": NB,
        "K": config.negative,
        "avg_path": max(1, math.ceil(math.log2(max(2, vocab_size)))),
        "layout": getattr(config, "table_layout", "split"),
        "kernel": config.resolved_kernel,
        "route": (
            "pair"
            if config.resolved_kernel == "pair"
            else ("band-hs" if config.use_hs else "band-ns")
        ),
        "backend": config.band_backend,
        "table_bytes": _dtype_bytes(config.dtype),
        "compute_bytes": _dtype_bytes(config.compute_dtype),
    }


def step_flops(config, vocab_size: int) -> float:
    """Algorithmic FLOPs one optimizer step executes (not model-useful
    FLOPs — masked band slots count, exactly as the hardware pays them).

    Band ns: three band contractions over the [B, C, S, S+2W] logit plane
    (qk logits, sv center-grad, vs context-grad) at 2*plane*d each, plus the
    shared-negative side's three [B*L, KP] contractions. Pair: the unrolled
    P = B*L*2W enumeration against K+1 targets, 3 * 2d per target
    (bench.model_flops_per_target's accounting). Positional hs: like pair
    with the padded Huffman path length in place of K+1.
    """
    g = step_geometry(config, vocab_size)
    B, L, d, W = g["B"], g["L"], g["d"], g["W"]
    if g["route"] == "pair":
        targets = (g["K"] + 1) if config.use_ns else g["avg_path"]
        return 6.0 * B * L * 2 * W * targets * d
    if g["route"] == "band-hs":
        # positional kernel: every (center, path-slot) pair scores/updates a
        # d-row; the padded path length bounds it
        return 6.0 * B * L * g["avg_path"] * d + 12.0 * B * L * g["avg_path"]
    # band-ns: positive band plane + shared-negative block + elementwise
    return (
        6.0 * g["plane"] * d
        + 6.0 * B * L * g["KP"] * d
        + 12.0 * g["plane"]
        + 8.0 * B * L * g["KP"]
    )


def step_hbm_bytes(config, vocab_size: int) -> Dict[str, float]:
    """Analytic memory traffic of one optimizer step, split by origin, as
    the JAX package models its routes (word2vec_tpu/utils/profiling.py
    documents each term and where its constants came from):

      table_io       — embedding-row gathers + read-modify-write scatters
      intermediates  — materialized row tensors / logit planes re-read by
                       later ops
      layout_copies  — the layout copies around the unfused overlap-add
                       chain (0 on the slab-scatter and kernel routes)
      scatter_rows   — a COUNT: rows fed to the step's table scatters
      dma_rows       — a COUNT: per-row transfers inside the fused step
      programs       — a COUNT: device programs the step splits into
      total          — sum of the BYTE terms

    A model, not a measurement: its value is the ordering of the routes
    and the terms' scaling, which the planner's cost model reads.
    """
    g = step_geometry(config, vocab_size)
    B, L, d = g["B"], g["L"], g["d"]
    tb, f32 = g["table_bytes"], 4
    if g["route"] == "pair":
        P = B * L * 2 * g["W"]
        targets = (g["K"] + 1) if config.use_ns else g["avg_path"]
        gathers = (P + P * targets) * d * tb
        scatters = 3.0 * (P + P * targets) * d * tb  # RMW + index machinery
        inter = 2.0 * P * targets * f32  # logits/grads planes
        return {
            "table_io": gathers + scatters,
            "intermediates": inter,
            "layout_copies": 0.0,
            # per-pair enumeration scatters every (pair, target) row
            "scatter_rows": float(P + P * targets),
            "dma_rows": 0.0,
            "programs": 4.0,
            "total": gathers + scatters + inter,
        }
    if g["route"] == "band-hs":
        rows = B * L * g["avg_path"]
        table_io = 4.0 * rows * d * tb
        inter = 4.0 * B * L * d * f32
        # positional kernel: the padded [B, L+2W, C] path-row buffer is the
        # syn1 scatter;
        # the two-tier split replaces the dense-prefix levels with a slice
        # add, leaving only the short tails (~avg_path - log2(top)) to
        # scatter. Plus the B*L center/context rows on emb_in.
        path = g["avg_path"]
        if getattr(config, "hs_dense_top", 0):
            path = max(
                1.0, path - math.log2(max(2, config.hs_dense_top))
            )
        return {
            "table_io": table_io,
            "intermediates": inter,
            "layout_copies": 0.0,
            "scatter_rows": float(B * (L + 2 * g["W"]) * path + B * L),
            "dma_rows": 0.0,
            "programs": 6.0,
            "total": table_io + inter,
        }
    # --- band ns ---
    ein_rows = B * L * d
    slab_rows = B * g["C"] * g["slab"] * d
    neg_rows = g["NB"] * g["KP"] * d
    # gathers once + scatter read-modify-write (~2x) for each touched row set
    table_io = 3.0 * (ein_rows + slab_rows + neg_rows) * tb
    # Scatter-row machinery (the per-LAYOUT term): token-order paths issue
    # two B*L-row sorted scatters (one per table) + the negative rows; the
    # unified layout covers both tables with ONE B*L-row scatter at doubled
    # width; slab-space paths (slab_scatter, the fused pallas kernel) trade
    # one token-order scatter for a (S+2W)/S-larger slab-id scatter.
    slab_side = g["backend"] == "pallas" or (config.slab_scatter and g["S"] > 0)
    dma_rows = 0.0
    programs = 9.0  # the XLA chain's gather/matmul/overlap-add/scatter ops
    if slab_side:
        scatter_rows = B * L + B * g["C"] * g["slab"] + g["NB"] * g["KP"]
    elif g["layout"] == "unified":
        scatter_rows = B * L + g["NB"] * g["KP"]
    else:
        scatter_rows = 2 * B * L + g["NB"] * g["KP"]
    if g["backend"] == "pallas_fused":
        # Fully-fused step (ops/pallas_step.py): gathers and the doubled-
        # width sorted scatter happen INSIDE the kernels as per-row DMAs
        # (dma_rows), and the only XLA scatter left is the negative-row
        # tail. The intermediates term collapses to the token-order
        # [B, L, 2, d] gradient stack crossing HBM once out of the grad
        # kernel and once into the scatter kernel — the band planes, the
        # gathered row stack and the overlap-add chain never leave VMEM.
        scatter_rows = g["NB"] * g["KP"]
        dma_rows = float(
            B * L                          # center rows, both planes/DMA
            + B * g["C"] * g["slab"]       # context slab rows
            + g["NB"] * g["KP"]            # negative rows
            + 2 * B * L                    # scatter read-modify-writes
        )
        programs = 3.0  # grad kernel + scatter kernel + negative scatter
        inter = 4.0 * ein_rows * f32  # the [B, L, 2, d] grad stack, out+in
        copies = 0.0
    elif g["backend"] == "pallas":
        # each row tensor crosses HBM exactly once in and once out
        # (kernel outputs d_h/d_ctx/d_neg in f32)
        inter = (ein_rows + slab_rows + neg_rows) * tb + (
            B * g["C"] * g["S"] * d + slab_rows + neg_rows
        ) * f32
        copies = 0.0
        # one compute kernel + XLA gathers and the three scatters;
        # pallas_oa stays at the XLA chain's count — its kernel replaces
        # the overlap-add chain 1:1 (the win there was bytes, not programs)
        programs = 6.0
    elif g["backend"] == "pallas_oa" and g["S"] > 0:
        # the XLA chain's traffic, with the overlap-add done in VMEM by
        # ops/pallas_overlap.py: the layout-copy term disappears and the
        # kernel itself streams the slab-space grad plane in and the
        # token-order plane out once (~2x slab_rows, sequential — no
        # LAYOUT_COPY_INEFFICIENCY multiplier applies)
        inter = (
            4.0 * (ein_rows + slab_rows) * g["compute_bytes"]
            + 4.0 * g["plane"] * f32
            + 2.0 * slab_rows * f32
        )
        copies = 0.0
    else:
        # XLA chain: row tensors re-read by the four band contractions, and
        # the [B, C, S, S+2W] logit/grad planes round-trip between them
        inter = 4.0 * (ein_rows + slab_rows) * g["compute_bytes"] + 4.0 * g[
            "plane"
        ] * f32
        copies = (
            0.0
            if (config.slab_scatter or g["S"] == 0)
            else 3.0 * slab_rows * f32
        )
    return {
        "table_io": table_io,
        "intermediates": inter,
        "layout_copies": copies,
        "scatter_rows": float(scatter_rows),
        "dma_rows": dma_rows,
        "programs": programs,
        "total": table_io + inter + copies,
    }
