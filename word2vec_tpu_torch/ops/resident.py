"""Device-resident corpus: batches assembled ON THE DEVICE inside the step.

Port of word2vec_tpu/ops/resident.py. The host batcher (data/batcher.py)
streams [S, B, L] token chunks over host->device copies every dispatch.
For corpora that fit in device memory (text8 packed is ~68 MB against the
H100's 80 GB; the gate is bytes, not design), the corpus can instead live
on the device — the flat token stream plus the row table — and each
step's [B, L] batch is assembled by gathers inside the captured step. A
dispatch then carries only scalars (the chunk's first batch index, the
alphas) plus one [R] int32 row-order copy per EPOCH, and the host fill
work goes with the token traffic.

The assembled batch is bit-identical to the host pipeline's (fill_batch)
on the same row order — pinned against the JAX package's assemble_batch
by tests/test_torch_resident.py — so the training trajectory is exactly
the streaming path's: same rows per step, same step-indexed draws
(device.step_seed), same alpha schedule.

Reference mapping: the per-epoch shuffle (Word2Vec.cpp:373) stays on the
host as the [R] permutation (a pure function of (seed, epoch), which is
what mid-epoch resume relies on); row fetch — the reference's
`samples[idx]` read at Word2Vec.cpp:377-390 — joins everything below it
on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import Word2VecConfig
# epoch_order re-exported: the row permutation is shared with BatchIterator
# so resident and streaming paths visit identical rows in identical order
from ..data.batcher import PAD, PackedCorpus, epoch_order  # noqa: F401
from .graphs import ChunkRunner, StepGraph, copy_in, shard_list
from .shards import halo_exchange
from .tables import DeviceTables

# Ceiling of the auto-mode resident gate: 2 GiB leaves the tables and the
# step's workspace ample device memory; int32 row addressing holds to 2^31
# tokens anyway.
RESIDENT_MAX_BYTES = 2 << 30


def resident_budget_bytes(device: Optional[torch.device] = None) -> int:
    """The packed-corpus device-memory budget for auto mode: half the free
    memory the card reports (torch.cuda.mem_get_info, which already counts
    the tables and everything else living there, with 2x headroom for the
    step's workspace), capped at RESIDENT_MAX_BYTES; the constant on the
    CPU. One process only (the JAX package's multi-process agreement on
    the minimum comes with the multi-GPU slice)."""
    budget = RESIDENT_MAX_BYTES
    if device is not None and torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(torch.device(device))
        budget = max(0, min(RESIDENT_MAX_BYTES, free // 2))
    return budget


DeviceCorpus = Dict[str, torch.Tensor]  # {"flat": [N], "starts": [R], "lens": [R]} i32


def corpus_fits(corpus: PackedCorpus, max_bytes: Optional[int] = None) -> bool:
    if max_bytes is None:
        # read each call (tests monkeypatch the module constant)
        max_bytes = resident_budget_bytes()
    return (
        corpus.flat.nbytes + 8 * corpus.num_rows <= max_bytes
        and len(corpus.flat) < 2**31
    )


def corpus_arrays(corpus: PackedCorpus) -> Dict[str, np.ndarray]:
    """The packed corpus as int32 host arrays, ready for device placement."""
    if len(corpus.flat) >= 2**31:
        raise ValueError("corpus too large for int32 row addressing")
    return {
        "flat": np.asarray(corpus.flat, np.int32),
        "starts": corpus.row_starts.astype(np.int32),
        "lens": np.asarray(corpus.row_lens, np.int32),
    }


def device_corpus(corpus: PackedCorpus, device) -> DeviceCorpus:
    """Place the packed corpus on `device` (one copy, reused every dispatch)."""
    return {
        k: torch.from_numpy(v).to(device)
        for k, v in corpus_arrays(corpus).items()
    }


def assemble_batch(
    corpus: DeviceCorpus,
    order: torch.Tensor,  # [R] int32 — this epoch's row permutation
    t,                    # batch index (int, or an int64 [] / [1] tensor)
    batch_rows: int,
    max_len: int,
    col0: int = 0,
) -> torch.Tensor:
    """[B, max_len] int32 token batch for batch index t; PAD(-1) outside rows.

    Matches fill_batch exactly: batch t takes rows order[t*B : t*B+B];
    positions past the end of the epoch (partial final batch, or a chunk's
    no-op pad steps) come out as all-PAD rows, which every mask of the step
    provably ignores. Gathers only (index_select / take), so a captured
    step assembles it without a host sync.

    col0 selects a column window [col0, col0 + max_len) of each row — the
    sequence-parallel shard's position slice.
    """
    dev = order.device
    n_rows = order.shape[0]
    pos = t * batch_rows + torch.arange(batch_rows, dtype=torch.int64, device=dev)
    in_epoch = pos < n_rows
    rows = order.index_select(0, torch.clamp_max(pos, n_rows - 1)).long()
    rows = torch.where(in_epoch, rows, -1)
    ok = rows >= 0
    r = torch.where(ok, rows, 0)
    starts = corpus["starts"].index_select(0, r).long()
    lens = torch.where(ok, corpus["lens"].index_select(0, r).long(), 0)
    cols = col0 + torch.arange(max_len, dtype=torch.int64, device=dev)[None, :]
    within = cols < lens[:, None]
    flat = corpus["flat"]
    idx = torch.clamp_max(starts[:, None] + cols, flat.shape[0] - 1)
    return torch.where(within, flat.take(idx), PAD).to(torch.int32)


class ResidentChunkRunner(ChunkRunner):
    """S sequential optimizer steps a call, batches assembled on the device
    (make_resident_chunk_runner):

        runner(params, corpus, order [R], seed, step0, epoch_t0, alphas [S],
               steps=None) -> {name: [S] for name in StepGraph.names (ops/graphs.py)}

    The same trajectory contract as ChunkRunner: step i is step step0 + i
    of the run, on batch epoch_t0 + i of this epoch's order (epoch_t0 is
    the within-epoch index of the chunk's first batch: skip + chunk offset
    on resume). The captured step reads the corpus, a static copy of the
    order and the batch index from device memory, so one graph serves
    every chunk of every epoch."""

    def resident_graph(
        self, params, corpus: DeviceCorpus, S: int, R: int
    ) -> StepGraph:
        """The graph for chunks of S steps over `corpus` and [R] orders,
        captured on first use."""
        cfg = self.config
        B, L = cfg.batch_rows, cfg.max_sentence_len
        work = self._buffers(params)

        r, n = self.replica, self.stride
        blk = r if self.block is None else self.block
        halo = self.halo

        def make(graphed):
            dev = next(iter(shard_list(work)[0].values())).device
            order = torch.zeros(R, dtype=torch.int32, device=dev)
            t0 = torch.zeros(1, dtype=torch.int64, device=dev)
            if r is None:
                batch = lambda slot: assemble_batch(corpus, order, t0 + slot, B, L)  # noqa: E731
            elif halo is None:
                # replica r's row block of global step t0 + slot, as JAX's
                # sharded resident chunk takes block t * dp + r
                batch = lambda slot: assemble_batch(  # noqa: E731
                    corpus, order, (t0 + slot) * n + blk, B, L)
            else:
                # sequence shard s of the row block: its haloed column
                # slice, what the streaming path stages (halo_exchange)
                s, sp = halo
                W = cfg.window
                batch = lambda slot: halo_exchange(  # noqa: E731
                    assemble_batch(corpus, order, (t0 + slot) * n + blk, B, L),
                    s, sp, W)
            g = StepGraph(
                self.step, work, batch, S,
                graphed=graphed, env=self.env, replica=r, fold=self.fold,
                shard_steps=self.shard_steps(),
            )
            g.order, g.t0 = order, t0
            return g

        key = ("resident", S, R) + tuple(v.data_ptr() for v in corpus.values())
        return self._cached(key, work, make)

    def __call__(self, params, corpus: DeviceCorpus, order, seed: int,
                 step0: int, epoch_t0: int, alphas,
                 steps: Optional[int] = None) -> Dict[str, torch.Tensor]:
        g = self.resident_graph(params, corpus, len(alphas), order.shape[0])
        copy_in(g.order, order)
        g.t0.fill_(int(epoch_t0))
        return self.run(g, params, alphas, seed, step0, steps)


def make_resident_chunk_runner(
    config: Word2VecConfig, tables: DeviceTables, *, graphed: bool = True,
    tp: int = 1, sp: int = 1,
) -> ResidentChunkRunner:
    """The resident chunk runner (see ResidentChunkRunner); with
    config.fused_tables its steps run on the restacked [V, 2, d] slab."""
    return ResidentChunkRunner(config, tables, graphed=graphed, tp=tp, sp=sp)


def epoch_step_words(
    corpus: PackedCorpus, order: np.ndarray, batch_rows: int
) -> np.ndarray:
    """[steps_per_epoch] words consumed by each optimizer step (host-side
    alpha schedule + progress accounting; the device only needs tokens)."""
    lens = corpus.row_lens[order].astype(np.int64)
    n = len(lens)
    steps = -(-n // batch_rows)
    padded = np.zeros(steps * batch_rows, np.int64)
    padded[:n] = lens
    return padded.reshape(steps, batch_rows).sum(axis=1)
