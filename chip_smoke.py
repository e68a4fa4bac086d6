#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (word2vec_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
     versions; a CUDA device is required.
  2. build: every csrc/*.cu source compiled by nvcc (one process each, all
     started together), with the build seconds, ptxas's register / spill /
     smem report and the band cores' dynamic shared memory.
  3. kernels vs plain versions on the card, at the flagship shapes:
     fused_grad_core and band_core (sg and cbow, f32 tables, bf16 and f32
     compute; band_core in row and batch negative scope) within the stated
     tolerance, n_ctx / ctx_w exact, two calls bitwise equal; both cores
     with bf16 compute (their tensor-core bodies) at the odd shapes of
     ODD_SHAPES (f32 and bf16 tables), likewise; the slab scatter (f32 and bf16
     tables, whole rows and the plane-1 negative tail), the overlap-add
     and the ordered row sum bitwise, the row sum also across two runs;
     then the run list (exact), the scatter and the row sum on adversarial
     id sets at flagship width (one run, all distinct, a -1 prefix, runs
     around every threshold and stage size, a batch padded to row 0),
     bitwise and across two runs.
  4. the slice: one step on a small input per route (pallas_fused,
     xla, pallas_oa and pallas on split tables, xla on the unified slab),
     kernels on the card vs the plain versions on the CPU with the same
     draws; then the flagship Trainer (sg, ns, K=5, d=300, window 5,
     B=256 x L=192, KP=64, f32 tables, bf16 compute) for 30 steps on one
     synthetic 71k-word Zipf corpus on each of band_backend 'xla' (the JAX
     default, split tables), 'pallas_oa' and 'pallas' (split) and
     'pallas_fused' (unified slab): finite, falling loss; exact launch
     counts per step (expected_launches), each route's run with every
     count set to 0 just before it; export and a save/load round trip of
     the default route's vectors; two runs of one flagship step on the
     default route, bitwise equal.
  5. times: device-time medians (CUDA events queued behind a spin kernel,
     cuda_ms) per kernel and for its plain version, the
     per-phase cycle split of both band cores (sg and cbow, bf16 and f32
     compute; a core_phases line), the
     library call that computes the same function where there is one
     (index_add_ for the scatter and the row sum, F.fold for the
     overlap-add, unique_consecutive for the run list), each kernel's
     bound, and the trainer's words/sec per route. The scatter and the row
     sum are also timed at every call shape the step makes (unified,
     split in/out and neg, a real batch's ids, grad_inputs' ragged rows,
     the pallas slab side), each
     beside index_add_, its bytes bound, its chain bound (longest run x
     dependent-add cycles / SM clock) and its longest run. Then the
     dispatch A/B: words/sec per route of four arms, one run each in turn
     (A B C D): A eager per-step, B each step replayed as a CUDA
     graph, C graphed chunk_steps=0 streaming, D graphed chunk_steps=0
     resident; each arm's capture seconds and its device busy / idle
     shares under torch.profiler; the median host batch fill [256 x 192].
  6. cli: the command line a user runs (word2vec_tpu_torch.cli), in
     process on the card: the phase-5 Zipf corpus written as a text8 file
     and its 71,000-word vocabulary as a -read-vocab file; at flagship
     width on pallas_fused/unified (chunk_steps 6) and xla/split
     (per-step): a full epoch (31 steps) with a checkpoint file every 18
     steps, then --resume from the mid-epoch checkpoint (step 18) to the
     end, the resumed final params and exported binary vectors bitwise
     equal to the uninterrupted run's; exact launch counts of each run
     (expected_launches of its steps + the capture's warm-up step); the
     checkpoint's save (from the CLI's log) and load seconds; the exported
     vectors loaded back into a query engine on the card and one on the
     CPU, 256 neighbor queries with identical ids and scores within 1e-5,
     f32 and bf16 tables, and each engine's wall ms; --eval-ws353 on the
     topical toy corpus at -size 300 reading (20/20 pairs); the native
     host layer built, its fill bitwise equal to the numpy fill on the
     flagship corpus, and both fills' median ms. One cli_phase JSON line.
  4b (between 4 and 5) graphs: on each route, at flagship width, the
     graphed per-step run (whole, and resumed mid-epoch by
     train(state=...)), chunk_steps=4 streaming and chunk_steps=4 resident
     (a partial last chunk) against the eager per-step run of the same
     seed, bitwise on the params, each path's launch counts exact
     (expected_launches). A capture that fails raises.
  7. hs and pair: the other step routes at flagship width on the phase-5
     corpus and vocabulary (split tables, f32 tables, bf16 compute, clip
     1.0): hs sg one tier, hs sg two tiers (hs_dense_top=512, auto tail
     bound), hs cbow one tier, pair on ns (K=5) and pair on hs with 4
     micro sub-steps. First one step per route at a small shape, the
     card vs the plain versions on the CPU with the same draws (params
     within 1e-6, f32 compute). Per route: one (sub-)step with every ordered-sum
     call recorded (run list, row sum, scatter at the route's own call
     shapes), each held bitwise against its plain version and the
     scatters timed beside index_add_, their bytes and chain bounds and
     their longest run; eager per-step, graphed per-step and chunked
     resident runs of 6 steps from one seed, bitwise equal, each with its
     launch counts set to 0 just before it and exact just after
     (hs_launches); 24 graphed steps whose loss must fall and stay
     finite, with words/sec, the host-clock step and the peak memory.
     Then the CLI on hs cbow two tiers (chunk_steps 6) and pair on ns
     (per-step): a full epoch with a checkpoint file every 18 steps,
     --resume from the mid-epoch file ≡ the uninterrupted run bitwise
     (state.npz and the binary vectors), exact launch counts. One
     hs_phase JSON line.
  8. serve: the serving tier on the card. Two `python -m
     word2vec_tpu_torch.serve` processes over phase 6's exported binary
     vectors (V=71,000 x d=300, --coalesce-ms 2), started together. The
     chaos one (--faults oom:times=1,stall@5:secs=0.2,hang@26:secs=60,
     cache off): one query alone gets the injected oom's 503, the next 24
     sequential queries are 200 and equal to the port's engine on the CPU
     over the same file (the stall fires at batch 5), then a query wedges
     batch 26 and the process gets two SIGTERMs; its exit, collected at
     the end of the phase, must be 75 with flight.json reason preempted /
     forced. The other (--metrics-dir and --trace): 2,000 queries (70%
     neighbors k=10, 20% analogy k=5, 10% similarity; words drawn Zipf
     with a fixed seed, 20% repeats) from 64 keep-alive connections, half
     on the GET routes and half as POST /v1/query batches of 4: every
     response 200, every word list equal to the CPU engine's and every
     score and similarity within 1e-6; /stats and /metrics count 2,000
     requests, no error, some cache hits; SIGTERM exits 0 with flight.json
     and a schema-valid trace.json. In process: a real CUDA OOM (the
     allocator's free cached blocks occupied, its limit set 16 MiB above
     what it holds) fails a batch of 256 neighbor queries with 256 x 503
     "allocation failure (device out of memory): CUDA out of memory...";
     the limit restored, the same batch is 200 and right. Then a V=1,000,000
     x d=300 f32 table made from a seed: 8,192 neighbor queries (k=10,
     distinct words) from 128 clients on coalesce_ms 0, 2, 0, 2, with
     queries/sec, ServeStats p50/p99, batch fill, the first batch_topk
     call and the CUDA-event ms per batch_topk; no port kernel launched;
     64 answers equal to a plain f64 top-k on the card; five batch_topk
     calls of the measured fill under torch.profiler (device busy ms a
     call, idle share, the largest device items, the bound). One
     serve_phase JSON line.
  9. telemetry: the trainer's telemetry through the CLI, in process on
     the card, at flagship width on pallas_fused/unified (chunk_steps 6)
     over the first 18 steps of phase 5's corpus, two epochs (36 steps).
     Four timing runs interleaved (A B A B): A with every telemetry flag
     (--metrics-dir --trace --prom-textfile --health-metrics 1
     --quality-probe-every 12 --slo --signal-window 6 --emit-device
     --log-jsonl), B with none; words/sec of each. In every run the port
     kernels' launch counts equal expected_launches of 37 steps (the
     capture's warm-up included) and the graph replays 36; a fifth run
     with the telemetry on but the probe off makes as many synchronizing
     torch calls (torch.cuda.set_sync_debug_mode) as the off run. A's
     files: manifest.json with TEL_MANIFEST_KEYS and shutdown clean,
     trace.json valid with one chunk parent per dispatch (36 steps), the
     prom file's w2v_* names, the health fields in every step record, the
     probe rows at steps 12, 24, 36, `device: gpu NVIDIA H100...` on
     stderr. Then one graphed health step against the same step run
     eagerly from the same draws, its counters against full-table
     float64 sums (1e-5 relative; non-finite cells exact, one planted inf
     counted as 1) and the step's device ms with health on and off (CUDA
     events around a replay); the probe's host copy and scoring ms on the
     flagship tables; and the exits, each with flight.json and the
     manifest's shutdown: a QualityAlert (--quality-budget 1
     --quality-floor 0.99 --quality-grace 0 and a --probe-pairs file: the
     Zipf vocabulary carries no planted golds) rc 3, a divergence
     (--resume from a checkpoint written by the port's saver with NaN in
     row 0 of emb_in and divergence_budget 2 in its config) rc 2 with
     nonfinite_params > 0 in the dump, a preemption (a patched stop check)
     rc 75. One telemetry_phase JSON line.
 10. resilience and device telemetry: phase 9's CLI runs (36 flagship
     steps, pallas_fused/unified, chunk_steps 6), in process unless said
     otherwise, each with its launch counts, graph replays and captures
     counted: an uninterrupted run (the reference); auto-recovery
     (--faults nan@20 --divergence-budget 2 --auto-recover 1, checkpoints
     every 12, keep 2): exit 0, one auto_recover record (resume_step <
     failed_step, alpha halved, seed + 1), one capture and launches of the
     replayed steps plus the warm-up, finite tables, the recovery's
     checkpoint load and copy into the graph's buffers timed; --faults
     sigterm@18: exit 75, the resume bitwise equal to the reference
     (state.npz and the binary vectors); --faults ckpt_oserror:times=2:
     exit 0, two retry warnings, a checkpoint that verifies; the memory
     ledger every 6 boundaries (w2v_mem_* gauges, the manifest's init /
     table_place / train_step watermarks, table_place at least the slab's
     170,400,000 bytes, headroom in (0, 1)) with the launches, replays and
     synchronizing calls of a run sampling every 36, and its us a sample;
     --profile-steps 12:18 (capture_1.json valid, its trace holding the
     window's six steps of fused_grad_core and slab scatter launches, the
     profiler's start / stop ms) and a real SIGUSR2 at step 12 (a window
     armed at 18, mem_usr2.json, exit 0); a wedged card (~2 s of
     torch.cuda._sleep waited on under device_wait) named by a
     StepWatchdog(0.5 s); a subprocess with --faults hang@12:secs=120
     --step-deadline 2 started first: exit 76 within 2 x 2 + 1 s of the
     wedge, stall.json, stall_stacks.txt, flight.json (stalled), shutdown
     stalled, then --resume bitwise equal to the reference; words/sec with
     --step-deadline 30 and without, interleaved twice, with equal
     launches, replays and synchronizing calls. One resilience_phase JSON
     line.
 11. stream: continuous training through the CLI, in process on the card,
     at flagship width on pallas_fused/unified (chunk_steps 6) over the
     first 1,520,000 tokens of phase 5's corpus as one text8 file, with
     --corpus-mode streaming --segment-tokens 380000 --vocab-reserve 4096
     -min-count 5 and no -read-vocab (the vocabulary boots from segment
     0; later segments admit words). (a) uninterrupted, with checkpoints
     every 6 steps and --metrics-dir: exit 0, 4 stream_segment records, a
     vocab_growth with admitted > 0, table capacity = the boot vocabulary
     + 4096, captures = one for the first segment and one more after each
     growth that precedes a trained segment (and per new chunk length),
     launches = expected_launches of the steps + one warm-up a capture,
     replays = steps, the manifest's stream block, finite tables, the rows
     past the final vocabulary at their init bits and every boot row
     trained; its boundaries timed on the host clock (the gap from the
     last sync of a segment to the next one's first dispatch, split into
     encode, pack, refresh, the boundary checkpoint, capture, the first
     chunk's fill and the rest), refresh_vocab_tables ms, the producer's
     read ms per segment beside each segment's train s. Words/sec of (a)'s
     flags against --corpus-mode resident, interleaved twice, and both
     final tables' row norms and effective rank. (b) a real SIGTERM at the
     first boundary of the first segment after a growth: exit 75, a
     stream.json cursor naming that segment, then --resume: state.npz and
     the binary vectors bitwise equal to (a), launches exact. (c) -train -
     from a subprocess pipe of the same bytes with --stream-spool: exit 0,
     4 spooled segments, (a)'s admissions, cursors and vectors bitwise.
     (d) the library StreamRun over an ArraySource of the same ids (the
     final vocabulary) with a QueryEngine on the card as swap_engine and a
     thread of 64-word neighbor queries from the first dispatch on: one
     swap a boundary, no failed query, the swapped table's top-10 ids equal
     to the CPU engine's on the same table, swap_floor 1.01 with planted
     pairs -> table_swap_refused and the generation kept. One stream_phase
     JSON line.
 12. planner: the autotuned planner on the card (tune/), on phase 5's
     corpus and vocabulary at flagship width. (a) The host copy of the band
     cores' shared memory (ops/launch.core_smem_bytes) equal to the
     library's at every (S, KP) of the grid, the card's per-block limit
     equal to the planner's constant; one step of each kernel call shape
     the flagship band-ns grid offers beyond phases 3-4 (GRID_SHAPES: KP 16
     / 32, S 96 / 64, 128 / 512 rows, batch scope at KP 256, on each
     kernel route), the kernels on the card vs the plain versions on the
     CPU with the same draws (f32 compute, phase 4's tolerances), and the
     band cores' bf16 bodies at the same shapes vs their plain versions
     (phase 3's tolerances); band_core at batch scope and KP 256 refused
     before any launch and absent from the grid (REFUSED_SHAPES, ROADMAP
     Queue C). (b) probe_plan of the four routes' flagship plans: launches
     exact (the capture's warm-up step + 3 dispatches of 2 steps), the
     measured and predicted ms, the model's order of the routes beside the
     measured one. (c) the CLI with --autotune probe --plan-cache on phase
     9's corpus (36 steps), configured pallas_fused/unified (chunk 6) and
     xla/split (per-step), --metrics-dir with the health counters and the
     probe off: exit 0, one autotune record under the key
     `<card>|gpu|band-ns|V71000|d300|<layout>|kp64|<route>`, at most 4
     probes and no error record, the winner stored, the device memory
     allocated after resolve_plan equal to before it, each survivor's
     measured and predicted ms and the search's seconds. (d) the same with
     --autotune cached: a hit, zero probes, state.npz and the binary
     vectors bitwise equal to (c), launches and captures (counted after
     resolve_plan returned) equal, the checkpoint's config the
     plan-applied one. (e) words/sec of the plan-applied run against the
     configured default (--autotune off), interleaved twice. (f) the
     anchors fitted (tune/cost_model.py): the xla step's scatter kernels
     over its scatter rows and its device window less busy time over its
     programs (torch.profiler), the per-dispatch overhead (host clock less
     CUDA events of a 6-step pallas_fused dispatch), the layout-copy
     inefficiency and the DMA cost a row by the inversion cost_calibrate
     makes on the mean measured step of the default runs of xla and
     pallas_fused; each anchor's verdict on the mean of the plan-applied
     runs under the fitted anchors, and in the manifests of (c) and (d)
     under the module's, printed beside the measured step's spread (not
     held: it spreads by more than the smaller terms); every manifest's
     cost_calibrate block the JAX CLI's, with a measured step. One
     planner_phase JSON line.
 13. parallel: one-process data parallelism (word2vec_tpu_torch/parallel/)
     at flagship width on phase 5's corpus, two replicas on the one card
     (make_mesh(2, devices=[card, card]); its 36 batches make 18 global
     steps an epoch). (a) Each route of phase 4
     trains 36 global steps with dp_sync_every 8 in mean mode
     (pallas_fused/unified also in delta mode): launches exactly
     expected_launches of 2 x 36 replica steps plus the two captures'
     warm-ups, a loss that falls and stays finite, five syncs (8, 16, 24,
     32 and the run's final one), each on the card bitwise equal to the
     port's sync on the CPU over copies of the same replicas and the
     replicas bitwise equal after it. (b) On pallas_fused/unified and
     xla/split: the graphed per-step run, chunk_steps 2 streaming and
     chunk_steps 2 resident bitwise equal to the eager per-step dp run,
     each with exact launch counts; a run with a checkpoint every 12 steps
     (each syncs through export_params), and the same run resumed by a
     fresh trainer from its mid-epoch step-12 checkpoint file, bitwise
     equal. (c) words/sec of dp 2 on the one card against dp 1 (Trainer)
     on pallas_fused/unified, chunk_steps 2, interleaved twice (A B A B), and
     the CUDA-event ms of one sync of the flagship tables in each mode
     beside its bytes bound. (d) With two or more cards: two replicas on
     two cards bitwise equal to two on one, and the CLI with --dp 2;
     with one card the phase says those arms need a second card (the
     cross-device code is held with the card and the CPU as the two
     devices by tests/test_torch_cuda.py::test_dp2_replicas_on_two_devices).
     One parallel_phase JSON line.
 14. tensor and sequence parallelism (word2vec_tpu_torch/parallel/ and
     ops/shards.py) at flagship width on 'xla', every shard on the one
     card (make_mesh(dp, tp=, sp=, devices=[card] * n)). (a) One tp-2 step
     on split f32 tables and one tp-4 step on the bf16 unified slab (d/tp
     = 150 and 75) from fixed draws: every fused_slab_scatter (both
     planes and the plane-1 tail), ordered_row_sum and find_runs call
     bitwise its plain version, shard 0's scatters timed beside
     index_add_ and their bounds. (b) Every psum of those steps (ops/
     shards.shard_sum) bitwise the CPU shard-order sum of copies of its
     partials, and their CUDA-event ms a step beside their bytes bound
     (each partial read once, the total written once). (c) tp 2 and tp 4
     steps on f32 tables within 5e-5 of the tp-1 step of the same draws;
     with the clip off, the sp-2 shards' deltas (the single-device draws
     cut to each haloed slice) summed within 1e-4 of the single-device
     delta. (d) (2, 2, 2), 36 global steps with dp_sync_every 8: the
     graphed per-step, chunk-2 streaming and chunk-2 resident runs
     bitwise equal to the eager per-step run, launches exact (8
     shard-steps a global step plus each capture's warm-up), every sync
     bitwise the CPU sync, a loss that falls and stays finite. (e) hs sg
     and pair ns at tp 2: 6 graphed steps bitwise eager, counted. (f)
     words/sec of tp 2 and sp 2 on the one card against tp = sp = 1
     (Trainer), chunk 2, interleaved twice (A B C A B C); the tables'
     bytes of a tp-2 shard against tp 1, the memory each arm holds after
     its capture and its peak during it. With two or more cards a tp-2
     replica's shards on two cards (eager) bitwise equal to the one-card
     run; with one card the phase says that arm needs a second card (the
     cross-device code is held on a card-and-CPU mesh by tests/
     test_torch_cuda.py::test_tp2_replica_on_a_card_and_the_cpu). One
     tp_sp_phase JSON line.
 15. several processes (word2vec_tpu_torch/parallel/multihost.py): two
     processes on the one card, started as `chip_smoke.py --mp-child SPEC`
     under the W2V_* contract (W2V_COORDINATOR a fresh localhost port),
     the tables gathered over gloo through host memory (the recorded
     backend), phase 5's tokens in whole rows of L split into two
     equal-row shards (equal words a step on both ranks, so the alpha
     schedules agree). (a) Arm A, pallas_fused/unified, dp 2 (one replica
     a process), dp_sync_every 8, mean, 32 global steps; arm B, xla/split,
     dp 4 x tp 2 (two replicas a process, each two shards on the card),
     delta, 16 global steps: each arm's export bitwise the one-process run
     of the same mesh on the card fed the same global steps (each rank's
     batches in rank order), launches exact on both ranks, the loss falls.
     (b) Rank 0's one eager flagship step: every fused_slab_scatter,
     ordered_row_sum and find_runs call bitwise its plain version,
     fused_grad_core within TOL. (c) Through the CLI (--multihost --dp 2,
     chunk 8, a checkpoint every 8): sigterm@10 on rank 1 stops both ranks
     at the agreed step 16, exit 75 each; --resume from it ends bitwise
     equal to the uninterrupted run (vectors and state.npz). (d)
     peer_dead@10 on rank 1 under --step-deadline and --sync-deadline 10:
     rank 0 exits 75 or 76 within the deadlines. (e) Host-clock ms of a
     cross-process sync of arm A's tables per mode, split into staging
     out (d2h), the gather and staging in (h2d), beside its host-link
     bound (each process's replica out and the other's in over the card's
     PCIe Gen5 x16 at 64 GB/s a direction); the heartbeat and the metrics
     gather; words/sec of arm A against the one-process dp-2 run (A B).
     (f) With two or more cards arm A with one card a
     rank, over NCCL, bitwise equal to (a); with one card the phase says
     that arm needs a second card and records what NCCL says to two ranks
     on one card. One multiproc_phase JSON line.
 16. elastic training (word2vec_tpu_torch/resilience/elastic.py, policy.py,
     parallel/coordservice.py): three CLI processes on the one card, each
     `chip_smoke.py --el-child DIR -- <cli arguments>` (the CLI in process
     with the drill's instruments; each exec keeps the prefix) in its own
     process group, --multihost --dp 3 --elastic ... --sync-deadline 10
     --checkpoint-every 16 --compile-cache, pallas_fused/unified, f32
     tables, chunk 8, dp_sync_every 8, phase 5's tokens in whole rows, 8
     batches a rank (an epoch is 8 global steps), 8 epochs. (a)
     shrink+grow: peer_rejoin@16 on rank 2 shrinks the fleet to 2
     (generation 1); rank 2 is started again (kept warm, its imports done)
     and announces once generation 1 passed its first boundary; it is
     admitted at a sync boundary (generation 2, world 3). (b) rank0_dead@16:
     the survivors elect old rank 1, which hosts the round and becomes rank
     0 of generation 1 (world 2). (c) --elastic-policy (a throughput shrink
     rule and a grow rule, cooldown 3, 16-step signal windows) with 1.5 s
     stalls injected on rank 2 at 32, 40, 48 and 56, 24 epochs: a
     zero-failure policy shrink evicting rank 2 (it execs announce-only
     and parks), then a policy-gated grow re-admitting it.
     Every leg: exit 0 on every live rank (no 75/76), the manifest's
     generations, triggers, elastic_generation and remesh / election
     records, the counters in the metrics log; every generation g >= 1
     BITWISE a fresh fleet of its shape (the members' shards, no --elastic)
     resumed from <dir>.elastic_g<g> and fed the same global steps (the
     last generation's final checkpoint and vectors; an earlier one's
     checkpoint at the next snapshot's step, the fresh fleet stopped there
     by a SIGTERM); launches exact per rank per generation (its steps plus
     one capture's warm-up), one capture a generation, no nvcc after
     generation 0, no socket of an old image in the new one; rank 0 of a
     generation after a remesh records one flagship step (after its
     training, its launches not counted): the scatters, row sums and run
     lists bitwise their plain versions, fused_grad_core within TOL. The
     blackout of each transition, from the kill (or the boundary) to the
     next generation's first dispatch boundary, in parts (the old image's
     handoff: detection, the boundary checkpoint, the round, the snapshot,
     the exec; the new rank 0's start-up marks: interpreter and torch
     import, elastic startup, shepherd, the wait for the store,
     process-group init, checkpoint load, corpus, trainer and import, the
     captures, the first dispatch); words/sec of each generation between
     its first and last boundary; the card's memory (mem_get_info, all
     processes) before the kill and after each generation's first
     boundary. One elastic_phase JSON line.
The line before the card line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# flagship geometry
V, D, B, L, W, K, KP = 71000, 300, 256, 192, 5, 5, 64
STEPS = 30
# the flagship trainer runs: (band_backend, table_layout); the first is the
# JAX package's default and the one whose vectors are exported
ROUTES = [("xla", "split"), ("pallas_oa", "split"), ("pallas", "split"),
          ("pallas_fused", "unified")]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device ms of fn() over reps runs, each timed with CUDA events.
    Before each run a spin kernel (torch.cuda._sleep, ~0.5 ms) keeps the
    device busy while the host enqueues the events and fn's launches, so
    a call whose host side is slower than its kernels is timed by its
    kernels, not by the Python that launches them (a call that enqueues
    more than the spin covers, like the plain versions' loops, still
    counts its host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def expected_launches(backend: str, layout: str, steps: int,
                      replicas: int = 1, warmups: int = 0) -> dict:
    """Kernel launches of `steps` flagship trainer steps on one route
    (global steps of `replicas` data-parallel replicas, each running the
    route's step once a global step; plus `warmups` eager capture warm-up
    steps, one a captured graph). The
    flagship config keeps the defaults clip_row_update=1.0 (the row trust
    region: one ordered row sum for the in table, two for the out table's
    positive and negative contributions) and scatter_mean=False (which
    would add three more); the tables take one ordered scatter each on
    split tables plus the negative tail, or one doubled-width scatter plus
    the tail on the unified slab; each sorted id array gets its run list
    once."""
    from word2vec_tpu_torch.ops.launch import LAUNCHES

    per = {k: 0 for k in LAUNCHES}
    per["ordered_row_sum"] = 3
    per["fused_slab_scatter"] = 2 if layout == "unified" else 3
    # one run list per distinct sorted id array: the token ids (both
    # token-order sides) and the negative ids; pallas scatters its context
    # side from slab space, a third array
    per["find_runs"] = 3 if backend == "pallas" else 2
    kernel = {"pallas_fused": "fused_grad_core", "pallas_oa": "overlap_add_slabs",
              "pallas": "band_core"}.get(backend)
    if kernel:
        per[kernel] = 1
    return {k: v * (steps * replicas + warmups) for k, v in per.items()}


# ------------------------------------------------------------ inputs
def zipf_p():
    ranks = np.arange(1, V + 1, dtype=np.float64)
    return (1.0 / ranks) / np.sum(1.0 / ranks)


def grad_inputs(dev, table_dtype, seed=0):
    from word2vec_tpu_torch.ops import banded

    rng = np.random.default_rng(seed)
    p = zipf_p()
    toks = rng.choice(V, size=(B, L), p=p).astype(np.int32)
    lens = rng.integers(L // 2, L + 1, size=B)
    for r in range(B):  # ragged rows: -1 padding past each row's end
        toks[r, lens[r]:] = -1
    emb = np.stack(
        [
            rng.uniform(-0.5, 0.5, size=(V, D)) / D,
            rng.normal(0.0, 0.05, size=(V, D)),
        ],
        axis=1,
    ).astype(np.float32)
    tokens = torch.from_numpy(toks).to(dev)
    S = banded.resolve_chunk(L, W, 0)
    C, _ = banded._geom(L, W, S)
    valid = tokens >= 0
    tok = torch.where(valid, tokens, 0)
    keep = valid & torch.from_numpy(rng.random((B, L)) < 0.8).to(dev)
    w_eff = torch.from_numpy(
        W - rng.integers(0, W, size=(B, L)).astype(np.int32)
    ).to(dev)
    pad = C * S - L
    pad2 = torch.nn.functional.pad
    return dict(
        tokens=tokens,
        emb=torch.from_numpy(emb).to(dev).to(table_dtype).contiguous(),
        tok_c=pad2(tok, (0, pad)).reshape(B, C, S).contiguous(),
        tok_k=banded.slab_token_ids(tokens, W, S).contiguous(),
        keep_c=pad2(keep.float(), (0, pad)).reshape(B, C, S).contiguous(),
        w_c=pad2(w_eff.float(), (0, pad)).reshape(B, C, S).contiguous(),
        negs=torch.from_numpy(
            rng.choice(V, size=(B, KP), p=p).astype(np.int32)
        ).to(dev),
        alpha=0.025,
    )


# odd shapes of the band cores' tiling (d, KP, W, S, L, B): S never a
# multiple of the 16-row mma tile, L never a multiple of S, d and KP off
# the tile too; tests/test_torch_band_tiles.py emulates the kernels' tiling
# at the same shapes on the CPU
ODD_SHAPES = {
    "d7-kp8-w1": (7, 8, 1, 13, 30, 3),
    "d64-kp64-w5": (64, 64, 5, 21, 50, 3),
    "d300-kp100-w5": (300, 100, 5, 19, 45, 2),
    "d300-kp64-w5-flagship-chunk": (300, 64, 5, 118, 192, 2),
    "d64-kp100-w1": (64, 100, 1, 10, 27, 4),
}


def _small_tokens(rng, V_, B_, L_):
    tokens = rng.integers(0, V_, size=(B_, L_)).astype(np.int32)
    tokens[B_ - 1, L_ // 2 + 1:] = -1  # a ragged row
    if B_ > 2:
        tokens[1, 3:] = -1
    return torch.from_numpy(tokens)


def small_grad_inputs(*, V, d, B, L, W, S, KP, table, seed=0):
    """fused_grad_core's inputs at a small shape, on the CPU: a [V, 2, d]
    slab, ragged rows, a negative that collides with row 0's tokens."""
    from word2vec_tpu_torch.ops import banded

    rng = np.random.default_rng(seed)
    C, _ = banded._geom(L, W, S)
    tokens = _small_tokens(rng, V, B, L)
    tok = torch.where(tokens >= 0, tokens, 0)
    pad = C * S - L
    keep = torch.from_numpy(rng.random((B, L)) < 0.8) & (tokens >= 0)
    w_eff = torch.from_numpy(rng.integers(1, W + 1, size=(B, L)).astype(np.float32))
    negs = torch.from_numpy(rng.integers(0, V, size=(B, KP)).astype(np.int32))
    negs[0, :3] = tokens[0, 2:5]
    P = torch.nn.functional.pad
    emb = np.stack([rng.uniform(-0.5, 0.5, size=(V, d)),
                    rng.normal(0, 0.5, size=(V, d))], axis=1).astype(np.float32)
    return dict(
        emb=torch.from_numpy(emb).to(table),
        tok_c=P(tok, (0, pad)).reshape(B, C, S).contiguous(),
        tok_k=banded.slab_token_ids(tokens, W, S).contiguous(),
        keep_c=P(keep.float(), (0, pad)).reshape(B, C, S).contiguous(),
        w_c=P(w_eff, (0, pad)).reshape(B, C, S).contiguous(),
        negs=negs,
    )


def small_core_inputs(*, V, d, B, L, W, S, KP, table, scope, model, seed=1):
    """band_core's inputs at a small shape, on the CPU, as the pallas route
    gathers them (raw -1-padded center ids)."""
    from word2vec_tpu_torch.ops import banded

    rng = np.random.default_rng(seed)
    C, P = banded._geom(L, W, S)
    tokens = _small_tokens(rng, V, B, L)
    tok = torch.where(tokens >= 0, tokens, 0).long()
    pad = C * S - L
    keep = torch.from_numpy(rng.random((B, L)) < 0.8) & (tokens >= 0)
    w_eff = torch.from_numpy(rng.integers(1, W + 1, size=(B, L)).astype(np.float32))
    tab = torch.from_numpy(rng.normal(0, 0.5, size=(2, V, d)).astype(np.float32))
    tab = tab.to(table)
    ctr, ctx = (tab[1], tab[0]) if model == "cbow" else (tab[0], tab[1])
    nb = B if scope == "row" else 1
    negs = torch.from_numpy(rng.integers(0, V, size=(nb, KP)).astype(np.int32))
    negs[0, :3] = tokens[0, 2:5]
    P2 = torch.nn.functional.pad
    return dict(
        a=banded._pad_rows(ctr[tok], C * S).reshape(B, C, S, d).contiguous(),
        bk=banded._slabs(banded._pad_ctx(ctx[tok], W, P), C, S, 2 * W).contiguous(),
        en=tab[1][negs.long()].contiguous(),
        tok_c=P2(tokens, (0, pad), value=-1).reshape(B, C, S).contiguous(),
        tok_k=banded.slab_token_ids(tokens, W, S).contiguous(),
        keep_c=P2(keep.float(), (0, pad)).reshape(B, C, S).contiguous(),
        w_c=P2(w_eff, (0, pad)).reshape(B, C, S).contiguous(),
        negs=negs,
    )


GRAD_ORDER = ("emb", "tok_c", "tok_k", "keep_c", "w_c", "negs")
CORE_ORDER = ("a", "bk", "en", "tok_c", "tok_k", "keep_c", "w_c", "negs")


def core_inputs(inp, model, scope):
    """band_core's inputs as the pallas route builds them
    (ops/band_step.py _apply_pallas) from grad_inputs' slab: center rows
    and context slabs gathered from the two planes, raw -1-padded ids."""
    from word2vec_tpu_torch.ops import banded

    emb, tokens = inp["emb"], inp["tokens"]
    S = banded.resolve_chunk(L, W, 0)
    C, P = banded._geom(L, W, S)
    tok = torch.where(tokens >= 0, tokens, 0).long()
    ctr, ctx = (1, 0) if model == "cbow" else (0, 1)
    negs = inp["negs"] if scope == "row" else inp["negs"][:1]
    return (
        banded._pad_rows(emb[tok, ctr], C * S).reshape(B, C, S, D).contiguous(),
        banded._slabs(banded._pad_ctx(emb[tok, ctx], W, P), C, S, 2 * W).contiguous(),
        emb[negs.long(), 1].contiguous(),
        torch.nn.functional.pad(tokens, (0, C * S - L), value=-1)
        .reshape(B, C, S).contiguous(),
        inp["tok_k"], inp["keep_c"], inp["w_c"], negs.contiguous(),
        inp["alpha"],
    )


def band_flops(tok_k, keep_c, w_c, centers, is_cbow, dneg_rows):
    """The contractions this data needs: the negative logits and d_hid at
    KP columns per center, d_neg over `dneg_rows` positions, and the band
    logits, the center-side and the context-side band products over the
    masked pairs only (2 operations a multiply-add)."""
    from word2vec_tpu_torch.ops import banded

    S = keep_c.shape[2]
    dist = torch.as_tensor(banded.band_dist(L, W, S), device=tok_k.device)
    mask = (
        (keep_c > 0)[..., None] & (tok_k >= 0)[:, :, None, :]
        & (dist <= w_c[..., None]) & (dist > 0)
    )
    pairs = int(mask.sum())
    return 2 * D * (
        2 * centers * KP + dneg_rows * KP + 3 * pairs
        + (centers if is_cbow else 0)
    )


def grad_bound(inp, cdt, is_cbow):
    """(bound ms, bound_by) of one fused_grad_core call on these inputs:
    each distinct table row the data needs read once, the index and weight
    inputs read once, every output written once; the contractions this
    data needs at the compute type's peak."""
    emb, tok_c, tok_k, negs = inp["emb"], inp["tok_c"], inp["tok_k"], inp["negs"]
    es = emb.element_size()
    Bc, C, S = tok_c.shape
    n_ctr = torch.unique(tok_c).numel()
    n_ctx = torch.unique(tok_k[tok_k >= 0]).numel()
    n_neg = torch.unique(negs).numel()
    nbytes = (
        (n_ctr * 2 * D + n_ctx * D + n_neg * D) * es
        + 4 * (tok_c.numel() * 3 + tok_k.numel() + negs.numel())
        + 4 * (2 * Bc * C * S * D + 2 * Bc * C * S + Bc * KP * D + Bc * KP + 2)
    )
    flops = band_flops(tok_k, inp["keep_c"], inp["w_c"], Bc * C * S, is_cbow, Bc * L)
    return bound_ms(nbytes, flops, PEAK_FLOPS[cdt])


def core_bound(args, cdt, is_cbow):
    """(bound ms, bound_by) of one band_core call: its gathered inputs
    (a, bk, en in the table dtype, the ids and weights) read once, every
    output written once; the contractions as band_flops counts them."""
    a, bk, en, tok_c, tok_k, keep_c, w_c, negs, _ = args
    Bc, C, S, d = a.shape
    SK = bk.shape[2]
    NB = negs.shape[0]
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (a, bk, en, tok_c, tok_k, keep_c, w_c, negs))
    out_bytes = 4 * (Bc * C * S * d + Bc * C * SK * d + NB * KP * d
                     + Bc * C * S + Bc * C * SK + NB * KP + 2)
    flops = band_flops(tok_k, keep_c, w_c, Bc * C * S, is_cbow, Bc * C * S)
    return bound_ms(in_bytes + out_bytes, flops, PEAK_FLOPS[cdt])


def scatter_inputs(dev, table_dtype, seed=1):
    rng = np.random.default_rng(seed)
    p = zipf_p()
    n = B * L
    idx = np.sort(rng.choice(V, size=n, p=p)).astype(np.int32)
    idx[:7] = -1  # padding ids are skipped
    emb = rng.normal(0.0, 0.1, size=(V, 2, D)).astype(np.float32)
    vals = rng.normal(0.0, 1e-3, size=(n, 2, D)).astype(np.float32)
    negs = np.sort(rng.choice(V, size=B * KP, p=p)).astype(np.int32)
    vneg = rng.normal(0.0, 1e-3, size=(B * KP, D)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(
        emb=t(emb).to(table_dtype).contiguous(),
        idx=t(idx),
        vals=t(vals).to(table_dtype).contiguous(),
        negs=t(negs),
        vneg=t(vneg).to(table_dtype).contiguous(),
    )


def scatter_bound(idx, vals):
    es = vals.element_size()
    width = vals[0].numel()
    live = idx[idx >= 0]
    rows = torch.unique(live).numel()
    nbytes = vals.numel() * es + idx.numel() * 4 + 2 * rows * width * es
    return bound_ms(nbytes, live.numel() * width, PEAK_FLOPS[torch.float32])


def row_sum_inputs(dev, seed=3):
    """A flagship batch's sorted token ids (the clip budget's in-table
    call) with per-update norms spanning eight decades, and an unsorted
    negative-draw contribution."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(V, size=B * L, p=zipf_p())).astype(np.int32)
    vals = (rng.random(B * L) * 10.0 ** rng.uniform(-4, 4, size=B * L)).astype(np.float32)
    i2 = rng.choice(V, size=B * KP, p=zipf_p()).astype(np.int32)
    v2 = rng.random(B * KP).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(idx), t(vals), t(i2), t(v2)


def trainer_ids(tokens):
    """The sorted token ids a step's tail scatters: -1 padding mapped to
    row 0 as the step's gate does, stably sorted."""
    flat = torch.where(tokens >= 0, tokens, 0).reshape(-1)
    return torch.sort(flat, stable=True).values.to(torch.int32).contiguous()


def slab_ids(tokens):
    """The pallas route's slab-space ids: invalid slots mapped to row 0."""
    from word2vec_tpu_torch.ops import banded

    S = banded.resolve_chunk(L, W, 0)
    k = banded.slab_token_ids(tokens, W, S).reshape(-1)
    return torch.sort(torch.where(k >= 0, k, 0), stable=True).values.to(
        torch.int32).contiguous()


def adversarial_ids(dev, seed=8):
    """Named sorted id sets over the flagship vocabulary, one per edge of
    the ordered sums' work split: one run, all distinct, a -1 prefix,
    runs one below, at and one above the long-run threshold and each
    stage size (read from the built kernels), and a flagship batch's ids
    with ragged rows padded to row 0 (grad_inputs' tokens)."""
    from word2vec_tpu_torch import _build

    rng = np.random.default_rng(seed)
    lr = _build.library("runs").w2v_long_run()
    st = _build.library("fused_step").w2v_scatter_stage_terms()
    rs = _build.library("row_sum").w2v_row_sum_stage()
    edges, row = [], 1
    for n in (lr - 1, lr, lr + 1, st - 1, st, st + 1, 2 * st + 1,
              rs - 1, rs, rs + 1, 2 * rs + 1):
        edges += [row] * n + [row + 1]
        row += 2 + int(rng.integers(0, 3))
    sets = {
        "one_run": np.full(8192, 11),
        "distinct": rng.choice(V, size=20000, replace=False),
        "neg_prefix": np.concatenate(
            [np.full(64, -1), rng.choice(V, size=20000, p=zipf_p())]),
        "edges": np.asarray(edges),
    }
    out = {k: torch.from_numpy(np.sort(v).astype(np.int32)).to(dev)
           for k, v in sets.items()}
    out["trainer"] = trainer_ids(grad_inputs(dev, torch.float32)["tokens"])
    return out


def longest_run(idx) -> int:
    live = idx[idx >= 0]
    if live.numel() == 0:
        return 0
    return int(torch.unique_consecutive(live, return_counts=True)[1].max())


# dependent-add latency of one ordered term, in cycles: the FADD (4); in
# bf16 also the widening shift and the round back (counted as 4 more, a
# floor: the round alone is not faster)
CHAIN_CYCLES = {torch.float32: 4, torch.bfloat16: 8}


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi clocks failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# ------------------------------------------------------------ phases
def rel_err(k, p):
    k, p = k.double(), p.double()
    return float((k - p).abs().max()), float(
        (k - p).abs().max() / p.abs().max().clamp_min(1e-30)
    )


# tolerance on max|kernel - plain| / max|plain| per gradient output: f32
# compute differs only in summation order and FMA contraction; with bf16
# compute an intermediate (a gradient weight) that lands on a bf16
# rounding boundary in one version can round one bf16 ulp (2^-8) away in
# the other, so the bound is bf16-ulp class; losses 1e-4; masks exact
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


GRAD_NAMES = ("d_ctr", "d_ctx", "n_ctx", "ctx_w", "d_neg", "w_neg_sum", "losses")
CORE_NAMES = ("d_h", "d_ctx", "d_neg", "n_ctx", "ctx_w", "w_neg_sum", "losses")


def check_outputs(what, names, got, ref, cdt, quiet=False):
    """Log (unless quiet) and hold each output; return the worst abs error
    over the gradient outputs."""
    worst = 0.0
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"{what}: {name} shape {tuple(g.shape)} or non-finite values")
        ab, rel = rel_err(g, r)
        exact = name in ("n_ctx", "ctx_w")
        limit = 0.0 if exact else (1e-4 if name == "losses" else TOL[cdt])
        if not quiet:
            log(f"  {what} {name}: max_abs_err={ab:.3e} max_rel_err={rel:.3e} "
                f"(limit {limit:g})")
        if rel > limit:
            fail(f"{what} {name}: rel err {rel:.3e} > {limit:g}")
        if not exact and name != "losses":
            worst = max(worst, ab)
    return worst


def phase_kernels(dev):
    from word2vec_tpu_torch.ops import band_core as bc
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import overlap as ov
    from word2vec_tpu_torch.ops import train_step as ts

    errs = {}
    for model in ("sg", "cbow"):
        for cdt in (torch.bfloat16, torch.float32):
            inp = grad_inputs(dev, torch.float32)
            kw = dict(W=W, K=K, L=L, cdt=cdt, is_cbow=model == "cbow",
                      cbow_mean=True)
            args = (inp["emb"], inp["tok_c"], inp["tok_k"], inp["keep_c"],
                    inp["w_c"], inp["negs"], inp["alpha"])
            got = fs.fused_grad_core(*args, **kw)
            again = fs.fused_grad_core(*args, **kw)
            ref = fs.fused_grad_core_plain(*args, **kw)
            torch.cuda.synchronize()
            errs[("fused_grad_core", model, cdt)] = check_outputs(
                f"fused_grad_core {model} cdt={str(cdt)[6:]}", GRAD_NAMES,
                got, ref, cdt)
            same = same_bits(got, again)
            log(f"  fused_grad_core {model} cdt={str(cdt)[6:]}: two calls "
                f"bitwise_equal={same}")
            if not same:
                fail(f"fused_grad_core {model} {cdt}: two calls differ (bitwise)")
    inp = grad_inputs(dev, torch.float32)
    for model in ("sg", "cbow"):
        for scope in ("row", "batch"):
            args = core_inputs(inp, model, scope)
            for cdt in (torch.bfloat16, torch.float32):
                kw = dict(W=W, K=K, cdt=cdt, is_cbow=model == "cbow", cbow_mean=True)
                got = bc.band_core(*args, **kw)
                again = bc.band_core(*args, **kw)
                ref = bc.band_core_plain(*args, **kw)
                torch.cuda.synchronize()
                errs[("band_core", model, scope, cdt)] = check_outputs(
                    f"band_core {model} {scope} cdt={str(cdt)[6:]}", CORE_NAMES,
                    got, ref, cdt)
                same = same_bits(got, again)
                log(f"  band_core {model} {scope} cdt={str(cdt)[6:]}: two calls "
                    f"bitwise_equal={same}")
                if not same:
                    fail(f"band_core {model} {scope} {cdt}: two calls differ (bitwise)")
                if bool((got[1][args[4] < 0] != 0).any()):
                    fail("band_core: context gradient at an invalid slab slot")
    phase_odd_shapes(dev)
    for dt in (torch.float32, torch.bfloat16):
        sc = scatter_inputs(dev, dt)
        got = fs.fused_slab_scatter(sc["emb"].clone(), sc["idx"], sc["vals"])
        ref = fs.fused_slab_scatter_plain(sc["emb"].clone(), sc["idx"], sc["vals"])
        got = fs.fused_slab_scatter(got, sc["negs"], sc["vneg"], plane=1)
        ref = fs.fused_slab_scatter_plain(ref, sc["negs"], sc["vneg"], plane=1)
        torch.cuda.synchronize()
        same = torch.equal(bits(got), bits(ref))
        moved = not torch.equal(got, sc["emb"])
        log(f"  fused_slab_scatter {str(dt)[6:]}: bitwise_equal={same} "
            f"table_changed={moved}")
        if not (same and moved):
            fail(f"fused_slab_scatter {dt}: kernel != plain (bitwise)")
    # the overlap-add on a flagship slab-space gradient [256, 2, 128, 300]
    S = 118
    y = torch.randn((B, 2, S + 2 * W, D), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    got = ov.overlap_add_slabs(y, W, S)
    ref = ov.overlap_add_slabs_plain(y, W, S)
    torch.cuda.synchronize()
    same = got.shape == ref.shape and torch.equal(bits(got), bits(ref))
    log(f"  overlap_add_slabs [{B}, 2, {S + 2 * W}, {D}] f32: bitwise_equal={same}")
    if not same:
        fail("overlap_add_slabs: kernel != plain (bitwise)")
    # the ordered row sum: a sorted and an unsorted contribution, bitwise
    # against the plain version and across two runs
    idx, vals, i2, v2 = row_sum_inputs(dev)
    runs = []
    for _ in range(2):
        out = ts.ordered_row_sum(V, idx, vals, presorted=True)
        runs.append(ts.ordered_row_sum(V, i2, v2, out))
    o2 = torch.argsort(i2, stable=True)
    ref = ts.ordered_row_sum_plain(V, i2[o2], v2[o2],
                                   ts.ordered_row_sum_plain(V, idx, vals))
    torch.cuda.synchronize()
    same = torch.equal(bits(runs[0]), bits(ref))
    again = torch.equal(bits(runs[0]), bits(runs[1]))
    log(f"  ordered_row_sum [N={idx.numel()}+{i2.numel()}]: bitwise_equal={same} "
        f"repeatable={again}")
    if not (same and again):
        fail("ordered_row_sum: kernel != plain or not repeatable (bitwise)")
    phase_ordered_sets(dev)
    return errs


def same_bits(xs, ys) -> bool:
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(xs, ys))


def phase_odd_shapes(dev):
    """Both band cores with bf16 compute (the tensor-core bodies) at the
    odd shapes of ODD_SHAPES, sg and cbow, f32 and bf16 tables, band_core
    in row and batch scope: within TOL of the plain version, n_ctx / ctx_w
    exact, and two calls bitwise equal."""
    from word2vec_tpu_torch.ops import band_core as bc
    from word2vec_tpu_torch.ops import fused_step as fs

    cdt = torch.bfloat16
    for shape, (d, kp, w, s, l, b) in ODD_SHAPES.items():
        geo = dict(V=80, d=d, B=b, L=l, W=w, S=s, KP=kp)
        for model in ("sg", "cbow"):
            for table in (torch.float32, torch.bfloat16):
                tag = f"{shape} {model} {str(table)[6:]} tables"
                inp = small_grad_inputs(table=table, **geo)
                args = [inp[k].to(dev) for k in GRAD_ORDER]
                kw = dict(W=w, K=K, L=l, cdt=cdt, is_cbow=model == "cbow")
                got = fs.fused_grad_core(*args, 0.03, **kw)
                again = fs.fused_grad_core(*args, 0.03, **kw)
                ref = fs.fused_grad_core_plain(*args, 0.03, **kw)
                torch.cuda.synchronize()
                check_outputs(f"fused_grad_core {tag}", GRAD_NAMES, got, ref, cdt,
                              quiet=True)
                if not same_bits(got, again):
                    fail(f"fused_grad_core {tag}: two calls differ (bitwise)")
                for scope in ("row", "batch"):
                    inp = small_core_inputs(table=table, scope=scope, model=model,
                                            **geo)
                    args = [inp[k].to(dev) for k in CORE_ORDER]
                    kw = dict(W=w, K=K, cdt=cdt, is_cbow=model == "cbow")
                    got = bc.band_core(*args, 0.03, **kw)
                    again = bc.band_core(*args, 0.03, **kw)
                    ref = bc.band_core_plain(*args, 0.03, **kw)
                    torch.cuda.synchronize()
                    check_outputs(f"band_core {tag} {scope}", CORE_NAMES, got, ref,
                                  cdt, quiet=True)
                    if not same_bits(got, again):
                        fail(f"band_core {tag} {scope}: two calls differ (bitwise)")
        log(f"  odd shape {shape} (d={d} KP={kp} W={w} S={s} L={l} B={b}): both "
            "cores, sg/cbow, f32/bf16 tables, row/batch: within tolerance, "
            "repeatable bitwise")


def phase_ordered_sets(dev):
    """The run list, the slab scatter (whole doubled-width rows and the
    plane-1 tail, f32 and bf16 tables) and the ordered row sum on every
    adversarial id set at flagship width: bitwise vs the plain versions
    and across two runs; zero terms and -0.0 cells included."""
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import runs as rl
    from word2vec_tpu_torch.ops import train_step as ts

    gen = torch.Generator(device=dev).manual_seed(10)
    emb32 = torch.randn((V, 2, D), device=dev, generator=gen) * 0.1
    emb32[::3] = -0.0
    for name, idx in adversarial_ids(dev).items():
        n = idx.numel()
        runs = rl.find_runs(idx)
        got = rl.unpack_runs(runs, n)
        want = rl.unpack_runs(rl.find_runs_plain(idx), n)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"find_runs {name}: kernel != plain")
        v32 = torch.randn((n, 2, D), device=dev, generator=gen) * 1e-3
        v32[::5] = 0.0
        res = []
        for dt in (torch.float32, torch.bfloat16):
            emb, vals = emb32.to(dt), v32.to(dt)
            pv = vals[:, 1].contiguous()
            ref = fs.fused_slab_scatter_plain(emb.clone(), idx, vals)
            ref = fs.fused_slab_scatter_plain(ref, idx, pv, plane=1)
            outs = []
            for _ in range(2):
                g = fs.fused_slab_scatter(emb.clone(), idx, vals, runs=runs)
                outs.append(fs.fused_slab_scatter(g, idx, pv, plane=1))
            torch.cuda.synchronize()
            ok = all(torch.equal(bits(o), bits(ref)) for o in outs)
            res.append(f"{str(dt)[6:]}={ok}")
            if not ok or torch.equal(ref, emb):
                fail(f"fused_slab_scatter {name} {dt}: kernel != plain or "
                     "not repeatable (bitwise)")
        live = idx[idx >= 0].contiguous()
        rv = (torch.rand(live.numel(), device=dev, generator=gen)
              * 10.0 ** (8 * torch.rand(live.numel(), device=dev, generator=gen) - 4))
        rv[::7] = 0.0
        start = torch.randn(V, device=dev, generator=gen)
        start[::3] = -0.0
        ref = ts.ordered_row_sum_plain(V, live, rv, start.clone())
        outs = [ts.ordered_row_sum(V, live, rv, start.clone(), presorted=True)
                for _ in range(2)]
        torch.cuda.synchronize()
        ok = all(torch.equal(bits(o), bits(ref)) for o in outs)
        log(f"  ordered sums, {name} [N={n}, longest run {longest_run(idx)}]: "
            f"run list exact; scatter (2x{D} + plane 1) bitwise and repeatable "
            f"{' '.join(res)}; row sum bitwise and repeatable={ok}")
        if not ok:
            fail(f"ordered_row_sum {name}: kernel != plain or not repeatable")


def step_vs_cpu(dev, cfg, v, rows, rng, tag):
    """One step of `cfg`'s band route on `rows` x cfg.max_sentence_len
    tokens over a v-row vocabulary: the kernels on the card vs the plain
    versions on the CPU, the same params and draws (f32 compute: the two
    differ only in summation order). Params within 1e-6, loss_sum within
    1e-4 relative; returns the params' max abs error."""
    from word2vec_tpu_torch.data.negative import build_alias_table
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.models.params import FUSED_KEY
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.ops.train_step import Draws
    from word2vec_tpu_torch.ops.tables import DeviceTables

    d, Lc = cfg.word_dim, cfg.max_sentence_len
    counts = np.arange(2 * v, v, -1).astype(np.float64)
    at = build_alias_table(counts ** 0.75 / np.sum(counts ** 0.75))
    keep = rng.uniform(0.3, 1.0, size=v).astype(np.float32)

    def tables(dv):
        return DeviceTables(
            torch.as_tensor(keep, device=dv),
            torch.as_tensor(at.accept, device=dv),
            torch.as_tensor(at.alias, device=dv),
        )

    toks = rng.integers(0, v, size=(rows, Lc)).astype(np.int32)
    toks[3, (5 * Lc) // 8:] = -1
    emb = np.stack([rng.uniform(-0.5, 0.5, (v, d)) / d,
                    rng.normal(0, 0.05, (v, d))], axis=1).astype(np.float32)

    def params(dv):
        t = torch.from_numpy(emb.copy()).to(dv)
        if cfg.table_layout == "unified":
            return {FUSED_KEY: t}
        return {"emb_in": t[:, 0].contiguous(),
                "emb_out_ns": t[:, 1].contiguous()}

    cpu = torch.device("cpu")
    step_cpu = BandStep(cfg, tables(cpu))
    step_gpu = BandStep(cfg, tables(dev))
    tok_cpu = torch.from_numpy(toks)
    dr = step_cpu.draw(generator(cpu, 3), tok_cpu)
    p_cpu, p_gpu, start = params(cpu), params(dev), params(cpu)
    m_cpu = step_cpu.apply(p_cpu, tok_cpu, dr, 0.03)
    m_gpu = step_gpu.apply(
        p_gpu, tok_cpu.to(dev),
        Draws(dr.u_sub.to(dev), dr.w_eff.to(dev), dr.negs.to(dev)), 0.03,
    )
    torch.cuda.synchronize()
    err = max(float((p_gpu[k].cpu() - p_cpu[k]).abs().max()) for k in p_cpu)
    moved = max(float((p_cpu[k] - start[k]).abs().max()) for k in p_cpu)
    lerr = abs(float(m_gpu["loss_sum"]) - float(m_cpu["loss_sum"]))
    log(f"  {tag}: params max_abs_err={err:.3e} (update max {moved:.3e}), "
        f"loss_sum err={lerr:.3e}")
    if not (err <= 1e-6 and moved > 1e-4):
        fail(f"{tag}: GPU step disagrees with the CPU step")
    if lerr > 1e-4 * abs(float(m_cpu["loss_sum"])):
        fail(f"{tag}: loss_sum disagrees")
    return err


def phase_small_step(dev):
    """One step per route, kernels on the card vs plain versions on the CPU,
    same params and draws (small shape, f32 compute)."""
    from word2vec_tpu_torch.config import Word2VecConfig

    rng = np.random.default_rng(5)
    cases = [
        ("pallas_fused", "unified", "sg", "row"),
        ("pallas_fused", "unified", "cbow", "row"),
        ("xla", "split", "sg", "row"),
        ("xla", "split", "cbow", "batch"),
        ("pallas_oa", "split", "sg", "batch"),
        ("pallas_oa", "split", "cbow", "row"),
        ("pallas", "split", "sg", "row"),
        ("pallas", "split", "cbow", "batch"),
        ("xla", "unified", "sg", "row"),
    ]
    for backend, layout, model, scope in cases:
        cfg = Word2VecConfig(
            model=model, negative=3, word_dim=64, window=3, min_count=1,
            compute_dtype="float32", shared_negatives=8, max_sentence_len=40,
            band_chunk=10, table_layout=layout, band_backend=backend,
            negative_scope=scope, scatter_mean=True,
        )
        step_vs_cpu(dev, cfg, 500, 8, rng,
                    f"small step {backend}/{layout} {model} {scope}")


def flagship_corpus():
    from word2vec_tpu_torch import PackedCorpus
    from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab

    t0 = time.perf_counter()
    vocab = zipf_vocab(V)
    n_tok = (STEPS + 1) * B * L
    corpus = PackedCorpus.pack(
        zipf_corpus_ids(vocab, n_tok, seed=0, sentence_len=1000), L
    )
    log(f"  corpus: V={len(vocab)} tokens={corpus.num_tokens} rows="
        f"{corpus.num_rows} ({time.perf_counter() - t0:.1f} s to make)")
    return vocab, corpus


def flagship_cfg(backend, layout, **over):
    """The flagship trainer config on one route."""
    from word2vec_tpu_torch import Word2VecConfig

    return Word2VecConfig(
        model="sg", train_method="ns", negative=K, word_dim=D, window=W,
        batch_rows=B, max_sentence_len=L, shared_negatives=KP,
        negative_scope="row", table_layout=layout, band_backend=backend,
        min_count=5, **over,
    )


def phase_trainer(dev, vocab, corpus, backend, layout, out_dir=None):
    from word2vec_tpu_torch import Trainer, export_matrix
    from word2vec_tpu_torch.io.embeddings import (
        load_embeddings_binary, save_embeddings_binary,
    )
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts

    cfg = flagship_cfg(backend, layout)
    tr = Trainer(cfg, vocab, corpus)  # device defaults to cuda
    tr.train(log_every=0, max_steps=3)  # warm-up (allocator, libraries)
    reset_launch_counts()
    state, rep = tr.train(log_every=5, max_steps=STEPS)
    counts = dict(LAUNCHES)
    hist = rep.loss_history
    log(f"  trainer {backend}/{layout}: steps={rep.steps} words={rep.total_words} "
        f"wall={rep.wall_time:.3f} s words/sec={rep.words_per_sec:.1f} "
        f"loss_history={hist}")
    log(f"  launches {backend}/{layout}: {counts}")
    if rep.steps != STEPS:
        fail(f"trainer {backend} ran {rep.steps} steps, expected {STEPS}")
    if not (hist and all(np.isfinite(hist))):
        fail(f"trainer {backend}: non-finite loss history {hist}")
    if not hist[-1] < hist[0]:
        fail(f"trainer {backend}: loss did not fall: {hist}")
    want = expected_launches(backend, layout, STEPS)
    if counts != want:
        fail(f"trainer {backend}/{layout}: launch counts {counts} != {want}")
    if out_dir is not None:
        mat = export_matrix(state.params, cfg).float().cpu().numpy()
        if mat.shape != (len(vocab), D) or not np.isfinite(mat).all():
            fail(f"export: shape {mat.shape} or non-finite values")
        path = os.path.join(out_dir, "vectors.bin")
        save_embeddings_binary(path, vocab.words, mat)
        words, back = load_embeddings_binary(path)
        if words != vocab.words or not np.array_equal(back, mat):
            fail("saved vectors do not load back")
        log(f"  export: {mat.shape} saved and reloaded")
    return counts, rep


def corpus_batch(dev, corpus):
    """The flagship corpus's first batch [B, L] (int32, -1 padding)."""
    from word2vec_tpu_torch.data.batcher import BatchIterator

    batch, _ = next(iter(BatchIterator(corpus, B, L, seed=0).epoch(0)))
    return torch.from_numpy(batch).to(dev)


def phase_repeat(dev, vocab, corpus):
    """Two runs of one flagship step on the default route (xla, split
    tables) from the same params, tokens and draws: bitwise-equal tables
    and metrics (every per-row sum and table update adds in a fixed
    order)."""
    from word2vec_tpu_torch import Word2VecConfig
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.ops.tables import DeviceTables

    cfg = Word2VecConfig(
        model="sg", train_method="ns", negative=K, word_dim=D, window=W,
        batch_rows=B, max_sentence_len=L, shared_negatives=KP, min_count=5,
    )
    step = BandStep(cfg, DeviceTables.build(vocab, cfg, dev))
    tokens = corpus_batch(dev, corpus)
    draws = step.draw(torch.Generator(device=dev).manual_seed(9), tokens)
    emb = grad_inputs(dev, torch.float32)["emb"]
    outs = []
    for _ in range(2):
        params = {"emb_in": emb[:, 0].contiguous(),
                  "emb_out_ns": emb[:, 1].contiguous()}
        metrics = step.apply(params, tokens, draws, 0.025)
        torch.cuda.synchronize()
        outs.append((params, metrics))
    (p0, m0), (p1, m1) = outs
    same = all(torch.equal(bits(p0[k]), bits(p1[k])) for k in p0) and all(
        torch.equal(bits(m0[k]), bits(m1[k])) for k in m0)
    moved = not torch.equal(p0["emb_out_ns"], emb[:, 1])
    log(f"  repeat flagship xla/split step: bitwise_equal={same} "
        f"table_changed={moved} clip_engaged={float(m0['clip_engaged']):.0f}")
    if not (same and moved):
        fail("two runs of one flagship step differ (bitwise)")


def phase_cores(dev, card, clock):
    """Device time and per-phase cycle split of both band cores at the
    flagship (f32 tables; band_core in row scope), sg and cbow, bf16 and
    f32 compute: the split is the mean over the B blocks of each phase's
    clock64() cycles (csrc/band_tiles.cuh PhaseClock), as a share of the
    block's cycles and in microseconds at the max SM clock."""
    from word2vec_tpu_torch.ops import band_core as bc
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops.launch import CORE_PHASES

    inp = grad_inputs(dev, torch.float32)
    rows = []
    for model in ("sg", "cbow"):
        gargs = (inp["emb"], inp["tok_c"], inp["tok_k"], inp["keep_c"],
                 inp["w_c"], inp["negs"], inp["alpha"])
        cargs = core_inputs(inp, model, "row")
        for cdt in (torch.bfloat16, torch.float32):
            calls = {
                "fused_grad_core": lambda rec=None: fs.fused_grad_core(
                    *gargs, W=W, K=K, L=L, cdt=cdt, is_cbow=model == "cbow",
                    phase_cycles=rec),
                "band_core": lambda rec=None: bc.band_core(
                    *cargs, W=W, K=K, cdt=cdt, is_cbow=model == "cbow",
                    phase_cycles=rec),
            }
            for name, call in calls.items():
                ms = cuda_ms(call, reps=10)
                rec = torch.zeros((B, len(CORE_PHASES)), dtype=torch.int64,
                                  device=dev)
                call(rec)
                torch.cuda.synchronize()
                per = rec.double().mean(0)
                total = float(per.sum())
                split = {p: float(v) / total for p, v in zip(CORE_PHASES, per)}
                rows.append({
                    "kernel": name, "model": model, "cdt": str(cdt)[6:], "ms": ms,
                    "block_cycles": total, "block_us": total / clock * 1e6,
                    "split": split,
                })
                log(f"  {name} {model} cdt={str(cdt)[6:]}: {ms:.4f} ms; one block "
                    f"{total:.0f} cycles ({total / clock * 1e6:.1f} us at max clock): "
                    + " ".join(f"{p} {100 * v:.1f}%" for p, v in split.items())
                    + f" ({card})")
    log(json.dumps({"core_phases": rows, "card": card}))
    return rows


def phase_times(dev, errs, counts, tokens):
    """Times at the flagship shapes; `tokens` is one batch of the flagship
    corpus (the real step's ids for the ordered sums)."""
    from word2vec_tpu_torch.ops import band_core as bc
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import overlap as ov
    from word2vec_tpu_torch.ops import runs as rl
    from word2vec_tpu_torch.ops import train_step as ts

    kernels = []

    def entry(name, source, replaces, route, err, ms, plain, bms, by, lib):
        n = counts[route][name]
        log(f"  {name}: {ms:.4f} ms, plain {plain:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms "
            f"({by}); {n} launches in the {route[0]}/{route[1]} trainer run")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"word2vec_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
        })

    inp = grad_inputs(dev, torch.float32)
    kw = dict(W=W, K=K, L=L, cdt=torch.bfloat16, is_cbow=False, cbow_mean=True)
    args = (inp["emb"], inp["tok_c"], inp["tok_k"], inp["keep_c"],
            inp["w_c"], inp["negs"], inp["alpha"])
    ms = cuda_ms(lambda: fs.fused_grad_core(*args, **kw), reps=20)
    plain = cuda_ms(lambda: fs.fused_grad_core_plain(*args, **kw), reps=5)
    bms, by = grad_bound(inp, torch.bfloat16, False)
    log("  (fused_grad_core sg, f32 tables, bf16 compute)")
    entry("fused_grad_core", "fused_step.cu", "word2vec_tpu/ops/pallas_step.py:401",
          ("pallas_fused", "unified"),
          errs[("fused_grad_core", "sg", torch.bfloat16)], ms, plain, bms, by, None)

    # the slab scatter at every call shape the step makes, each beside
    # index_add_ and both bounds; the run lists are built before timing
    # (find_runs is timed on its own below)
    card, clock = card_line(), sm_clock_hz()
    sc = scatter_inputs(dev, torch.float32)
    emb, idx, vals = sc["emb"], sc["idx"], sc["vals"]
    emb_in = emb[:, 0].contiguous()
    ids_batch = trainer_ids(tokens)
    ids_slab = slab_ids(tokens)
    ids_ragged = trainer_ids(grad_inputs(dev, torch.float32)["tokens"])
    g = torch.Generator(device=dev).manual_seed(11)
    calls = [
        ("unified [N, 2x300] (xla/pallas_fused, unified slab)", emb, idx, vals, None),
        ("unified bf16 [N, 2x300]", emb.to(torch.bfloat16), idx,
         vals.to(torch.bfloat16), None),
        ("split in/out [N, 300] (xla, pallas_oa)", emb_in, idx,
         vals[:, 0].contiguous(), None),
        ("split neg [B*KP, 300] (every split route)", emb_in, sc["negs"], sc["vneg"], None),
        ("trainer batch in/out [N, 300] (real step ids, padding on row 0)",
         emb_in, ids_batch, torch.randn((ids_batch.numel(), D), device=dev,
                                        generator=g) * 1e-3, None),
        ("ragged batch in/out [N, 300] (grad_inputs' rows, padding on row 0)",
         emb_in, ids_ragged, torch.randn((ids_ragged.numel(), D), device=dev,
                                         generator=g) * 1e-3, None),
        ("pallas slab side [B*C*(S+2W), 300] (invalid slots on row 0)",
         emb_in, ids_slab, torch.randn((ids_slab.numel(), D), device=dev,
                                       generator=g) * 1e-3, None),
    ]
    call_rows = []
    for label, e, ix, vv, plane in calls:
        runs = rl.find_runs(ix)
        k_ms = cuda_ms(lambda: fs.fused_slab_scatter(e, ix, vv, plane, runs=runs),
                       reps=20)
        live = ix >= 0
        rows = e.view(e.shape[0], -1)
        li, lv = ix[live].long(), vv[live].reshape(int(live.sum()), -1)
        lib = cuda_ms(lambda: rows.index_add_(0, li, lv), reps=20)
        b_bytes, _ = scatter_bound(ix, vv)
        longest = longest_run(ix)
        b_chain = longest * CHAIN_CYCLES[e.dtype] / clock * 1e3
        call_rows.append({
            "call": label, "n": ix.numel(), "width": vv[0].numel(),
            "dtype": str(e.dtype)[6:], "ms": k_ms, "index_add_ms": lib,
            "bytes_bound_ms": b_bytes, "chain_bound_ms": b_chain,
            "longest_run": longest,
        })
        log(f"  fused_slab_scatter {label}: {k_ms:.4f} ms, index_add_ {lib:.4f} ms, "
            f"bytes bound {b_bytes:.4f} ms, chain bound {b_chain:.4f} ms "
            f"(longest run {longest}) ({card})")
    u = call_rows[0]
    plain = cuda_ms(
        lambda: fs.fused_slab_scatter_plain(emb, idx, vals), reps=3, warmup=1
    )
    bms, by = ((u["bytes_bound_ms"], "bytes") if u["bytes_bound_ms"] >= u["chain_bound_ms"]
               else (u["chain_bound_ms"], "operations"))
    log(f"  (fused_slab_scatter entry: the unified doubled-width f32 call; "
        f"bound_by {by} = {'bytes' if by == 'bytes' else 'the longest run chain'})")
    entry("fused_slab_scatter", "fused_step.cu", "word2vec_tpu/ops/pallas_step.py:490",
          ("xla", "split"), 0.0, u["ms"], plain, bms, by, u["index_add_ms"])

    # the run list of the unified call's ids; torch.unique_consecutive
    # computes the same runs (with a host sync)
    ms = cuda_ms(lambda: rl.find_runs(idx), reps=20)
    plain = cuda_ms(lambda: rl.find_runs_plain(idx), reps=5)
    lib = cuda_ms(lambda: torch.unique_consecutive(idx, return_counts=True), reps=20)
    n_runs = int(torch.unique_consecutive(idx[idx >= 0]).numel())
    bms, by = bound_ms(4 * idx.numel() + 8 * n_runs + 16, idx.numel(),
                       PEAK_FLOPS[torch.float32])
    for label, ix in (("trainer batch", ids_batch), ("pallas slab side", ids_slab),
                      ("neg", sc["negs"])):
        log(f"  find_runs {label} [N={ix.numel()}]: "
            f"{cuda_ms(lambda: rl.find_runs(ix), reps=20):.4f} ms")
    log(f"  (find_runs on the unified call's {idx.numel()} ids, {n_runs} runs)")
    entry("find_runs", "runs.cu", "word2vec_tpu/ops/pallas_step.py:490",
          ("xla", "split"), 0.0, ms, plain, bms, by, lib)

    # the overlap-add on a flagship slab-space gradient; F.fold computes the
    # same sums (col2im) from the pre-permuted input
    S = 118
    C, SK = 2, S + 2 * W
    y = torch.randn((B, C, SK, D), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    yp = y.permute(0, 3, 2, 1).reshape(B, D * SK, C).contiguous()

    def lib_fold():
        return torch.nn.functional.fold(
            yp, output_size=(C * S + 2 * W, 1), kernel_size=(SK, 1), stride=(S, 1))

    ms = cuda_ms(lambda: ov.overlap_add_slabs(y, W, S), reps=20)
    plain = cuda_ms(lambda: ov.overlap_add_slabs_plain(y, W, S), reps=20)
    lib = cuda_ms(lib_fold, reps=20)
    folded = lib_fold()[:, :, W:W + C * S, 0].permute(0, 2, 1)
    fold_err = float((folded - ov.overlap_add_slabs(y, W, S)).abs().max())
    log(f"  (overlap_add_slabs f32 [{B}, {C}, {SK}, {D}]; F.fold vs the kernel: "
        f"max_abs_err={fold_err:.3e})")
    out_elems = B * C * S * D
    bms, by = bound_ms(4 * (y.numel() + out_elems), out_elems,
                       PEAK_FLOPS[torch.float32])
    entry("overlap_add_slabs", "overlap.cu", "word2vec_tpu/ops/pallas_overlap.py:108",
          ("pallas_oa", "split"), 0.0, ms, plain, bms, by, lib)

    cargs = core_inputs(inp, "sg", "row")
    ckw = dict(W=W, K=K, cdt=torch.bfloat16, is_cbow=False, cbow_mean=True)
    ms = cuda_ms(lambda: bc.band_core(*cargs, **ckw), reps=20)
    plain = cuda_ms(lambda: bc.band_core_plain(*cargs, **ckw), reps=3, warmup=1)
    bms, by = core_bound(cargs, torch.bfloat16, False)
    log("  (band_core sg, row scope, f32 tables, bf16 compute)")
    entry("band_core", "band_core.cu", "word2vec_tpu/ops/pallas_band.py:292",
          ("pallas", "split"),
          errs[("band_core", "sg", "row", torch.bfloat16)], ms, plain, bms, by, None)
    phase_cores(dev, card, clock)

    # the ordered row sum: synthetic flagship ids and the real step's ids
    out = torch.zeros(V, device=dev)
    idx, vals, _, _ = row_sum_inputs(dev)
    for label, ix in (("synthetic Zipf ids", idx), ("trainer batch", ids_batch),
                      ("ragged batch", ids_ragged), ("pallas slab side", ids_slab)):
        rv = vals[: ix.numel()] if ix.numel() <= vals.numel() else torch.rand(
            ix.numel(), device=dev, generator=g)
        runs = rl.find_runs(ix)
        k_ms = cuda_ms(lambda: ts.ordered_row_sum(V, ix, rv, out, presorted=True,
                                                  runs=runs), reps=20)
        li = ix.long()
        lib = cuda_ms(lambda: torch.zeros(V, device=dev).index_add_(0, li, rv), reps=20)
        rows = torch.unique(ix).numel()
        b_bytes, _ = bound_ms(8 * ix.numel() + 8 * rows, ix.numel(),
                              PEAK_FLOPS[torch.float32])
        longest = longest_run(ix)
        b_chain = longest * CHAIN_CYCLES[torch.float32] / clock * 1e3
        call_rows.append({
            "call": f"ordered_row_sum {label}", "n": ix.numel(), "width": 1,
            "dtype": "float32", "ms": k_ms, "index_add_ms": lib,
            "bytes_bound_ms": b_bytes, "chain_bound_ms": b_chain,
            "longest_run": longest,
        })
        log(f"  ordered_row_sum {label} [N={ix.numel()}]: {k_ms:.4f} ms, "
            f"index_add_ {lib:.4f} ms, bytes bound {b_bytes:.4f} ms, chain bound "
            f"{b_chain:.4f} ms (longest run {longest}) ({card})")
    r = call_rows[-4]
    plain = cuda_ms(lambda: ts.ordered_row_sum_plain(V, idx, vals), reps=3, warmup=1)
    bms, by = ((r["bytes_bound_ms"], "bytes") if r["bytes_bound_ms"] >= r["chain_bound_ms"]
               else (r["chain_bound_ms"], "operations"))
    log(f"  (ordered_row_sum entry: a flagship batch's {idx.numel()} sorted Zipf "
        f"ids; bound_by {by} = {'bytes' if by == 'bytes' else 'the longest run chain'})")
    entry("ordered_row_sum", "row_sum.cu", "word2vec_tpu/ops/train_step.py:88",
          ("xla", "split"), 0.0, r["ms"], plain, bms, by, r["index_add_ms"])
    log(json.dumps({"ordered_sum_calls": call_rows, "card": card,
                    "sm_clock_mhz": clock / 1e6}))
    return kernels


# the graph phase's corpus: 230 sentences of 1,000 tokens, wrapped at
# L=192 into 1,380 rows, so an epoch is 6 flagship steps, the last batch
# partial (100 rows) and a chunk of 4 steps padded at the epoch's end
GRAPH_TOKENS = 230_000
GRAPH_CHUNK = 4


def same_params(a, b) -> bool:
    return sorted(a) == sorted(b) and all(
        torch.equal(bits(a[k]), bits(b[k])) for k in a)


def phase_graphs(dev, vocab):
    """Every dispatch path on every route at flagship width, each run
    against the eager per-step run of the same seed, bitwise on the
    params: graphed per-step (a run resumed mid-epoch at step 3 by
    train(state=...), and a whole epoch), chunk_steps=4 streaming and
    chunk_steps=4 resident (the epoch's second chunk partial: 2 steps, 2
    pad steps skipped). Each path's launch counts are set to 0 just before
    it and read just after, and must equal expected_launches for the steps
    it ran (a capture counts its launches once a replay; the warm-up of a
    capture runs on clones in an earlier, uncounted run)."""
    import gc

    from word2vec_tpu_torch import PackedCorpus, Trainer
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts
    from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids

    corpus = PackedCorpus.pack(
        zipf_corpus_ids(vocab, GRAPH_TOKENS, seed=1, sentence_len=1000), L)
    spe = -(-corpus.num_rows // B)
    log(f"  graph corpus: rows={corpus.num_rows} steps/epoch={spe}")
    rows = []
    for backend, layout in ROUTES:
        tag = f"{backend}/{layout}"

        def trainer(graphs=True, **over):
            tr = Trainer(flagship_cfg(backend, layout, iters=1, **over), vocab, corpus)
            tr.graphs = graphs
            return tr

        def counted(tr, n_steps, what, **kw):
            reset_launch_counts()
            state, rep = tr.train(log_every=0, **kw)
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            want = expected_launches(backend, layout, n_steps)
            if counts != want:
                fail(f"graphs {tag} {what}: launch counts {counts} != {want}")
            if not np.isfinite(rep.final_loss):
                fail(f"graphs {tag} {what}: non-finite loss")
            return state

        ref = counted(trainer(graphs=False), spe, "eager per-step")
        row = {"route": tag, "steps": spe}
        g = trainer()
        part, _ = g.train(log_every=0, max_steps=3)  # captures the step
        row["capture_s per-step"] = g.capture_s
        checks = [
            ("graphed per-step, resumed at step 3",
             counted(g, spe - 3, "resumed", state=part)),
            ("graphed per-step", counted(g, spe, "per-step")),
        ]
        for name, over in (
            ("chunk_steps=4 streaming", dict(chunk_steps=GRAPH_CHUNK, resident="off")),
            ("chunk_steps=4 resident", dict(chunk_steps=GRAPH_CHUNK, resident="on")),
        ):
            c = trainer(**over)
            first, rep = c.train(log_every=0)  # captures the chunk's step
            row[f"capture_s {name}"] = c.capture_s
            if name.endswith("resident") and rep.resident["resolved"] != "resident":
                fail(f"graphs {tag}: the resident path resolved {rep.resident}")
            checks += [(f"{name} (capturing run)", first),
                       (name, counted(c, spe, name))]
        for name, state in checks:
            ok = same_params(state.params, ref.params) and state.step == spe
            row[name] = ok
            if not ok:
                fail(f"graphs {tag}: {name} != eager per-step (bitwise)")
        log(f"  graphs {tag}: " + ", ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in row.items() if k != "route"))
        rows.append(row)
        del g, c, ref, checks
        gc.collect()
        torch.cuda.empty_cache()
    log(json.dumps({"graph_phase": rows}))


# the four dispatch arms of the words/sec A/B: (replay CUDA graphs,
# config overrides)
ARMS = {
    "A eager per-step": (False, dict(chunk_steps=1)),
    "B graphed per-step": (True, dict(chunk_steps=1)),
    "C graphed chunk_steps=0 streaming": (True, dict(chunk_steps=0, resident="off")),
    "D graphed chunk_steps=0 resident": (True, dict(chunk_steps=0, resident="on")),
}


def host_fill_ms(corpus, reps=50) -> float:
    """Median ms of one host batch fill [B x L] (data/batcher.fill_batch,
    the numpy fill the streaming paths run in their producer thread)."""
    from word2vec_tpu_torch.data.batcher import epoch_order, fill_batch

    order = epoch_order(0, 0, corpus.num_rows)
    out = np.empty((B, L), np.int32)
    times = []
    for i in range(reps):
        pos = (i * B) % max(1, corpus.num_rows - B)
        t0 = time.perf_counter()
        fill_batch(corpus.flat, corpus.row_starts, corpus.row_lens, order, pos, out)
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


#: timed runs of each dispatch arm, in turn
DISPATCH_REPS = 1


def phase_dispatch(vocab, corpus, card):
    """Words/sec of the four dispatch arms per route, one run each in turn
    on this card (A B C D), each run two epochs of the flagship corpus
    (host clock around Trainer.train, synchronized at both ends); each
    arm's capture seconds; the device's busy and idle shares of one more
    run of each arm under torch.profiler (busy = the union of the device
    intervals; idle = 1 - busy / the synchronized host window)."""
    import gc

    from word2vec_tpu_torch import Trainer
    from word2vec_tpu_torch.profile_step import _busy_us

    fill = host_fill_ms(corpus)
    log(f"  host batch fill [{B} x {L}] (numpy fill_batch): median {fill:.4f} ms "
        f"({card})")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = []
    for backend, layout in ROUTES:
        tag = f"{backend}/{layout}"
        trainers = {}
        for arm, (graphs, over) in ARMS.items():
            tr = Trainer(flagship_cfg(backend, layout, iters=2, **over), vocab, corpus)
            tr.graphs = graphs
            tr.train(log_every=0, max_steps=3)  # warm-up; captures the graph
            trainers[arm] = (tr, tr.capture_s)
        wps = {arm: [] for arm in ARMS}
        steps = {}
        for _ in range(DISPATCH_REPS):
            for arm, (tr, _) in trainers.items():
                _, rep = tr.train(log_every=0)
                wps[arm].append(rep.words_per_sec)
                steps[arm] = rep.steps
        for arm, (tr, cap) in trainers.items():
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.train(log_every=0)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
            busy = _busy_us([e for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA])
            row = {
                "route": tag, "arm": arm, "words_per_sec": wps[arm],
                "steps": steps[arm], "capture_s": cap,
                "profiled_ms_per_step": window_us / 1e3 / steps[arm],
                "device_busy_ms_per_step": busy / 1e3 / steps[arm],
                "device_idle_share": 1.0 - busy / window_us,
            }
            rows.append(row)
            log(f"  dispatch {tag} {arm}: words/sec "
                + " / ".join(f"{w:.1f}" for w in wps[arm])
                + f" ({row['steps']} steps a run); capture {cap:.3f} s; profiled "
                f"{row['profiled_ms_per_step']:.4f} ms/step, device busy "
                f"{row['device_busy_ms_per_step']:.4f} ms/step, idle "
                f"{100 * row['device_idle_share']:.1f}% ({card})")
        del trainers, tr
        gc.collect()
        torch.cuda.empty_cache()
    log(json.dumps({"dispatch_arms": rows, "host_fill_ms": fill, "card": card}))


# the CLI phase: (band_backend, table_layout, chunk_steps) per route, the
# checkpoint cadence (the epoch is 31 steps: a mid-epoch file at 18)
CLI_ROUTES = [("pallas_fused", "unified", 6), ("xla", "split", 1)]
CLI_EVERY = 18
QUERIES = 256


def check_no_jax() -> None:
    if any(m == "jax" or m.startswith(("jax.", "word2vec_tpu."))
           or m == "word2vec_tpu" for m in sys.modules):
        fail("the port imported jax or the JAX package")


def run_cli(argv, log_path):
    """cli.main(argv) with the launch counts set to 0 just before it and
    read just after; returns (counts, the JSONL log records)."""
    from word2vec_tpu_torch import cli
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    rc = cli.main(argv + ["--log-jsonl", log_path])
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    if rc != 0:
        fail(f"cli exited {rc}: {' '.join(argv)}")
    with open(log_path) as f:
        return counts, [json.loads(line) for line in f]


def npz_bitwise(a: str, b: str) -> bool:
    with np.load(os.path.join(a, "state.npz")) as x, \
            np.load(os.path.join(b, "state.npz")) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].tobytes() == y[k].tobytes() and x[k].dtype == y[k].dtype
            for k in x.files)


def wall_ms(fn, reps: int) -> float:
    """Median host-clock ms of fn() (which returns host data, so each call
    includes its device work)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def phase_cli(vocab, corpus, card, tmp):
    """The CLI main path on the card (phase 6 of the module docstring)."""
    import contextlib
    import filecmp
    import io
    import shutil

    from word2vec_tpu_torch import native
    from word2vec_tpu_torch.data.batcher import epoch_order, fill_batch
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint
    from word2vec_tpu_torch.io.embeddings import load_embeddings_binary
    from word2vec_tpu_torch.serve.query import QueryEngine

    t_phase = time.perf_counter()
    row = {"card": card}
    # the native host layer: built on this host, its fill = the numpy fill
    if not native.available():
        fail(f"the native host layer did not build: {native.build_error}")
    order = epoch_order(0, 0, corpus.num_rows)
    a, b = np.empty((B, L), np.int32), np.empty((B, L), np.int32)
    for pos in range(0, corpus.num_rows, 997):
        wa = native.fill_batch(corpus.flat, corpus.row_starts, corpus.row_lens, order, pos, a)
        wb = fill_batch(corpus.flat, corpus.row_starts, corpus.row_lens, order, pos, b)
        if wa != wb or not np.array_equal(a, b):
            fail(f"native fill != numpy fill at row {pos}")
    fills = {}
    for name, fn in (("native", native.fill_batch), ("numpy", fill_batch)):
        fills[name] = wall_ms(lambda fn=fn: fn(
            corpus.flat, corpus.row_starts, corpus.row_lens, order, 4096, a), 50)
    row["host_fill_ms"] = fills
    row["native_library"] = str(native._target().relative_to(HERE))
    log(f"  native host layer {row['native_library']}: fill [{B} x {L}] "
        f"native {fills['native']:.4f} ms, numpy {fills['numpy']:.4f} ms "
        f"(median; equal bitwise on the flagship corpus)")

    # the phase-5 corpus as a text8 file, its vocabulary as a vocab file
    txt = os.path.join(tmp, "zipf.txt")
    vtxt = os.path.join(tmp, "vocab.txt")
    with open(txt, "w") as f:
        f.write(" ".join(np.asarray(vocab.words)[corpus.flat].tolist()))
    vocab.save(vtxt)
    rows = -(-corpus.num_tokens // L)  # a text8 stream, cut every L tokens
    spe = -(-rows // B)
    routes = {}
    exported = None
    for backend, layout, chunk in CLI_ROUTES:
        tag = f"{backend}/{layout}"
        flags = ["-train", txt, "-read-vocab", vtxt, "-size", str(D),
                 "-window", str(W), "-negative", str(K), "-iter", "1",
                 "--batch-rows", str(B), "--max-sentence-len", str(L),
                 "--shared-negatives", str(KP), "--band-backend", backend,
                 "--table-layout", layout, "--chunk-steps", str(chunk),
                 "-binary", "1", "--quiet"]
        ck, ck2, mid = (os.path.join(tmp, f"{n}_{backend}") for n in ("ck", "ck2", "mid"))
        out, out2 = (os.path.join(tmp, f"{n}_{backend}.bin") for n in ("v", "v2"))
        counts, recs = run_cli(flags + [
            "-output", out, "--checkpoint-dir", ck,
            "--checkpoint-every", str(CLI_EVERY)], os.path.join(tmp, f"log_{backend}"))
        rep = [r for r in recs if r.get("event") == "train_report"][-1]
        saves = [r["seconds"] for r in recs if r.get("event") == "checkpoint"]
        if rep["steps"] != spe or rep["nonfinite_loss_steps"]:
            fail(f"cli {tag}: {rep}")
        want = expected_launches(backend, layout, spe + 1)
        if counts != want:
            fail(f"cli {tag}: launch counts {counts} != {want}")
        t0 = time.perf_counter()
        st, _, _ = load_checkpoint(ck + ".old", fallback=False)
        load_s = time.perf_counter() - t0
        if st.step != CLI_EVERY:
            fail(f"cli {tag}: the mid-epoch checkpoint holds step {st.step}")
        mid_words = st.words_done
        del st
        shutil.copytree(ck + ".old", mid)
        counts2, recs2 = run_cli(flags + [
            "-output", out2, "--checkpoint-dir", ck2, "--resume", mid],
            os.path.join(tmp, f"log2_{backend}"))
        rep2 = [r for r in recs2 if r.get("event") == "train_report"][-1]
        # the report's words/sec counts the checkpoint's words too (as the
        # JAX trainer's does): the tail's own rate is its words over the
        # same wall time
        with np.load(os.path.join(ck2, "state.npz")) as z:
            end_words = int(z["__words_done"])
        tail_wps = (end_words - mid_words) * rep2["words_per_sec"] / end_words
        want2 = expected_launches(backend, layout, spe - CLI_EVERY + 1)
        if counts2 != want2:
            fail(f"cli {tag} resumed: launch counts {counts2} != {want2}")
        same = npz_bitwise(ck, ck2) and filecmp.cmp(out, out2, shallow=False)
        if not same:
            fail(f"cli {tag}: the resumed run's params or vectors differ from "
                 "the uninterrupted run's (bitwise)")
        nbytes = os.path.getsize(os.path.join(ck, "state.npz"))
        routes[tag] = {
            "steps": rep["steps"], "chunk_steps": chunk,
            "words_per_sec": rep["words_per_sec"],
            "resumed_steps": rep2["steps"] - CLI_EVERY,
            "resumed_words_per_sec": tail_wps,
            "final_loss": rep["final_loss"],
            "checkpoint_save_s": saves, "checkpoint_load_s": load_s,
            "checkpoint_bytes": nbytes, "resume_bitwise": same,
            "launches": counts, "resumed_launches": counts2,
        }
        log(f"  cli {tag} (chunk_steps {chunk}): {rep['steps']} steps "
            f"{rep['words_per_sec']:.1f} words/sec; resumed at {CLI_EVERY}: "
            f"{tail_wps:.1f} words/sec, params and vectors bitwise "
            f"equal; checkpoint {nbytes} B saved in "
            + ", ".join(f"{x:.3f}" for x in saves) + f" s, loaded in "
            f"{load_s:.3f} s ({card})")
        exported = out
    row["routes"] = routes

    # the exported vectors through the query engine: card vs CPU
    words, M = load_embeddings_binary(exported)
    if words != vocab.words or M.shape != (V, D) or not np.isfinite(M).all():
        fail("the exported vectors do not load back")
    rng = np.random.default_rng(0)
    qid = rng.choice(V, QUERIES, replace=False).astype(np.int32)
    trip = np.stack([qid, qid, qid], axis=1)
    wts = np.tile(np.float32([[1.0, 0.0, 0.0]]), (QUERIES, 1))
    row["query_ms"] = {}
    for dt in ("float32", "bfloat16"):
        card_e = QueryEngine(M, vocab, table_dtype=dt)
        cpu_e = QueryEngine(M, vocab, table_dtype=dt, device="cpu")
        got, ref = card_e.batch_topk(trip, wts, 10), cpu_e.batch_topk(trip, wts, 10)
        err = 0.0
        for (gi, gv), (ri, rv) in zip(got, ref):
            if not np.array_equal(gi, ri):
                fail(f"query engine {dt}: card ids {gi} != cpu ids {ri}")
            err = max(err, float(np.abs(gv - rv).max()))
        if err > 1e-5:
            fail(f"query engine {dt}: scores differ by {err}")
        ms = {"card": wall_ms(lambda: card_e.batch_topk(trip, wts, 10), 20),
              "cpu": wall_ms(lambda: cpu_e.batch_topk(trip, wts, 10), 3),
              "max_abs_err": err}
        row["query_ms"][dt] = ms
        log(f"  query engine {dt} table, {QUERIES} neighbor queries (k=10) on "
            f"V={V}, d={D}: ids identical card vs cpu, max score err {err:.2e}; "
            f"card {ms['card']:.3f} ms, cpu {ms['cpu']:.3f} ms (wall, median; {card})")
        del card_e, cpu_e

    # --eval-ws353 on the topical toy corpus of tests/test_cli.py
    topics = [["cat", "kitten", "dog", "puppy", "horse"],
              ["king", "queen", "prince", "princess"],
              ["paris", "france", "berlin", "germany", "city", "country"],
              ["apple", "banana", "fruit"]]
    trng = np.random.default_rng(11)
    toks = []
    for _ in range(300):
        t = topics[trng.integers(len(topics))]
        toks += list(trng.choice(t, size=6))
    toy = os.path.join(tmp, "toy.txt")
    with open(toy, "w") as f:
        f.write(" ".join(toks))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        run_cli(["-train", toy, "-output", "", "-size", str(D), "-negative", "3",
                 "-min-count", "1", "-iter", "2", "--batch-rows", "4",
                 "--max-sentence-len", "32", "--eval-ws353",
                 os.path.join(HERE, "tests", "fixtures", "wordsim_fixture_20.csv"),
                 "--quiet"], os.path.join(tmp, "log_toy"))
    line = [x for x in out.getvalue().splitlines() if x.startswith("WS-353")]
    if not line or "(20/20 pairs)" not in line[0]:
        fail(f"--eval-ws353 on the toy corpus: {out.getvalue()!r}")
    row["ws353"] = line[0]
    log(f"  toy corpus -size {D} on the card: {line[0]}")
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"cli_phase": row}))
    return exported



# ------------------------------------------------- phase 7: hs and pair
# the other step routes at flagship width (d=300, window 5, B=256 x
# L=192, V=71,000), split tables, f32 tables, bf16 compute, clip 1.0:
# (name, config overrides); pair on hs runs 4 micro sub-steps of 64 rows
# (one [P, C, d] f32 buffer is ~3.1 GB there, ~12.4 GB at 256 rows)
HS_ROUTES = [
    ("hs-sg-1tier", dict(train_method="hs", negative=0)),
    ("hs-sg-2tier", dict(train_method="hs", negative=0, hs_dense_top=512,
                         hs_tail_slots=-1)),
    ("hs-cbow-1tier", dict(train_method="hs", negative=0, model="cbow")),
    ("pair-ns", dict(kernel="pair")),
    ("pair-hs-micro4", dict(kernel="pair", train_method="hs", negative=0,
                            micro_steps=4)),
]
HS_STEPS = 6       # steps of each dispatch path's run
HS_LOSS_STEPS = 24  # steps of the run whose loss must fall
HS_CHUNK = 4


def hs_cfg(**over):
    from word2vec_tpu_torch import Word2VecConfig

    base = dict(model="sg", train_method="ns", negative=K, word_dim=D,
                window=W, batch_rows=B, max_sentence_len=L,
                shared_negatives=KP, min_count=5, iters=1)
    base.update(over)
    return Word2VecConfig(**base)


def hs_launches(cfg, steps: int) -> dict:
    """Kernel launches of `steps` steps of an hs or pair route: every
    table update is one sorted scatter (ops/train_step.sorted_scatter)
    with its run list and, with the clip on, one ordered row sum (two
    with scatter_mean); the two-tier hs step's dense slice is a plain add.
    Per micro sub-step."""
    from word2vec_tpu_torch.ops.launch import LAUNCHES

    scatters = 2
    sums = 2 * ((cfg.clip_row_update > 0) + cfg.scatter_mean)
    per = {k: 0 for k in LAUNCHES}
    per.update(find_runs=scatters, fused_slab_scatter=scatters, ordered_row_sum=sums)
    return {k: v * steps * cfg.micro_steps for k, v in per.items()}


class CallRecorder:
    """Records the inputs and outputs of every ordered-sum kernel call the
    hs and pair steps make (the three wrappers as ops/train_step calls
    them), so each is held against its plain version at its own shape."""

    NAMES = ("find_runs", "ordered_row_sum", "fused_slab_scatter")

    def __init__(self, band=False):
        from word2vec_tpu_torch.ops import band_step as bs
        from word2vec_tpu_torch.ops import train_step as ts

        self.ts = ts
        # band=True: the band step's own calls too (it imports the wrappers)
        self.mods = (ts, bs) if band else (ts,)
        self.real = {n: getattr(ts, n) for n in self.NAMES}
        self.calls = []

    def __enter__(self):
        real, calls = self.real, self.calls

        def runs(idx):
            r = real["find_runs"](idx)
            calls.append(("find_runs", idx.clone(), r.clone()))
            return r

        def row_sum(num_rows, idx, vals, out=None, *, presorted=False, runs=None):
            before = None if out is None else out.clone()
            r = real["ordered_row_sum"](num_rows, idx, vals, out,
                                        presorted=presorted, runs=runs)
            calls.append(("ordered_row_sum", num_rows, idx.clone(), vals.clone(),
                          before, r.clone(), presorted))
            return r

        def scatter(emb, sorted_idx, vals, plane=None, runs=None):
            before = emb.clone()
            r = real["fused_slab_scatter"](emb, sorted_idx, vals, plane, runs=runs)
            calls.append(("fused_slab_scatter", before, sorted_idx.clone(),
                          vals.clone(), r.clone(), runs, plane))
            return r

        for n, f in (("find_runs", runs), ("ordered_row_sum", row_sum),
                     ("fused_slab_scatter", scatter)):
            for m in self.mods:
                setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            for m in self.mods:
                setattr(m, n, f)


def run_row(idx) -> int:
    """The row of the longest run of sorted ids."""
    ids, n = torch.unique_consecutive(idx, return_counts=True)
    return int(ids[n.argmax()])


#: phase 7 times the ordered row sums of at least this many terms (the
#: pair hs sub-step's [2,457,600]) beside index_add_
ROW_SUM_TIMED_N = 1_000_000


def check_hs_calls(name, calls, card, clock, timed=None):
    """Every recorded call against its plain version, bitwise (the run
    list exact); the scatters (those whose call index is in `timed`, when
    given) and the row sums of ROW_SUM_TIMED_N terms or more also timed
    (kernel ms, index_add_ ms, bytes and chain bounds). Returns the timed
    rows."""
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import runs as rl
    from word2vec_tpu_torch.ops import train_step as ts

    rows = []
    for at, c in enumerate(calls):
        kind = c[0]
        if kind == "find_runs":
            _, idx, got = c
            n = idx.numel()
            want = rl.find_runs_plain(idx)
            if not all(torch.equal(a, b) for a, b in
                       zip(rl.unpack_runs(got, n), rl.unpack_runs(want, n))):
                fail(f"hs {name}: find_runs [N={n}] kernel != plain")
        elif kind == "ordered_row_sum":
            _, num_rows, idx, vals, before, got, presorted = c
            if not presorted:
                order = torch.argsort(idx, stable=True)
                idx, vals = idx[order], vals[order]
            want = ts.ordered_row_sum_plain(
                num_rows, idx, vals, None if before is None else before.clone())
            if not torch.equal(bits(got), bits(want)):
                fail(f"hs {name}: ordered_row_sum [N={idx.numel()}] kernel != plain")
            if idx.numel() >= ROW_SUM_TIMED_N:
                # the long sums timed beside index_add_ (unordered) into
                # the same zeroed [num_rows] f32 vector
                i32 = idx.to(torch.int32).contiguous()
                runs = rl.find_runs(i32)
                k_ms = cuda_ms(lambda: ts.ordered_row_sum(
                    num_rows, i32, vals, presorted=True, runs=runs), reps=10)
                li, v32 = idx.long(), vals.float()
                lib = cuda_ms(lambda: torch.zeros(
                    num_rows, dtype=torch.float32, device=idx.device
                ).index_add_(0, li, v32), reps=10)
                n = idx.numel()
                b_bytes = (8 * n + 4 * num_rows) / HBM_BYTES_PER_S * 1e3
                longest = longest_run(idx)
                rows.append({
                    "call": "ordered_row_sum", "n": n, "table_rows": num_rows,
                    "ms": k_ms, "index_add_ms": lib, "bytes_bound_ms": b_bytes,
                    "chain_bound_ms": longest * CHAIN_CYCLES[torch.float32]
                    / clock * 1e3, "longest_run": longest,
                })
                log(f"  hs {name} row sum [N={n} into {num_rows} rows]: "
                    f"{k_ms:.4f} ms, index_add_ {lib:.4f} ms, bytes bound "
                    f"{b_bytes:.4f} ms, chain bound "
                    f"{rows[-1]['chain_bound_ms']:.4f} ms (longest run "
                    f"{longest}) ({card})")
        else:
            _, before, idx, vals, got, runs, plane = c
            t0 = time.perf_counter()
            want = fs.fused_slab_scatter_plain(before.clone(), idx, vals, plane)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            if not torch.equal(bits(got), bits(want)):
                fail(f"hs {name}: fused_slab_scatter [N={idx.numel()}] kernel != plain")
            if timed is not None and at not in timed:
                continue
            tb = before.clone()
            k_ms = cuda_ms(lambda: ts.fused_slab_scatter(tb, idx, vals, plane, runs=runs),
                           reps=10)
            li = idx.long()
            dst = tb if plane is None else tb[:, plane]
            lib = cuda_ms(lambda: dst.index_add_(0, li, vals), reps=10)
            b_bytes, _ = scatter_bound(idx, vals)
            longest = longest_run(idx)
            live = vals.reshape(vals.shape[0], -1).ne(0).any(dim=1)
            rows.append({
                "call": "fused_slab_scatter", "width": vals.shape[-1],
                "layout": "unified" if before.dim() == 3 else "split", "plane": plane,
                "n": idx.numel(), "table_rows": before.shape[0],
                "dtype": str(before.dtype)[6:], "ms": k_ms, "index_add_ms": lib,
                "bytes_bound_ms": b_bytes,
                "chain_bound_ms": longest * CHAIN_CYCLES[before.dtype] / clock * 1e3,
                "longest_run": longest,
                "longest_run_row": run_row(li),
                "zero_terms": int((~live).sum()),
                "longest_nonzero_run": longest_run(idx[live]), "plain_s": plain_s,
            })
            log(f"  hs {name} scatter [N={idx.numel()} into {before.shape[0]} rows]: "
                f"{k_ms:.4f} ms, index_add_ {lib:.4f} ms, bytes bound "
                f"{b_bytes:.4f} ms, chain bound {rows[-1]['chain_bound_ms']:.4f} ms "
                f"(longest run {longest} on row {rows[-1]['longest_run_row']}; "
                f"{rows[-1]['zero_terms']} zero terms; longest run of nonzero terms "
                f"{rows[-1]['longest_nonzero_run']}; plain {plain_s:.1f} s) ({card})")
    return rows


# the CLI on the hs and pair routes: (name, flags, chunk_steps); a chunk
# of 6 steps ends at the step-18 checkpoint (CLI_EVERY)
HS_CLI_ROUTES = [
    ("hs-cbow-2tier", ["-train_method", "hs", "-negative", "0", "-model", "cbow",
                       "--hs-dense-top", "512"], 6),
    ("pair-ns", ["-negative", str(K), "--kernel", "pair"], 1),
]


def phase_hs_cli(vocab, corpus, card, tmp):
    """The CLI on two of phase 7's routes, at flagship width on the
    phase-5 corpus as a text8 file: a full epoch with a checkpoint file
    every CLI_EVERY steps, then --resume from the mid-epoch file to the
    end, bitwise equal to the uninterrupted run (state.npz and the binary
    vectors); exact launch counts (the epoch's steps + the capture's
    warm-up); the exported vectors of every word, finite."""
    import filecmp
    import shutil

    from word2vec_tpu_torch.io.embeddings import load_embeddings_binary

    txt, vtxt = os.path.join(tmp, "zipf.txt"), os.path.join(tmp, "vocab.txt")
    with open(txt, "w") as f:
        f.write(" ".join(np.asarray(vocab.words)[corpus.flat].tolist()))
    vocab.save(vtxt)
    spe = -(-(-(-corpus.num_tokens // L)) // B)  # text8 rows of L, B a step
    rows = []
    for name, route_flags, chunk in HS_CLI_ROUTES:
        flags = ["-train", txt, "-read-vocab", vtxt, "-size", str(D),
                 "-window", str(W), "-iter", "1", "--batch-rows", str(B),
                 "--max-sentence-len", str(L), "--chunk-steps", str(chunk),
                 "-binary", "1", "--quiet"] + route_flags
        ck, ck2, mid = (os.path.join(tmp, f"{n}_{name}") for n in ("ck", "ck2", "mid"))
        out, out2 = (os.path.join(tmp, f"{n}_{name}.bin") for n in ("v", "v2"))
        counts, recs = run_cli(flags + [
            "-output", out, "--checkpoint-dir", ck,
            "--checkpoint-every", str(CLI_EVERY)], os.path.join(tmp, f"log_{name}"))
        rep = [r for r in recs if r.get("event") == "train_report"][-1]
        if rep["steps"] != spe or rep["nonfinite_loss_steps"]:
            fail(f"cli {name}: {rep}")
        with open(os.path.join(ck, "config.json")) as f:
            saved = json.load(f)
        cfg = hs_cfg(**{k: saved[k] for k in (
            "model", "train_method", "negative", "kernel", "hs_dense_top",
            "micro_steps", "clip_row_update", "scatter_mean")})
        if counts != hs_launches(cfg, spe + 1):
            fail(f"cli {name}: launch counts {counts} != {hs_launches(cfg, spe + 1)}")
        with np.load(os.path.join(ck + ".old", "state.npz")) as z:
            if int(z["__step"]) != CLI_EVERY:
                fail(f"cli {name}: the mid-epoch checkpoint holds step "
                     f"{int(z['__step'])}")
        shutil.copytree(ck + ".old", mid)
        counts2, recs2 = run_cli(flags + [
            "-output", out2, "--checkpoint-dir", ck2, "--resume", mid],
            os.path.join(tmp, f"log2_{name}"))
        if counts2 != hs_launches(cfg, spe - CLI_EVERY + 1):
            fail(f"cli {name} resumed: launch counts {counts2}")
        same = npz_bitwise(ck, ck2) and filecmp.cmp(out, out2, shallow=False)
        words, M = load_embeddings_binary(out)
        if not same or words != vocab.words or M.shape != (V, D) or not np.isfinite(M).all():
            fail(f"cli {name}: resumed != uninterrupted (bitwise) or bad vectors")
        rows.append({"route": name, "steps": rep["steps"], "chunk_steps": chunk,
                     "words_per_sec": rep["words_per_sec"],
                     "final_loss": rep["final_loss"], "resume_bitwise": same,
                     "launches": counts, "resumed_launches": counts2})
        log(f"  cli {name} (chunk_steps {chunk}): {rep['steps']} steps "
            f"{rep['words_per_sec']:.1f} words/sec (a checkpoint inside), final "
            f"loss {rep['final_loss']:.5f}; resumed at {CLI_EVERY}: params and "
            f"vectors bitwise equal; launches {counts} ({card})")
    return rows


def phase_hs_small(dev):
    """One step per hs / pair route at a small shape, the card's kernels
    vs the plain versions on the CPU, same params and draws (f32
    compute, scatter_mean and the clip on): params within 1e-6, loss
    within 1e-4 relative, pairs and hs_tail_dropped exact."""
    from word2vec_tpu_torch.data.vocab import Vocab
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.models.params import init_params
    from word2vec_tpu_torch.ops.tables import DeviceTables
    from word2vec_tpu_torch.ops.steps import make_step
    from word2vec_tpu_torch.ops.train_step import Draws

    v, d = 500, 64
    counts = np.maximum(1, np.round(20000.0 / np.arange(1, v + 1))).astype(np.int64)
    vocab = Vocab([f"w{i}" for i in range(v)], counts)
    rng = np.random.default_rng(6)
    toks = rng.choice(v, size=(8, 40), p=counts / counts.sum()).astype(np.int32)
    toks[3, 25:] = -1
    cpu = torch.device("cpu")
    for name, over in HS_ROUTES:
        over = dict(over, micro_steps=1)
        if over.get("hs_dense_top"):
            over.update(hs_dense_top=16, hs_tail_slots=40)  # drops some updates
        cfg = hs_cfg(**dict(over, word_dim=d, window=3, max_sentence_len=40,
                            batch_rows=8, compute_dtype="float32", band_chunk=10,
                            scatter_mean=True, subsample_threshold=1e-3,
                            negative=0 if "hs" in name else 3))
        steps = {dv: make_step(cfg, DeviceTables.build(vocab, cfg, dv))
                 for dv in (cpu, dev)}
        p_cpu = init_params(cfg, v, generator(cpu, 4))
        g = generator(cpu, 5)
        for t in p_cpu.values():  # nonzero everywhere, so every table moves
            t.normal_(0.0, 0.1, generator=g)
        start = {k: t.clone() for k, t in p_cpu.items()}
        p_gpu = {k: t.to(dev, copy=True) for k, t in p_cpu.items()}
        tok = torch.from_numpy(toks)
        dr = steps[cpu].draw(generator(cpu, 3), tok)
        m_cpu = steps[cpu].apply(p_cpu, tok, dr, 0.03)
        m_gpu = steps[dev].apply(p_gpu, tok.to(dev), Draws(
            dr.u_sub.to(dev), dr.w_eff.to(dev),
            None if dr.negs is None else dr.negs.to(dev)), 0.03)
        torch.cuda.synchronize()
        err = max(float((p_gpu[k].cpu() - p_cpu[k]).abs().max()) for k in p_cpu)
        moved = max(float((p_cpu[k] - start[k]).abs().max()) for k in p_cpu)
        lerr = abs(float(m_gpu["loss_sum"]) - float(m_cpu["loss_sum"]))
        same = all(float(m_gpu[k]) == float(m_cpu[k])
                   for k in ("pairs", "hs_tail_dropped"))
        log(f"  small step {name}: params max_abs_err={err:.3e} (update max "
            f"{moved:.3e}), loss_sum err={lerr:.3e}, pairs "
            f"{float(m_cpu['pairs']):.0f}, hs_tail_dropped "
            f"{float(m_cpu['hs_tail_dropped']):.0f} (card == CPU: {same})")
        # f32 compute: the two versions differ only in summation order
        if not (err <= 1e-6 and moved > 1e-4 and same):
            fail(f"small step {name}: the card's step disagrees with the CPU step")
        if lerr > 1e-4 * abs(float(m_cpu["loss_sum"])):
            fail(f"small step {name}: loss_sum disagrees")


def phase_hs(dev, vocab, corpus, card, tmp):
    """Phase 7 of the module docstring: the hs and pair routes at flagship
    width, each route's ordered-sum calls vs their plain versions, the
    dispatch paths bitwise and counted, the loss, and the route's time;
    then the CLI on two of them (phase_hs_cli)."""
    import gc

    from word2vec_tpu_torch import Trainer
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.models.params import init_params
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts
    from word2vec_tpu_torch.ops.tables import DeviceTables
    from word2vec_tpu_torch.ops.steps import make_step

    phase_hs_small(dev)
    clock = sm_clock_hz()
    tokens = corpus_batch(dev, corpus)
    out = []
    for name, over in HS_ROUTES:
        t_route = time.perf_counter()
        cfg = hs_cfg(**over)
        row = {"route": name, "card": card}
        torch.cuda.reset_peak_memory_stats(dev)

        # (a) one sub-step's ordered-sum calls at this route's shapes
        tables = DeviceTables.build(vocab, cfg, dev)
        if tables.hs_msig is not None:
            row.update(hs_P=tables.hs_msig.shape[1], hs_Ct=tables.hs_tail_codes.shape[1],
                       hs_coverage=tables.hs_dense_coverage)
        if tables.hs_codes is not None:
            row["hs_C"] = tables.hs_codes.shape[1]
        step = make_step(cfg, tables)
        params = init_params(cfg, len(vocab), generator(dev, 3))
        g = generator(dev, 4)
        for k in ("emb_out_hs", "emb_out_ns"):  # zero at init: every update
            if k in params:                     # of the step is nonzero here
                params[k].normal_(0.0, 0.1, generator=g)
        sub = tokens[: B // cfg.micro_steps]
        draws = step.draw(generator(dev, 5), sub)
        with CallRecorder() as rec:
            m = step.apply(params, sub, draws, 0.025)
        torch.cuda.synchronize()
        if not np.isfinite(float(m["loss_sum"])):
            fail(f"hs {name}: non-finite loss on the recorded step")
        del params, draws, step
        calls = rec.calls
        kinds = [c[0] for c in calls]
        want = hs_launches(cfg, 1)
        if {k: kinds.count(k) * cfg.micro_steps for k in rec.NAMES} != {
                k: want[k] for k in rec.NAMES}:
            fail(f"hs {name}: recorded calls {kinds} != {want}")
        row["scatters"] = check_hs_calls(name, calls, card, clock)
        del calls, rec
        gc.collect()
        torch.cuda.empty_cache()
        row["scatter_ms_step"] = cfg.micro_steps * sum(r["ms"] for r in row["scatters"])
        row["longest_run"] = max(r["longest_run"] for r in row["scatters"])

        # (b) eager per-step, graphed per-step and chunked resident runs
        # of HS_STEPS steps from the same seed: bitwise, counts exact
        def trainer(graphs=True, **kw):
            tr = Trainer(hs_cfg(**over, **kw), vocab, corpus)
            tr.graphs = graphs
            return tr

        def counted(tr, what, **kw):
            reset_launch_counts()
            state, rep = tr.train(log_every=0, max_steps=HS_STEPS, **kw)
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            want = hs_launches(cfg, HS_STEPS)
            if counts != want:
                fail(f"hs {name} {what}: launch counts {counts} != {want}")
            if not all(counts[k] > 0 for k in CallRecorder.NAMES):
                fail(f"hs {name} {what}: a kernel of the path never launched")
            if rep.steps != HS_STEPS or not np.isfinite(rep.final_loss):
                fail(f"hs {name} {what}: {rep.steps} steps, loss {rep.final_loss}")
            return state, counts

        ref, counts = counted(trainer(graphs=False), "eager per-step")
        row["launches_per_step"] = {k: v // HS_STEPS for k, v in counts.items() if v}
        g = trainer()
        g.train(log_every=0, max_steps=1)  # captures the step
        row["capture_s"] = g.capture_s
        got, _ = counted(g, "graphed per-step")
        row["graphed == eager"] = same_params(got.params, ref.params)
        c = trainer(chunk_steps=HS_CHUNK, resident="on")
        _, rep = c.train(log_every=0, max_steps=HS_CHUNK)  # captures the chunk's step
        if rep.resident["resolved"] != "resident":
            fail(f"hs {name}: the resident path resolved {rep.resident}")
        got_c, _ = counted(c, "chunked resident")
        row["chunked resident == eager"] = same_params(got_c.params, ref.params)
        if not (row["graphed == eager"] and row["chunked resident == eager"]):
            fail(f"hs {name}: a dispatch path != the eager per-step run (bitwise)")
        del c, got_c, got, ref
        gc.collect()

        # (c) the loss falls and stays finite; words/sec and the
        # host-clock step of the graphed per-step path
        g.train(log_every=0, max_steps=2)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, rep = g.train(log_every=6, max_steps=HS_LOSS_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        hist = rep.loss_history
        if not (hist and all(np.isfinite(hist)) and hist[-1] < hist[0]):
            fail(f"hs {name}: loss did not fall or is not finite: {hist}")
        row.update(
            loss_history=hist, words_per_sec=rep.words_per_sec,
            step_ms=wall * 1e3 / rep.steps,
            max_memory_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
            route_s=time.perf_counter() - t_route,
        )
        if g.kernel_decision is not None:
            fail(f"hs {name}: unexpected kernel auto-selection {g.kernel_decision}")
        log(f"  hs {name}: words/sec={rep.words_per_sec:.1f} step={row['step_ms']:.3f} ms "
            f"(host clock) peak memory={row['max_memory_gib']:.2f} GiB "
            f"longest run={row['longest_run']} scatter ms/step="
            f"{row['scatter_ms_step']:.4f} launches/step={row['launches_per_step']} "
            f"capture={row['capture_s']:.2f} s graphed==eager, chunked resident==eager "
            f"loss_history={[round(x, 5) for x in hist]} ({row['route_s']:.1f} s) ({card})")
        out.append(row)
        del g
        gc.collect()
        torch.cuda.empty_cache()
    cli = phase_hs_cli(vocab, corpus, card, tmp)
    log(json.dumps({"hs_phase": out, "hs_cli": cli}))
    return out


# ------------------------------------------------------ phase 8: serving
SERVE_QUERIES = 2000     # queries of the CLI server's mixed traffic
SERVE_CONNS = 64         # its concurrent keep-alive connections
SERVE_POST_BATCH = 4     # queries per POST /v1/query on half of them
CHAOS_CLEAN = 24         # sequential requests after the injected oom
CHAOS_HANG = CHAOS_CLEAN + 2   # the batch the hang fault wedges
CHAOS_FAULTS = f"oom:times=1,stall@5:secs=0.2,hang@{CHAOS_HANG}:secs=60"
TIMING_V = 1_000_000     # rows of the timing arm's table (d = D)
TIMING_QUERIES = 8192
TIMING_CLIENTS = 128
TIMING_ARMS = (0.0, 2.0, 0.0, 2.0)   # coalesce_ms, interleaved twice
SERVE_TOL = 1e-6


async def http_call(reader, writer, method, path, body=None):
    """One HTTP/1.1 request on a keep-alive connection -> (status, doc)."""
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    head = await reader.readline()
    if not head:
        raise ConnectionError("the server closed the connection")
    status, n = int(head.split()[1]), 0
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        key, _, val = line.decode("latin-1").partition(":")
        if key.strip().lower() == "content-length":
            n = int(val)
    payload = await reader.readexactly(n)
    try:
        return status, json.loads(payload)
    except ValueError:
        return status, payload.decode()


async def http_session(port, reqs):
    """reqs [(method, path, body)] in order on one connection."""
    import asyncio

    r, w = await asyncio.open_connection("127.0.0.1", port)
    try:
        return [await http_call(r, w, *q) for q in reqs]
    finally:
        w.close()


def http_once(port, method, path, body=None):
    import asyncio

    return asyncio.run(http_session(port, [(method, path, body)]))[0]


def query_path(q):
    """A query dict as its GET route."""
    import urllib.parse

    args = {k: v for k, v in q.items() if k != "op"}
    return f"/v1/{q['op']}?{urllib.parse.urlencode(args)}"


def serve_mix(words, n, seed):
    """n queries: 70% neighbors (k=10), 20% analogy (k=5), 10% similarity,
    words drawn Zipf (p ~ 1/rank) from the vocabulary, 20% of them repeats
    of earlier queries, shuffled."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(words) + 1)
    n_new = n - n // 5
    ids = rng.choice(len(words), size=(n_new, 3), p=p / p.sum())
    kind = rng.random(n_new)
    qs = []
    for (a, b, c), u in zip(ids, kind):
        if u < 0.7:
            qs.append({"op": "neighbors", "word": words[a], "k": 10})
        elif u < 0.9:
            qs.append({"op": "analogy", "a": words[a], "b": words[b],
                       "c": words[c], "k": 5})
        else:
            qs.append({"op": "similarity", "w1": words[a], "w2": words[b]})
    qs += [dict(qs[i]) for i in rng.choice(n_new, n - n_new)]
    return [qs[i] for i in rng.permutation(n)]


def expected_answers(eng, qs):
    """{query key: the CPU engine's answer} for every distinct query."""
    keys = {json.dumps(q, sort_keys=True): q for q in qs}
    out = {}
    for op, k in (("neighbors", 10), ("analogy", 5)):
        todo = [(key, q) for key, q in keys.items() if q["op"] == op]
        if op == "neighbors":
            res = eng.neighbors_batch([q["word"] for _, q in todo], k=k)
        else:
            res = eng.analogy_batch([(q["a"], q["b"], q["c"]) for _, q in todo],
                                    k=k)
        out.update({key: r for (key, _), r in zip(todo, res)})
    sims = [(key, q) for key, q in keys.items() if q["op"] == "similarity"]
    for (key, _), s in zip(sims, eng.similarity_batch(
            [(q["w1"], q["w2"]) for _, q in sims])):
        out[key] = s
    return out


def check_answer(what, q, status, doc, want):
    """One query's response against the CPU engine's answer."""
    if status != 200:
        fail(f"{what}: {q} -> {status} {doc}")
    if q["op"] == "similarity":
        if abs(doc["similarity"] - want) > SERVE_TOL:
            fail(f"{what}: {q} similarity {doc['similarity']} != {want}")
        return
    got = doc["neighbors"]
    if [w for w, _ in got] != [w for w, _ in want]:
        fail(f"{what}: {q} -> {[w for w, _ in got]} != {[w for w, _ in want]}")
    err = max((abs(s - t) for (_, s), (_, t) in zip(got, want)), default=0.0)
    if err > SERVE_TOL:
        fail(f"{what}: {q} scores differ by {err}")


def start_server(args, tmp, name):
    """`python -m word2vec_tpu_torch.serve` on the card; stderr goes to a
    file."""
    err = open(os.path.join(tmp, f"{name}.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "word2vec_tpu_torch.serve", *args],
        cwd=HERE, stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    proc.err_path = os.path.join(tmp, f"{name}.err")
    proc.t_start = time.perf_counter()
    return proc


def await_ready(procs, timeout=180.0):
    """Read each server's ready line as it comes: proc.ready (the JSON
    line) and proc.ready_s (seconds from launch)."""
    import select

    pending = {p.stdout: p for p in procs}
    deadline = time.perf_counter() + timeout
    while pending:
        got, _, _ = select.select(list(pending), [], [],
                                  max(0.0, deadline - time.perf_counter()))
        if not got:
            fail("a serve CLI did not print its ready line in "
                 f"{timeout:.0f} s: {open(next(iter(pending.values())).err_path).read()}")
        for f in got:
            p = pending.pop(f)
            line = f.readline()
            if not line:
                fail(f"a serve CLI exited before serving: {open(p.err_path).read()}")
            p.ready, p.ready_s = json.loads(line), time.perf_counter() - p.t_start


def phase_serve_cli(proc, cpu_eng, words, mdir, card):
    """Part 1: mixed traffic on the CLI server, every answer held against
    the CPU engine, the counters, then SIGTERM -> 0 with its dumps."""
    import asyncio

    from word2vec_tpu_torch.obs.trace import load_trace, validate_trace_doc

    ready, start_s = proc.ready, proc.ready_s
    port = ready["port"]
    if (ready["event"], ready["vocab"], ready["dim"],
            ready["table_dtype"]) != ("serving", V, D, "float32"):
        fail(f"serve CLI ready line {ready}")
    qs = serve_mix(words, SERVE_QUERIES, seed=8)
    t0 = time.perf_counter()
    want = expected_answers(cpu_eng, qs)
    cpu_s = time.perf_counter() - t0
    # the first query alone (the cold process's first batch), then the rest
    t0 = time.perf_counter()
    first = http_once(port, "GET", query_path(qs[0]))
    first_ms = (time.perf_counter() - t0) * 1e3
    check_answer("serve cli", qs[0], *first, want[json.dumps(qs[0], sort_keys=True)])
    rest = qs[1:]
    sessions, asked = [], []   # per connection: requests, their queries
    for c in range(SERVE_CONNS):
        mine = rest[c::SERVE_CONNS]
        if c % 2 == 0:      # GET routes, one query a request
            sessions.append([("GET", query_path(q), None) for q in mine])
            asked.append([[q] for q in mine])
        else:               # POST /v1/query batches
            groups = [mine[i:i + SERVE_POST_BATCH]
                      for i in range(0, len(mine), SERVE_POST_BATCH)]
            sessions.append([("POST", "/v1/query", {"queries": g})
                             for g in groups])
            asked.append(groups)

    async def drive():
        return await asyncio.gather(*(http_session(port, s) for s in sessions))

    t0 = time.perf_counter()
    replies = asyncio.run(drive())
    wall = time.perf_counter() - t0
    checked = 1
    for groups, rep in zip(asked, replies, strict=True):
        for group, (status, doc) in zip(groups, rep, strict=True):
            if status != 200:
                fail(f"serve cli: {group} -> {status} {doc}")
            results = doc["results"] if "results" in doc else [
                dict(doc, status=status)]
            for q, res in zip(group, results, strict=True):
                check_answer("serve cli", q, res["status"], res,
                             want[json.dumps(q, sort_keys=True)])
                checked += 1
    if checked != SERVE_QUERIES:
        fail(f"serve cli: {checked} answers checked of {SERVE_QUERIES}")
    _, stats = http_once(port, "GET", "/stats")
    _, prom = http_once(port, "GET", "/metrics")
    gauges = {}
    for line in prom.splitlines():
        if line and not line.startswith("#"):
            name, _, val = line.rpartition(" ")
            gauges[name] = float(val)
    if (stats["serve_requests_total"] != SERVE_QUERIES
            or gauges.get("w2v_serve_requests_total") != SERVE_QUERIES
            or stats["serve_errors_total"] or stats["serve_shed_429_total"]
            or not stats["serve_cache_hits"]):
        fail(f"serve cli counters: /stats {stats}, /metrics requests "
             f"{gauges.get('w2v_serve_requests_total')}")
    proc.send_signal(signal.SIGTERM)
    rc = proc.wait(timeout=60)
    if rc != 0:
        fail(f"serve cli: SIGTERM drain exited {rc}: {open(proc.err_path).read()}")
    fl = json.load(open(os.path.join(mdir, "flight.json")))
    if (fl["reason"], fl["exit_code"]) != ("drained", 0):
        fail(f"serve cli flight.json: {fl['reason']} {fl['exit_code']}")
    counts = validate_trace_doc(load_trace(os.path.join(mdir, "trace.json")))
    row = {
        "start_s": start_s, "queries": SERVE_QUERIES, "connections": SERVE_CONNS,
        "wall_s": wall, "queries_per_s": (SERVE_QUERIES - 1) / wall,
        "first_query_ms": first_ms, "cpu_reference_s": cpu_s,
        "p50_ms": stats["serve_p50_ms"], "p99_ms": stats["serve_p99_ms"],
        "batch_fill_mean": stats["serve_batch_fill_mean"],
        "batches": stats["serve_batches_total"],
        "cache_hit_rate": stats["serve_cache_hit_rate"],
        "trace_events": counts, "exit_code": rc,
    }
    log(f"  serve cli (V={V}, d={D}, the phase-6 export, coalesce 2 ms): ready in "
        f"{start_s:.1f} s; {SERVE_QUERIES} queries (70/20/10 neighbors/analogy/"
        f"similarity, Zipf words, 20% repeats) on {SERVE_CONNS} connections in "
        f"{wall:.2f} s = {row['queries_per_s']:.0f} q/s, all 200 and = the CPU "
        f"engine; p50 {row['p50_ms']:.3f} ms p99 {row['p99_ms']:.3f} ms, fill "
        f"{row['batch_fill_mean']:.2f}, cache hits {row['cache_hit_rate']:.3f}; "
        f"first query {first_ms:.1f} ms; SIGTERM -> 0, flight.json + trace.json "
        f"({card})")
    return row


def phase_serve_chaos(proc, cpu_eng, words):
    """Part 2, until the hang: the injected oom fails the first batch 503,
    the next CHAOS_CLEAN requests are 200 and right (the stall fires at
    batch 5), then a request wedges batch CHAOS_HANG and the server gets
    two SIGTERMs. Returns the hung request's thread (the forced exit is
    collected at the end of the phase)."""
    import asyncio
    import threading

    port = proc.ready["port"]
    qs = serve_mix(words, CHAOS_CLEAN + 2, seed=9)
    want = expected_answers(cpu_eng, qs)
    key = lambda q: json.dumps(q, sort_keys=True)  # noqa: E731
    st, doc = http_once(port, "GET", query_path(qs[0]))
    oom_msg = doc.get("error", "")
    if st != 503 or not oom_msg.startswith(
            "allocation failure (device out of memory): injected fault"):
        fail(f"serve chaos: the injected oom gave {st} {doc}")
    lat = []
    for q in [qs[0]] + qs[1:CHAOS_CLEAN]:
        t0 = time.perf_counter()
        st, doc = http_once(port, "GET", query_path(q))
        lat.append(time.perf_counter() - t0)
        check_answer("serve chaos", q, st, doc, want[key(q)])
    if lat[3] < 0.2:       # batch 5 carries the stall
        fail(f"serve chaos: the stall@5 did not fire ({lat[3]:.3f} s)")
    st, h = http_once(port, "GET", "/healthz")
    _, stats = http_once(port, "GET", "/stats")
    if st != 200 or stats["serve_batches_total"] != CHAOS_CLEAN + 1:
        fail(f"serve chaos: healthz {st}, batches {stats['serve_batches_total']}")
    hung = {}

    def wedge():
        try:
            hung["reply"] = http_once(port, "GET", query_path(qs[-1]))
        except (ConnectionError, asyncio.IncompleteReadError) as e:
            hung["error"] = repr(e)

    t = threading.Thread(target=wedge, daemon=True)
    t.start()
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    time.sleep(0.5)
    if proc.poll() is not None:
        fail(f"serve chaos: exited {proc.returncode} on the first SIGTERM "
             "with a batch wedged")
    proc.send_signal(signal.SIGTERM)
    t_forced = time.perf_counter()

    def reap():             # the exit's time, while the phase goes on
        proc.wait()
        proc.exit_after_forced_s = time.perf_counter() - t_forced

    proc.reaper = threading.Thread(target=reap, daemon=True)
    proc.reaper.start()
    log(f"  serve chaos ({CHAOS_FAULTS}): the injected oom -> 503 "
        f"'{oom_msg}', then {CHAOS_CLEAN} requests 200 and right (the stall "
        f"at batch 5: {lat[3] * 1e3:.0f} ms), batch {CHAOS_HANG} wedged, two "
        f"SIGTERMs sent")
    return t, hung


def finish_serve_chaos(proc, thread, hung, mdir):
    """Part 2's end: the forced exit is 75 with a flight dump."""
    proc.reaper.join(timeout=120)
    if proc.reaper.is_alive():
        proc.kill()
        fail("serve chaos: no exit within 120 s of the second SIGTERM")
    rc, exit_s = proc.returncode, proc.exit_after_forced_s
    thread.join(timeout=30)
    if rc != 75:
        fail(f"serve chaos: forced exit {rc} != 75: {open(proc.err_path).read()}")
    fl = json.load(open(os.path.join(mdir, "flight.json")))
    if (fl["reason"], fl["exit_code"], fl["exit_reason"]) != (
            "preempted", 75, "forced"):
        fail(f"serve chaos flight.json: {fl['reason']} {fl['exit_code']} "
             f"{fl['exit_reason']}")
    if "reply" in hung and hung["reply"][0] == 200:
        fail("serve chaos: the wedged batch answered")
    return {"exit_code": rc, "exit_after_forced_s": exit_s,
            "flight_reason": fl["reason"], "exit_reason": fl["exit_reason"],
            "stats": {k: fl["stats"][k] for k in (
                "serve_requests_total", "serve_errors_total",
                "serve_batches_total")}}


def fill_cached_blocks():
    """Tensors occupying every free block of 1 MiB or more that the caching
    allocator holds, largest first, so that an allocation that follows
    needs new device memory."""
    free = sorted((b["size"] for seg in torch.cuda.memory_snapshot()
                   for b in seg["blocks"]
                   if b["state"] == "inactive" and b["size"] >= 1 << 20),
                  reverse=True)
    return [torch.empty(n, dtype=torch.uint8, device="cuda") for n in free]


def phase_serve_oom(M, vocab, cpu_eng):
    """Part 3: a real CUDA allocation failure inside the batch -> 503 for
    every query of that batch; the next batch -> 200 and right."""
    import asyncio

    from word2vec_tpu_torch.serve.query import QueryEngine
    from word2vec_tpu_torch.serve.server import EmbeddingServer, ServeConfig

    eng = QueryEngine(M, vocab)
    rng = np.random.default_rng(10)
    qs = [{"op": "neighbors", "word": vocab.words[i], "k": 10}
          for i in rng.choice(V, 256, replace=False)]
    want = expected_answers(cpu_eng, qs)

    async def drive():
        srv = EmbeddingServer(eng, ServeConfig(coalesce_ms=2.0, cache_size=0))
        await srv.start()
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = fill_cached_blocks()
            limit = torch.cuda.memory_reserved() + (16 << 20)
            total = torch.cuda.get_device_properties(0).total_memory
            torch.cuda.set_per_process_memory_fraction(limit / total)
            try:
                oom = await http_session(
                    srv.port, [("POST", "/v1/query", {"queries": qs})])
            finally:
                torch.cuda.set_per_process_memory_fraction(1.0)
                del held
            ok = await http_session(
                srv.port, [("POST", "/v1/query", {"queries": qs})])
            return oom[0], ok[0], limit, srv.stats.snapshot()
        finally:
            srv.begin_drain()
            if await srv.run() != 0:
                fail("serve oom: the in-process server did not drain to 0")

    (st1, doc1), (st2, doc2), limit, stats = asyncio.run(drive())
    msgs = {r["error"].split(".")[0] for r in doc1["results"]
            if r["status"] == 503}
    if st1 != 200 or len(doc1["results"]) != 256 or any(
            r["status"] != 503 for r in doc1["results"]) or msgs != {
            "allocation failure (device out of memory): CUDA out of memory"}:
        fail(f"serve oom: a real CUDA OOM gave {st1} "
             f"{[r['status'] for r in doc1['results']]} {msgs}")
    for q, res in zip(qs, doc2["results"], strict=True):
        check_answer("serve oom recovery", q, res["status"], res,
                     want[json.dumps(q, sort_keys=True)])
    log(f"  serve real CUDA OOM: allocator limit {limit / 2**20:.0f} MiB (16 MiB "
        f"above what this process holds, its free cached blocks occupied), a "
        f"batch of 256 neighbor queries -> 256 x "
        f"503 '{sorted(msgs)[0]}'; limit restored, the same batch -> 256 x 200 "
        f"and right ({stats['serve_batches_total']} batches)")
    return {"limit_mib": limit / 2**20, "oom_503": 256, "recovered_200": 256}


class TimedTopk:
    """Wraps QueryEngine.batch_topk: per call the host ms, the batch rows,
    and a CUDA-event pair around the call on the thread's current stream."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, ids, weights, k):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out = self.fn(ids, weights, k)
        b.record()
        self.calls.append((time.perf_counter() - t0, len(ids), a, b))
        return out

    def summary(self):
        torch.cuda.synchronize()
        host = [c[0] * 1e3 for c in self.calls]
        dev = [c[2].elapsed_time(c[3]) for c in self.calls]
        rows = [c[1] for c in self.calls]
        return {"calls": len(self.calls), "first_host_ms": host[0],
                "first_device_ms": dev[0],
                "device_ms_median": float(np.median(dev)),
                "device_ms_mean": float(np.mean(dev)),
                "host_ms_median": float(np.median(host)),
                "rows_mean": float(np.mean(rows))}


def phase_serve_timing(card):
    """Part 4: an in-process server on a V=1,000,000 x d=300 f32 table, 8,192
    neighbor queries (k=10, distinct words) from 128 clients, coalesce_ms 0
    and 2 interleaved twice; a sample of the answers against a plain f64
    top-k on the card."""
    import asyncio

    from word2vec_tpu_torch.data.vocab import Vocab
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts
    from word2vec_tpu_torch.serve.query import QueryEngine
    from word2vec_tpu_torch.serve.server import EmbeddingServer, ServeConfig

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    W = rng.standard_normal((TIMING_V, D), dtype=np.float32)
    words = [f"w{i}" for i in range(TIMING_V)]
    eng = QueryEngine(W, Vocab(words, np.ones(TIMING_V, np.int64)))
    del W
    build_s = time.perf_counter() - t0
    qids = rng.choice(TIMING_V, TIMING_QUERIES, replace=False)
    paths = [f"/v1/neighbors?word=w{i}&k=10" for i in qids]
    per = TIMING_QUERIES // TIMING_CLIENTS
    real = eng.batch_topk

    async def arm(coalesce_ms):
        srv = EmbeddingServer(eng, ServeConfig(coalesce_ms=coalesce_ms))
        await srv.start()
        try:
            t = time.perf_counter()
            rep = await asyncio.gather(*(
                http_session(srv.port, [("GET", p, None)
                                        for p in paths[c * per:(c + 1) * per]])
                for c in range(TIMING_CLIENTS)))
            wall = time.perf_counter() - t
            return rep, wall, srv.stats.snapshot(srv.cache)
        finally:
            srv.begin_drain()
            if await srv.run() != 0:
                fail("serve timing: the in-process server did not drain to 0")

    arms = []
    reset_launch_counts()
    for coalesce_ms in TIMING_ARMS:
        eng.batch_topk = TimedTopk(real)
        rep, wall, stats = asyncio.run(arm(coalesce_ms))
        flat = [r for sess in rep for r in sess]
        bad = [s for s, _ in flat if s != 200]
        if bad or stats["serve_errors_total"] or len(flat) != TIMING_QUERIES:
            fail(f"serve timing: {len(bad)} non-200 answers, {stats}")
        row = {"coalesce_ms": coalesce_ms, "wall_s": wall,
               "queries_per_s": TIMING_QUERIES / wall,
               "p50_ms": stats["serve_p50_ms"], "p99_ms": stats["serve_p99_ms"],
               "batch_fill_mean": stats["serve_batch_fill_mean"],
               "batches": stats["serve_batches_total"],
               "batch_topk": eng.batch_topk.summary()}
        arms.append(row)
        log(f"  serve timing V={TIMING_V} d={D} coalesce {coalesce_ms} ms: "
            f"{TIMING_QUERIES} queries / {TIMING_CLIENTS} clients in {wall:.2f} s "
            f"= {row['queries_per_s']:.0f} q/s; p50 {row['p50_ms']:.2f} ms p99 "
            f"{row['p99_ms']:.2f} ms; fill {row['batch_fill_mean']:.1f} over "
            f"{row['batches']} batches; batch_topk device "
            f"{row['batch_topk']['device_ms_median']:.3f} ms median (CUDA "
            f"events), first call {row['batch_topk']['first_host_ms']:.1f} ms "
            f"host ({card})")
    launched = {k: v for k, v in LAUNCHES.items() if v}
    if launched:
        fail(f"serve timing: the serving path launched port kernels {launched}")
    eng.batch_topk = real
    prof = profile_topk(eng, qids, round(arms[-1]["batch_topk"]["rows_mean"]))
    log(f"  serve timing: batch_topk of {prof['rows']} rows under torch.profiler: "
        f"{prof['wall_ms']:.3f} ms a call, device busy {prof['busy_ms']:.3f} ms "
        f"(idle {100 * prof['idle_share']:.1f}%), bound {prof['bound_ms']:.4f} ms "
        f"({prof['bound_by']}); top: "
        + ", ".join(f"{n[:40]} {ms:.3f}" for n, ms in prof["top"]) + f" ({card})")
    # a sample of the last arm's answers against a plain f64 top-k
    sample = np.arange(0, TIMING_QUERIES, TIMING_QUERIES // 64)
    t = eng.table.double()
    rows = torch.as_tensor(qids[sample], device=t.device)
    qs = t[rows]
    sc = qs @ t.T
    sc[torch.arange(len(sample), device=t.device), rows] = -float("inf")
    ref_v, ref_i = sc.float().topk(10, dim=1)
    ref_v, ref_i = ref_v.cpu().numpy(), ref_i.cpu().numpy()
    for n, s in enumerate(sample):
        st, doc = flat[s]
        got = doc["neighbors"]
        if [w for w, _ in got] != [f"w{i}" for i in ref_i[n]] or max(
                abs(x - y) for (_, x), y in zip(got, ref_v[n])) > SERVE_TOL:
            fail(f"serve timing: {paths[s]} -> {got[:3]}... != plain f64 top-k")
    del t, qs, sc, eng
    torch.cuda.empty_cache()
    return {"V": TIMING_V, "d": D, "table_bytes": TIMING_V * D * 4,
            "queries": TIMING_QUERIES, "clients": TIMING_CLIENTS,
            "build_s": build_s, "arms": arms, "batch_topk_profile": prof}


def profile_topk(eng, qids, rows, calls=5):
    """batch_topk of `rows` neighbor queries (k=10) under torch.profiler:
    wall and device-busy ms a call, the idle share, the largest device
    items, and the bound of the function it computes: each f32 table
    byte read once, 2·rows·d·V f32 operations."""
    from word2vec_tpu_torch.profile_step import _busy_us

    ids = np.repeat(qids[:rows, None], 3, axis=1).astype(np.int32)
    w = np.tile(np.float32([[1.0, 0.0, 0.0]]), (rows, 1))
    eng.batch_topk(ids, w, 10)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            eng.batch_topk(ids, w, 10)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / calls
    busy = _busy_us(dev)
    V_, d_ = eng.table.shape
    bound, by = bound_ms(V_ * d_ * 4 + rows * 10 * 8, 2.0 * rows * d_ * V_,
                         PEAK_FLOPS[torch.float32])
    return {"rows": rows, "calls": calls, "wall_ms": window_us / 1e3 / calls,
            "busy_ms": busy / 1e3 / calls, "idle_share": 1.0 - busy / window_us,
            "bound_ms": bound, "bound_by": by,
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}


def phase_serve(exported, card, tmp):
    """Phase 8 of the module docstring: the serving tier on the card."""
    from word2vec_tpu_torch.data.vocab import Vocab
    from word2vec_tpu_torch.io.embeddings import load_embeddings_binary
    from word2vec_tpu_torch.serve.query import QueryEngine

    t_phase = time.perf_counter()
    cli_dir, chaos_dir = (os.path.join(tmp, n) for n in ("serve_cli", "serve_chaos"))
    common = ["--vectors", exported, "--format", "binary", "--port", "0",
              "--coalesce-ms", "2"]
    procs = [start_server(common + ["--metrics-dir", cli_dir, "--trace", cli_dir],
                          tmp, "serve_cli"),
             start_server(common + ["--metrics-dir", chaos_dir, "--cache-size", "0",
                                    "--faults", CHAOS_FAULTS], tmp, "serve_chaos")]
    try:
        words, M = load_embeddings_binary(exported)
        vocab = Vocab(words, np.ones(len(words), np.int64))
        cpu_eng = QueryEngine(M, vocab, device="cpu")
        await_ready(procs)
        thread, hung = phase_serve_chaos(procs[1], cpu_eng, words)
        row = {"card": card, "cli": phase_serve_cli(procs[0], cpu_eng, words,
                                                    cli_dir, card)}
        row["real_oom"] = phase_serve_oom(M, vocab, cpu_eng)
        row["timing"] = phase_serve_timing(card)
        row["chaos"] = finish_serve_chaos(procs[1], thread, hung, chaos_dir)
        log(f"  serve chaos: forced exit 75 {row['chaos']['exit_after_forced_s']:.1f} s "
            f"after the second SIGTERM (the wedged batch thread is joined at exit), "
            f"flight.json reason preempted / forced")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"serve_phase": row}))
    return row


# ------------------------------------------------- phase 9: telemetry
TEL_SPE = 18          # steps per epoch of the telemetry corpus
TEL_ITERS = 2         # epochs: 36 steps
TEL_CHUNK = 6
TEL_PROBE = 12        # probe cadence: rows at steps 12, 24, 36
TEL_WINDOW = 6
TEL_SLO = "throughput_wps<0.5*baseline:for=3"
#: the keys of the port CLI's manifest.json after a clean run with --slo:
#: the JAX CLI's (pinned against it by tests/test_torch_telemetry_cli.py)
TEL_MANIFEST_KEYS = (
    "argv", "band_backend", "compile_cache", "config", "corpus_mode", "corpus_rows",
    "corpus_tokens", "cost_calibrate", "cost_harvest", "created_utc",
    "device", "device_memory", "elastic", "elastic_generation", "elastic_policy",
    "final_step", "fleet_health", "git_sha", "kernel", "kernel_decision",
    "mesh_size", "plan", "plan_source", "profiler", "recoveries",
    "resumed_from", "schema", "shutdown", "slo", "versions", "vocab_size",
)
TEL_PROM = ("w2v_loss", "w2v_grad_norm", "w2v_nonfinite_params",
            "w2v_update_norm_emb_in", "w2v_update_norm_emb_out_ns",
            "w2v_alpha_device", "w2v_quality_probes_total",
            "w2v_signal_throughput_wps", "w2v_slo_breaches_total",
            "w2v_step_time_seconds_bucket", "w2v_fleet_throughput_wps")
TEL_HEALTH = ("grad_norm", "update_norm_emb_in", "update_norm_emb_out_ns",
              "nonfinite_params", "alpha_device")


def counted_cli(argv, stop_check=None, stop_wrap=None):
    """cli.main(argv) in process with the launch counts set to 0 just
    before it and read just after, the graph replays and captures counted,
    the synchronizing torch calls counted (torch.cuda.set_sync_debug_mode),
    the warnings and stderr captured; stop_check(step) replaces the
    cooperative stop's poll, stop_wrap(real_check) wraps it. Returns a
    dict: rc, launches, replays, captures, syncs, warnings (their texts),
    stderr, seconds."""
    import contextlib
    import io
    import warnings

    from word2vec_tpu_torch import cli
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts
    from word2vec_tpu_torch.resilience import shutdown

    n = {"replays": 0, "captures": 0}
    replay = torch.cuda.CUDAGraph.replay
    capture_begin = torch.cuda.CUDAGraph.capture_begin

    def counted(self):
        n["replays"] += 1
        return replay(self)

    def counted_capture(self, *a, **k):
        n["captures"] += 1
        return capture_begin(self, *a, **k)

    make_stop = shutdown.ShutdownHandler.make_stop_check
    torch.cuda.CUDAGraph.replay = counted
    torch.cuda.CUDAGraph.capture_begin = counted_capture
    if stop_check is not None:
        shutdown.ShutdownHandler.make_stop_check = lambda self: stop_check
    if stop_wrap is not None:
        shutdown.ShutdownHandler.make_stop_check = (
            lambda self: stop_wrap(make_stop(self)))
    err = io.StringIO()
    t0 = time.perf_counter()
    try:
        reset_launch_counts()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught, \
                contextlib.redirect_stderr(err):
            warnings.simplefilter("always")
            rc = cli.main(argv)
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.CUDAGraph.replay = replay
        torch.cuda.CUDAGraph.capture_begin = capture_begin
        shutdown.ShutdownHandler.make_stop_check = make_stop
    texts = [str(w.message) for w in caught]
    return dict(rc=rc, launches=dict(LAUNCHES), replays=n["replays"],
                captures=n["captures"],
                syncs=sum("synchroniz" in t for t in texts), warnings=texts,
                stderr=err.getvalue(), seconds=time.perf_counter() - t0)


def tel_cli(argv, stop_at=None):
    """counted_cli(argv), stop_at patching the cooperative stop to fire at
    that step (a preemption). Returns (rc, counts, replays, syncs,
    stderr)."""
    r = counted_cli(argv, None if stop_at is None
                    else (lambda step: step >= stop_at))
    return r["rc"], r["launches"], r["replays"], r["syncs"], r["stderr"]


def tel_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def tel_counter_check(dev, vocab, corpus):
    """One flagship step with health_metrics on, graphed, against the same
    step run eagerly from the same draws on a copy of the tables, whose
    counters are computed here from full-table snapshots in float64; then
    the graph once more with an inf planted in a cell the step does not
    touch (the non-finite count must be exactly 1). Returns the comparison
    row and the graphs' device ms a step with health on and off."""
    from word2vec_tpu_torch.device import seed_step
    from word2vec_tpu_torch.models.params import FUSED_KEY, init_params
    from word2vec_tpu_torch.ops.tables import DeviceTables
    from word2vec_tpu_torch.ops.train_step import make_chunk_runner

    cfg = flagship_cfg("pallas_fused", "unified", health_metrics=True)
    tables = DeviceTables.build(vocab, cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    p0 = init_params(cfg, len(vocab), gen)
    p0[FUSED_KEY][:, 1].normal_(0.0, 0.01, generator=gen)  # both planes move
    tokens = corpus_batch(dev, corpus)
    seed, step, alpha = 7, 3, 0.025
    runner = make_chunk_runner(cfg, tables, graphed=True)
    base = runner.step.base
    ref = {k: v.clone() for k, v in p0.items()}
    seed_step(gen, seed, step)
    draws = base.draw(gen, tokens)
    old = ref[FUSED_KEY].clone()
    base.apply(ref, tokens, draws, torch.tensor(alpha, device=dev))
    want = {}
    for i, sub in enumerate(("emb_in", "emb_out_ns")):
        d = ref[FUSED_KEY][:, i].double() - old[:, i].double()
        want["update_sq_" + sub] = float((d * d).sum())
    want["grad_sq"] = want["update_sq_emb_in"] + want["update_sq_emb_out_ns"]
    want["nonfinite_params"] = float((~torch.isfinite(ref[FUSED_KEY])).sum())
    work = {k: v.clone() for k, v in p0.items()}
    m = runner(work, tokens[None], seed, step, np.float32([alpha]))
    got = {k: float(m[k][0]) for k in want}
    if not same_params(work, ref):
        fail("telemetry: the graphed health step's tables differ from the "
             "eager step's (bitwise)")
    # the same graph again on the start tables with one cell no step of
    # these draws touches set to inf: the whole table is counted
    touched = torch.zeros(V, dtype=torch.bool, device=dev)
    ids = torch.cat([tokens.reshape(-1), draws.negs.reshape(-1)]).long()
    touched[ids[ids >= 0]] = True
    free = int((~touched).nonzero().max())
    work[FUSED_KEY].copy_(p0[FUSED_KEY])
    work[FUSED_KEY][free, 1, 7] = float("inf")
    m = runner(work, tokens[None], seed, step, np.float32([alpha]))
    got_inf = float(m["nonfinite_params"][0])
    row = {"free_row": free, "nonfinite_params_planted": got_inf}
    if got_inf != 1.0:
        fail(f"telemetry: one planted inf cell counted as {got_inf}")
    for k in want:
        if k == "nonfinite_params":
            err = abs(got[k] - want[k])
            ok = err == 0.0
        else:
            err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
            ok = err <= 1e-5 and want[k] > 0
        row[k] = {"graph": got[k], "reference": want[k], "rel_err": err}
        if not ok:
            fail(f"telemetry counter {k}: graph {got[k]} vs reference {want[k]}")
    # the step's device time with health on and off (CUDA events around
    # one replay; the off graph is the one captured without health_metrics)
    off = make_chunk_runner(flagship_cfg("pallas_fused", "unified"), tables,
                            graphed=True)
    times = {}
    for name, r in (("health_on", runner), ("health_off", off)):
        params = {k: v.clone() for k, v in p0.items()}
        g = r.stream_graph(params, (1, B, L))
        g.tokens.copy_(tokens[None])
        g.alphas.fill_(alpha)
        times[name] = cuda_ms(lambda g=g: (g.slot.zero_(), g.run(seed, step)), 20)
        del params, g
    return row, times


def tel_flags(vocab, corpus, tmp):
    """The CLI flags of the phase 9 and 10 runs: the first TEL_SPE
    flagship steps of phase 5's corpus as a text8 file beside phase 6's
    vocabulary file (written here when missing), pallas_fused/unified,
    chunk_steps TEL_CHUNK, TEL_ITERS epochs, no vectors written."""
    txt = os.path.join(tmp, "telemetry.txt")
    vtxt = os.path.join(tmp, "vocab.txt")  # phase 6's vocabulary file
    if not os.path.exists(vtxt):
        vocab.save(vtxt)
    if not os.path.exists(txt):
        with open(txt, "w") as f:
            f.write(" ".join(np.asarray(vocab.words)[
                corpus.flat[:TEL_SPE * B * L]].tolist()))
    return ["-train", txt, "-read-vocab", vtxt, "-output", "", "-size", str(D),
            "-window", str(W), "-negative", str(K), "-iter", str(TEL_ITERS),
            "--batch-rows", str(B), "--max-sentence-len", str(L),
            "--shared-negatives", str(KP), "--band-backend", "pallas_fused",
            "--table-layout", "unified", "--chunk-steps", str(TEL_CHUNK),
            "--quiet", "--log-every", str(TEL_CHUNK)]


def phase_telemetry(vocab, corpus, card, tmp):
    """The trainer's telemetry through the CLI on the card (phase 9 of the
    module docstring)."""
    from word2vec_tpu_torch.io.checkpoint import save_checkpoint
    from word2vec_tpu_torch.models.params import FUSED_KEY, init_params
    from word2vec_tpu_torch.obs import tracediff
    from word2vec_tpu_torch.obs.quality import ProbeSet, QualityProbe
    from word2vec_tpu_torch.obs.trace import load_trace, validate_trace_doc
    from word2vec_tpu_torch.train import TrainState

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    row = {"card": card}
    steps = TEL_SPE * TEL_ITERS
    flags = tel_flags(vocab, corpus, tmp)
    pairs = os.path.join(tmp, "probe_pairs.txt")
    prng = np.random.default_rng(4)
    with open(pairs, "w") as f:
        for i in range(0, 64, 2):
            f.write(f"{vocab.words[i]},{vocab.words[i + 1]},{prng.uniform(0, 10):.2f}\n")
    want = expected_launches("pallas_fused", "unified", steps + 1)

    def run_on(i, probe=TEL_PROBE):
        d = os.path.join(tmp, f"tel_on{i}")
        argv = flags + [
            "--metrics-dir", d, "--trace", d + "_trace",
            "--prom-textfile", d + ".prom", "--health-metrics", "1",
            "--quality-probe-every", str(probe), "--slo", TEL_SLO,
            "--signal-window", str(TEL_WINDOW), "--emit-device",
            "--log-jsonl", d + ".jsonl"]
        return d, tel_cli(argv)

    def run_off(i):
        jl = os.path.join(tmp, f"tel_off{i}.jsonl")
        return jl, tel_cli(flags + ["--log-jsonl", jl])

    # the timing arms, interleaved twice: all telemetry on, all off
    wps = {"on": [], "off": []}
    arms = {}
    for i in range(2):
        for arm, fn in (("on", run_on), ("off", run_off)):
            where, (rc, counts, replays, syncs, err) = fn(i)
            if rc != 0:
                fail(f"telemetry {arm} run {i}: exit {rc}: {err[-2000:]}")
            jl = where + ".jsonl" if arm == "on" else where
            recs = tel_records(jl)
            rep = [r for r in recs if r.get("event") == "train_report"][-1]
            if rep["steps"] != steps or rep["nonfinite_loss_steps"]:
                fail(f"telemetry {arm} run {i}: {rep}")
            if counts != want or replays != steps:
                fail(f"telemetry {arm} run {i}: launches {counts} (want {want}), "
                     f"{replays} replays (want {steps})")
            wps[arm].append(rep["words_per_sec"])
            arms[arm] = (where, recs, err, syncs)
    # the same run without the probe: health, signals, phases, the flight
    # recorder and the sinks add no synchronizing call to the off run's
    where, (rc, counts, replays, syncs_np, _) = run_on(9, probe=0)
    if rc != 0 or counts != want or replays != steps:
        fail(f"telemetry run without the probe: rc {rc}, {counts}, {replays}")
    wps["on_without_probe"] = [r for r in tel_records(where + ".jsonl")
                               if r.get("event") == "train_report"][-1]["words_per_sec"]
    syncs_off = arms["off"][3]
    if syncs_np != syncs_off:
        fail(f"telemetry: {syncs_np} synchronizing calls with the telemetry on "
             f"and no probe, {syncs_off} with it off")
    row["syncs"] = {"off": syncs_off, "on_without_probe": syncs_np,
                    "on_with_probe": arms["on"][3]}
    row["launches"], row["replays"] = want, steps

    # the files of the last on run
    d, recs, err, _ = arms["on"]
    line = [x for x in err.splitlines() if x.startswith("device: ")]
    if not line or not line[0].startswith("device: gpu NVIDIA H100"):
        fail(f"--emit-device printed {line}")
    row["emit_device"] = line[0]
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    if sorted(man) != sorted(TEL_MANIFEST_KEYS) or man["shutdown"] != "clean" \
            or man["device"]["platform"] != "gpu":
        fail(f"manifest.json keys {sorted(man)} / shutdown {man.get('shutdown')}")
    doc = load_trace(os.path.join(d + "_trace", "trace.json"))
    validate_trace_doc(doc)
    parents = [e for e in doc["traceEvents"]
               if e.get("ph") == "X" and e.get("name") in ("step", "chunk")]
    summ = tracediff.summarize(doc)
    if summ["steps"] != steps or len(parents) != steps // TEL_CHUNK or \
            sorted(e["args"]["step"] for e in parents) != list(
                range(TEL_CHUNK, steps + 1, TEL_CHUNK)):
        fail(f"trace.json: {len(parents)} parents, {summ['steps']} steps")
    with open(d + ".prom") as f:
        prom = f.read()
    missing = [n for n in TEL_PROM if n not in prom]
    if missing:
        fail(f"the prom file lacks {missing}")
    srecs = [r for r in recs if "loss" in r and "event" not in r]
    if len(srecs) != steps // TEL_CHUNK or any(
            k not in r for r in srecs for k in TEL_HEALTH) or any(
            r["nonfinite_params"] != 0 or not r["grad_norm"] > 0 for r in srecs):
        fail(f"step records without the health fields: {srecs[:1]}")
    probes = [r for r in recs if "quality_row_norm_p50" in r]
    if [r["step"] for r in probes] != list(range(TEL_PROBE, steps + 1, TEL_PROBE)):
        fail(f"probe rows at {[r['step'] for r in probes]}")
    row["files"] = sorted(os.listdir(d))
    row["trace_steps"] = summ["steps"]
    row["phases"] = srecs[-1]["phases"]
    row["words_per_sec"] = wps
    log(f"  telemetry on/off, {steps} steps (chunk {TEL_CHUNK}), words/sec: "
        f"on {wps['on']}, off {wps['off']} (A B A B), on without the probe "
        f"{wps['on_without_probe']} (after them; {card}); launches and "
        f"{steps} replays equal in both; synchronizing calls off "
        f"{syncs_off}, on without the probe {syncs_np}, with it {arms['on'][3]}")

    # the counters against a full-table reference, the step's device ms
    chk, step_ms = tel_counter_check(dev, vocab, corpus)
    row["counter_check"], row["step_device_ms"] = chk, step_ms
    log(f"  health counters vs full-table reference: "
        + ", ".join(f"{k} rel err {v['rel_err']:.2e}" for k, v in chk.items()
                    if isinstance(v, dict))
        + f"; step device ms health on {step_ms['health_on']:.4f}, off "
        f"{step_ms['health_off']:.4f} ({card})")

    # the probe's ms on the flagship tables: host copy and scoring
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    cfg = flagship_cfg("pallas_fused", "unified")
    params = init_params(cfg, len(vocab), gen)
    params[FUSED_KEY][:, 1].normal_(0.0, 0.01, generator=gen)
    probe = QualityProbe(vocab, ProbeSet.from_files(vocab, pairs, None), every=1)
    split = []
    for i in range(4):
        torch.cuda.synchronize()
        probe.probe(params, i + 1)
        split.append(dict(probe.timing))
    row["probe_ms"] = {k: float(np.median([t[k] for t in split[1:]]))
                       for k in ("copy_ms", "score_ms")}
    log(f"  quality probe (V={V}, d={D}, unified): host copy "
        f"{row['probe_ms']['copy_ms']:.2f} ms, scoring "
        f"{row['probe_ms']['score_ms']:.2f} ms (wall, median of 3; {card})")
    del params

    # the abnormal exits, each with flight.json and the manifest's shutdown
    exits = {}
    qd = os.path.join(tmp, "tel_quality")
    rc, *_ = tel_cli(flags + [
        "--metrics-dir", qd, "--quality-probe-every", str(TEL_CHUNK),
        "--probe-pairs", pairs, "--quality-budget", "1",
        "--quality-floor", "0.99", "--quality-grace", "0"])
    exits["quality_alert"] = (rc, qd, 3)
    ck = os.path.join(tmp, "tel_nan_ck")
    ncfg = flagship_cfg("pallas_fused", "unified", chunk_steps=TEL_CHUNK,
                        iters=TEL_ITERS, health_metrics=True,
                        divergence_budget=2)
    nparams = init_params(ncfg, len(vocab), gen)
    nparams[FUSED_KEY][0, 0, :] = float("nan")
    save_checkpoint(ck, TrainState(nparams, 0, 0, 0), ncfg, vocab)
    del nparams
    nd = os.path.join(tmp, "tel_nan")
    rc, *_ = tel_cli(flags + ["--metrics-dir", nd, "--resume", ck])
    exits["diverged"] = (rc, nd, 2)
    pd = os.path.join(tmp, "tel_preempt")
    rc, *_ = tel_cli(flags + ["--metrics-dir", pd], stop_at=TEL_PROBE)
    exits["preempted"] = (rc, pd, 75)
    shutdowns = {"quality_alert": "quality_degraded", "diverged": "diverged",
                 "preempted": "preempted"}
    row["exits"] = {}
    for reason, (rc, where, want_rc) in exits.items():
        with open(os.path.join(where, "flight.json")) as f:
            fl = json.load(f)
        with open(os.path.join(where, "manifest.json")) as f:
            sd = json.load(f).get("shutdown")
        if rc != want_rc or fl.get("reason") != reason or sd != shutdowns[reason]:
            fail(f"telemetry exit {reason}: rc {rc}, flight {fl.get('reason')}, "
                 f"shutdown {sd}")
        bad = max([c.get("nonfinite_params", 0) for c in fl.get("counters", [])]
                  or [0])
        if reason == "diverged" and not bad > 0:
            fail(f"the divergence dump has no non-finite cells: {fl.get('counters')}")
        row["exits"][reason] = {"rc": rc, "failure_step": fl.get("failure_step"),
                                "nonfinite_params_max": bad}
    log("  exits: " + ", ".join(f"{k} rc {v['rc']} at step {v['failure_step']}"
                                for k, v in row["exits"].items())
        + " — each with flight.json and the manifest's shutdown")
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"telemetry_phase": row}))


# ------------------------------- phase 10: resilience and device telemetry
RES_STEPS = TEL_SPE * TEL_ITERS   # 36 steps a run, chunk TEL_CHUNK
RES_NAN = 20          # nan@20 lands at boundary 24, after its checkpoint
RES_HANG = 12         # hang@12: wedges the loop right after boundary 12
RES_DEADLINE = 2.0
RES_TERM = 18
RES_PROFILE = (12, 18)
RES_USR2_AT = 12      # the SIGUSR2 is sent at this boundary
RES_MEM_EVERY = 6
SLAB_BYTES = V * 2 * D * 4   # the unified f32 slab, 170,400,000 bytes
RES_PROM = ("w2v_mem_bytes_in_use", "w2v_mem_peak_bytes",
            "w2v_mem_bytes_limit", "w2v_mem_headroom_frac",
            "w2v_mem_available", "w2v_cost_harvest_programs")


def res_wedge(vocab, corpus, dev, out_dir):
    """A wedged card: a StepWatchdog (deadline 0.5 s, on_fire, its stall
    files into out_dir) on a flagship Trainer's PhaseRecorder, two beats,
    then ~2 s of spin enqueued (torch.cuda._sleep) and the host waiting
    for it under the device_wait span, as the trainer's lagged fetch
    waits. Returns (the fire record, the spin's wall seconds)."""
    from word2vec_tpu_torch.resilience.watchdog import StepWatchdog
    from word2vec_tpu_torch.train import Trainer

    tr = Trainer(flagship_cfg("pallas_fused", "unified"), vocab, corpus,
                 device=dev)
    rec = {}
    wd = StepWatchdog(deadline=0.5, phases=tr.phases, metrics_dir=out_dir,
                      on_fire=rec.update)
    torch.cuda.synchronize()
    wd.arm()
    wd.beat(1)
    wd.beat(2)
    t0 = time.perf_counter()
    torch.cuda._sleep(int(2.0 * sm_clock_hz()))
    with tr.phases.span("device_wait"):
        torch.cuda.synchronize()
    spin = time.perf_counter() - t0
    wd.disarm()
    with open(os.path.join(out_dir, "stall.json")) as f:
        phase = json.load(f)["phase"]
    if not wd.fired.is_set() or rec.get("phase") != "device_wait" \
            or phase != "device_wait":
        fail(f"the watchdog did not name the wedged card: {rec}")
    return rec, spin


def phase_resilience(vocab, corpus, card, tmp):
    """Resilience and device telemetry through the CLI on the card (phase
    10 of the module docstring)."""
    from word2vec_tpu_torch import train as train_mod
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint, verify_checkpoint
    from word2vec_tpu_torch.obs import profiler as profiler_mod
    from word2vec_tpu_torch.obs.devmem import MemoryLedger
    from word2vec_tpu_torch.obs.profiler import validate_capture_doc
    from word2vec_tpu_torch.resilience import supervisor as sup_mod

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    flags = tel_flags(vocab, corpus, tmp)
    steps = RES_STEPS
    row = {"card": card}

    def path(name):
        return os.path.join(tmp, "res_" + name)

    def run(argv, what, want_rc=0, stop_check=None):
        r = counted_cli(argv, stop_check)
        if r["rc"] != want_rc:
            fail(f"resilience {what}: exit {r['rc']} (want {want_rc}): "
                 f"{r['stderr'][-2000:]}")
        return r

    def counts_of(r, replays, what):
        want = expected_launches("pallas_fused", "unified", replays + 1)
        if r["launches"] != want or r["replays"] != replays or r["captures"] != 1:
            fail(f"resilience {what}: launches {r['launches']} (want {want}), "
                 f"{r['replays']} replays (want {replays}), {r['captures']} "
                 "captures (want 1)")

    def manifest(d):
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    def same_vectors(a, b):
        with open(a, "rb") as x, open(b, "rb") as y:
            return x.read() == y.read()

    # the stall: a subprocess (the watchdog's fire path os._exits), started
    # first; it is collected after the in-process runs
    stall_d, stall_ck = path("stall"), path("stall_ck")
    stall_log = open(path("stall.log"), "w")
    stall = subprocess.Popen(
        [sys.executable, "-m", "word2vec_tpu_torch.cli", *flags,
         "--health-metrics", "0", "--checkpoint-dir", stall_ck,
         "--checkpoint-every", "6", "--faults", f"hang@{RES_HANG}:secs=120",
         "--step-deadline", str(RES_DEADLINE), "--metrics-dir", stall_d],
        stdout=stall_log, stderr=subprocess.STDOUT, cwd=HERE,
        env={**os.environ, "PYTHONPATH": HERE},
    )
    t_stall = time.perf_counter()
    try:
        # the uninterrupted run every resume is held against
        full_ck, full_vec = path("full_ck"), path("full.bin")
        full = run(flags + ["--checkpoint-dir", full_ck, "-output", full_vec,
                            "-binary", "1"], "uninterrupted run")
        counts_of(full, steps, "uninterrupted run")

        # auto-recovery: the rollback (its checkpoint load, then the copy
        # into the captured graph's buffers) timed in place
        timing = {}
        recover, adopt = sup_mod.Supervisor._recover, train_mod.Trainer._adopt

        def timed_recover(self, err, attempt):
            t0 = time.perf_counter()
            out = recover(self, err, attempt)
            timing["load_s"] = time.perf_counter() - t0
            return out

        def timed_adopt(self, params):
            if "load_s" not in timing or "copy_s" in timing:
                return adopt(self, params)
            t0 = time.perf_counter()
            out = adopt(self, params)
            torch.cuda.synchronize()
            timing["copy_s"] = time.perf_counter() - t0
            return out

        rec_d, rec_ck = path("rec"), path("rec_ck")
        sup_mod.Supervisor._recover = timed_recover
        train_mod.Trainer._adopt = timed_adopt
        try:
            rec = run(flags + [
                "--checkpoint-dir", rec_ck, "--checkpoint-every", "12",
                "--checkpoint-keep", "2", "--faults", f"nan@{RES_NAN}",
                "--divergence-budget", "2", "--auto-recover", "1",
                "--metrics-dir", rec_d], "auto-recovery")
        finally:
            sup_mod.Supervisor._recover = recover
            train_mod.Trainer._adopt = adopt
        man = manifest(rec_d)
        recs = man.get("recoveries") or []
        if man["shutdown"] != "clean" or len(recs) != 1:
            fail(f"auto-recovery: shutdown {man['shutdown']}, recoveries {recs}")
        r0 = recs[0]
        if not (r0["resume_step"] < r0["failed_step"]
                and r0["init_alpha"] == 0.025 * 0.5 and r0["seed"] == 1):
            fail(f"auto-recovery record {r0}")
        counts_of(rec, steps + steps - r0["resume_step"], "auto-recovery")
        st, _, _ = load_checkpoint(rec_ck)
        if st.step != steps or not all(
                bool(torch.isfinite(v).all()) for v in st.params.values()):
            fail(f"auto-recovery: the final tables (step {st.step}) are not "
                 "all finite")
        recovery_s = timing["load_s"] + timing["copy_s"]
        row["recovery"] = dict(r0, load_s=timing["load_s"],
                               copy_s=timing["copy_s"], total_s=recovery_s,
                               replays=rec["replays"], captures=rec["captures"])
        log(f"  auto-recovery: rolled back from step {r0['failed_step']} to "
            f"{r0['rolled_back_to']}, alpha {r0['init_alpha']}, seed "
            f"{r0['seed']}; one capture, {rec['replays']} replays; recovery "
            f"{recovery_s:.4f} s = checkpoint load {timing['load_s']:.4f} s + "
            f"copy into the graph's buffers {timing['copy_s']:.4f} s ({card})")

        # preemption by a real SIGTERM, then the resume
        term_ck = path("term_ck")
        run(flags + ["--checkpoint-dir", term_ck, "--faults",
                     f"sigterm@{RES_TERM}"], "sigterm", want_rc=75)
        term_res_ck, term_vec = path("term_res_ck"), path("term_res.bin")
        term_res = run(flags + ["--resume", term_ck, "--checkpoint-dir",
                                term_res_ck, "-output", term_vec, "-binary", "1"],
                       "resume after the preemption")
        counts_of(term_res, steps - RES_TERM, "resume after the preemption")
        if not (npz_bitwise(full_ck, term_res_ck) and same_vectors(full_vec, term_vec)):
            fail("the resume after sigterm differs from the uninterrupted run")

        # checkpoint write faults: two injected OSErrors, retried
        oe_ck = path("oe_ck")
        oe = run(flags + ["--checkpoint-dir", oe_ck, "--checkpoint-every", "12",
                          "--faults", "ckpt_oserror:times=2"], "ckpt_oserror")
        retries = [w for w in oe["warnings"] if "retry" in w]
        verify_checkpoint(oe_ck)
        if len(retries) != 2 or load_checkpoint(oe_ck)[0].step != steps:
            fail(f"ckpt_oserror: {len(retries)} retry warnings: {retries}")
        row["ckpt_oserror_retries"] = retries

        # the memory ledger, sampled every 6 boundaries and every 36
        mem_d = path("mem")
        mem = run(flags + ["--metrics-dir", mem_d, "--mem-sample-every",
                           str(RES_MEM_EVERY)], "memory ledger")
        mem36 = run(flags + ["--metrics-dir", path("mem36"),
                             "--mem-sample-every", str(steps)], "ledger / 36")
        for k in ("launches", "replays", "syncs"):
            if mem[k] != mem36[k]:
                fail(f"memory ledger: {k} {mem[k]} sampling every "
                     f"{RES_MEM_EVERY}, {mem36[k]} every {steps}")
        counts_of(mem, steps, "memory ledger")
        with open(os.path.join(mem_d, "metrics.prom")) as f:
            prom = f.read()
        missing = [n for n in RES_PROM if n not in prom]
        dm = manifest(mem_d)["device_memory"]
        ph = dm["phases"]
        if missing or not dm["available"] or sorted(ph) != [
                "init", "table_place", "train_step"] \
                or ph["table_place"]["bytes_in_use_max"] < SLAB_BYTES \
                or ph["train_step"]["samples"] != steps // RES_MEM_EVERY \
                or not 0.0 < dm["headroom_frac_min"] < 1.0:
            fail(f"memory ledger: prom lacks {missing}; device_memory {dm}")
        led = MemoryLedger(devices=[dev])
        led.sample("init")
        t0 = time.perf_counter()
        for _ in range(1000):
            led.sample("train_step")
        sample_us = (time.perf_counter() - t0) / 1000 * 1e6
        row["memory"] = {"device_memory": dm, "sample_us": sample_us,
                         "syncs": mem["syncs"]}
        log(f"  memory ledger: table_place {ph['table_place']['bytes_in_use_max']:,}"
            f" B in use (slab {SLAB_BYTES:,}), peak {dm['peak_bytes']:,} B, "
            f"headroom min {dm['headroom_frac_min']}, {ph['train_step']['samples']} "
            f"train samples; launches, replays and {mem['syncs']} synchronizing "
            f"calls equal at every 6 and every 36; {sample_us:.2f} us a sample "
            f"({card})")

        # bounded profiler windows: --profile-steps, then a real SIGUSR2
        caps = []
        init = profiler_mod.ProfilerCapture.__init__

        def keep(self, *a, **k):
            init(self, *a, **k)
            caps.append(self)

        profiler_mod.ProfilerCapture.__init__ = keep
        try:
            prof_d = path("prof")
            prof = run(flags + ["--metrics-dir", prof_d, "--profile-steps",
                                "%d:%d" % RES_PROFILE], "profile window")
            usr2_d, sent = path("usr2"), []

            def send_usr2(step):
                if step >= RES_USR2_AT and not sent:
                    sent.append(step)
                    os.kill(os.getpid(), signal.SIGUSR2)
                return False

            run(flags + ["--metrics-dir", usr2_d], "SIGUSR2",
                stop_check=send_usr2)
        finally:
            profiler_mod.ProfilerCapture.__init__ = init
        counts_of(prof, steps, "profile window")
        with open(os.path.join(prof_d, "capture_1.json")) as f:
            doc = json.load(f)
        validate_capture_doc(doc)
        with open(os.path.join(doc["trace_dir"], doc["files"][0])) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        window = RES_PROFILE[1] - RES_PROFILE[0]
        seen = {"fused_grad_core": sum("grad_core" in n for n in names),
                "fused_slab_scatter": sum("slab_scatter" in n for n in names)}
        per = expected_launches("pallas_fused", "unified", window)
        if (doc["armed_step"], doc["stopped_step"]) != RES_PROFILE or any(
                seen[k] != per[k] for k in seen):
            fail(f"profile window {doc['armed_step']}:{doc['stopped_step']}: "
                 f"kernels {seen} (want {dict((k, per[k]) for k in seen)})")
        with open(os.path.join(usr2_d, "capture_1.json")) as f:
            udoc = json.load(f)
        validate_capture_doc(udoc)
        with open(os.path.join(usr2_d, "mem_usr2.json")) as f:
            umem = json.load(f)
        if udoc["reason"] != "sigusr2" or umem["reason"] != "sigusr2" \
                or not umem["summary"]["available"]:
            fail(f"SIGUSR2: capture {udoc}, ledger dump {umem.get('reason')}")
        row["profiler"] = {"window": doc, "kernels": seen,
                           "timing": [c.timing for c in caps],
                           "sigusr2": {"capture": udoc, "sent_at": sent}}
        log(f"  profiler: window {RES_PROFILE[0]}:{RES_PROFILE[1]} holds "
            f"{seen} (the {window} steps' launches); profiler start / stop "
            + ", ".join(f"{c.timing['start_ms']:.1f} / {c.timing['stop_ms']:.1f} ms"
                        for c in caps)
            + f"; SIGUSR2 at step {sent} -> capture armed at "
            f"{udoc['armed_step']}, stopped at {udoc['stopped_step']}, "
            f"mem_usr2.json ({card})")

        # the device wedge, named by the watchdog
        wedge, spin = res_wedge(vocab, corpus, dev, path("wedge"))
        row["wedge"] = dict(wedge, spin_s=spin)
        log(f"  device wedge: fired after {wedge['elapsed_s']} s (deadline "
            f"{wedge['effective_deadline_s']} s) naming {wedge['phase']}; "
            f"the spin took {spin:.2f} s")

        # the stall, collected
        try:
            stall_rc = stall.wait(timeout=300)
        except subprocess.TimeoutExpired:
            stall.kill()
            fail("the stalled run was not shot within 300 s")
        stall_wall = time.perf_counter() - t_stall
    finally:
        if stall.poll() is None:
            stall.kill()
            stall.wait()
        stall_log.close()
    with open(path("stall.log")) as f:
        stall_out = f.read()
    if stall_rc != 76:
        fail(f"the stalled run exited {stall_rc}: {stall_out[-2000:]}")
    with open(os.path.join(stall_d, "stall.json")) as f:
        srec = json.load(f)
    with open(os.path.join(stall_d, "flight.json")) as f:
        sfl = json.load(f)
    if srec["step"] < RES_HANG or srec["elapsed_s"] > 2 * RES_DEADLINE + 1.0 \
            or os.path.getsize(os.path.join(stall_d, "stall_stacks.txt")) == 0 \
            or sfl["reason"] != "stalled" \
            or manifest(stall_d)["shutdown"] != "stalled":
        fail(f"stall: {srec}, flight {sfl.get('reason')}")
    stall_res_ck, stall_vec = path("stall_res_ck"), path("stall_res.bin")
    sres = run(flags + ["--resume", stall_ck, "--checkpoint-dir", stall_res_ck,
                        "-output", stall_vec, "-binary", "1"],
               "resume after the stall")
    counts_of(sres, steps - RES_HANG, "resume after the stall")
    if not (npz_bitwise(full_ck, stall_res_ck) and same_vectors(full_vec, stall_vec)):
        fail("the resume after the stall differs from the uninterrupted run")
    row["stall"] = dict(srec, process_wall_s=stall_wall,
                        past_deadline_s=srec["elapsed_s"] - RES_DEADLINE)
    log(f"  stall: exit 76, stall.json at step {srec['step']}, phase "
        f"{srec['phase']}, {srec['elapsed_s']} s after the wedge (deadline "
        f"{RES_DEADLINE} s, effective {srec['effective_deadline_s']} s); "
        "stall_stacks.txt, flight.json (stalled), shutdown stalled; the resume "
        "and the sigterm resume equal the uninterrupted run bitwise")

    # words/sec with the watchdog armed and without, interleaved twice
    wps, arms = {"on": [], "off": []}, {}
    for i in range(2):
        for arm in ("on", "off"):
            jl = path(f"wd_{arm}{i}.jsonl")
            extra = ["--step-deadline", "30"] if arm == "on" else []
            r = run(flags + extra + ["--log-jsonl", jl], f"watchdog {arm}")
            rep = [x for x in tel_records(jl)
                   if x.get("event") == "train_report"][-1]
            wps[arm].append(rep["words_per_sec"])
            arms.setdefault(arm, []).append(r)
    for a, b in zip(arms["on"], arms["off"]):
        if any(a[k] != b[k] for k in ("launches", "replays", "syncs")):
            fail(f"the watchdog changed the launches, replays or syncs: "
                 f"{[(a[k], b[k]) for k in ('launches', 'replays', 'syncs')]}")
    row["words_per_sec"] = wps
    row["syncs"] = {"watchdog_on": arms["on"][0]["syncs"],
                    "watchdog_off": arms["off"][0]["syncs"]}
    log(f"  words/sec with --step-deadline 30 {wps['on']}, without "
        f"{wps['off']} (A B A B; {card}); launches, replays and "
        f"{arms['on'][0]['syncs']} synchronizing calls equal")
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"resilience_phase": row}, default=str))


# ------------------------------------------------------------ phase 11
STREAM_SEG = 380_000       # --segment-tokens: 4 segments of ~8 flagship steps
STREAM_TOKENS = 4 * STREAM_SEG   # the first 1,520,000 tokens of phase 5's corpus
STREAM_RESERVE = 4096      # --vocab-reserve
STREAM_CHUNK = 6           # --chunk-steps
STREAM_EVERY = 6           # --checkpoint-every


def stream_flags(vocab, corpus, tmp, train=None, mode="streaming"):
    """The CLI flags of the phase 11 runs: phase 5's corpus, its first
    STREAM_TOKENS tokens as one text8 file (no -read-vocab: the vocabulary
    boots from segment 0 at -min-count 5), pallas_fused/unified, chunk
    STREAM_CHUNK, one epoch, no vectors written unless -output is added."""
    txt = os.path.join(tmp, "stream.txt")
    if not os.path.exists(txt):
        with open(txt, "w") as f:
            f.write(" ".join(np.asarray(vocab.words)[
                corpus.flat[:STREAM_TOKENS]].tolist()))
    flags = ["-train", train or txt, "-output", "", "-size", str(D),
             "-window", str(W), "-negative", str(K), "-iter", "1",
             "-min-count", "5", "--batch-rows", str(B),
             "--max-sentence-len", str(L), "--shared-negatives", str(KP),
             "--band-backend", "pallas_fused", "--table-layout", "unified",
             "--chunk-steps", str(STREAM_CHUNK), "--quiet",
             "--log-every", str(STREAM_CHUNK)]
    if mode == "streaming":
        flags += ["--corpus-mode", "streaming", "--segment-tokens",
                  str(STREAM_SEG), "--vocab-reserve", str(STREAM_RESERVE)]
    return flags, txt


class StreamTimeline:
    """Host-clock events of one streaming CLI run, taken by wrapping the
    functions a segment boundary runs (no sync is added): each train()
    call (one a segment), the trainer's syncs, every _runner call (and
    whether it captured), refresh_vocab_tables, each dispatch's start,
    the encode and the pack of each segment, each checkpoint save and each
    source read (with the thread it ran on)."""

    def __init__(self):
        self.ev = []

    def __enter__(self):
        import threading

        from word2vec_tpu_torch import train as train_mod
        from word2vec_tpu_torch.io import checkpoint as ck_mod
        from word2vec_tpu_torch.ops import graphs
        from word2vec_tpu_torch.stream import driver, source

        ev, now = self.ev, time.perf_counter
        T = train_mod.Trainer
        real = {
            (T, "_sync"): T._sync, (T, "train"): T.train,
            (T, "_runner"): T._runner,
            (T, "refresh_vocab_tables"): T.refresh_vocab_tables,
            (graphs.ChunkRunner, "run"): graphs.ChunkRunner.run,
            (driver, "encode_segment"): driver.encode_segment,
            (driver, "PackedCorpus"): driver.PackedCorpus,
            (ck_mod, "save_checkpoint"): ck_mod.save_checkpoint,
            (source.FileSource, "read_segment"): source.FileSource.read_segment,
        }
        self.real = real

        def timed(kind, fn):
            def call(*a, **k):
                t0 = now()
                out = fn(*a, **k)
                ev.append((kind, t0, now()))
                return out
            return call

        def sync(tr):
            real[(T, "_sync")](tr)
            ev.append(("sync", now(), now()))

        def runner(tr, n):
            before = sum(len(r._graphs) for r in tr._runners.values())
            t0 = now()
            out = real[(T, "_runner")](tr, n)
            after = sum(len(r._graphs) for r in tr._runners.values())
            ev.append(("capture" if after > before else "runner", t0, now()))
            return out

        def run(self_, *a, **k):
            ev.append(("dispatch", now(), now()))
            return real[(graphs.ChunkRunner, "run")](self_, *a, **k)

        packed = real[(driver, "PackedCorpus")]

        class TimedPack:
            @staticmethod
            def from_flat(flat, max_len):
                t0 = now()
                out = packed.from_flat(flat, max_len)
                ev.append(("pack", t0, now()))
                return out

        read = real[(source.FileSource, "read_segment")]

        def read_segment(self_, index, shard, offset, vocab=None):
            t0 = now()
            out = read(self_, index, shard, offset, vocab=vocab)
            main = threading.current_thread() is threading.main_thread()
            ev.append(("read" if not main else "boot_read", t0, now(), index))
            return out

        T._sync = sync
        T.train = timed("train", real[(T, "train")])
        T._runner = runner
        T.refresh_vocab_tables = timed("refresh", real[(T, "refresh_vocab_tables")])
        graphs.ChunkRunner.run = run
        driver.encode_segment = timed("encode", real[(driver, "encode_segment")])
        driver.PackedCorpus = TimedPack
        ck_mod.save_checkpoint = timed("save", real[(ck_mod, "save_checkpoint")])
        source.FileSource.read_segment = read_segment
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in self.real.items():
            setattr(owner, name, fn)

    def boundaries(self):
        """Per segment boundary (train i -> train i + 1), ms: the gap from
        the last sync of train i to the first dispatch of train i + 1, and
        its parts: encode, pack, refresh (growth), save (the boundary
        checkpoint), capture, fill (the next train's first sync to its
        first dispatch: the first chunk's fill and staging) and the rest."""
        ev = sorted(self.ev, key=lambda e: e[1])
        trains = [e for e in ev if e[0] == "train"]
        out = []
        for a, b in zip(trains, trains[1:]):
            last_sync = max(e[2] for e in ev if e[0] == "sync" and e[2] <= a[2])
            inner = [e for e in ev if b[1] <= e[1] <= b[2]]
            first_dispatch = min(e[1] for e in inner if e[0] == "dispatch")
            first_sync = min(e[2] for e in inner if e[0] == "sync")

            def ms(kind, lo=a[2], hi=b[1], pool=ev):
                return sum((e[2] - e[1]) * 1e3 for e in pool
                           if e[0] == kind and lo <= e[1] <= hi)

            row = {
                "gap_ms": (first_dispatch - last_sync) * 1e3,
                "encode_ms": ms("encode"), "pack_ms": ms("pack"),
                "refresh_ms": ms("refresh"), "save_ms": ms("save"),
                "capture_ms": ms("capture", b[1], b[2], inner),
                "fill_ms": (first_dispatch - first_sync) * 1e3,
            }
            row["rest_ms"] = row["gap_ms"] - sum(
                v for k, v in row.items() if k != "gap_ms")
            out.append(row)
        return out

    def segments(self):
        """Per trained segment: its train() s, and the producer's read ms
        of each segment index (reads on the producer thread)."""
        trains = [e[2] - e[1] for e in self.ev if e[0] == "train"]
        reads = {e[3]: (e[2] - e[1]) * 1e3 for e in self.ev if e[0] == "read"}
        return trains, reads


def phase_stream(vocab, corpus, card, tmp):
    """Continuous training on the card (phase 11 of the module docstring)."""
    import threading

    from word2vec_tpu_torch import Trainer
    from word2vec_tpu_torch.data.batcher import PackedCorpus
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint, read_stream_cursor
    from word2vec_tpu_torch.models.params import FUSED_KEY, init_params, logical_table
    from word2vec_tpu_torch.obs.quality import ProbeSet
    from word2vec_tpu_torch.ops import graphs
    from word2vec_tpu_torch.serve.query import QueryEngine
    from word2vec_tpu_torch.stream import ArraySource, StreamRun

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    row = {"card": card}
    flags, txt = stream_flags(vocab, corpus, tmp)
    res_flags, _ = stream_flags(vocab, corpus, tmp, mode="resident")

    def path(name):
        return os.path.join(tmp, "st_" + name)

    def run(argv, what, want_rc=0, **kw):
        r = counted_cli(argv, **kw)
        if r["rc"] != want_rc:
            fail(f"stream {what}: exit {r['rc']} (want {want_rc}): "
                 f"{r['stderr'][-2000:]}")
        return r

    def records(mdir):
        return tel_records(os.path.join(mdir, "metrics.jsonl"))

    def same_vectors(a, b):
        with open(a, "rb") as x, open(b, "rb") as y:
            return x.read() == y.read()

    def io_flags(name, vec=True):
        out = ["--checkpoint-dir", path(name + "_ck"), "--checkpoint-every",
               str(STREAM_EVERY), "--metrics-dir", path(name + "_m")]
        return out + (["-output", path(name + ".bin"), "-binary", "1"] if vec else [])

    # (a) uninterrupted, its boundaries timed
    with StreamTimeline() as tl:
        a = run(flags + io_flags("a"), "(a) uninterrupted")
    recs = records(path("a_m"))
    segs = [r for r in recs if r.get("event") == "stream_segment"]
    grows = [r for r in recs if r.get("event") == "vocab_growth"]
    rep = [r for r in recs if r.get("event") == "train_report"][-1]
    man = manifest_of(path("a_m"))
    v_boot = man["vocab_size"]
    cursor = read_stream_cursor(path("a_ck"))
    # captures: one a runner; a growth drops them all, and a chunk length
    # not seen since the last growth captures one more
    steps_of = [-(-s["rows"] // B) for s in segs]
    cache, want_caps = set(), 0
    for s, n in zip(segs, steps_of):
        if any(g["segment"] == s["segment"] - 1 for g in grows):
            cache.clear()
        key = min(STREAM_CHUNK, n)
        want_caps += key not in cache
        cache.add(key)
    trained_growths = sum(g["segment"] < segs[-1]["segment"] for g in grows)
    chunk_lens = {min(STREAM_CHUNK, n) for n in steps_of}
    want = expected_launches("pallas_fused", "unified", sum(steps_of) + want_caps)
    if (len(segs) != 4 or not grows or not all(g["admitted"] > 0 for g in grows)
            or cursor["capacity"] != v_boot + STREAM_RESERVE
            or rep["steps"] != sum(steps_of) or a["captures"] != want_caps
            or a["launches"] != want or a["replays"] != sum(steps_of)):
        fail(f"stream (a): {len(segs)} segments, growths {grows}, capacity "
             f"{cursor['capacity']} (boot {v_boot}), steps {rep['steps']} vs "
             f"{steps_of}, captures {a['captures']} (want {want_caps}), "
             f"launches {a['launches']} (want {want}), replays {a['replays']}")
    mst = man.get("stream") or {}
    if man["shutdown"] != "clean" or mst.get("segments") != 4 \
            or mst.get("cursor", {}).get("segment") != 4 \
            or mst.get("growths") != len(grows):
        fail(f"stream (a): manifest shutdown {man['shutdown']}, stream {mst}")
    st, ck_cfg, ck_vocab = load_checkpoint(path("a_ck"))
    slab = st.params[FUSED_KEY]
    init = init_params(ck_cfg, v_boot, generator(dev, ck_cfg.seed))[FUSED_KEY].cpu()
    n_live = len(ck_vocab)
    moved = (slab[:v_boot] != init[:v_boot]).reshape(v_boot, -1).any(dim=1)
    if not bool(torch.isfinite(slab).all()) or slab.shape[0] != v_boot + STREAM_RESERVE \
            or not torch.equal(slab[n_live:], init[n_live:]) or not bool(moved.all()):
        fail(f"stream (a): tables finite {bool(torch.isfinite(slab).all())}, "
             f"shape {tuple(slab.shape)}, reserve rows at init "
             f"{torch.equal(slab[n_live:], init[n_live:])}, boot rows trained "
             f"{int(moved.sum())} of {v_boot}")
    bounds = tl.boundaries()
    train_s, read_ms = tl.segments()
    refresh = [(e[2] - e[1]) * 1e3 for e in tl.ev if e[0] == "refresh"]
    captures = [(e[2] - e[1]) * 1e3 for e in tl.ev if e[0] == "capture"]
    row["a"] = {
        "segments": [{k: s[k] for k in ("segment", "raw_tokens", "encoded_tokens", "rows")}
                     for s in segs],
        "growths": grows, "boot_vocab": v_boot, "final_vocab": n_live,
        "capacity": cursor["capacity"], "steps": rep["steps"],
        "captures": a["captures"], "launches": a["launches"],
        "replays": a["replays"], "words_per_sec": rep["words_per_sec"],
        "seconds": a["seconds"],
    }
    row["boundaries"] = bounds
    row["refresh_ms"] = refresh
    row["capture_ms"] = captures
    row["segment_train_s"] = train_s
    row["producer_read_ms"] = read_ms
    log(f"  (a) {len(segs)} segments ({[s['encoded_tokens'] for s in segs]} tokens, "
        f"{steps_of} steps), boot vocabulary {v_boot}, growths "
        f"{[(g['segment'], g['admitted']) for g in grows]} -> {n_live} words, "
        f"capacity {cursor['capacity']}; {a['captures']} captures, "
        f"{a['replays']} replays, launches = expected of {sum(steps_of)} steps "
        f"+ {want_caps} warm-ups (1 + {trained_growths} growths before a "
        f"segment + {len(chunk_lens) - 1} more chunk lengths); reserve rows at their init bits, every boot "
        f"row trained; {rep['words_per_sec']} words/sec ({card})")
    for i, bd in enumerate(bounds):
        log(f"  boundary {i} -> {i + 1}: gap {bd['gap_ms']:.1f} ms = encode "
            f"{bd['encode_ms']:.1f} + pack {bd['pack_ms']:.1f} + refresh "
            f"{bd['refresh_ms']:.1f} + save {bd['save_ms']:.1f} + capture "
            f"{bd['capture_ms']:.1f} + fill {bd['fill_ms']:.1f} + rest "
            f"{bd['rest_ms']:.1f}; segment {i} trained in {train_s[i]:.3f} s")
    log(f"  refresh_vocab_tables ms {refresh}; captures ms {captures}; producer "
        f"read ms per segment {read_ms}; train s per segment {train_s}")

    # words/sec: (a)'s flags streaming against resident, interleaved twice
    wps = {"streaming": [rep["words_per_sec"]], "resident": []}
    for i in range(2):
        if i:
            a2 = run(flags + io_flags("a2", vec=False), "(a) again")
            if a2["launches"] != a["launches"]:
                fail(f"stream (a) again: launches {a2['launches']} != {a['launches']}")
            wps["streaming"].append([r for r in records(path("a2_m"))
                                     if r.get("event") == "train_report"][-1]["words_per_sec"])
        r_run = run(res_flags + io_flags(f"r{i}", vec=False), f"resident {i}")
        wps["resident"].append([r for r in records(path(f"r{i}_m"))
                                if r.get("event") == "train_report"][-1]["words_per_sec"])
    row["words_per_sec"] = wps
    log(f"  words/sec streaming {wps['streaming']}, resident {wps['resident']} "
        f"(A B A B; {card})")
    # the final tables of (a) and of the first resident run: the golds-free
    # quality statistics (row norms, effective rank) on the card
    from word2vec_tpu_torch.obs.quality import score_table

    row["table_stats"] = {}
    for name in ("a", "r0"):
        stq, _, vq = load_checkpoint(path(name + "_ck"))
        rec, _ = score_table(logical_table(stq.params, "emb_in")[: len(vq)]
                             .float().numpy(), vq, ProbeSet(), device=dev)
        row["table_stats"][name] = {k: v for k, v in rec.items() if k in (
            "quality_row_norm_p50", "quality_row_norm_p99",
            "quality_effective_rank")}
    log(f"  final tables (row norm p50 / p99, effective rank): "
        f"{row['table_stats']}")

    # (b) a real SIGTERM at the first boundary of the first segment after a
    # growth, exit 75, then --resume bitwise equal to (a)
    g0 = grows[0]["segment"] + 1
    per_seg = [-(-n // STREAM_CHUNK) for n in steps_of]
    term_at = sum(per_seg[:g0]) + 1

    def wrap(real):
        seen = [0]

        def check(step):
            seen[0] += 1
            if seen[0] == term_at:
                os.kill(os.getpid(), signal.SIGTERM)
            return real(step)
        return check

    run(flags + io_flags("b", vec=False), "(b) sigterm", want_rc=75, stop_wrap=wrap)
    bdoc = read_stream_cursor(path("b_ck"))
    bst, _, _ = load_checkpoint(path("b_ck"))
    if bdoc["segment"] != g0 or bdoc["vocab_generation"] < 1:
        fail(f"stream (b): the cursor names segment {bdoc['segment']} "
             f"(generation {bdoc['vocab_generation']}), want {g0}")
    b2 = run(flags + io_flags("b2") + ["--resume", path("b_ck")], "(b) resume")
    left = sum(steps_of) - bdoc["global_steps"] - bst.step
    want_b = expected_launches("pallas_fused", "unified", left + b2["captures"])
    if not (npz_bitwise(path("a_ck"), path("b2_ck"))
            and same_vectors(path("a.bin"), path("b2.bin"))) \
            or b2["launches"] != want_b:
        fail(f"stream (b): the resume differs from (a), or launches "
             f"{b2['launches']} != {want_b}")
    row["b"] = {"stopped_segment": bdoc["segment"], "stopped_step": bst.step,
                "generation": bdoc["vocab_generation"], "resume_steps": left,
                "resume_captures": b2["captures"]}
    log(f"  (b) SIGTERM at boundary {term_at} -> exit 75 in segment "
        f"{bdoc['segment']} at its step {bst.step} (generation "
        f"{bdoc['vocab_generation']}); the resume ({left} steps, "
        f"{b2['captures']} captures) equals (a) bitwise")

    # (c) -train - from a subprocess pipe of the same bytes, spooled
    spool = path("spool")
    r_fd, w_fd = os.pipe()
    feeder = subprocess.Popen(
        [sys.executable, "-c", "import shutil, sys; shutil.copyfileobj("
         "open(sys.argv[1], 'rb'), sys.stdout.buffer)", txt], stdout=w_fd)
    os.close(w_fd)
    stdin = os.dup(0)
    os.dup2(r_fd, 0)
    os.close(r_fd)
    try:
        c_flags, _ = stream_flags(vocab, corpus, tmp, train="-")
        c = run(c_flags + io_flags("c") + ["--stream-spool", spool], "(c) pipe")
    finally:
        os.dup2(stdin, 0)
        os.close(stdin)
        feeder.wait(timeout=60)
    c_grows = [r for r in records(path("c_m")) if r.get("event") == "vocab_growth"]
    c_doc = read_stream_cursor(path("c_ck"))
    keys = ("segment", "vocab_generation", "tokens_total", "global_steps",
            "global_words")
    cursors_match = all(c_doc[k] == cursor[k] for k in keys)
    c_same = same_vectors(path("a.bin"), path("c.bin"))
    if c["rc"] != 0 or sorted(os.listdir(spool)) != [
            f"seg_{i:06d}.txt" for i in range(4)] or c_grows != grows \
            or not cursors_match or not c_same or c["launches"] != a["launches"]:
        fail(f"stream (c): spool {sorted(os.listdir(spool))}, growths equal "
             f"{c_grows == grows}, cursors match {cursors_match} ({c_doc} vs "
             f"{cursor}), vectors equal {c_same}, launches {c['launches']}")
    row["c"] = {"spool": sorted(os.listdir(spool)), "cursors_match": cursors_match,
                "vectors_equal": c_same, "words_per_sec": [
                    r for r in records(path("c_m"))
                    if r.get("event") == "train_report"][-1]["words_per_sec"]}
    log(f"  (c) -train - through a pipe: 4 spooled segments, the same "
        f"admissions, cursors (segment, generation, tokens, steps, words) "
        f"equal, vectors equal to (a) bitwise")

    # (d) the library StreamRun over an ArraySource of the same ids, with a
    # CUDA query engine as swap_engine and neighbor queries throughout
    to_final = np.full(len(vocab), -1, np.int32)
    for w in ck_vocab.words:
        to_final[vocab[w]] = ck_vocab[w]
    ids = to_final[corpus.flat[:STREAM_TOKENS]]
    ids = ids[ids >= 0]
    cfg = flagship_cfg("pallas_fused", "unified", corpus_mode="streaming",
                       chunk_steps=STREAM_CHUNK)
    tr = Trainer(cfg, ck_vocab, PackedCorpus.from_flat(ids[:STREAM_SEG], L),
                 device=dev)
    W0 = logical_table(tr.init_state().params, "emb_in").float().cpu().numpy()
    from word2vec_tpu_torch.data.vocab import Vocab as _Vocab

    engine = QueryEngine(W0, _Vocab(list(ck_vocab.words), ck_vocab.counts.copy()),
                         device=dev)
    qwords = ck_vocab.words[:64]
    stop = threading.Event()
    served = {"ok": 0, "failed": 0, "errors": [], "spans": []}

    def client():
        while not stop.is_set():
            t_q = time.perf_counter()
            try:
                out = engine.neighbors_batch(qwords, k=10)
                if len(out) != 64 or any(len(o) != 10 for o in out):
                    raise AssertionError("short answer")
                served["ok"] += 1
            except Exception as e:  # noqa: BLE001 — counted, then failed on
                served["failed"] += 1
                served["errors"].append(repr(e)[:200])
            served["spans"].append((t_q, time.perf_counter()))

    # the captures of (d), timed: the queries run across them (a capture
    # on the trainer's stream leaves other threads' device work alone)
    real_capture, cap_spans = graphs.StepGraph._capture, []

    def timed_capture(self_, env):
        t_c = time.perf_counter()
        real_capture(self_, env)
        cap_spans.append((t_c, time.perf_counter()))

    q = threading.Thread(target=client, daemon=True)
    graphs.StepGraph._capture = timed_capture
    swap_recs = []
    try:
        q.start()
        srun = StreamRun(tr, ArraySource(ids, STREAM_SEG), swap_engine=engine,
                         swap_floor=0.0, log_fn=swap_recs.append)
        t0 = time.perf_counter()
        d_state, d_rep = srun.train(log_every=0)
        d_s = time.perf_counter() - t0
    finally:
        graphs.StepGraph._capture = real_capture
        stop.set()
        q.join(timeout=60)
    if q.is_alive():
        fail("stream (d): the query thread did not stop")
    # no growth in (d): one capture a distinct chunk length (a text8
    # segment of n ids packs into ceil(n / L) rows)
    d_chunks = {min(STREAM_CHUNK, -(-(-(-min(STREAM_SEG, len(ids) - i) // L)) // B))
                for i in range(0, len(ids), STREAM_SEG)}
    during = sum(any(a < c1 and c0 < b for a, b in served["spans"])
                 for c0, c1 in cap_spans)
    W_fin = logical_table(d_state.params, "emb_in")[: len(ck_vocab)].float().cpu().numpy()
    cpu = QueryEngine(W_fin, ck_vocab, device="cpu")
    probe = ck_vocab.words[100:164]
    ids_card = [[w for w, _ in o] for o in engine.neighbors_batch(probe, k=10)]
    ids_cpu = [[w for w, _ in o] for o in cpu.neighbors_batch(probe, k=10)]
    gen = engine.generation
    rng = np.random.default_rng(11)
    pick = rng.choice(min(2000, len(ck_vocab)), size=(64, 2), replace=True)
    srun.swap_floor = 1.01
    srun.probe_set = ProbeSet(
        pairs=[(ck_vocab.words[i], ck_vocab.words[j], float(g)) for (i, j), g
               in zip(pick, rng.uniform(0, 10, 64)) if i != j],
        analogies=[], tracked=[], source="file")
    t0 = time.perf_counter()
    srun._maybe_swap(d_state, d_rep.stream["segments"])
    refuse_ms = (time.perf_counter() - t0) * 1e3
    swaps = [r for r in swap_recs if r.get("event") == "table_swap"]
    if (d_rep.stream["swaps"] != d_rep.stream["segments"] or gen != len(swaps)
            or len(cap_spans) != len(d_chunks)
            or [r["segment"] for r in swaps] != list(range(d_rep.stream["segments"]))
            or served["failed"] or not served["ok"] or ids_card != ids_cpu
            or srun.swaps_refused != 1 or engine.generation != gen
            or swap_recs[-1].get("event") != "table_swap_refused"):
        fail(f"stream (d): {d_rep.stream}, generation {gen}, captures "
             f"{len(cap_spans)} (chunk lengths {d_chunks}), queries "
             f"{dict(served, spans=len(served['spans']))}, "
             f"top-k card == cpu {ids_card == ids_cpu}, refused "
             f"{srun.swaps_refused}, last record {swap_recs[-1]}")
    row["d"] = {"segments": d_rep.stream["segments"], "swaps": d_rep.stream["swaps"],
                "queries_ok": served["ok"], "queries_failed": served["failed"],
                "captures": len(cap_spans), "captures_with_queries": during,
                "capture_ms": [(b - a) * 1e3 for a, b in cap_spans],
                "train_s": d_s, "refused_swap_ms": refuse_ms,
                "refused": swap_recs[-1]}
    log(f"  (d) library StreamRun: {d_rep.stream['segments']} segments, "
        f"{d_rep.stream['swaps']} swaps (one a boundary), {served['ok']} "
        f"neighbor batches of 64 served during it, 0 failed, queries in "
        f"flight during {during} of its {len(cap_spans)} captures; the swapped "
        f"table's top-10 ids = the CPU engine's; swap_floor 1.01 -> "
        f"table_swap_refused (score {swap_recs[-1].get('score')}, "
        f"{refuse_ms:.1f} ms), generation stays {gen}")
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"stream_phase": row}, default=str))


# ------------------------------------------------------- phase 12: planner
#: (band route, layout, rows, band chunk S, KP, negative scope): kernel call
#: shapes of the flagship band-ns grid on the card (tune/planner
#: .candidate_grid) that phases 3-4 do not hold: KP 16 / 32, S 96 / 64,
#: 128 / 512 rows, batch scope at KP 256, on each kernel route
GRID_SHAPES = (
    ("pallas_fused", "unified", 128, 96, 16, "row"),
    ("pallas_fused", "unified", 512, 64, 32, "row"),
    ("pallas", "split", 128, 96, 16, "row"),
    ("pallas", "split", 512, 64, 32, "row"),
    ("pallas_oa", "split", 128, 96, 16, "row"),
    ("pallas_oa", "split", 512, 64, 32, "row"),
    ("pallas_oa", "split", B, 0, 256, "batch"),
)
#: grid shapes a wrapper refuses before any launch (ROADMAP Queue C): the
#: band_core tiles of batch scope at KP 256 and d 300 exceed a block's
#: shared memory
REFUSED_SHAPES = (("pallas", "split", B, 0, 256, "batch"),)
#: the CLI runs of (c)-(f): (band route, layout, chunk_steps); the search
#: key of each is the configured route's
PLAN_CLI = (("pallas_fused", "unified", 6), ("xla", "split", 1))
#: torch.profiler kernel names of the xla step's sorted-scatter machinery
#: (the slab scatter, its run lists, the ordered row sums, the sorts) and
#: of its layout copies
SCATTER_NAMES = ("slab_scatter", "runs_kernel", "ordered_row_sum", "adix",
                 "sort", "Sort")
COPY_NAMES = ("copy", "Copy")


def grid_cfg(backend, layout, rows, chunk, kp, scope, cdt="bfloat16"):
    from word2vec_tpu_torch import Word2VecConfig

    return Word2VecConfig(
        model="sg", negative=K, word_dim=D, window=W, min_count=1,
        compute_dtype=cdt, shared_negatives=kp, max_sentence_len=L,
        band_chunk=chunk, table_layout=layout, band_backend=backend,
        negative_scope=scope, batch_rows=rows,
    )


def planner_shapes(dev):
    """(a): the host copy of the band cores' shared memory against the
    library's at every (S, KP) the grid offers, the card's per-block limit
    against the planner's constant; one step of each GRID_SHAPES entry,
    card vs CPU (f32 compute, phase 4's tolerances), and the band core of
    the kernel routes at that shape with bf16 compute (the tensor-core
    bodies the grid runs) vs its plain version (phase 3's tolerances);
    each REFUSED_SHAPES entry refused by its wrapper with no launch, and
    absent from the planner's grid."""
    from word2vec_tpu_torch import _build
    from word2vec_tpu_torch.ops import band_core as bc
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import launch
    from word2vec_tpu_torch.ops.banded import resolve_chunk
    from word2vec_tpu_torch.tune import planner

    out = {}
    optin = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", None)
    if optin != launch.SMEM_PER_BLOCK:
        fail(f"shared memory a block may opt into: {optin}, the planner "
             f"assumes {launch.SMEM_PER_BLOCK}")
    n = 0
    for kernel, lib, fn in (("fused_grad_core", "fused_step",
                             "w2v_grad_core_smem_bytes"),
                            ("band_core", "band_core", "w2v_band_core_smem_bytes")):
        get = getattr(_build.library(lib), fn)
        for S in (118, 96, 64):
            for kp in (16, 32, 64, 256):
                for bf in (1, 0):
                    host = launch.core_smem_bytes(kernel, S, S + 2 * W, kp, D, W,
                                                  bool(bf))
                    if host != get(S, S + 2 * W, kp, D, W, bf):
                        fail(f"{kernel} shared memory S={S} KP={kp} bf16={bf}: "
                             f"host {host} != library {get(S, S + 2 * W, kp, D, W, bf)}")
                    n += 1
    out["smem_shapes_equal"] = n
    out["smem_optin"] = optin
    rng = np.random.default_rng(12)
    out["steps"] = []
    for backend, layout, rows, chunk, kp, scope in GRID_SHAPES:
        S = resolve_chunk(L, W, chunk)
        tag = f"grid step {backend}/{layout} B={rows} S={S} KP={kp} {scope}"
        err = step_vs_cpu(dev, grid_cfg(backend, layout, rows, chunk, kp, scope,
                                         "float32"), 4000, rows, rng, tag)
        row = {"shape": [backend, layout, rows, S, kp, scope], "step_err": err}
        if backend in ("pallas_fused", "pallas"):
            geo = dict(V=4000, d=D, B=rows, L=L, W=W, S=S, KP=kp)
            cdt = torch.bfloat16
            if backend == "pallas_fused":
                inp = small_grad_inputs(table=torch.float32, **geo)
                args = [inp[k].to(dev) for k in GRAD_ORDER]
                kw = dict(W=W, K=K, L=L, cdt=cdt, is_cbow=False)
                got = fs.fused_grad_core(*args, 0.03, **kw)
                ref = fs.fused_grad_core_plain(*args, 0.03, **kw)
                names = GRAD_NAMES
            else:
                inp = small_core_inputs(table=torch.float32, scope=scope,
                                        model="sg", **geo)
                args = [inp[k].to(dev) for k in CORE_ORDER]
                kw = dict(W=W, K=K, cdt=cdt, is_cbow=False)
                got = bc.band_core(*args, 0.03, **kw)
                ref = bc.band_core_plain(*args, 0.03, **kw)
                names = CORE_NAMES
            torch.cuda.synchronize()
            row["core_bf16_max_abs_err"] = check_outputs(
                f"{tag} core bf16", names, got, ref, cdt, quiet=True)
            del got, ref, args, inp
        out["steps"].append(row)
    log(f"  (a) {len(GRID_SHAPES)} grid shapes held (step card vs CPU, f32 "
        f"compute; the band cores' bf16 bodies vs plain); shared memory host "
        f"== library at {n} shapes, per-block limit {optin} B")
    out["refused"] = []
    grid = planner.candidate_grid(flagship_cfg("xla", "split"), V,
                                  {"platform": "gpu"})
    for backend, layout, rows, chunk, kp, scope in REFUSED_SHAPES:
        S = resolve_chunk(L, W, chunk)
        inp = small_core_inputs(table=torch.float32, scope=scope, model="sg",
                                V=4000, d=D, B=rows, L=L, W=W, S=S, KP=kp)
        args = [inp[k].to(dev) for k in CORE_ORDER]
        before = dict(launch.LAUNCHES)
        try:
            bc.band_core(*args, 0.03, W=W, K=K, cdt=torch.bfloat16, is_cbow=False)
        except ValueError as e:
            msg = str(e)
        else:
            fail(f"band_core {scope} KP={kp}: not refused")
        if launch.LAUNCHES != before or "shared memory" not in msg:
            fail(f"band_core {scope} KP={kp}: refused after a launch or "
                 f"for another reason: {msg}")
        cfg = grid_cfg(backend, layout, rows, chunk, kp, scope)
        offered = [p for p in grid if p.band_backend == backend
                   and p.negative_scope == scope]
        if planner.kernel_fits(cfg) or offered:
            fail(f"the grid still offers {backend} {scope} at KP {kp}")
        out["refused"].append({"shape": [backend, layout, rows, S, kp, scope],
                               "why": msg})
        log(f"  (a) refused, as ROADMAP Queue C names it: {backend} {scope} "
            f"KP={kp} S={S}: {msg}")
    return out


def planner_incumbents(dev, vocab, corpus):
    """(b): probe_plan of each route's flagship plan, its launches exact,
    its measured and predicted ms, the model's order beside the measured
    one."""
    from word2vec_tpu_torch.tune import cost_model, planner

    kind, platform = planner.device_identity(dev)
    rows = {}
    for backend, layout in ROUTES:
        cfg = flagship_cfg(backend, layout)
        rec = planner.probe_plan(cfg, cfg.current_plan(), vocab, corpus,
                                 device=dev)
        planner.free_probe_residue(dev)
        if "error" in rec:
            fail(f"probe {backend}/{layout}: {rec['error']}")
        # the capture's eager warm-up step, then 3 dispatches of 2 steps
        want = expected_launches(backend, layout, 1 + 3 * 2)
        if rec["launches"] != want:
            fail(f"probe {backend}/{layout}: launches {rec['launches']} != {want}")
        est = cost_model.predict(cfg, len(vocab), kind, platform)
        rows[f"{backend}/{layout}"] = {
            "measured_step_ms": rec["measured_step_ms"],
            "predicted_total_ms": est.total_ms,
            "probe_words_per_sec": rec["probe_words_per_sec"],
            "launches": {k: v for k, v in rec["launches"].items() if v},
        }
        log(f"  (b) probe {backend}/{layout}: measured {rec['measured_step_ms']} "
            f"ms/step, predicted {est.total_ms:.4f}, launches exact "
            f"{rows[f'{backend}/{layout}']['launches']}")
    model = sorted(rows, key=lambda r: rows[r]["predicted_total_ms"])
    measured = sorted(rows, key=lambda r: rows[r]["measured_step_ms"])
    log(f"  (b) order, fastest first: model {model}; measured {measured}")
    return {"routes": rows, "model_order": model, "measured_order": measured}


def planner_cli(argv):
    """counted_cli(argv) with resolve_plan wrapped: the device memory
    allocated just before and just after it (cached blocks and cuBLAS
    workspaces released first, so the check reads only what the search
    left), its seconds, and the launch counts and captures reset when it
    returns, so they count the trainer's run alone."""
    from word2vec_tpu_torch import tune
    from word2vec_tpu_torch.ops.launch import reset_launch_counts
    from word2vec_tpu_torch.tune import planner

    seen, caps = {}, {"n": 0}
    real = tune.resolve_plan
    begin = torch.cuda.CUDAGraph.capture_begin

    def counting(self, *a, **k):
        caps["n"] += 1
        return begin(self, *a, **k)

    def wrapped(*a, **k):
        planner.free_probe_residue(torch.device("cuda", 0))
        seen["mem_before"] = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = real(*a, **k)
        seen["search_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        seen["mem_after"] = torch.cuda.memory_allocated()
        seen["search_captures"] = caps["n"]
        reset_launch_counts()
        caps["n"] = 0
        return res

    tune.resolve_plan = wrapped
    torch.cuda.CUDAGraph.capture_begin = counting
    try:
        r = counted_cli(argv)
    finally:
        tune.resolve_plan = real
        torch.cuda.CUDAGraph.capture_begin = begin
    r["trainer_captures"] = caps["n"]
    r.update(seen)
    if r["rc"] != 0:
        fail(f"cli exited {r['rc']}: {' '.join(argv)}\n{r['stderr'][-2000:]}")
    return r


def spans_of(out) -> dict:
    """ms a step of the loop's spans in a CLI run's merged trace."""
    from word2vec_tpu_torch.obs import tracediff

    with open(os.path.join(out + "_t", "trace.json")) as f:
        summ = tracediff.summarize(json.load(f))
    return {k: v["ms_per_step"] for k, v in summ["spans"].items()}


def calibrated_ms(man) -> float:
    """The measured device ms a step of a run's manifest cost_calibrate
    block, which must be the JAX CLI's: no error, a measurement, one row
    an anchor with a verdict."""
    from word2vec_tpu_torch.tune import cost_model

    cal = man.get("cost_calibrate") or {"error": "missing"}
    rows = cal.get("anchors", [])
    if ("error" in cal or not cal.get("measured_device_ms", 0) > 0
            or [r["anchor"] for r in rows] != list(cost_model.ANCHORS)
            or any(r["verdict"] not in ("ok", "drift", "stale") for r in rows)):
        fail(f"manifest cost_calibrate: {cal}")
    return cal["measured_device_ms"]


def cli_wps(log_path) -> float:
    return [r for r in tel_records(log_path)
            if r.get("event") == "train_report"][-1]["words_per_sec"]


def profile_xla(dev, vocab, corpus, steps=10):
    """One graphed dispatch of `steps` xla/split flagship steps (a
    ChunkRunner chunk: the replays issued back to back, the host ahead of
    the card) under torch.profiler: device ms a step of the scatter
    machinery and of the layout copies, and the window (first kernel start
    to last kernel end) less the busy time, a step."""
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.models.params import init_params
    from word2vec_tpu_torch.ops.tables import DeviceTables
    from word2vec_tpu_torch.ops.train_step import make_chunk_runner
    from word2vec_tpu_torch.profile_step import _busy_us
    from word2vec_tpu_torch.tune import planner

    cfg = flagship_cfg("xla", "split")
    chunks = planner._probe_chunks(corpus, cfg, steps, 2)
    tables = DeviceTables.build(vocab, cfg, dev)
    params = init_params(cfg, len(vocab), generator(dev, 0))
    runner = make_chunk_runner(cfg, tables)
    alphas = np.full(steps, cfg.init_alpha, np.float32)
    runner(params, chunks[0][0], 13, 0, alphas)
    g = runner.stage(params, chunks[1][0])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        runner.run(g, params, alphas, 13, steps, steps)
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "Memcpy HtoD" not in e.name]  # the alphas' upload ahead of it
    if not ev:
        fail("profile_xla: the profiler saw no device time")

    def ms(names):
        return sum(e.time_range.end - e.time_range.start for e in ev
                   if any(n in e.name for n in names)) / 1e3 / steps

    window = (max(e.time_range.end for e in ev)
              - min(e.time_range.start for e in ev))
    busy = _busy_us(ev)
    del runner, tables, params, g
    planner.free_probe_residue(dev)
    return {"steps": steps, "scatter_ms": ms(SCATTER_NAMES),
            "copy_ms": ms(COPY_NAMES), "window_ms": window / 1e3 / steps,
            "busy_ms": busy / 1e3 / steps}


def dispatch_overhead_ms(dev, vocab, corpus, steps=6, reps=20):
    """The host cost of one graphed ChunkRunner dispatch of `steps` flagship
    pallas_fused steps beyond its device time: the median over `reps`
    dispatches of (host clock from the call to a synchronize) less (CUDA
    events around the call). Returns (that ms, the host ms of staging the
    tokens of the runner's first 5 dispatches)."""
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.models.params import init_params
    from word2vec_tpu_torch.ops.tables import DeviceTables
    from word2vec_tpu_torch.ops.train_step import make_chunk_runner
    from word2vec_tpu_torch.tune import planner

    cfg = flagship_cfg("pallas_fused", "unified")
    chunks = planner._probe_chunks(corpus, cfg, steps, 2)
    tables = DeviceTables.build(vocab, cfg, dev)
    params = init_params(cfg, len(vocab), generator(dev, 0))
    runner = make_chunk_runner(cfg, tables)
    alphas = np.full(steps, cfg.init_alpha, np.float32)
    runner(params, chunks[0][0], 13, 0, alphas)
    torch.cuda.synchronize()
    # the host ms of staging a dispatch's tokens from a numpy array (pinned
    # by copy_in) over the runner's first dispatches: what a probe paid
    # before it pinned its chunks ahead of its timing
    stage_ms = []
    for i in range(5):
        t0 = time.perf_counter()
        g = runner.stage(params, chunks[1][0])
        stage_ms.append((time.perf_counter() - t0) * 1e3)
        runner.run(g, params, alphas, 13, (i + 1) * steps, steps)
        torch.cuda.synchronize()
    gaps = []
    for i in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        runner(params, chunks[1][0], 13, (i + 1) * steps, alphas)
        b.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        gaps.append(host - a.elapsed_time(b))
    del runner, tables, params
    planner.free_probe_residue(dev)
    return float(np.median(gaps)), stage_ms


class patched_anchors:
    """The cost model's anchors and the card's per-dispatch overhead set to
    `fit` inside the block (the module constants outside it)."""

    def __init__(self, fit):
        from word2vec_tpu_torch.tune import cost_model

        self.cm, self.fit = cost_model, fit

    def __enter__(self):
        cm = self.cm
        self.old = {k: getattr(cm, k) for k in
                    ("LAYOUT_COPY_INEFFICIENCY", "SCATTER_SEC_PER_ROW",
                     "PROGRAM_GAP_MS", "DMA_SEC_PER_ROW")}
        self.old_spec = dict(cm.DEVICE_SPECS)
        for k, v in self.fit.items():
            if k == "dispatch_overhead_ms":
                for kind, (peak, bw, _) in self.old_spec.items():
                    cm.DEVICE_SPECS[kind] = (peak, bw, v)
            else:
                setattr(cm, k, v)
        return cm

    def __exit__(self, *exc):
        for k, v in self.old.items():
            setattr(self.cm, k, v)
        self.cm.DEVICE_SPECS.clear()
        self.cm.DEVICE_SPECS.update(self.old_spec)


def fit_anchors(dev, vocab, corpus, measured):
    """(f): the four anchors and the per-dispatch overhead, each fitted on
    the route where its term is largest. measured[backend] = the device ms
    a step (cost_model.measured_device_ms) of a CLI run of that route's
    flagship plan."""
    from word2vec_tpu_torch.tune import cost_model, planner

    kind, platform = planner.device_identity(dev)
    prof = profile_xla(dev, vocab, corpus)
    xla = flagship_cfg("xla", "split")
    fused = flagship_cfg("pallas_fused", "unified")
    est_x = cost_model.predict(xla, len(vocab), kind, platform)
    fit = {
        "SCATTER_SEC_PER_ROW": prof["scatter_ms"] / est_x.scatter_rows / 1e3,
        "PROGRAM_GAP_MS": (prof["window_ms"] - prof["busy_ms"]) / est_x.programs,
    }
    fit["dispatch_overhead_ms"], stage_ms = dispatch_overhead_ms(dev, vocab, corpus)
    stream_ms = 1e3 * est_x.copy_bytes / HBM_BYTES_PER_S
    direct = prof["copy_ms"] / stream_ms
    with patched_anchors(dict(fit, LAYOUT_COPY_INEFFICIENCY=0.0)) as cm:
        rest = cm.predict(xla, len(vocab), kind, platform)
        # the xla step less every other predicted term, over the copies'
        # streaming time (the inversion cost_calibrate makes)
        fit["LAYOUT_COPY_INEFFICIENCY"] = (
            (measured["xla"] - rest.total_ms) / stream_ms)
    with patched_anchors(dict(fit, DMA_SEC_PER_ROW=1e-9)) as cm:
        est_f = cm.predict(fused, len(vocab), kind, platform)
        cal = cm.cost_calibrate(est_f, measured["pallas_fused"])
        dma = [r for r in cal["anchors"] if r["anchor"] == "dma_sec_per_row"][0]
        if "implied_value" not in dma:
            fail(f"(f) the DMA term is not active on pallas_fused: {dma}")
        fit["DMA_SEC_PER_ROW"] = dma["implied_value"]
    prof["first_stage_ms"] = stage_ms
    log(f"  (f) xla profile: {prof}; layout copies alone {direct:.2f}x their "
        f"streaming time; fitted {fit}")
    return fit, prof, direct


def calibrate_with(fit, cfg, vocab_size, kind, platform, measured):
    with patched_anchors(fit) as cm:
        return cm.cost_calibrate(
            cm.predict(cfg, vocab_size, kind, platform), measured)


def phase_planner(vocab, corpus, card, tmp):
    """The autotuning planner on the card (phase 12 of the module
    docstring)."""
    import filecmp

    from word2vec_tpu_torch.io.checkpoint import load_checkpoint
    from word2vec_tpu_torch.tune import cache as plan_cache
    from word2vec_tpu_torch.tune import cost_model, planner

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind, platform = planner.device_identity(dev)
    row = {"card": card}
    row["a"] = planner_shapes(dev)
    row["b"] = planner_incumbents(dev, vocab, corpus)
    base = tel_flags(vocab, corpus, tmp)

    def flags(backend, layout, chunk, name, autotune, cache):
        argv = list(base)
        for flag, val in (("--band-backend", backend), ("--table-layout", layout),
                          ("--chunk-steps", str(chunk))):
            argv[argv.index(flag) + 1] = val
        out = os.path.join(tmp, f"p12_{name}")
        return argv + [
            "-output", out + ".bin", "-binary", "1", "--checkpoint-dir",
            out + "_ck", "--checkpoint-every", "1000", "--metrics-dir",
            out + "_m", "--health-metrics", "0", "--quality-probe-every", "0",
            "--autotune", autotune, "--plan-cache", cache, "--trace",
            out + "_t", "--log-jsonl", out + ".jsonl"], out

    row["c"], row["d"], row["e"], row["f"] = {}, {}, {}, {}
    measured = {}
    for backend, layout, chunk in PLAN_CLI:
        cache = os.path.join(tmp, f"p12_plans_{backend}.json")
        key = plan_cache.plan_key(kind, platform, "band-ns", V, D, layout, KP,
                                  backend)
        # (c) the search, then training with the winner
        argv, out_c = flags(backend, layout, chunk, f"c_{backend}", "probe", cache)
        c = planner_cli(argv)
        recs = tel_records(out_c + ".jsonl")
        tune_rec = [r for r in recs if r.get("event") == "autotune"]
        probes = [r for r in recs if r.get("event") == "autotune_probe"]
        if (len(tune_rec) != 1 or tune_rec[0]["key"] != key
                or not 0 < len(probes) <= 4 or any("error" in p for p in probes)):
            fail(f"(c) {backend}: autotune records {tune_rec}, probes {probes}")
        winner = tune_rec[0]["plan"]
        entry = plan_cache.lookup(
            key, planner.config_fingerprint(flagship_cfg(backend, layout)), cache)
        if entry is None or entry["plan"] != winner:
            fail(f"(c) {backend}: the winner is not stored under {key}: {entry}")
        if c["mem_after"] != c["mem_before"]:
            fail(f"(c) {backend}: device memory {c['mem_before']} before the "
                 f"search, {c['mem_after']} after it")
        man_c = manifest_of(out_c + "_m")
        if man_c.get("plan_source") != "probe" or man_c["plan"] != winner:
            fail(f"(c) {backend}: manifest plan {man_c.get('plan')} / "
                 f"{man_c.get('plan_source')}, winner {winner}")
        survivors = [{"plan": p["plan"], "measured_step_ms": p["measured_step_ms"],
                      "predicted_total_ms": p["predicted_total_ms"],
                      "launches": {k: v for k, v in p["launches"].items() if v}}
                     for p in probes]
        row["c"][backend] = {
            "key": key, "winner": winner, "probes": survivors,
            "search_s": c["search_s"], "search_captures": c["search_captures"],
            "mem_before": c["mem_before"], "mem_after": c["mem_after"],
            "launches": c["launches"], "captures": c["trainer_captures"],
            "replays": c["replays"], "cost_calibrate": man_c.get("cost_calibrate"),
        }
        log(f"  (c) {backend}/{layout} --autotune probe: key {key}, "
            f"{len(probes)} probes in {c['search_s']:.3f} s "
            f"({c['search_captures']} captures), no error record, winner "
            f"{winner}, stored; device memory {c['mem_before']} B before the "
            f"search == after")
        for p in survivors:
            log(f"      probe {p['plan']}: measured {p['measured_step_ms']} "
                f"ms/step, predicted {p['predicted_total_ms']}")
        # (d) the cached run: a hit, zero probes, bitwise equal to (c)
        argv, out_d = flags(backend, layout, chunk, f"d_{backend}", "cached", cache)
        d = planner_cli(argv)
        recs = tel_records(out_d + ".jsonl")
        tune_d = [r for r in recs if r.get("event") == "autotune"]
        if (len(tune_d) != 1 or tune_d[0]["source"] != "cache"
                or tune_d[0]["probes"] or tune_d[0]["plan"] != winner
                or any(r.get("event") == "autotune_probe" for r in recs)):
            fail(f"(d) {backend}: autotune records {tune_d}")
        same = (npz_bitwise(out_c + "_ck", out_d + "_ck")
                and filecmp.cmp(out_c + ".bin", out_d + ".bin", shallow=False))
        if not same or d["launches"] != c["launches"] or (
                d["trainer_captures"] != c["trainer_captures"]):
            fail(f"(d) {backend}: bitwise {same}, launches {d['launches']} vs "
                 f"{c['launches']}, captures {d['trainer_captures']} vs "
                 f"{c['trainer_captures']}")
        st, ck_cfg, _ = load_checkpoint(out_d + "_ck")
        if ck_cfg.current_plan().to_json() != winner or ck_cfg.autotune != "off":
            fail(f"(d) {backend}: the checkpoint's config is not the plan-applied "
                 f"one: {ck_cfg.current_plan().to_json()} / {ck_cfg.autotune}")
        man_d = manifest_of(out_d + "_m")
        row["d"][backend] = {"bitwise": same, "launches": d["launches"],
                             "captures": d["trainer_captures"],
                             "search_s": d["search_s"],
                             "cost_calibrate": man_d.get("cost_calibrate")}
        log(f"  (d) {backend}/{layout} --autotune cached: a hit, 0 probes "
            f"({d['search_s'] * 1e3:.1f} ms), state.npz and vectors bitwise "
            f"equal to (c), launches {d['launches']} and captures "
            f"{d['trainer_captures']} equal")
        # (e) the plan-applied run vs the configured default, A B A B
        wps = {"plan": [cli_wps(out_d + ".jsonl")], "default": []}
        ms = {"plan": [calibrated_ms(man_c), calibrated_ms(man_d)],
              "default": []}
        for i, arm in enumerate(("default", "plan", "default")):
            argv, out_e = flags(backend, layout, chunk, f"e{i}_{backend}",
                                "off" if arm == "default" else "cached", cache)
            planner_cli(argv)
            wps[arm].append(cli_wps(out_e + ".jsonl"))
            ms[arm].append(calibrated_ms(manifest_of(out_e + "_m")))
            log(f"      {arm} run spans ms/step: {spans_of(out_e)}")
        row["e"][backend] = wps
        log(f"  (e) {backend}/{layout} words/sec, plan-applied {wps['plan']} vs "
            f"configured default {wps['default']} ({card})")
        measured[backend] = dict(ms, winner=winner, chunk=chunk, layout=layout)
    # (f) the anchors, fitted on the mean measured step of each route's
    # default runs, then held on the mean of its plan-applied runs ((c), (d)
    # and (e)'s), each predicted at the plan it trained
    fit, prof, direct = fit_anchors(dev, vocab, corpus, {
        k: float(np.mean(v["default"])) for k, v in measured.items()})
    if not all(np.isfinite(v) and v > 0 for v in fit.values()):
        fail(f"(f) a fitted anchor is not a positive number: {fit}")
    verdicts = {}
    for backend, m in measured.items():
        cfg = flagship_cfg(backend, m["layout"], chunk_steps=m["chunk"]).apply_plan(
            planner.TunePlan.from_json(m["winner"]))
        held = float(np.mean(m["plan"]))
        cal = calibrate_with(fit, cfg, V, kind, platform, held)
        verdicts[backend] = cal
        log(f"  (f) {backend} held on its plan-applied runs ({m['plan']} ms "
            f"measured, mean {held:.4f}; {cal['predicted_device_ms']} predicted; "
            f"default runs {m['default']}): " + ", ".join(
                f"{r['anchor']} {r['verdict']} {r.get('ratio', '')} "
                f"(share {r.get('share_of_measured', 0)})" for r in cal["anchors"]))
        # not held as a pass/fail: the measured step (the loop's spans on a
        # shared host) spreads by more than the smaller terms between runs
        # of one plan, so their verdicts move with the run; the spread is
        # in the line beside them
        runs = m["plan"] + m["default"]
        verdicts[backend]["spread_ms"] = [min(runs), max(runs)]
        for tag in ("c", "d"):
            cc = row[tag][backend]["cost_calibrate"]
            log(f"  (f) {backend} manifest cost_calibrate of ({tag}), the module's "
                f"anchors: verdict {cc.get('verdict')}, " + ", ".join(
                    f"{r['anchor']} {r['verdict']} {r.get('ratio', '')}"
                    for r in cc.get("anchors", ())))
    row["f"] = {"fit": fit, "profile": prof, "copy_kernels_x_stream": direct,
                "measured_device_ms": measured, "held": verdicts,
                "module": {k: getattr(cost_model, k) for k in (
                    "LAYOUT_COPY_INEFFICIENCY", "SCATTER_SEC_PER_ROW",
                    "PROGRAM_GAP_MS", "DMA_SEC_PER_ROW")},
                "module_overhead_ms": cost_model.device_spec(kind, platform)[2]}
    row["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"planner_phase": row}, default=str))


# -------------------------------------------------- 13. data parallelism
DP = 2                # replicas, both on the one card
DP_STEPS = 36         # global steps a run: two epochs of phase 5's 36 batches
DP_EVERY = 8          # dp_sync_every
# chunk_steps of the chunked runs: it divides the sync interval and tiles
# the 18-step epoch. A chunk of 4 would end each epoch on a chunk of 2, and
# the syncs after it would land on its chunk boundaries (26, 34 instead of
# 24, 32), as in the JAX trainer: another trajectory, not a fault.
DP_CHUNK = 2
DP_CKPT = 12          # the resume's checkpoint step: mid-epoch, between syncs
DP_WPS_REPS = 2       # A B A B


def dp_cfg(backend, layout, **over):
    over.setdefault("iters", 3)
    return flagship_cfg(backend, layout, dp_sync_every=DP_EVERY, **over)


def dp_trainer(vocab, corpus, devs, backend, layout, graphs=True, **over):
    from word2vec_tpu_torch.parallel import ShardedTrainer, make_mesh

    tr = ShardedTrainer(dp_cfg(backend, layout, **over), vocab, corpus,
                        mesh=make_mesh(len(devs), devices=devs))
    tr.graphs = graphs
    return tr


def host_copy(rep):
    """A replica (a Params dict, or a list of tp shard dicts) copied to
    the CPU."""
    if isinstance(rep, list):
        return [host_copy(s) for s in rep]
    return {k: v.to("cpu", copy=True) for k, v in rep.items()}


class SyncCheck:
    """Wraps a ShardedTrainer's sync: every sync on the card is held,
    bitwise, against the port's sync on the CPU over copies of the same
    replicas (and base), shard by shard, and the replicas must be bitwise
    equal after it. Launches nothing of the port's kernels."""

    def __init__(self, tr, tag):
        from word2vec_tpu_torch.parallel import make_delta_sync, make_mesh, make_sync

        self.tr, self.tag, self.n = tr, tag, 0
        self.inner = tr.sync_fn
        cpu = make_mesh(tr.dp, tp=tr.tp, sp=tr.sp, device="cpu")
        self.cpu = make_delta_sync(cpu) if tr.config.sync_mode == "delta" else make_sync(cpu)
        tr.sync_fn = self

    def __call__(self, params, *base):
        from word2vec_tpu_torch.ops.graphs import shard_list

        host = [host_copy(p) for p in params]
        hbase = [host_copy(b) for b in base]
        out = self.inner(params, *base)
        want = self.cpu(host, *hbase)
        first = shard_list(out[0])
        for r, p in enumerate(out):
            for t, (sh, ref) in enumerate(zip(shard_list(p), shard_list(want[r]))):
                for k, v in sh.items():
                    if not torch.equal(bits(v.cpu()), bits(ref[k])):
                        fail(f"parallel {self.tag}: sync {self.n} replica {r} shard "
                             f"{t} {k} != the CPU sync (bitwise)")
                    if not torch.equal(bits(v), bits(first[t][k])):
                        fail(f"parallel {self.tag}: replicas differ after sync {self.n}")
        self.n += 1
        return out


def dp_counted(tr, n_steps, captures, backend, layout, what, **kw):
    """One run with the counts set to 0 just before it: each replica's
    kernels once a global step, plus one eager warm-up step per capture."""
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    state, rep = tr.train(**kw)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    want = expected_launches(backend, layout, n_steps, replicas=tr.dp,
                             warmups=captures)
    if counts != want:
        fail(f"parallel {backend}/{layout} {what}: launch counts {counts} != {want}")
    if rep.steps != n_steps and "state" not in kw:
        fail(f"parallel {backend}/{layout} {what}: {rep.steps} steps")
    return state, rep, counts


def dp_sync_ms(tr, mode):
    """CUDA-event ms of one sync of the trainer's replicas (in place, as
    training syncs them), and its bytes bound: the mean reads and writes
    every replica once; the delta sync also reads and writes its base."""
    from word2vec_tpu_torch.parallel import make_delta_sync, make_sync

    reps = tr._replicas
    table = sum(v.numel() * v.element_size() for v in reps[0].values())
    if mode == "delta":
        sync, base = make_delta_sync(tr.mesh), {k: v.clone() for k, v in reps[0].items()}
        ms = cuda_ms(lambda: sync(reps, base), reps=10)
        nbytes = 2 * (len(reps) + 1) * table
    else:
        sync = make_sync(tr.mesh)
        ms = cuda_ms(lambda: sync(reps), reps=10)
        nbytes = 2 * len(reps) * table
    return ms, nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def dp_two_cards(dev, vocab, corpus, tmp):
    """Phase 13 (d): with two or more cards, two replicas on two cards
    bitwise equal to two on one card, each sync bitwise the CPU sync, and
    the CLI with --dp 2 (exact launches); with one card, the statement
    that these arms need a second card."""
    if torch.cuda.device_count() < 2:
        log("  parallel: the two-card arms (two replicas on two cards, the CLI "
            "with --dp 2) need a second card; this machine has one")
        return "not run: needs a second card (this machine has one)"
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    tr = dp_trainer(vocab, corpus, two, "pallas_fused", "unified")
    chk = SyncCheck(tr, "two cards")
    _, rep, _ = dp_counted(tr, DP_STEPS, DP, "pallas_fused", "unified",
                           "two cards", log_every=4, max_steps=DP_STEPS)
    one = dp_trainer(vocab, corpus, [dev] * DP, "pallas_fused", "unified")
    dp_counted(one, DP_STEPS, DP, "pallas_fused", "unified", "one card",
               log_every=0, max_steps=DP_STEPS)
    same = all(same_params({k: v.cpu() for k, v in a.items()},
                           {k: v.cpu() for k, v in b.items()})
               for a, b in zip(tr._replicas, one._replicas))
    if not same:
        fail("parallel: two cards != two replicas on one card (bitwise)")
    counts, recs = run_cli(tel_flags(vocab, corpus, tmp) + ["--dp", "2"],
                           os.path.join(tmp, "log_dp2"))
    steps = TEL_ITERS * -(-TEL_SPE // 2)
    rep_cli = [r for r in recs if r.get("event") == "train_report"][-1]
    want = expected_launches("pallas_fused", "unified", steps, replicas=2, warmups=2)
    if rep_cli["steps"] != steps or counts != want:
        fail(f"parallel: --dp 2 CLI ran {rep_cli['steps']} steps, counts {counts}")
    out = {"syncs_bitwise": chk.n, "equals_one_card": same,
           "words_per_sec": rep.words_per_sec, "cli_steps": rep_cli["steps"],
           "cli_words_per_sec": rep_cli["words_per_sec"]}
    log(f"  parallel two cards: {out}")
    return out


def phase_parallel(dev, vocab, corpus, card, tmp):
    """Data parallelism on the card (phase 13 of the module docstring)."""
    import gc

    from word2vec_tpu_torch import Trainer, TrainState
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    t_phase = time.perf_counter()
    devs = [dev] * DP
    row = {"card": card, "dp": DP, "devices": [str(d) for d in devs],
           "steps": DP_STEPS, "dp_sync_every": DP_EVERY, "routes": []}

    # (a) every route, mean sync (pallas_fused also delta): 36 global steps
    for backend, layout in ROUTES:
        for mode in (("mean", "delta") if backend == "pallas_fused" else ("mean",)):
            tag = f"{backend}/{layout}/{mode}"
            tr = dp_trainer(vocab, corpus, devs, backend, layout, sync_mode=mode)
            chk = SyncCheck(tr, tag)
            t0 = time.perf_counter()
            _, rep, counts = dp_counted(tr, DP_STEPS, DP, backend, layout, tag,
                                        log_every=4, max_steps=DP_STEPS)
            hist = rep.loss_history
            if not (hist and all(np.isfinite(hist)) and hist[-1] < hist[0]):
                fail(f"parallel {tag}: loss {hist}")
            # per-step: syncs at 8, 16, 24, 32 and the run's final one at 36
            if chk.n != DP_STEPS // DP_EVERY + 1:
                fail(f"parallel {tag}: {chk.n} syncs")
            row["routes"].append({
                "route": tag, "launches": counts, "syncs_bitwise": chk.n,
                "loss_history": hist, "wall_s": time.perf_counter() - t0,
                "checked_words_per_sec": rep.words_per_sec, "capture_s": tr.capture_s,
            })
            log(f"  parallel {tag}: syncs={chk.n} (each bitwise the CPU sync, "
                f"replicas equal) loss {hist[0]:.5f} -> {hist[-1]:.5f} "
                f"words/sec with the checks={rep.words_per_sec:.1f} launches={counts}")
            del tr, chk
            gc.collect()
            torch.cuda.empty_cache()

    # (b) the dispatch paths and the resume, against the eager per-step run
    row["dispatch"] = {}
    for backend, layout in (("pallas_fused", "unified"), ("xla", "split")):
        tag = f"{backend}/{layout}"
        eager = dp_trainer(vocab, corpus, devs, backend, layout, graphs=False)
        ref, _, _ = dp_counted(eager, DP_STEPS, 0, backend, layout, "eager",
                               log_every=0, max_steps=DP_STEPS)
        res = {}
        for name, over in (("graphed per-step", {}),
                           (f"chunk_steps={DP_CHUNK} streaming",
                            dict(chunk_steps=DP_CHUNK, resident="off")),
                           (f"chunk_steps={DP_CHUNK} resident",
                            dict(chunk_steps=DP_CHUNK, resident="on"))):
            tr = dp_trainer(vocab, corpus, devs, backend, layout, **over)
            st, rep, _ = dp_counted(tr, DP_STEPS, DP, backend, layout, name,
                                    log_every=0, max_steps=DP_STEPS)
            if name.endswith("resident") and rep.resident["resolved"] != "resident":
                fail(f"parallel {tag}: the resident path resolved {rep.resident}")
            res[name] = same_params(st.params, ref.params) and all(
                same_params(a, b) for a, b in zip(tr._replicas, eager._replicas))
            if not res[name]:
                fail(f"parallel {tag}: {name} != eager per-step (bitwise)")
        # the resume: a checkpoint every 12 steps (each forces a sync at 12,
        # 24 and 36 through export_params, in both runs), resumed from 12
        path = os.path.join(tmp, f"dp_ck_{backend}")

        def ckpt_cb(trainer, save):
            def cb(s):
                host = trainer.export_params(s)
                if save:
                    save_checkpoint(path, TrainState(host, s.step, s.words_done, s.epoch),
                                    trainer.config, vocab)
            return cb

        u = dp_trainer(vocab, corpus, devs, backend, layout)
        whole, _, _ = dp_counted(u, DP_STEPS, DP, backend, layout, "uninterrupted",
                                 log_every=0, max_steps=DP_STEPS,
                                 checkpoint_cb=ckpt_cb(u, False),
                                 checkpoint_every=DP_CKPT)
        a = dp_trainer(vocab, corpus, devs, backend, layout)
        a.train(log_every=0, max_steps=DP_CKPT, checkpoint_cb=ckpt_cb(a, True),
                checkpoint_every=DP_CKPT)
        st, _, _ = load_checkpoint(path)
        if st.step != DP_CKPT or st.params[next(iter(st.params))].dim() not in (2, 3):
            fail(f"parallel {tag}: checkpoint at step {st.step}")
        b = dp_trainer(vocab, corpus, devs, backend, layout)
        resumed, _, _ = dp_counted(b, DP_STEPS - DP_CKPT, DP, backend, layout,
                                   "resumed", log_every=0, max_steps=DP_STEPS,
                                   state=st, checkpoint_cb=ckpt_cb(b, False),
                                   checkpoint_every=DP_CKPT)
        res[f"resumed at {DP_CKPT}"] = resumed.step == DP_STEPS and same_params(
            resumed.params, whole.params) and all(
            same_params(x, y) for x, y in zip(b._replicas, u._replicas))
        if not res[f"resumed at {DP_CKPT}"]:
            fail(f"parallel {tag}: the resume from step {DP_CKPT} != the uninterrupted run")
        row["dispatch"][tag] = res
        log(f"  parallel dispatch {tag}: {res}")
        del eager, ref, tr, u, a, b, whole, resumed, st
        gc.collect()
        torch.cuda.empty_cache()

    # (c) words/sec, dp 2 on one card against dp 1 (Trainer), A B A B, and
    # one sync of the flagship tables in each mode
    arms = {
        "dp=2 (one card)": dp_trainer(vocab, corpus, devs, "pallas_fused", "unified",
                                      chunk_steps=DP_CHUNK, resident="off"),
        "dp=1 (Trainer)": Trainer(dp_cfg("pallas_fused", "unified", chunk_steps=DP_CHUNK,
                                         resident="off"), vocab, corpus, device=dev),
    }
    wps = {k: [] for k in arms}
    for tr in arms.values():
        tr.train(log_every=0, max_steps=DP_CHUNK)  # capture
    for _ in range(DP_WPS_REPS):
        for name, tr in arms.items():
            steps = DP_STEPS if name.startswith("dp=2") else DP * DP_STEPS
            _, rep = tr.train(log_every=0, max_steps=steps)
            wps[name].append(rep.words_per_sec)
    row["words_per_sec"] = wps
    row["dp2_over_dp1"] = float(np.mean(wps["dp=2 (one card)"]) / np.mean(wps["dp=1 (Trainer)"]))
    log(f"  parallel words/sec A B A B ({card}): {wps} ratio {row['dp2_over_dp1']:.4f}")
    dp2 = arms["dp=2 (one card)"]
    row["sync"] = {}
    for mode in ("mean", "delta"):
        ms, bound, nbytes = dp_sync_ms(dp2, mode)
        row["sync"][mode] = {"ms": ms, "bound_ms": bound, "bytes": nbytes,
                             "bound_by": "bytes"}
        log(f"  parallel sync {mode} of the flagship tables ({card}): {ms:.4f} ms, "
            f"bytes bound {bound:.4f} ms ({nbytes} B)")
    del arms, dp2
    gc.collect()
    torch.cuda.empty_cache()

    # (d) two cards: two replicas on two cards against two on one, bitwise,
    # and the CLI with --dp 2
    row["two_cards"] = dp_two_cards(dev, vocab, corpus, tmp)
    row["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"parallel_phase": row}, default=str))


# ------------------------------------------------ 14: tensor and sequence
TP_MESHES = [(1, 1, 2), (1, 1, 4), (1, 2, 1), (2, 2, 2)]  # (dp, sp, tp)
TP_ALL = (2, 2, 2)
TP_STEPS = 36         # global steps of (d): two epochs at dp 2
TP_EVERY = 8
TP_CHUNK = 2
TP_HS_STEPS = 6
TP_WPS_STEPS = 18
TP_WPS_REPS = 2       # A B C A B C
TP_ALPHA = 0.025


def tp_cfg(layout="split", **over):
    over.setdefault("iters", 3)
    return flagship_cfg("xla", layout, dp_sync_every=TP_EVERY, **over)


def tp_trainer(vocab, corpus, devs, mesh, cfg=None, graphs=True, **over):
    """A ShardedTrainer on the (dp, sp, tp) mesh over `devs` (the card
    repeated: every replica and shard on the one card)."""
    from word2vec_tpu_torch.parallel import ShardedTrainer, make_mesh

    dp, sp, tp = mesh
    tr = ShardedTrainer(cfg or tp_cfg(**over), vocab, corpus,
                        mesh=make_mesh(dp, tp=tp, sp=sp, devices=devs))
    tr.graphs = graphs
    return tr


def tp_expected(tr, n_steps, captures):
    """Launches of n_steps global steps: each replica's each shard runs
    the route's step once a global step, plus one eager warm-up step of
    every shard a capture."""
    cfg = tr.config
    shards = tr.reps * tr.tp
    if cfg.use_hs or cfg.resolved_kernel == "pair":
        return {k: v * shards for k, v in hs_launches(cfg, n_steps + captures).items()}
    return expected_launches("xla", cfg.table_layout, n_steps, replicas=shards,
                             warmups=captures * tr.tp)


def tp_counted(tr, n_steps, captures, what, **kw):
    """One run with the counts set to 0 just before it, held to tp_expected."""
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts

    reset_launch_counts()
    state, rep = tr.train(**kw)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    want = tp_expected(tr, n_steps, captures)
    if counts != want:
        fail(f"tp_sp {what}: launch counts {counts} != {want}")
    if rep.steps != n_steps and "state" not in kw:
        fail(f"tp_sp {what}: {rep.steps} steps")
    return state, rep, counts


class PsumCheck:
    """Records every shard-order sum of the model axis (ops/shards.
    shard_sum at the psum sites) of an eager step: each is then held,
    bitwise, against the port's CPU sum over copies of the same partials,
    and timed."""

    def __init__(self):
        from word2vec_tpu_torch.ops import shards

        self.mod, self.real, self.calls = shards, shards.shard_sum, []

    def __enter__(self):
        real, calls = self.real, self.calls

        def rec(parts, home):
            out = real(parts, home)
            calls.append(([p.clone() for p in parts], out.clone(), home))
            return out

        self.mod.shard_sum = rec
        return self

    def __exit__(self, *exc):
        self.mod.shard_sum = self.real

    def check(self, what):
        for i, (parts, out, _) in enumerate(self.calls):
            want = self.real([p.to("cpu", copy=True) for p in parts], torch.device("cpu"))
            if not torch.equal(bits(out.cpu()), bits(want)):
                fail(f"tp_sp {what}: psum {i} {tuple(out.shape)} on the card != "
                     "the CPU shard-order sum (bitwise)")
        return len(self.calls)

    def timing(self):
        """(CUDA-event ms of all of the step's sums, their bytes bound:
        each partial read once and the total written once, the bytes)."""
        ms = sum(cuda_ms(lambda p=p, h=h: self.real(p, h), reps=10)
                 for p, _, h in self.calls)
        nbytes = sum(sum(x.numel() * 4 for x in p) + o.numel() * 4
                     for p, o, _ in self.calls)
        return ms, nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def tp_params(cfg, vocab, dev, seed=3):
    """Initial tables with a nonzero out table, so the first step moves
    every table and the logits are not all zero."""
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.models.params import FUSED_KEY, init_params

    p = init_params(cfg, len(vocab), generator(dev, seed))
    g = generator(dev, seed + 1)
    out = p[FUSED_KEY][:, 1] if FUSED_KEY in p else p["emb_out_ns"]
    out.copy_((0.1 * torch.randn(out.shape, generator=g, device=dev)).to(out.dtype))
    return p


def tp_one_step(cfg, tables, full, tokens, draws, tp, sp=1):
    """One eager step of a replica's tp shards (the runner ShardedTrainer
    builds) from the full tables `full` on fixed draws; returns the
    shards' tables concatenated and the metrics."""
    from word2vec_tpu_torch.ops.train_step import make_chunk_runner
    from word2vec_tpu_torch.parallel.trainer import concat_shards, split_params

    shards = [{k: v.contiguous().clone() for k, v in part.items()}
              for part in split_params(full, tp)]
    runner = make_chunk_runner(cfg, tables, graphed=False, fused=False, tp=tp, sp=sp)
    runner.draws_hook = lambda step, sub: draws
    m = runner(shards if tp > 1 else shards[0], tokens[None], 0, 0,
               np.float32([TP_ALPHA]))
    return concat_shards(shards), {k: float(v[0]) for k, v in m.items()}


def tp_halo_draws(draws, s, sp):
    """The single-device draws of [B, L] rows cut to sequence shard s's
    haloed columns (the owned centers keep their own uniforms and
    windows; the halo's are never read as centers)."""
    from word2vec_tpu_torch.ops.shards import halo_exchange
    from word2vec_tpu_torch.ops.train_step import Draws

    return Draws(halo_exchange(draws.u_sub, s, sp, W).contiguous(),
                 halo_exchange(draws.w_eff, s, sp, W).contiguous(), draws.negs)


def tp_steps_arms(dev, vocab, corpus, card, clock, row):
    """Phase 14 (a) to (c) on one flagship batch and fixed draws."""
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.ops.shards import halo_exchange
    from word2vec_tpu_torch.ops.tables import DeviceTables
    from word2vec_tpu_torch.device import generator

    tokens = corpus_batch(dev, corpus)
    row["calls"], row["psum"], row["vs_tp1"] = {}, {}, {}
    for layout, dtype, tps in (("split", "float32", (2, 4)), ("unified", "bfloat16", (4,))):
        cfg = tp_cfg(layout, dtype=dtype)
        tables = DeviceTables.build(vocab, cfg, dev)
        draws = BandStep(cfg, tables).draw(generator(dev, 5), tokens)
        full = tp_params(cfg, vocab, dev)
        ref, m1 = tp_one_step(cfg, tables, full, tokens, draws, 1)
        for tp in tps:
            tag = f"tp{tp}/{layout}/{dtype}"
            record = (tp, layout) in ((2, "split"), (4, "unified"))
            with CallRecorder(band=True) as rec, PsumCheck() as ps:
                got, m = tp_one_step(cfg, tables, full, tokens, draws, tp)
            torch.cuda.synchronize()
            n_psum = ps.check(tag)
            if n_psum == 0:
                fail(f"tp_sp {tag}: the step made no shard-order sum")
            if record:
                # (a) every call bitwise its plain version; shard 0's
                # scatters (all issued before shard 1's: they follow the
                # step's last psum) timed
                sc = [i for i, c in enumerate(rec.calls) if c[0] == "fused_slab_scatter"]
                rows = check_hs_calls(f"tp_sp {tag}", rec.calls, card, clock,
                                      timed=set(sc[:len(sc) // tp]))
                widths = {c[3].shape[-1] for c in rec.calls if c[0] == "fused_slab_scatter"}
                if widths != {D // tp}:
                    fail(f"tp_sp {tag}: scatter widths {widths}")
                row["calls"][tag] = {"n_calls": len(rec.calls), "timed": rows}
                ms, bound, nbytes = ps.timing()
                row["psum"][tag] = {"sums": n_psum, "ms": ms, "bound_ms": bound,
                                    "bytes": nbytes, "bound_by": "bytes"}
                log(f"  tp_sp {tag}: {len(rec.calls)} kernel calls bitwise their plain "
                    f"versions; {n_psum} psums bitwise the CPU sum, {ms:.4f} ms a "
                    f"step (bytes bound {bound:.4f} ms, {nbytes} B) ({card})")
            if dtype == "float32":
                # (c) the tp step against the tp-1 step of the same draws
                err = max(float((got[k] - ref[k]).abs().max()) for k in ref)
                row["vs_tp1"][tag] = {"max_abs_err": err, "loss_sum": m["loss_sum"],
                                      "loss_sum_tp1": m1["loss_sum"]}
                if not err <= 5e-5 or abs(m["pairs"] - m1["pairs"]) > 1e-6 * m1["pairs"]:
                    fail(f"tp_sp {tag}: {err} from the tp-1 step (5e-5), pairs "
                         f"{m['pairs']} vs {m1['pairs']}")
                log(f"  tp_sp {tag} vs tp 1: max abs err {err:.3e} (<= 5e-5)")
        del tables, full, ref
    # (c) sp 2: the sum of the shards' deltas is the single-device delta
    cfg = tp_cfg("split", clip_row_update=0.0)
    tables = DeviceTables.build(vocab, cfg, dev)
    draws = BandStep(cfg, tables).draw(generator(dev, 6), tokens)
    full = tp_params(cfg, vocab, dev)
    one, m1 = tp_one_step(cfg, tables, full, tokens, draws, 1)
    delta = {k: torch.zeros_like(v) for k, v in full.items()}
    pairs = 0.0
    for s in range(2):
        toks = halo_exchange(tokens, s, 2, W).contiguous()
        got, m = tp_one_step(cfg, tables, full, toks, tp_halo_draws(draws, s, 2), 1, sp=2)
        pairs += m["pairs"]
        for k in delta:
            delta[k] += got[k] - full[k]
    err = max(float((delta[k] - (one[k] - full[k])).abs().max()) for k in full)
    row["sp2_conservation"] = {"max_abs_err": err, "pairs": pairs, "pairs_one": m1["pairs"]}
    if not err <= 1e-4 or abs(pairs - m1["pairs"]) > 1e-6 * m1["pairs"]:
        fail(f"tp_sp sp 2: shard deltas {err} from the single-device delta (1e-4), "
             f"pairs {pairs} vs {m1['pairs']}")
    log(f"  tp_sp sp 2: the shards' deltas sum to the single-device delta within "
        f"{err:.3e} (<= 1e-4), pairs {pairs} vs {m1['pairs']}")


def tp_two_cards(vocab, corpus):
    """Phase 14, the two-card arm: a tp-2 replica's shards on two cards
    (eager: no graph spans two cards) bitwise equal to the same run on
    one card; with one card, the statement that it needs a second."""
    if torch.cuda.device_count() < 2:
        log("  tp_sp: the two-card arm (a tp-2 replica's shards on two cards) "
            "needs a second card; this machine has one")
        return "not run: needs a second card (this machine has one)"
    two = [torch.device("cuda", 0), torch.device("cuda", 1)]
    a = tp_trainer(vocab, corpus, two, (1, 1, 2))
    if not a.split_shards:
        fail("tp_sp: two cards did not split the shards")
    sa, _ = a.train(log_every=0, max_steps=TP_HS_STEPS)
    b = tp_trainer(vocab, corpus, [two[0]] * 2, (1, 1, 2), graphs=False)
    sb, _ = b.train(log_every=0, max_steps=TP_HS_STEPS)
    same = same_params({k: v.cpu() for k, v in sa.params.items()},
                       {k: v.cpu() for k, v in sb.params.items()})
    if not same:
        fail("tp_sp: shards on two cards != the one-card run (bitwise)")
    return {"equals_one_card": same, "steps": TP_HS_STEPS}


def phase_tp_sp(dev, vocab, corpus, card, tmp):
    """Tensor and sequence parallelism on the card (phase 14 of the module
    docstring)."""
    import gc

    from word2vec_tpu_torch import Trainer

    t_phase = time.perf_counter()
    clock = sm_clock_hz()
    row = {"card": card, "meshes": [list(m) for m in TP_MESHES]}

    # (a) the kernels' calls at d/tp, (b) the psums, (c) vs tp 1 and sp 1
    tp_steps_arms(dev, vocab, corpus, card, clock, row)
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the dispatch paths at (2, 2, 2) against the eager per-step run
    devs = [dev] * 8
    reps, tp = TP_ALL[0] * TP_ALL[1], TP_ALL[2]
    eager = tp_trainer(vocab, corpus, devs, TP_ALL, graphs=False)
    chk = SyncCheck(eager, "(2,2,2) eager")
    ref, _, _ = tp_counted(eager, TP_STEPS, 0, "(2,2,2) eager", log_every=0,
                           max_steps=TP_STEPS)
    res = {"eager syncs bitwise": chk.n}
    for name, over in (("graphed per-step", {}),
                       (f"chunk_steps={TP_CHUNK} streaming",
                        dict(chunk_steps=TP_CHUNK, resident="off")),
                       (f"chunk_steps={TP_CHUNK} resident",
                        dict(chunk_steps=TP_CHUNK, resident="on"))):
        tr = tp_trainer(vocab, corpus, devs, TP_ALL, **over)
        chk = SyncCheck(tr, f"(2,2,2) {name}")
        st, rep, counts = tp_counted(tr, TP_STEPS, reps, f"(2,2,2) {name}",
                                     log_every=4, max_steps=TP_STEPS)
        if chk.n != TP_STEPS // TP_EVERY + 1:
            fail(f"tp_sp (2,2,2) {name}: {chk.n} syncs")
        if name.endswith("resident") and rep.resident["resolved"] != "resident":
            fail(f"tp_sp: the resident path resolved {rep.resident}")
        same = same_params(st.params, ref.params)
        if not same:
            fail(f"tp_sp (2,2,2): {name} != eager per-step (bitwise)")
        hist = rep.loss_history
        if not (hist and all(np.isfinite(hist)) and hist[-1] < hist[0]):
            fail(f"tp_sp (2,2,2) {name}: loss {hist}")
        res[name] = {"bitwise_eager": same, "launches": counts, "syncs_bitwise": chk.n,
                     "loss_history": hist, "capture_s": tr.capture_s}
        log(f"  tp_sp (2,2,2) {name}: bitwise the eager run, {chk.n} syncs bitwise the "
            f"CPU sync, loss {hist[0]:.5f} -> {hist[-1]:.5f}, launches {counts}")
        del tr
    row["dispatch"] = res
    del eager, ref
    gc.collect()
    torch.cuda.empty_cache()

    # (e) hs sg and pair ns at tp 2: graphed == eager, counted
    row["hs_pair"] = {}
    for name, over in (("hs-sg", dict(train_method="hs", negative=0)),
                       ("pair-ns", dict(kernel="pair"))):
        cfg = hs_cfg(dp_sync_every=TP_EVERY, **over)
        runs = {}
        for graphs in (False, True):
            tr = tp_trainer(vocab, corpus, [dev] * 2, (1, 1, 2), cfg=cfg, graphs=graphs)
            runs[graphs] = tp_counted(tr, TP_HS_STEPS, int(graphs), f"{name} tp 2",
                                      log_every=0, max_steps=TP_HS_STEPS)
        same = same_params(runs[True][0].params, runs[False][0].params)
        if not same:
            fail(f"tp_sp {name} tp 2: graphed != eager (bitwise)")
        row["hs_pair"][name] = {"bitwise_eager": same, "launches": runs[True][2]}
        log(f"  tp_sp {name} tp 2: {TP_HS_STEPS} graphed steps bitwise eager, "
            f"launches {runs[True][2]}")
        del runs, tr
        gc.collect()
        torch.cuda.empty_cache()

    # (f) words/sec of tp 2 and sp 2 on the one card against tp = sp = 1,
    # interleaved; the device memory each arm holds after its capture
    # (its tables and static buffers) and its peak during the capture (the
    # warm-up step on clones of the tables: tables, clones, workspace)
    arms = {
        "tp=sp=1 (Trainer)": Trainer(tp_cfg(chunk_steps=TP_CHUNK, resident="off"),
                                     vocab, corpus, device=dev),
        "tp=2": tp_trainer(vocab, corpus, [dev] * 2, (1, 1, 2), chunk_steps=TP_CHUNK,
                           resident="off"),
        "sp=2": tp_trainer(vocab, corpus, [dev] * 2, (1, 2, 1), chunk_steps=TP_CHUNK,
                           resident="off"),
    }
    held, peak = {}, {}
    for name, tr in arms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        tr.train(log_every=0, max_steps=TP_CHUNK)  # capture
        torch.cuda.synchronize()
        held[name] = torch.cuda.memory_allocated(dev) - base
        peak[name] = torch.cuda.max_memory_allocated(dev) - base
    wps = {k: [] for k in arms}
    for _ in range(TP_WPS_REPS):
        for name, tr in arms.items():
            _, rep = tr.train(log_every=0, max_steps=TP_WPS_STEPS)
            wps[name].append(rep.words_per_sec)
    one = float(np.mean(wps["tp=sp=1 (Trainer)"]))
    row["words_per_sec"] = wps
    row["over_tp1"] = {k: float(np.mean(v)) / one for k, v in wps.items()}
    tp2 = arms["tp=2"]
    shard_bytes = [sum(v.numel() * v.element_size() for v in s.values())
                   for s in tp2._replicas[0]]
    row["memory"] = {
        "tp1_table_bytes": sum(v.numel() * v.element_size()
                               for v in arms["tp=sp=1 (Trainer)"]._params.values()),
        "tp2_shard_table_bytes": shard_bytes,
        "held_after_capture_bytes": held,
        "peak_during_capture_bytes": peak,
    }
    log(f"  tp_sp words/sec A B C A B C ({card}): {wps}; over tp=sp=1 {row['over_tp1']}")
    log(f"  tp_sp memory: {row['memory']}")
    del arms, tp2
    gc.collect()
    torch.cuda.empty_cache()

    row["two_cards"] = tp_two_cards(vocab, corpus)
    row["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"tp_sp_phase": row}, default=str))


# ------------------------------------------------ 15: several processes
MP_PROCS = 2          # processes, both on the one card (gloo tables)
MP_EVERY = 8          # dp_sync_every: syncs at 8, 16, 24, 32
MP_ITERS = 2          # epochs: 16 global steps each at one replica a process
MP_WPS_REPS = 1       # A B
MP_CUT = 10           # the sigterm / peer_dead step on rank 1
MP_DEADLINE = 10.0    # --step-deadline and --sync-deadline of the kill drill
#: the host link of an H100 SXM: PCIe Gen5 x16, 64 GB/s a direction (data
#: sheet); two processes on one card share it
HOST_LINK_BYTES_PER_S = 64e9
#: (name, band_backend, layout, dp, tp, sync_mode) of the library arms
MP_ARMS = (("A", "pallas_fused", "unified", 2, 1, "mean"),
           ("B", "xla", "split", 4, 2, "delta"))


def mp_cfg(backend, layout, mode):
    return flagship_cfg(backend, layout, dp_sync_every=MP_EVERY, sync_mode=mode,
                        iters=MP_ITERS, resident="off")


def mp_shards(corpus):
    """Phase 5's tokens in whole rows of L, split into MP_PROCS rank shards
    of equal rows: every global step carries equal words on every rank, so
    the ranks' alpha schedules are the one-process run's."""
    rows = corpus.num_tokens // L // MP_PROCS
    return [corpus.flat[p * rows * L:(p + 1) * rows * L].astype(np.int32)
            for p in range(MP_PROCS)]


def mp_corpus(flat):
    from word2vec_tpu_torch import PackedCorpus

    return PackedCorpus.from_flat(flat, L)  # no separators: rows of exactly L


def mp_local_launches(tr, steps):
    """This process's launches of `steps` global steps of a fresh trainer:
    each local replica's shards run the step once a global step, plus the
    capture's eager warm-up step of every shard."""
    backend, layout = tr.config.band_backend, tr.config.table_layout
    shards = tr.local_reps * tr.tp
    return expected_launches(backend, layout, steps, replicas=shards,
                             warmups=shards)


def mp_wait(path, kids, what, timeout=300.0):
    t0 = time.monotonic()
    while not os.path.exists(path):
        for k in kids:
            if k.poll() is not None:
                fail(f"multiproc {what}: a process exited {k.returncode} early")
        if time.monotonic() - t0 > timeout:
            fail(f"multiproc {what}: timed out waiting for {path}")
        time.sleep(0.01)


def rank_fed_trainer(cfg, vocab, flats, dp, devs, tp=1):
    """The one-process ShardedTrainer of the fleet's mesh fed the fleet's
    global steps: each global step is rank 0's local_dp batches, then
    rank 1's (each rank's shard, its own BatchIterator)."""
    from word2vec_tpu_torch import PackedCorpus
    from word2vec_tpu_torch.data.batcher import BatchIterator
    from word2vec_tpu_torch.parallel import ShardedTrainer, make_mesh

    shards = [mp_corpus(f) for f in flats]

    class Fed(ShardedTrainer):
        def _batchers(self):
            c = self.config
            return [BatchIterator(s, c.batch_rows, c.max_sentence_len,
                                  seed=self.run_seed) for s in shards]

        def _agreed_steps_per_epoch(self, batcher):
            per = self.dp // len(shards)
            return min(-(-b.steps_per_epoch() // per) for b in self._batchers())

        def _global_batches(self, batcher, epoch, skip):
            per = self.dp // len(shards)
            its = [b.epoch(epoch, skip * per) for b in self._batchers()]
            for _ in range(skip, self._agreed_steps_per_epoch(batcher)):
                blocks, words = [], 0
                for it in its:
                    for _ in range(per):
                        got = next(it, None)
                        if got is None:
                            blocks.append(np.full((B, L), -1, np.int32))
                        else:
                            blocks.append(got[0])
                            words += got[1]
                yield np.concatenate(blocks, axis=0), words

    whole = PackedCorpus.from_flat(np.concatenate(flats), L)
    return Fed(cfg, vocab, whole, mesh=make_mesh(dp, tp=tp, devices=devs))


def mp_record_step(tr, flat, card, clock):
    """(b) One eager flagship step of this rank's replica-0 tables on its
    first batch: every fused_slab_scatter, ordered_row_sum and find_runs
    call bitwise its plain version, fused_grad_core within the stated
    tolerance of its plain version."""
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.ops import band_step as bs
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops.steps import make_step

    cfg, dev = tr.config, tr.device
    step = make_step(cfg, tr.tables)
    params = {k: v.clone() for k, v in tr._replicas[0].items()}
    tokens = torch.from_numpy(flat[:B * L].reshape(B, L).copy()).to(dev)
    draws = step.draw(generator(dev, 5), tokens)
    grads, real = [], bs.fused_grad_core

    def grad(*a, **kw):
        out = real(*a, **kw)
        grads.append(([x.clone() if torch.is_tensor(x) else x for x in a], dict(kw),
                      [o.clone() for o in out]))
        return out

    bs.fused_grad_core = grad
    try:
        with CallRecorder(band=True) as rec:
            step.apply(params, tokens, draws, 0.025)
    finally:
        bs.fused_grad_core = real
    torch.cuda.synchronize()
    kinds = [c[0] for c in rec.calls]
    want = expected_launches(cfg.band_backend, cfg.table_layout, 1)
    if {k: kinds.count(k) for k in CallRecorder.NAMES} != {
            k: want[k] for k in CallRecorder.NAMES} or len(grads) != 1:
        fail(f"multiproc: recorded calls {kinds} + {len(grads)} grad cores != {want}")
    check_hs_calls("multiproc rank 0", rec.calls, card, clock, timed=set())
    a, kw, got = grads[0]
    ref = fs.fused_grad_core_plain(*a, **kw)
    errs = check_outputs("multiproc fused_grad_core", GRAD_NAMES, got, ref,
                         torch.bfloat16, quiet=True)
    return {"calls": len(rec.calls) + 1, "bitwise": len(rec.calls),
            "fused_grad_core_max_abs_err": errs}


def mp_child(spec_path) -> int:
    """One process of a phase-15 fleet (`chip_smoke.py --mp-child SPEC`)
    under the W2V_* contract: the library arms, or the NCCL probe."""
    from word2vec_tpu_torch.parallel import multihost

    spec = json.load(open(spec_path))
    tmp = spec["tmp"]
    if spec["role"] == "nccl_probe":
        return mp_nccl_probe(spec)
    from word2vec_tpu_torch.ops.graphs import METRICS
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts
    from word2vec_tpu_torch.parallel import (
        ShardedTrainer, make_delta_sync, make_global_mesh, make_sync,
    )
    from word2vec_tpu_torch.utils.synthetic import zipf_vocab

    check_no_jax()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not multihost.initialize_from_env():
        fail("multiproc child: no W2V_* contract")
    rank = multihost.process_index()
    card = card_line()
    vocab = zipf_vocab(V)
    flat = np.load(os.path.join(tmp, f"shard{rank}.npy"))
    corpus = mp_corpus(flat)
    own = spec["devices"] == "own"
    out = {"rank": rank, "card": card, "runs": {}}

    def trainer(backend, layout, dp, tp, mode):
        n = dp // MP_PROCS * tp
        devs = None if own else [torch.device("cuda", 0)] * n
        return ShardedTrainer(mp_cfg(backend, layout, mode), vocab, corpus,
                              mesh=make_global_mesh(dp, tp, devices=devs))

    for name, backend, layout, dp, tp, mode in MP_ARMS:
        if name not in spec["arms"]:
            continue
        reps = MP_WPS_REPS if name == "A" and not own else 1
        for k in range(reps):
            tr = trainer(backend, layout, dp, tp, mode)
            multihost.reset_collective_stats()
            reset_launch_counts()
            state, rep = tr.train(log_every=4)
            torch.cuda.synchronize()
            counts = dict(LAUNCHES)
            want = mp_local_launches(tr, rep.steps)
            if counts != want:
                fail(f"multiproc {name} rank {rank}: launch counts {counts} != {want}")
            hist = rep.loss_history
            if not (hist and all(np.isfinite(hist)) and hist[-1] < hist[0]):
                fail(f"multiproc {name} rank {rank}: loss {hist}")
            if k == 0 and rank == 0:
                exp = tr.export_params(state)
                np.savez(os.path.join(tmp, f"export_{name}.npz"),
                         **{key: v.float().cpu().numpy() for key, v in exp.items()})
            out["runs"].setdefault(name, []).append({
                "steps": rep.steps, "words": rep.total_words,
                "words_per_sec": rep.words_per_sec, "wall_s": rep.wall_time,
                "launches": counts, "loss_history": hist,
                "collectives": multihost.collective_stats(),
                "capture_s": tr.capture_s,
            })
            if name == "A" and not own:
                # the parent's one-process run goes between ours (A B A B)
                open(os.path.join(tmp, f"a{k}_r{rank}.done"), "w").close()
                t0 = time.monotonic()
                while not os.path.exists(os.path.join(tmp, f"b{k}.done")):
                    if time.monotonic() - t0 > 300:
                        fail("multiproc: the parent's run never ended")
                    time.sleep(0.01)
            if name == "A" and k == reps - 1 and not own:
                # (e) one cross-process sync of the flagship tables per
                # mode, split; the heartbeat and the metrics gather
                out["sync"] = {}
                for mode_ in ("mean", "delta"):
                    reps_ = tr._replicas
                    base = {key: v.clone() for key, v in reps_[0].items()}
                    sync = (make_sync(tr.mesh) if mode_ == "mean"
                            else make_delta_sync(tr.mesh))
                    times = []
                    multihost.reset_collective_stats()
                    for _ in range(5):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        sync(reps_) if mode_ == "mean" else sync(reps_, base)
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                    st = multihost.collective_stats()
                    out["sync"][mode_] = {
                        "ms": float(np.median(times)), "ms_each": times,
                        "d2h_ms": st["d2h_ms"] / 5, "gather_ms": st["gather_ms"] / 5,
                        "h2d_ms": st["h2d_ms"] / 5, "bytes_sent": st["bytes"] // 5,
                    }
                hb = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    multihost.global_heartbeat([float(rank), 0.0, 1.0, 2.0, 0.0, 0.0])
                    hb.append((time.perf_counter() - t0) * 1e3)
                mg = []
                rows = np.zeros((len(METRICS), 1, 1), np.float32)
                for _ in range(20):
                    t0 = time.perf_counter()
                    multihost.gather_replica_rows(rows)
                    mg.append((time.perf_counter() - t0) * 1e3)
                out["heartbeat_ms"] = float(np.median(hb))
                out["metrics_gather_ms"] = float(np.median(mg))
                if rank == 0:
                    out["recorded_step"] = mp_record_step(
                        tr, flat, card, sm_clock_hz())
            del tr, state
            torch.cuda.empty_cache()
    out["topology"] = multihost.topology()
    with open(os.path.join(tmp, f"child{spec['tag']}_r{rank}.json"), "w") as f:
        json.dump(out, f, default=str)
    sys.stdout.flush()
    # no teardown: the fleet is done, and a group's exit is the process's
    os._exit(0)


def mp_nccl_probe(spec) -> int:
    """Two ranks asking NCCL for one communicator on the one card: what
    the library says (NCCL refuses two ranks on one GPU)."""
    import torch.distributed as dist

    rank = int(os.environ["W2V_PROC_ID"])
    res = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://{os.environ['W2V_COORDINATOR']}",
                                world_size=MP_PROCS, rank=rank)
        t = torch.ones(4, device="cuda:0")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        res["outcome"] = f"no error: all_reduce gave {t.tolist()}"
    except Exception as e:  # noqa: BLE001 — the message is the measurement
        res["outcome"] = f"{type(e).__name__}: {str(e)[:600]}"
    with open(os.path.join(spec["tmp"], f"nccl_r{rank}.json"), "w") as f:
        json.dump(res, f)
    sys.stdout.flush()
    os._exit(0)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


#: every process phase 15 started (killed on the way out if still running)
MP_KIDS: list = []


def mp_spawn(argvs, tmp, tag, extra_env=None):
    """Start one process a rank under the W2V_* contract (a fresh
    localhost port); each rank's output in tmp/<tag>_r<p>.log."""
    env = dict(os.environ, W2V_COORDINATOR=f"127.0.0.1:{free_port()}",
               W2V_NUM_PROCS=str(len(argvs)), PYTHONUNBUFFERED="1")
    env.update(extra_env or {})
    kids = []
    for p, argv in enumerate(argvs):
        log_f = open(os.path.join(tmp, f"{tag}_r{p}.log"), "w")
        kids.append(subprocess.Popen(argv, env=dict(env, W2V_PROC_ID=str(p)),
                                     stdout=log_f, stderr=subprocess.STDOUT,
                                     cwd=HERE))
    MP_KIDS.extend(kids)
    return kids


def mp_finish(kids, what, timeout=240.0):
    """Wait for every rank (killing all at the timeout); the exit codes
    and the time each one was seen to end."""
    t0 = time.monotonic()
    ends = [None] * len(kids)
    try:
        while None in ends:
            for i, k in enumerate(kids):
                if ends[i] is None and k.poll() is not None:
                    ends[i] = time.monotonic()
            if time.monotonic() - t0 > timeout:
                fail(f"multiproc {what}: ranks still running after {timeout:.0f} s")
            time.sleep(0.01)
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
                k.wait()
    return [k.returncode for k in kids], ends


def mp_tail(tmp, tag, p, n=15):
    with open(os.path.join(tmp, f"{tag}_r{p}.log")) as f:
        return "".join(f.readlines()[-n:])


def mp_cli_flags(tmp, p, ck, out, extra=()):
    return [sys.executable, "-m", "word2vec_tpu_torch.cli",
            "-train", os.path.join(tmp, f"shard{p}.txt"),
            "-read-vocab", os.path.join(tmp, "vocab.txt"), "-output", out,
            "-binary", "1", "-size", str(D), "-window", str(W), "-negative", str(K),
            "-iter", str(MP_ITERS), "--batch-rows", str(B), "--max-sentence-len",
            str(L), "--shared-negatives", str(KP), "--band-backend", "pallas_fused",
            "--table-layout", "unified", "--chunk-steps", str(MP_EVERY),
            "--dp", str(MP_PROCS), "--dp-sync-every", str(MP_EVERY), "--multihost",
            "--checkpoint-dir", ck, "--checkpoint-every", str(MP_EVERY),
            "--quiet", *extra]


def phase_multiproc(dev, vocab, corpus, card, tmp):
    """Several processes on the one card (phase 15 of the module
    docstring); no process it started outlives it."""
    try:
        mp_phase(dev, vocab, corpus, card, tmp)
    finally:
        for k in MP_KIDS:
            if k.poll() is None:
                k.kill()
                k.wait()


def mp_phase(dev, vocab, corpus, card, tmp):
    import gc

    from word2vec_tpu_torch.io.checkpoint import load_checkpoint

    gc.collect()
    torch.cuda.empty_cache()  # the children share the card
    t_phase = time.perf_counter()
    row = {"card": card, "procs": MP_PROCS, "dp_sync_every": MP_EVERY}
    flats = mp_shards(corpus)
    for p, f in enumerate(flats):
        np.save(os.path.join(tmp, f"shard{p}.npy"), f)
    me = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--mp-child"]

    def spec(tag, **kw):
        path = os.path.join(tmp, f"spec_{tag}.json")
        with open(path, "w") as f:
            json.dump(dict(kw, tmp=tmp, tag=tag), f)
        return me + [path]

    # (a), (b), (e): the library arms, two processes sharing the card;
    # the one-process dp-2 run (the same mesh fed the same global steps)
    # between the fleet's runs of arm A: A B A B
    kids = mp_spawn([spec("lib", role="lib", arms=["A", "B"], devices="shared")] * MP_PROCS,
                    tmp, "lib")
    refs, wps_ref = {}, []
    for k in range(MP_WPS_REPS):
        for p in range(MP_PROCS):
            mp_wait(os.path.join(tmp, f"a{k}_r{p}.done"), kids, "arm A")
        ref = rank_fed_trainer(mp_cfg("pallas_fused", "unified", "mean"), vocab,
                                  flats, 2, [dev] * 2)
        state, rep = ref.train(log_every=4)
        torch.cuda.synchronize()
        wps_ref.append(rep.words_per_sec)
        if k == 0:
            refs["A"] = {key: v.float().cpu().numpy()
                         for key, v in ref.export_params(state).items()}
        del ref, state
        gc.collect()
        torch.cuda.empty_cache()
        open(os.path.join(tmp, f"b{k}.done"), "w").close()
    ref = rank_fed_trainer(mp_cfg("xla", "split", "delta"), vocab, flats, 4,
                              [dev] * 8, tp=2)
    state, _ = ref.train(log_every=0)
    refs["B"] = {key: v.float().cpu().numpy() for key, v in ref.export_params(state).items()}
    del ref, state
    gc.collect()
    torch.cuda.empty_cache()
    rcs, _ = mp_finish(kids, "library arms")
    if rcs != [0] * MP_PROCS:
        fail(f"multiproc library arms exited {rcs}: {mp_tail(tmp, 'lib', 0)}"
             f"{mp_tail(tmp, 'lib', 1)}")
    kid = [json.load(open(os.path.join(tmp, f"childlib_r{p}.json"))) for p in range(MP_PROCS)]
    row["topology"] = kid[0]["topology"]
    if row["topology"]["table_backend"] != "gloo":
        fail(f"multiproc: the table backend on one card is {row['topology']}")
    row["arms"] = {}
    for name, backend, layout, dp, tp, mode in MP_ARMS:
        got = np.load(os.path.join(tmp, f"export_{name}.npz"))
        same = sorted(got.files) == sorted(refs[name]) and all(
            got[key].tobytes() == refs[name][key].tobytes() for key in got.files)
        if not same:
            fail(f"multiproc arm {name}: the fleet's export != the one-process run of "
                 "the same mesh fed the same global steps (bitwise)")
        runs = [c["runs"][name] for c in kid]
        row["arms"][name] = {
            "route": f"{backend}/{layout}", "dp": dp, "tp": tp, "sync": mode,
            "bitwise_one_process": same,
            "launches_per_rank": [r[0]["launches"] for r in runs],
            "steps": runs[0][0]["steps"], "loss_history": runs[0][0]["loss_history"],
            "capture_s": [r[0]["capture_s"] for r in runs],
            "collectives_rank0": runs[0][0]["collectives"],
        }
        log(f"  multiproc arm {name} ({backend}/{layout}, dp {dp}, tp {tp}, {mode}): "
            f"export bitwise the one-process run; launches exact on both ranks "
            f"{row['arms'][name]['launches_per_rank'][0]}")
    fleet = [sum(c["runs"]["A"][k]["words_per_sec"] for c in kid) for k in range(MP_WPS_REPS)]
    row["words_per_sec"] = {"fleet (2 processes, 1 replica each)": fleet,
                            "one process, dp 2": wps_ref}
    row["fleet_over_one_process"] = float(np.mean(fleet) / np.mean(wps_ref))
    log(f"  multiproc words/sec A B ({card}): fleet {fleet}, one process {wps_ref}; "
        f"ratio {row['fleet_over_one_process']:.4f}")
    table = V * 2 * D * 4  # one replica's unified f32 slab
    row["sync"] = {}
    for mode, wire in (("mean", table), ("delta", table // 2)):
        s = kid[0]["sync"][mode]
        # every process stages its replica out and the other's in over the
        # one card's host link: MP_PROCS * wire bytes each way
        bound = MP_PROCS * wire / HOST_LINK_BYTES_PER_S * 1e3
        row["sync"][mode] = dict(s, bound_ms=bound, bound_by="bytes (host link)",
                                 wire_bytes=wire)
        log(f"  multiproc sync {mode} ({card}): {s['ms']:.3f} ms (d2h {s['d2h_ms']:.3f}, "
            f"gather {s['gather_ms']:.3f}, h2d {s['h2d_ms']:.3f}); host-link bound "
            f"{bound:.3f} ms ({wire} B a replica)")
    row["heartbeat_ms"] = kid[0]["heartbeat_ms"]
    row["metrics_gather_ms"] = kid[0]["metrics_gather_ms"]
    row["recorded_step"] = kid[0]["recorded_step"]
    log(f"  multiproc heartbeat {row['heartbeat_ms']:.3f} ms, metrics gather "
        f"{row['metrics_gather_ms']:.3f} ms; rank 0's step: "
        f"{row['recorded_step']['bitwise']} calls bitwise their plain versions")

    # (c) the agreed stop and the resume, (d) kill one of two: the CLI
    vocab.save(os.path.join(tmp, "vocab.txt"))
    words = np.asarray(vocab.words)
    for p, f in enumerate(flats):
        with open(os.path.join(tmp, f"shard{p}.txt"), "w") as fh:
            fh.write(" ".join(words[f].tolist()))
    ck = {t: os.path.join(tmp, f"ck_{t}") for t in ("whole", "cut", "kill")}
    vec = {t: os.path.join(tmp, f"v_{t}.bin") for t in ("whole", "cut")}
    fleets = {
        "whole": mp_spawn([mp_cli_flags(tmp, p, ck["whole"], vec["whole"])
                           for p in range(MP_PROCS)], tmp, "whole"),
        "cut": mp_spawn([mp_cli_flags(tmp, p, ck["cut"], vec["cut"],
                                      ["--faults", f"sigterm@{MP_CUT}"] if p == 1 else [])
                         for p in range(MP_PROCS)], tmp, "cut"),
        "kill": mp_spawn([mp_cli_flags(tmp, p, ck["kill"], "", [
            "--step-deadline", str(MP_DEADLINE), "--sync-deadline", str(MP_DEADLINE)]
            + (["--faults", f"peer_dead@{MP_CUT}"] if p == 1 else []))
            for p in range(MP_PROCS)], tmp, "kill"),
    }
    ends = {t: mp_finish(k, t) for t, k in fleets.items()}
    if ends["whole"][0] != [0, 0]:
        fail(f"multiproc whole CLI run exited {ends['whole'][0]}: "
             f"{mp_tail(tmp, 'whole', 0)}{mp_tail(tmp, 'whole', 1)}")
    if ends["cut"][0] != [75, 75]:
        fail(f"multiproc agreed stop: exits {ends['cut'][0]} (want 75, 75): "
             f"{mp_tail(tmp, 'cut', 0)}{mp_tail(tmp, 'cut', 1)}")
    stopped, _, _ = load_checkpoint(ck["cut"])
    if stopped.step % MP_EVERY or not MP_CUT <= stopped.step < MP_ITERS * 16:
        fail(f"multiproc agreed stop at step {stopped.step}")
    resumed = mp_spawn([mp_cli_flags(tmp, p, ck["cut"], vec["cut"], ["--resume", ck["cut"]])
                        for p in range(MP_PROCS)], tmp, "resume")
    rcs, _ = mp_finish(resumed, "resume")
    if rcs != [0, 0]:
        fail(f"multiproc resume exited {rcs}: {mp_tail(tmp, 'resume', 0)}")
    same = (open(vec["cut"], "rb").read() == open(vec["whole"], "rb").read()
            and npz_bitwise(ck["cut"], ck["whole"]))
    if not same:
        fail("multiproc: the resumed run != the uninterrupted run (bitwise)")
    row["agreed_stop"] = {"exits": ends["cut"][0], "stopped_at": stopped.step,
                          "resume_bitwise": same}
    log(f"  multiproc agreed stop: sigterm@{MP_CUT} on rank 1 -> both ranks stopped at "
        f"step {stopped.step}, exit 75, 75; --resume bitwise the uninterrupted run")
    (rc0, rc1), (end0, end1) = ends["kill"]
    after = end0 - end1  # the survivor's exit after the victim's death
    if rc1 != -signal.SIGKILL or rc0 not in (75, 76) or after > 2 * MP_DEADLINE + 10:
        fail(f"multiproc kill: exits {rc0}, {rc1}, survivor {after:.1f} s after: "
             f"{mp_tail(tmp, 'kill', 0)}")
    with open(os.path.join(tmp, "kill_r0.log")) as f:
        said = [ln.strip() for ln in f if "peer" in ln or "error" in ln][-3:]
    # both ends are seen by one 10 ms poll loop, so "after" may read < 0
    row["kill"] = {"victim_exit": rc1, "survivor_exit": rc0,
                   "survivor_s_after_victim": after, "survivor_said": said}
    log(f"  multiproc kill one of two: rank 1 {rc1}, rank 0 exit {rc0} "
        f"{max(after, 0.0):.2f} s later (deadlines {MP_DEADLINE} s): {said}")

    # (f) NCCL: one card a rank where there are two; on one card, what
    # NCCL says to two ranks on it
    if torch.cuda.device_count() >= 2:
        kids = mp_spawn([spec("nccl", role="lib", arms=["A"], devices="own")] * MP_PROCS,
                        tmp, "nccl")
        rcs, _ = mp_finish(kids, "NCCL arm")
        if rcs != [0] * MP_PROCS:
            fail(f"multiproc NCCL arm exited {rcs}: {mp_tail(tmp, 'nccl', 0)}")
        got = np.load(os.path.join(tmp, "export_A.npz"))
        topo = json.load(open(os.path.join(tmp, "childnccl_r0.json")))["topology"]
        same = all(got[key].tobytes() == refs["A"][key].tobytes() for key in got.files)
        if topo["table_backend"] != "nccl" or not same:
            fail(f"multiproc NCCL arm: backend {topo['table_backend']}, bitwise {same}")
        row["nccl"] = {"bitwise_one_process": same, "topology": topo}
    else:
        log("  multiproc: the NCCL arm (one card a rank) needs a second card; "
            "this machine has one")
        kids = mp_spawn([spec("probe", role="nccl_probe")] * MP_PROCS, tmp, "probe")
        rcs, _ = mp_finish(kids, "NCCL probe", timeout=60.0)
        said = [json.load(open(os.path.join(tmp, f"nccl_r{p}.json")))["outcome"]
                if os.path.exists(os.path.join(tmp, f"nccl_r{p}.json")) else None
                for p in range(MP_PROCS)]
        row["nccl"] = {"not run": "needs a second card (this machine has one)",
                       "two_ranks_one_card": said}
        log(f"  multiproc NCCL, two ranks on one card: {said}")
    row["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"multiproc_phase": row}, default=str))


# ------------------------------------------------- phase 16: elastic drills
EL_PROCS = 3          # processes at launch, all on the one card
EL_EVERY = 8          # dp_sync_every (the default 64 cut: >= 2 syncs a generation)
EL_ROWS = 8 * B       # rows a shard: an epoch is 8 global steps, one chunk, one sync
EL_ITERS = 8          # epochs: 64 global steps (legs a and b)
EL_ITERS_C = 24       # leg c: 192, so generation 1 outlasts the evicted host's cold start
EL_KILL = 16          # the peer_rejoin / rank0_dead boundary
EL_CKPT = 16          # --checkpoint-every
EL_DEADLINE = 10.0    # --sync-deadline
EL_POLICY = ("throughput_wps<0.55*baseline:for=2:baseline=2:act=shrink,"
             "throughput_wps>0.7*baseline:for=2:baseline=2:act=grow,cooldown=3")
#: the policy leg's straggler: stalls in its signal windows 3 and 4 (a
#: window is EL_CKPT steps, so each holds one checkpoint and the windows
#: of a steady run read alike)
EL_STALLS = ",".join(f"stall@{s}:secs=1.5" for s in (32, 40, 48, 56))


def el_ports(n: int) -> int:
    """A base port with n free consecutive ports after it, below the
    ephemeral range (a gloo pair listener never takes one mid-drill)."""
    import random
    import socket

    rnd = random.SystemRandom()
    for _ in range(200):
        base = rnd.randrange(20000, 32000 - n)
        try:
            socks = []
            for q in range(n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + q))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    fail("elastic: no run of free ports")


#: every process phase 16 started, each the leader of its process group
EL_KIDS: list = []


def el_kill_group(proc) -> None:
    """SIGKILL a rank's process group: the rank (any generation of it, the
    pid survives the execs) and the store shepherds it started."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


class ElasticLeg:
    """One elastic drill leg: a fleet of CLI processes under the W2V_*
    contract with --multihost --elastic (the ranks and every generation
    of them, exec'd in place, each in its own process group), watched from
    here: exits, the rank-0 manifest's generations, the card's memory.
    `prefix` is the command a rank runs before the CLI's arguments (the
    exec keeps it: resilience/elastic.launch_prefix)."""

    def __init__(self, tmp, tag, prefix, flags, shards, mode, extra=None,
                 env=None, card=False, ckpt_every=EL_CKPT, deadline=EL_DEADLINE):
        self.tmp, self.tag, self.prefix = tmp, tag, list(prefix)
        self.ckpt_every, self.deadline = ckpt_every, deadline
        self.flags, self.shards, self.mode = list(flags), list(shards), mode
        self.extra = extra or {}
        self.card = card
        self.ck = os.path.join(tmp, f"{tag}_ck")
        self.mdir = os.path.join(tmp, f"{tag}_m")
        self.out = os.path.join(tmp, f"{tag}_vec.bin")
        # generation g's store on port0 + g; the rendezvous and its
        # standby slots on eport + r
        self.port0 = el_ports(8 + EL_PROCS + 2)
        self.eport = self.port0 + 8
        self.base_env = dict(os.environ, **(env or {}),
                             W2V_COORDINATOR=f"127.0.0.1:{self.port0}",
                             W2V_NUM_PROCS=str(len(shards)),
                             W2V_ELASTIC_COORD=f"127.0.0.1:{self.eport}",
                             PYTHONUNBUFFERED="1")
        self.procs, self.argvs, self.envs = [], [], []
        self.mem = []  # (t, bytes in use on the card)
        self.t0 = time.monotonic()

    def argv(self, p):
        return self.prefix + [
            "-train", self.shards[p], *self.flags, "-output", self.out,
            "--multihost", "--dp", str(len(self.shards)),
            "--elastic", self.mode, "--sync-deadline", str(self.deadline),
            "--checkpoint-dir", self.ck, "--checkpoint-every", str(self.ckpt_every),
            "--metrics-dir", self.mdir, "--quality-probe-every", "0",
            "--compile-cache", os.path.join(self.tmp, "kcache"),
            *self.extra.get(p, [])]

    def spawn(self, p, argv=None, env=None):
        argv = argv or self.argv(p)
        env = env or dict(self.base_env, W2V_PROC_ID=str(p))
        log_f = open(os.path.join(self.tmp, f"{self.tag}_r{p}.log"), "a")
        proc = subprocess.Popen(argv, env=env, stdout=log_f,
                                stderr=subprocess.STDOUT, cwd=HERE,
                                start_new_session=True)
        EL_KIDS.append(proc)
        return proc, argv, env

    def start(self):
        for p in range(len(self.shards)):
            proc, argv, env = self.spawn(p)
            self.procs.append(proc)
            self.argvs.append(argv)
            self.envs.append(env)

    def manifest(self):
        try:
            return manifest_of(self.mdir)
        except (OSError, ValueError):
            return {}

    def events(self, kind=None):
        ev = self.manifest().get("mesh_events") or []
        return [e for e in ev if kind is None or e.get("event") == kind]

    def sample(self):
        if self.card:
            free, total = torch.cuda.mem_get_info()
            self.mem.append((time.monotonic(), total - free))

    def wait(self, pred, what, timeout=240.0, dead_ok=()):
        """Poll (10 ms) until pred(); a process that exits nonzero (except
        those in dead_ok) fails the leg at once."""
        t0 = time.monotonic()
        while not pred():
            for i, k in enumerate(self.procs):
                if k.poll() not in (None, 0) and i not in dead_ok:
                    fail(f"elastic {self.tag}: rank {i} exited {k.returncode}: "
                         f"{self.tail(i)}")
            if time.monotonic() - t0 > timeout:
                fail(f"elastic {self.tag}: timed out waiting for {what}: "
                     f"{self.tail(0)}")
            self.sample()
            time.sleep(0.01)
        return time.monotonic()

    def gen_started(self, g):
        return lambda: any(e.get("gen") == g for e in
                           self.events("generation_first_boundary"))

    def tail(self, p, n=25):
        try:
            with open(os.path.join(self.tmp, f"{self.tag}_r{p}.log")) as f:
                return "".join(f.readlines()[-n:])
        except OSError:
            return ""

    def finish(self, timeout=240.0, dead=()):
        self.wait(lambda: all(k.poll() is not None for i, k in
                              enumerate(self.procs) if i not in dead),
                  "the end", timeout, dead_ok=dead)
        rcs = [k.returncode for k in self.procs]
        for k in self.procs:
            el_kill_group(k)
        return rcs

    def stop(self):
        for k in self.procs:
            el_kill_group(k)
            if k.poll() is None:
                k.wait()


def el_reference(tmp, tag, prefix, flags, shards, resume, stop_at=None,
                 env=None, ckpt_every=EL_CKPT):
    """A fresh fleet of len(shards) processes resumed from `resume`
    (--multihost, not elastic; its own store), to the end or stopped by a
    SIGTERM at `stop_at` (exit 75, the checkpoint at that step). Returns
    (processes, checkpoint dir, vectors path)."""
    ck = os.path.join(tmp, f"{tag}_ck")
    out = os.path.join(tmp, f"{tag}_vec.bin")
    base = dict(os.environ, **(env or {}),
                W2V_COORDINATOR=f"127.0.0.1:{el_ports(1)}",
                W2V_NUM_PROCS=str(len(shards)), PYTHONUNBUFFERED="1")
    kids = []
    for p, shard in enumerate(shards):
        argv = prefix + ["-train", shard, *flags, "-output", out, "--multihost",
                         "--dp", str(len(shards)), "--checkpoint-dir", ck,
                         "--checkpoint-every", str(ckpt_every), "--quality-probe-every",
                         "0", "--resume", resume]
        if stop_at is not None and p == 0:
            argv += ["--faults", f"sigterm@{stop_at}"]
        log_f = open(os.path.join(tmp, f"{tag}_r{p}.log"), "w")
        kids.append(subprocess.Popen(argv, env=dict(base, W2V_PROC_ID=str(p)),
                                     stdout=log_f, stderr=subprocess.STDOUT,
                                     cwd=HERE, start_new_session=True))
    EL_KIDS.extend(kids)
    return kids, ck, out


def el_snapshot_step(ck, g):
    with np.load(os.path.join(f"{ck}.elastic_g{g}", "state.npz")) as z:
        return int(z["__step"])


def el_leg_a(leg):
    """(a) shrink then grow: peer_rejoin on rank 2 at EL_KILL; rank 2 is
    started again as it was launched (less its fault) and, once generation
    1 passed its first boundary, announces itself; it is admitted at a
    sync boundary. Behind the el-child prefix the restarted process is
    kept warm (imports done) until then, so the announce does not wait
    out an interpreter start on a busy host."""
    leg.start()
    t_kill = leg.wait(lambda: leg.procs[2].poll() is not None, "the victim's death",
                      dead_ok=(2,))
    mem_kill = leg.mem[-2][1] if len(leg.mem) > 1 else None
    if leg.procs[2].returncode != -signal.SIGKILL:
        fail(f"elastic a: the victim exited {leg.procs[2].returncode}")
    t_kill = el_kill_time(leg, 2, t_kill)
    argv = [a for a in leg.argvs[2]]
    i = argv.index("--faults")
    del argv[i:i + 2]
    gate = os.path.join(leg.tmp, f"{leg.tag}_rejoin.go")
    if "--el-child" in argv:
        j = argv.index("--")
        argv[j:j] = ["--wait", gate]
        leg.procs[2], _, _ = leg.spawn(2, argv, leg.envs[2])
    leg.wait(leg.gen_started(1), "generation 1", dead_ok=(2,))
    if "--el-child" in argv:
        open(gate, "w").close()
    else:
        leg.procs[2], _, _ = leg.spawn(2, argv, leg.envs[2])
    t_relaunch = time.monotonic()
    leg.wait(leg.gen_started(2), "generation 2 (the rejoiner admitted)")
    return {"t_kill": t_kill, "mem_before_kill": mem_kill,
            "t_relaunch": t_relaunch}


def el_kill_time(leg, rank, seen):
    """The victim's own clock at its SIGKILL (the el-child writes it),
    else when this poll loop saw the death."""
    path = os.path.join(leg.prefix[leg.prefix.index("--el-child") + 1],
                        f"kill_g0_r{rank}.json") if "--el-child" in leg.prefix else ""
    if path and os.path.exists(path):
        with open(path) as f:
            return json.load(f)["t"]
    return seen


def el_leg_b(leg):
    """(b) rank0_dead at EL_KILL: the survivors elect the lowest surviving
    rank, which hosts the round and rank 0 of generation 1."""
    leg.start()
    t_kill = leg.wait(lambda: leg.procs[0].poll() is not None, "rank 0's death",
                      dead_ok=(0,))
    mem_kill = leg.mem[-2][1] if len(leg.mem) > 1 else None
    if leg.procs[0].returncode != -signal.SIGKILL:
        fail(f"elastic b: rank 0 exited {leg.procs[0].returncode}")
    t_kill = el_kill_time(leg, 0, t_kill)
    leg.wait(leg.gen_started(1), "generation 1 (elected)", dead_ok=(0,))
    return {"t_kill": t_kill, "mem_before_kill": mem_kill}


def el_leg_c(leg):
    """(c) the policy: rank 2 stalls (no failure), the throughput rule
    evicts it at a sync boundary (it execs announce-only and parks), the
    recovery rule opens the grow gate and it is admitted again."""
    leg.start()
    leg.wait(leg.gen_started(1), "generation 1 (policy shrink)")
    leg.wait(leg.gen_started(2), "generation 2 (policy grow)")
    return {}


def el_transitions(leg, t_kill=None):
    """Each generation g >= 1's blackout, from the failure (the drill's
    kill clock) or the boundary (the old image's detect clock) to its
    first dispatch boundary, in parts (the new rank 0's start-up marks
    and the old image's handoff); and the card's memory after that
    boundary."""
    starts = {e["gen"]: e for e in leg.events("generation_start")}
    firsts = {e["gen"]: e for e in leg.events("generation_first_boundary")}
    rows = []
    for g in sorted(k for k in firsts if k >= 1):
        st, fb = starts[g]["startup"], firsts[g]
        h = st.get("handoff") or {}
        t_from = t_kill if (t_kill is not None and g == 1) else h["detect_t"]
        round_end = h["round_start_t"] + h["round_s"]
        parts = {
            "detection": h["detect_t"] - t_from,
            "checkpoint": h["round_start_t"] - h["detect_t"],
            "round (less the snapshot)": h["round_s"] - (h.get("snapshot_s") or 0.0),
            "snapshot": h.get("snapshot_s") or 0.0,
            "exec": st["exec_t"] - round_end,
            "interpreter and torch import": st["main"] - st["exec_t"],
            "elastic startup": st["elastic_startup"] - st["main"],
            "shepherd start": st.get("shepherd_s", 0.0),
            "wait for the store": st.get("store_wait_s", 0.0),
            "process-group init": st.get("group_init_s", 0.0),
            "checkpoint load": st["checkpoint_load"] - st["group"],
            "corpus": st["corpus"] - st["checkpoint_load"],
            "trainer and import": st["trainer"] - st["corpus"],
            "to train()": fb["train_start_t"] - st["trainer"],
            "captures": fb["capture_s"],
            "first dispatch": fb["t"] - fb["train_start_t"] - fb["capture_s"],
        }
        after = [m for t, m in leg.mem if t >= fb["t"]]
        rows.append({
            "gen": g, "world": starts[g]["world"], "trigger": starts[g]["trigger"],
            "blackout_s": fb["t"] - t_from, "parts_s": parts,
            "first_boundary_step": fb["step"], "nvcc_runs": fb["nvcc_runs"],
            "inherited_sockets": st.get("inherited_sockets"),
            "card_bytes_after_first_boundary": after[0] if after else None,
            "rank0_bytes_allocated": fb.get("memory_allocated"),
        })
    return rows


def el_child(argv) -> int:
    """One rank of a phase-16 fleet (`chip_smoke.py --el-child OUT [--wait
    FILE] -- <cli arguments>`): the port's CLI in process, with the drill's
    instruments: every dispatch boundary's clock and words, and when the
    process leaves its generation (exit or exec) its launch counts, nvcc
    runs and boundaries into OUT; rank 0 of a generation after a remesh
    also records one flagship step against the plain versions (its
    launches taken back out of the counts). With --wait the process
    imports everything, then waits for FILE before the CLI starts: a
    restarted host kept warm, announced when the drill says."""
    sep = argv.index("--")
    out_dir, opts, cli_argv = argv[0], argv[1:sep], argv[sep + 1:]
    from word2vec_tpu_torch import _build, cli
    from word2vec_tpu_torch.ops.launch import LAUNCHES
    from word2vec_tpu_torch.parallel import trainer as ptr
    from word2vec_tpu_torch.resilience import elastic

    gen = int(os.environ.get("W2V_ELASTIC_GEN", "0") or 0)
    rank = int(os.environ.get("W2V_PROC_ID", "0"))
    seen = {"boundaries": [], "trainer": None, "recorded": None}
    real_train, real_stop = ptr.ShardedTrainer.train, ptr.ShardedTrainer._check_stop

    def train(self, state=None, *a, **kw):
        seen["trainer"] = self
        seen["start_step"] = state.step if state is not None else 0
        return real_train(self, state, *a, **kw)

    def record_step(tr):
        """After the generation trained (so the blackout is not timed
        with it): one eager flagship step of rank 0's replica tables."""
        before = dict(LAUNCHES)
        i = cli_argv.index("-train")
        from word2vec_tpu_torch import native

        flat = native.encode_file(cli_argv[i + 1], tr.vocab, native.MODE_STREAM)
        seen["recorded"] = mp_record_step(tr, flat, card_line(), sm_clock_hz())
        LAUNCHES.clear()
        LAUNCHES.update(before)  # the comparison's launches do not count

    def check_stop(self, state):
        seen["boundaries"].append((time.monotonic(), state.step, state.words_done))
        return real_stop(self, state)

    def dump(how):
        tr = seen["trainer"]
        if gen >= 1 and rank == 0 and tr is not None and seen["boundaries"] \
                and tr.device.type == "cuda" and seen["recorded"] is None:
            record_step(tr)
        rec = {"gen": gen, "rank": rank, "pid": os.getpid(), "how": how,
               "world": int(os.environ.get("W2V_NUM_PROCS", "1")),
               "launches": dict(LAUNCHES), "nvcc_runs": list(_build.NVCC_RUNS),
               "start_step": seen.get("start_step"),
               "boundaries": seen["boundaries"], "recorded_step": seen["recorded"],
               "captures": len(tr._runners) if tr is not None else 0,
               "capture_s": tr.capture_s if tr is not None else None}
        name = f"g{gen}_r{rank}_{os.getpid()}_{how}_{time.monotonic_ns()}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, default=str)

    real_replace, real_kill = elastic._replace_image, os.kill

    def replace_image(*a, **kw):
        dump("exec")
        real_replace(*a, **kw)

    def kill(pid, sig):
        if pid == os.getpid() and sig == signal.SIGKILL:
            # an injected host loss: the blackout starts now
            with open(os.path.join(out_dir, f"kill_g{gen}_r{rank}.json"), "w") as f:
                json.dump({"t": time.monotonic()}, f)
        real_kill(pid, sig)

    ptr.ShardedTrainer.train = train
    ptr.ShardedTrainer._check_stop = check_stop
    elastic._replace_image = replace_image
    os.kill = kill
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if opts[:1] == ["--wait"]:
        while not os.path.exists(opts[1]):
            time.sleep(0.005)
    rc = cli.main(cli_argv)
    dump("exit")
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def el_dumps(out_dir):
    """The ranks' records of leaving a generation (not the kill clocks)."""
    rows = []
    for name in sorted(os.listdir(out_dir)):
        if not name.startswith("g"):
            continue
        with open(os.path.join(out_dir, name)) as f:
            rows.append(json.load(f))
    return rows


def el_check_launches(tag, dumps, backend, layout):
    """Every rank of every generation that trained: launches exactly its
    steps of the route plus one capture's warm-up, one capture, no nvcc
    after generation 0. Returns {gen: [launches of rank 0..]}."""
    per_gen = {}
    for d in dumps:
        if not d["boundaries"]:
            continue  # a parked rejoiner's image: it trained nothing
        steps = d["boundaries"][-1][1] - d["start_step"]
        want = expected_launches(backend, layout, steps, warmups=1)
        if d["launches"] != want:
            fail(f"elastic {tag}: gen {d['gen']} rank {d['rank']} launches "
                 f"{d['launches']} != {want} ({steps} steps)")
        if d["captures"] != 1:
            fail(f"elastic {tag}: gen {d['gen']} rank {d['rank']} captures "
                 f"{d['captures']}")
        if d["gen"] >= 1 and d["nvcc_runs"]:
            fail(f"elastic {tag}: gen {d['gen']} ran nvcc {d['nvcc_runs']}")
        per_gen.setdefault(d["gen"], {})[d["rank"]] = {
            "steps": steps, "fused_grad_core": d["launches"].get("fused_grad_core")}
    return per_gen


def el_words_per_sec(dumps):
    """Each generation's fleet words/sec between its first and last
    boundary (the sum of its ranks' local rates)."""
    out = {}
    for d in dumps:
        b = d["boundaries"]
        if len(b) < 2:
            continue
        (t0, _, w0), (t1, _, w1) = b[0], b[-1]
        out.setdefault(d["gen"], 0.0)
        out[d["gen"]] += (w1 - w0) / max(t1 - t0, 1e-9)
    return out


#: each leg's generations g >= 1 and the launch ranks (shards) of their
#: members in new-rank order; its worlds and triggers by generation; the
#: counters its rank-0 metrics must show
EL_PLANS = {"a": [(1, [0, 1]), (2, [0, 1, 2])], "b": [(1, [1, 2])],
            "c": [(1, [0, 1]), (2, [0, 1, 2])]}
EL_WANT = {"a": ([3, 2, 3], ["launch", "failure", "rejoin"], ("remesh", "peer_rejoin")),
           "b": ([3, 2], ["launch", "failure"], ("rendezvous_election",)),
           "c": ([3, 2, 3], ["launch", "policy", "policy"],
                 ("remesh", "policy_remesh", "peer_rejoin"))}


def el_start_references(leg, name, prefix, env, ckpt_every=EL_CKPT):
    """One fresh fleet a generation g >= 1 of the leg (el_reference):
    resumed from its snapshot, to the end for the last generation, else
    stopped at the next snapshot's step."""
    gens = sorted({e["gen"] for e in leg.events("generation_start")})
    refs = []
    for g, members in EL_PLANS[name]:
        last = g == gens[-1]
        stop = None if last else el_snapshot_step(leg.ck, g + 1)
        kids, ck, vec = el_reference(
            leg.tmp, f"ref{leg.tag}{g}", prefix, leg.flags,
            [leg.shards[m] for m in members], f"{leg.ck}.elastic_g{g}",
            stop_at=stop, env=env, ckpt_every=ckpt_every)
        refs.append((g, last, kids, ck, vec))
    return refs


def el_check_references(leg, name, refs):
    """Each generation bitwise its fresh resume: the last one's final
    checkpoint and vectors, an earlier one's checkpoint at the step the
    next generation's snapshot holds."""
    same_by_gen = {}
    for g, last, kids, ck, vec in refs:
        rcs, _ = mp_finish(kids, f"elastic reference {name} gen {g}", timeout=300.0)
        for k in kids:
            el_kill_group(k)
        want = [0] * len(kids) if last else [75] * len(kids)
        if rcs != want:
            fail(f"elastic reference {name} gen {g}: exits {rcs} (want {want})")
        if last:
            same = (npz_bitwise(ck, leg.ck)
                    and open(vec, "rb").read() == open(leg.out, "rb").read())
        else:
            same = npz_bitwise(ck, f"{leg.ck}.elastic_g{g + 1}")
        if not same:
            fail(f"elastic {name}: generation {g} != a fresh fleet resumed from its "
                 "snapshot (bitwise)")
        same_by_gen[g] = same
    return same_by_gen


def el_check_manifest(leg, name):
    """The rank-0 manifest's generations (worlds, triggers), its
    elastic_generation and clean end, the remesh and election records,
    and the counters fired in the metrics log."""
    man = leg.manifest()
    starts = leg.events("generation_start")
    worlds = [e["world"] for e in starts]
    triggers = [e["trigger"] for e in starts]
    want_w, want_t, want_fired = EL_WANT[name]
    if worlds != want_w or triggers != want_t \
            or man.get("elastic_generation") != len(want_w) - 1 \
            or man.get("shutdown") != "clean":
        fail(f"elastic {name}: manifest generations {worlds} {triggers}, "
             f"elastic_generation {man.get('elastic_generation')}, "
             f"shutdown {man.get('shutdown')}")
    with open(os.path.join(leg.mdir, "metrics.jsonl")) as f:
        evs = [json.loads(x).get("event") for x in f]
    fired = {k: evs.count(k) for k in ("remesh", "peer_rejoin",
                                       "rendezvous_election", "policy_remesh")}
    if not all(fired[k] for k in want_fired):
        fail(f"elastic {name}: counters {fired}")
    if name == "b":
        el = leg.events("rendezvous_election")
        if not el or el[-1]["elected_rank"] != 1:
            fail(f"elastic b: election events {el}")
    if name == "c":
        rem = leg.events("remesh")
        if [e["kind"] for e in rem] != ["policy_shrink", "grow"] \
                or rem[0]["victim"] != 2:
            fail(f"elastic c: remesh events {rem}")
    return worlds, triggers, fired


def phase_elastic(dev, vocab, corpus, card, tmp):
    """The elastic drills on the one card (phase 16 of the module
    docstring); no process it started outlives it."""
    try:
        return el_phase(dev, vocab, corpus, card, tmp)
    finally:
        for k in EL_KIDS:
            el_kill_group(k)
            if k.poll() is None:
                k.kill()
                k.wait()


def el_phase(dev, vocab, corpus, card, tmp):
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # the children share the card
    t_phase = time.perf_counter()
    vocab.save(os.path.join(tmp, "vocab.txt"))
    words = np.asarray(vocab.words)
    shards = []
    for p in range(EL_PROCS):
        flat = corpus.flat[p * EL_ROWS * L:(p + 1) * EL_ROWS * L]
        path = os.path.join(tmp, f"el_shard{p}.txt")
        with open(path, "w") as fh:
            fh.write(" ".join(words[flat].tolist()))
        shards.append(path)
    flags = ["-read-vocab", os.path.join(tmp, "vocab.txt"), "-binary", "1",
             "-size", str(D), "-window", str(W), "-negative", str(K),
             "--batch-rows", str(B), "--max-sentence-len",
             str(L), "--shared-negatives", str(KP), "--band-backend", "pallas_fused",
             "--table-layout", "unified", "--chunk-steps", str(EL_EVERY),
             "--dp-sync-every", str(EL_EVERY), "-subsample", "0", "--quiet"]
    env = {"OMP_NUM_THREADS": "2"}
    row = {"card": card, "procs": EL_PROCS, "dp_sync_every": EL_EVERY,
           "steps": {"a": EL_ITERS * EL_ROWS // B, "b": EL_ITERS * EL_ROWS // B,
                     "c": EL_ITERS_C * EL_ROWS // B}}
    legs = {}
    for name, mode, iters, extra, drive in (
        ("a", "shrink+grow", EL_ITERS, {2: ["--faults", f"peer_rejoin@{EL_KILL}"]},
         el_leg_a),
        ("b", "shrink", EL_ITERS, {0: ["--faults", f"rank0_dead@{EL_KILL}"]}, el_leg_b),
        ("c", "shrink+grow", EL_ITERS_C,
         {p: ["--elastic-policy", EL_POLICY, "--signal-window", str(EL_CKPT)]
          + (["--faults", EL_STALLS] if p == 2 else []) for p in range(EL_PROCS)},
         el_leg_c),
    ):
        out = os.path.join(tmp, f"dumps_{name}")
        os.makedirs(out)
        prefix = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--el-child",
                  out, "--"]
        leg = ElasticLeg(tmp, name, prefix, flags + ["-iter", str(iters)], shards,
                         mode, extra, env, card=True)
        t0 = time.perf_counter()
        try:
            info = drive(leg)
            rcs = leg.finish(dead=(0,) if name == "b" else ())
        finally:
            leg.stop()
        live = [r for i, r in enumerate(rcs) if not (name == "b" and i == 0)]
        if any(r != 0 for r in live):
            fail(f"elastic {name}: exits {rcs} (75/76 or worse on the elastic path): "
                 f"{leg.tail(0)}{leg.tail(1)}")
        legs[name] = {"leg": leg, "info": info, "rcs": rcs, "out": out,
                      "seconds": time.perf_counter() - t0}
        log(f"  elastic leg {name}: exits {rcs} in {legs[name]['seconds']:.1f} s")

    # every generation's export against a fresh fleet of its shape resumed
    # from its snapshot and fed the same global steps, all at once
    pre = [sys.executable, "-m", "word2vec_tpu_torch.cli"]
    refs = {name: el_start_references(st["leg"], name, pre, env)
            for name, st in legs.items()}
    t_ref = time.perf_counter()
    for name, st in legs.items():
        st["bitwise"] = el_check_references(st["leg"], name, refs[name])
    ref_s = time.perf_counter() - t_ref

    row["legs"] = {}
    for name, st in legs.items():
        leg = st["leg"]
        worlds, triggers, fired = el_check_manifest(leg, name)
        dumps = el_dumps(st["out"])
        counts = el_check_launches(name, dumps, "pallas_fused", "unified")
        rec = [d["recorded_step"] for d in dumps if d["recorded_step"]]
        if not rec:
            fail(f"elastic {name}: no recorded step after a remesh")
        trans = el_transitions(leg, st["info"].get("t_kill"))
        for t in trans:
            if t["nvcc_runs"] or t["inherited_sockets"]:
                fail(f"elastic {name}: generation {t['gen']}: nvcc {t['nvcc_runs']}, "
                     f"inherited sockets {t['inherited_sockets']}")
        wps = el_words_per_sec(dumps)
        row["legs"][name] = {
            "exits": st["rcs"], "seconds": st["seconds"],
            "worlds": worlds, "triggers": triggers,
            "snapshots": {g: el_snapshot_step(leg.ck, g) for g in range(1, len(worlds))},
            "bitwise_fresh_resume": st["bitwise"],
            "launches": counts, "counters": fired,
            "recorded_step": rec[0],
            "transitions": trans,
            "words_per_sec": wps,
            "card_bytes_before_kill": st["info"].get("mem_before_kill"),
        }
        log(f"  elastic {name} ({card}): worlds {worlds}, triggers {triggers}; "
            f"every generation bitwise its fresh resume; launches exact; "
            f"words/sec by generation {wps}")
        for t in trans:
            log(f"    gen {t['gen']} blackout {t['blackout_s']:.3f} s: "
                + ", ".join(f"{k} {v:.3f}" for k, v in t["parts_s"].items()))
    row["references_s"] = ref_s
    row["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"elastic_phase": row}, default=str))


def manifest_of(mdir):
    with open(os.path.join(mdir, "manifest.json")) as f:
        return json.load(f)


def main() -> int:
    if sys.argv[1:2] == ["--el-child"]:
        # one rank of a phase-16 fleet: no CUDA call before its CLI runs
        # (a rejoiner announces before it touches the card)
        return el_child(sys.argv[2:])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import word2vec_tpu_torch  # noqa: F401 — fails outside the repository
    from word2vec_tpu_torch import _build

    if sys.argv[1:2] == ["--mp-child"]:
        return mp_child(sys.argv[2])  # one process of a phase-15 fleet

    check_no_jax()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1 device] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        _build.library(name)
    log(f"[2 build] {time.perf_counter() - t0:.1f} s")
    for name, rep in _build.PTXAS_REPORTS.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}: {line.strip()}")
    # the band cores' dynamic shared memory at the flagship chunk
    S, SK = 118, 118 + 2 * W
    for lib, fn in (("fused_step", "w2v_grad_core_smem_bytes"),
                    ("band_core", "w2v_band_core_smem_bytes")):
        get = getattr(_build.library(lib), fn)
        log(f"  {lib} dynamic shared memory (S={S}, KP={KP}, d={D}): bf16 compute "
            f"{get(S, SK, KP, D, W, 1)} B, f32 compute {get(S, SK, KP, D, W, 0)} B")

    log(f"[3 kernels vs plain, flagship shapes] (at {time.perf_counter() - t0:.1f} s)")
    errs = phase_kernels(dev)

    log(f"[4 slice] (at {time.perf_counter() - t0:.1f} s)")
    phase_small_step(dev)
    vocab, corpus = flagship_corpus()
    counts, reps = {}, {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
        prefix="smoke_", dir=os.path.join(HERE, "build")
    ) as out_dir:
        for route in ROUTES:
            counts[route], reps[route] = phase_trainer(
                dev, vocab, corpus, *route,
                out_dir=out_dir if route == ROUTES[0] else None,
            )
    phase_repeat(dev, vocab, corpus)

    log("[4b graphs: every dispatch path vs the eager per-step run] "
        f"(at {time.perf_counter() - t0:.1f} s)")
    phase_graphs(dev, vocab)

    log(f"[5 times] card: {card} (at {time.perf_counter() - t0:.1f} s)")
    kernels = phase_times(dev, errs, counts, corpus_batch(dev, corpus))
    for (backend, layout), rep in reps.items():
        log(f"  trainer words/sec {backend}/{layout}: {rep.words_per_sec:.1f} "
            f"({card})")
    t5 = time.perf_counter()
    phase_dispatch(vocab, corpus, card)
    log(f"  (dispatch A/B {time.perf_counter() - t5:.1f} s)")

    log(f"[6 cli] (at {time.perf_counter() - t0:.1f} s)")
    with tempfile.TemporaryDirectory(
        prefix="smoke_cli_", dir=os.path.join(HERE, "build")
    ) as tmp_cli:
        exported = phase_cli(vocab, corpus, card, tmp_cli)

        log(f"[7 hs and pair] (at {time.perf_counter() - t0:.1f} s)")
        with tempfile.TemporaryDirectory(
            prefix="smoke_hs_", dir=os.path.join(HERE, "build")
        ) as tmp:
            phase_hs(dev, vocab, corpus, card, tmp)

        log(f"[8 serve] (at {time.perf_counter() - t0:.1f} s)")
        phase_serve(exported, card, tmp_cli)

        log(f"[9 telemetry] (at {time.perf_counter() - t0:.1f} s)")
        phase_telemetry(vocab, corpus, card, tmp_cli)

        log(f"[10 resilience and device telemetry] (at {time.perf_counter() - t0:.1f} s)")
        phase_resilience(vocab, corpus, card, tmp_cli)

        log(f"[11 stream] (at {time.perf_counter() - t0:.1f} s)")
        phase_stream(vocab, corpus, card, tmp_cli)

        log(f"[12 planner] (at {time.perf_counter() - t0:.1f} s)")
        phase_planner(vocab, corpus, card, tmp_cli)

        log(f"[13 parallel] (at {time.perf_counter() - t0:.1f} s)")
        phase_parallel(dev, vocab, corpus, card, tmp_cli)

        log(f"[14 tensor and sequence parallel] (at {time.perf_counter() - t0:.1f} s)")
        phase_tp_sp(dev, vocab, corpus, card, tmp_cli)

        log(f"[15 several processes] (at {time.perf_counter() - t0:.1f} s)")
        with tempfile.TemporaryDirectory(
            prefix="smoke_mp_", dir=os.path.join(HERE, "build")
        ) as tmp_mp:
            phase_multiproc(dev, vocab, corpus, card, tmp_mp)

        log(f"[16 elastic] (at {time.perf_counter() - t0:.1f} s)")
        with tempfile.TemporaryDirectory(
            prefix="smoke_el_", dir=os.path.join(HERE, "build")
        ) as tmp_el:
            phase_elastic(dev, vocab, corpus, card, tmp_el)
    check_no_jax()
    log(f"  (the whole smoke {time.perf_counter() - t0:.1f} s)")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
