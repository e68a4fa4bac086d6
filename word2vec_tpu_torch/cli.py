"""word2vec.c-compatible command line for the PyTorch / CUDA port.

The train -> checkpoint -> export -> eval subset of word2vec_tpu/cli.py,
with the same flag names, defaults, validation messages and exit codes:

    python -m word2vec_tpu_torch.cli -train text8 -output vec.bin -size 300 \\
        -window 5 -negative 5 -model sg -train_method ns -iter 3 -binary 1

Training runs on the GPU (--backend gpu, the default, raises when there is
no CUDA device; it never carries on on the CPU); --backend cpu runs the
kernels' plain PyTorch versions, for tests. The corpus is counted and
encoded by the native host layer (native/, built with g++ at first use;
the pure-Python layer otherwise, and the vocab line says which ran), every
optimizer step is a CUDA graph replay through the route's hand-written
kernels (train.py), checkpoints are the JAX package's format
(io/checkpoint.py, loadable by either package), and --eval-ws353 /
--eval-analogy score the exported vectors through a query engine resident
on the card (serve/query.py, eval/).

Reference divergences (deliberate, as in the JAX CLI):
  - `-train <file>` is honored (the reference hardcodes ./text8).
  - `-binary` works (the reference's parse line is commented out).
  - `-alpha` is honored for skip-gram; the 0.05 cbow-mean default applies
    only when model=cbow and -alpha was not given (word2vec.c behavior).
  - `-threads` is accepted for compatibility and ignored.

The telemetry flags are the JAX CLI's: --metrics-dir writes
manifest.json (the realized config, the card, the library versions, the
git sha; `shutdown` added on every exit), metrics.jsonl and metrics.prom
there, turns on the full health counters (unless --health-metrics 0),
the quality probe (every 100 steps unless --quality-probe-every says
otherwise) and the derived-signal plane (signals_p0.jsonl, fleet.json);
--trace DIR exports the run's span timeline (trace_p0.json, trace.json);
a divergence (exit 2), a QualityAlert (exit 3) and a preemption (exit 75)
each dump flight.json into --metrics-dir. --slo rules and --signal-window
shape the signal plane, --prom-textfile and --tensorboard add sinks,
--emit-device prints `device: <platform> <kind>` to stderr, and
--debug-nans runs eagerly, one step a dispatch, raising FloatingPointError
at the first non-finite loss or table cell (there is no torch counterpart
of jax_debug_nans).

The resilience and device-telemetry flags are the JAX CLI's too:
--auto-recover N rolls a divergence back to the last good checkpoint
(scaling alpha by --recover-alpha-scale, advancing the seed) up to N
times before exit 2; --faults injects the chaos plan (the hidden
--inject-nan is nan@0); --step-deadline arms the watchdog, which writes
stall.json, stall_stacks.txt and flight.json and exits 76 when no step
boundary lands in time; the memory ledger (--mem-sample-every, w2v_mem_*
gauges, the manifest's device_memory) and the program harvest are on with
the signal plane; --profile-steps A:B and --profile-on-breach N write
bounded torch.profiler windows (capture_<n>.json + profile_<n>/) into
--metrics-dir, where SIGUSR2 asks for one more window and writes
mem_usr2.json (SIGUSR1: flight_usr1.json + stacks_usr1.txt); --profile DIR
traces the whole run.

Continuous training is the JAX CLI's too: --corpus-mode streaming reads
-train (a file, a comma list, a directory, a glob, or `-` for stdin,
spooled to --stream-spool) in --segment-tokens segments, one Trainer.train
call a segment (stream/driver.StreamRun), admits new words into
--vocab-reserve rows at segment boundaries (the step is captured again
after a growth), and writes the stream cursor (stream.json) into every
checkpoint, so --resume re-enters the segment it stopped in, bitwise.

The planner's flags are the JAX CLI's too: --autotune probe searches the
step-shape grid around the configured plan (pruned by the cost model with
the card's own anchors, then timed probes of the hand-written kernel
routes on CUDA graphs), stores the winner in --plan-cache (default
$W2V_PLAN_CACHE or ~/.cache/word2vec_tpu_torch/plan_cache.json) and
trains with it; --autotune cached starts from the stored plan with zero
probes (probing on a miss). The plan-applied config goes into the
checkpoints and the manifest, and with the telemetry on the run-end
manifest carries cost_calibrate's per-anchor verdict.

The mesh is the JAX CLI's: --dp N replicas, --sp S sequence shards of
each row and --tp T tensor-parallel shards of each table
(parallel/ShardedTrainer; dp*sp*tp > 1 routes there), one a visible card
(--backend cpu: all on the CPU), refusing more than there are cards with
the mesh's message and, under --tp or --sp > 1, the Pallas routes with the
JAX trainer's reason (exit 1); --dp-sync-every and --sync-mode set the
replica sync. A replica whose shards sit on different cards runs its steps
eagerly (no CUDA graph spans two cards; the manifest's split_shards).
Meshes over several cards are not verified on two cards yet: the
cross-device code has run only on a mesh of one card and the CPU.
Checkpoints hold the synced, unreplicated [V, d] tables, so a mesh run and
a single-device run (of either package) resume from each other's.

--multihost runs one process of a fleet on torch.distributed
(parallel/multihost.py): every process is started with the W2V_COORDINATOR,
W2V_NUM_PROCS and W2V_PROC_ID environment, its own -train shard and the
same -read-vocab; the --dp replicas are spread over the processes (the data
axis is the only one that spans them), and only process 0 writes the
vocabulary, the vectors, the checkpoints and the metrics directory.
--sync-deadline SECS bounds every cross-process collective: a dead peer
becomes a SyncTimeout, and the survivors checkpoint where safe and exit 75
(one process: exit 1, there is no peer).

--elastic shrink|shrink+grow makes such a fleet heal itself instead
(resilience/elastic.py; needs --sync-deadline, --checkpoint-dir and
--checkpoint-every): on a SyncTimeout the survivors agree on membership at
the elastic rendezvous (W2V_ELASTIC_COORD, hosted by rank 0; the lowest
surviving rank is elected when rank 0 is the one lost), snapshot the
newest verified checkpoint to <dir>.elastic_g<g> and exec in place into
generation g at N-1 processes (--dp rescaled, --resume the snapshot, the
generation's store on port0 + g hosted by the store shepherd,
parallel/coordservice.py); shrink+grow also admits a restarted host (it
announces before it joins the group or touches the card) at the next sync
boundary. --elastic-policy evicts a straggler and re-admits it on signal
rules (resilience/policy.py), --rejoin-window bounds a parked rejoiner's
re-announces, and --compile-cache DIR lets an exec'd generation load its
kernel libraries from DIR/<topology key> (tune/compile_cache.py). The
manifest's elastic_generation and mesh_events follow the fleet across the
execs. --prng is accepted and persisted (config.prng_impl, as in the JAX
CLI), but the port's draws are its own whatever the name (ROADMAP C5).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import os
import sys
import time
from typing import List, Optional

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="word2vec_tpu_torch",
        description="word2vec on the GPU, PyTorch/CUDA port "
                    "(reference-compatible flags)",
        allow_abbrev=False,
    )
    # reference flags (main.cpp:123-151); single-dash long names as upstream
    p.add_argument("-train", dest="train", metavar="FILE", help="training corpus")
    p.add_argument("-output", dest="output", metavar="FILE",
                   default="text8-sgns.txt", help="output vectors (main.cpp:106)")
    p.add_argument("-size", dest="size", type=int, default=200,
                   help="embedding dim (default 200, main.cpp:112)")
    p.add_argument("-window", dest="window", type=int, default=5)
    p.add_argument("-subsample", dest="subsample", type=float, default=1e-4)
    p.add_argument("-train_method", dest="train_method", default="ns",
                   choices=["ns", "hs"])
    p.add_argument("-negative", dest="negative", type=int, default=0,
                   help="negative samples (reference default 0, main.cpp:118)")
    p.add_argument("-threads", dest="threads", type=int, default=1,
                   help="accepted for compatibility; ignored")
    p.add_argument("-iter", dest="iter", type=int, default=1)
    p.add_argument("-min-count", dest="min_count", type=int, default=5)
    p.add_argument("--max-vocab", type=int, default=0,
                   help="cap the vocabulary to the top-N words by count "
                        "(0 = unlimited); the working version of the "
                        "reference's declared-but-undefined reduce_vocab "
                        "(Word2Vec.h:69)")
    p.add_argument("-alpha", dest="alpha", type=float, default=None)
    p.add_argument("-model", dest="model", default="sg", choices=["sg", "cbow"])
    p.add_argument("-save-vocab", dest="save_vocab", metavar="FILE")
    p.add_argument("-read-vocab", dest="read_vocab", metavar="FILE")
    p.add_argument("-binary", dest="binary", type=int, default=0)
    p.add_argument("-cbow-mean", dest="cbow_mean", type=int, default=1,
                   help="cbow projection: 1=mean (reference default), 0=sum")
    # single-device levers
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="gpu (default): the CUDA device, raising when there "
                        "is none; cpu: the kernels' plain PyTorch versions")
    p.add_argument("--prng", choices=["threefry", "rbg"], default="threefry",
                   help="the JAX package's PRNG impl name for the draw "
                        "streams, persisted in checkpoints "
                        "(config.prng_impl): a resumed run keeps the "
                        "checkpoint's impl and warns if this flag differs. "
                        "The port draws from torch's generator whatever the "
                        "name (ROADMAP C5)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh axis: replicas, one a visible "
                        "card (--backend cpu: on the CPU). Replicas on "
                        "several cards are not verified on two cards yet "
                        "(only a card and the CPU)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh axis")
    p.add_argument("--sp", type=int, default=1,
                   help="sequence-parallel mesh axis (halo-exchange context "
                        "parallelism for long rows; band-route kernels — "
                        "ns band or positional hs)")
    p.add_argument("--dp-sync-every", type=int, default=64)
    p.add_argument("--sync-mode", choices=["mean", "delta"], default="mean",
                   help="replica reconciliation: mean = full-table mean; "
                        "delta = the mean of the bf16-rounded updates since "
                        "the last sync (parallel/trainer.py)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process mode: torch.distributed from the "
                        "W2V_COORDINATOR/W2V_NUM_PROCS/W2V_PROC_ID env "
                        "contract, mesh over the processes with the data "
                        "axis spanning them (parallel/multihost.py); pass "
                        "each process its own corpus shard via -train")
    p.add_argument("--micro-steps", type=int, default=0,
                   help="sequential optimizer sub-steps per dispatched batch "
                        "(0 = auto with --batch-rows 0, else 1)")
    p.add_argument("--chunk-steps", type=int, default=0,
                   help="optimizer steps per dispatch (0 = auto, 1 = "
                        "per-step); identical trajectory either way")
    p.add_argument("--batch-rows", type=int, default=0,
                   help="sentence rows per device step; 0 = auto-size so an "
                        "epoch has enough optimizer steps to learn")
    p.add_argument("--clip-row-update", type=float, default=1.0,
                   help="per-row trust region: max L2 norm of one row's "
                        "summed update per optimizer step (0 = off)")
    p.add_argument("--scatter-mean", type=int, default=0, choices=[0, 1],
                   help="normalize duplicate-row updates by count (hot-row "
                        "stabilizer; 0 = reference-faithful sum)")
    p.add_argument("--kernel", choices=["auto", "band", "pair"], default="auto",
                   help="device kernel: band (the objective's fast path: "
                        "banded ns or positional hs), pair (per-pair "
                        "enumeration, reference-faithful), auto (band; pair "
                        "in the band kernel's degeneracy domain)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="dot-product dtype; float32 for reference-exact scores")
    p.add_argument("--table-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype of the [V, d] embedding tables")
    p.add_argument("--stochastic-rounding", type=int, default=0, choices=[0, 1],
                   help="unbiased stochastic rounding of table updates "
                        "(bfloat16 tables)")
    p.add_argument("--table-layout", choices=["split", "unified"],
                   default="split",
                   help="split = two [V, d] tables; unified = one [V, 2, d] "
                        "slab")
    p.add_argument("--shared-negatives", type=int, default=64,
                   help="shared negative draws per batch row (band kernel)")
    p.add_argument("--negative-scope", choices=["row", "batch"], default="row",
                   help="share the negative pool per row, or one pool for "
                        "the whole batch")
    p.add_argument("--band-backend",
                   choices=["xla", "pallas", "pallas_oa", "pallas_fused"],
                   default="xla",
                   help="band step route: xla (torch ops + the scatter "
                        "kernels), pallas (the band core kernel), pallas_oa "
                        "(the overlap-add kernel), pallas_fused (the fused "
                        "step; --table-layout unified)")
    p.add_argument("--slab-scatter", type=int, default=0, choices=[0, 1],
                   help="band kernel: scatter context grads from slab space")
    p.add_argument("--hs-dense-top", type=int, default=0, metavar="P",
                   help="two-tier hs update: handle the top-P Huffman nodes "
                        "(a contiguous slice + per-path prefix) with dense "
                        "matmuls, gather/scatter only the short path tails "
                        "(config.hs_dense_top; 0 = single-tier)")
    p.add_argument("--hs-tail-slots", type=int, default=-1, metavar="T",
                   help="two-tier hs tail-scatter compaction bound per batch "
                        "row: -1 auto (+6 sigma), 0 off, >0 explicit "
                        "(config.hs_tail_slots)")
    p.add_argument("--autotune", choices=["off", "probe", "cached"],
                   default="off",
                   help="autotuned execution planner (tune/): probe = search "
                        "the step-shape space (cost-model-pruned grid, short "
                        "timed probes) and persist the winner; cached = "
                        "start from the persisted plan for this (device, "
                        "kernel, vocab, dim) with zero probe cost (falls "
                        "back to probe on a miss)")
    p.add_argument("--plan-cache", dest="plan_cache", metavar="FILE",
                   default="",
                   help="plan-cache JSON path (default: $W2V_PLAN_CACHE or "
                        "~/.cache/word2vec_tpu_torch/plan_cache.json; the "
                        "packaged seed plans back every lookup)")
    p.add_argument("--resident", choices=["auto", "on", "off"], default="auto",
                   help="device-resident corpus (chunked dispatch)")
    p.add_argument("--corpus-mode", choices=["resident", "streaming"],
                   default="resident",
                   help="how the corpus reaches the device (stream/): "
                        "resident = read+pack the whole corpus up front; "
                        "streaming = consume it in bounded segments from a "
                        "file set / comma list / directory / glob (-train "
                        "accepts all of those) or a pipe (-train -), with "
                        "the next segment read while the card trains, "
                        "mid-stream cursor checkpoints (bitwise SIGTERM "
                        "resume), and online vocab growth into "
                        "--vocab-reserve rows. A streaming checkpoint "
                        "resumes streaming automatically")
    p.add_argument("--segment-tokens", type=int, default=0, metavar="N",
                   help="streaming segment size in raw corpus tokens "
                        "(config.segment_tokens; 0 = auto, 4M). The "
                        "segment is the growth/swap/resume boundary unit "
                        "and the per-'epoch' alpha-schedule horizon")
    p.add_argument("--vocab-reserve", type=int, default=0, metavar="N",
                   help="reserve N embedding rows for online vocabulary "
                        "growth (streaming only): new words seen in a "
                        "consumed segment are admitted into reserved rows "
                        "at the next segment boundary, deterministically, "
                        "leaving existing rows bitwise untouched; a grown "
                        "vocab resumes through the compatible-superset "
                        "content-hash guard (0 = fixed vocabulary)")
    p.add_argument("--stream-spool", metavar="DIR", default="",
                   help="pipe-ingest spool directory (-train - only): "
                        "segments read from the pipe are spooled here so "
                        "a mid-stream resume can replay them (default: "
                        "<--checkpoint-dir>/stream_spool, else a temp dir "
                        "— resumable only while it survives)")
    p.add_argument("--max-sentence-len", type=int, default=192)
    p.add_argument("--corpus-format", choices=["text8", "lines"], default="text8",
                   help="text8: whitespace stream (main.cpp:63-92); "
                        "lines: one sentence per line (Word2Vec.cpp:19-30)")
    p.add_argument("--binary-layout", choices=["reference", "google"],
                   default="reference")
    p.add_argument("--export-int8", metavar="FILE",
                   help="also export the table as the int8 "
                        "symmetric-quantized container (per-row scale "
                        "header, io/embeddings.save_embeddings_int8)")
    p.add_argument("--export-side", choices=["auto", "input", "output"],
                   default="auto",
                   help="which table -output saves: auto = the reference's "
                   "choice (main.cpp:196-202); input = the gather-side "
                   "table; output = the ns prediction table")
    p.add_argument("--checkpoint-dir", metavar="DIR")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="STEPS")
    p.add_argument("--checkpoint-keep", type=int, default=1, metavar="N",
                   help="previous checkpoints retained as rollback targets "
                        "(<dir>.old ... .old{N}); --auto-recover depends on "
                        "N >= 1 (io/checkpoint.py retention)")
    p.add_argument("--resume", metavar="DIR", help="resume from checkpoint "
                   "dir (integrity-checked; a corrupt checkpoint is "
                   "quarantined as .corrupt and the .old backup loads "
                   "instead); a checkpoint of either package loads")
    p.add_argument("--allow-vocab-mismatch", action="store_true",
                   help="skip the --resume vocabulary-compatibility guard")
    p.add_argument("--auto-recover", type=int, default=0, metavar="N",
                   help="supervised divergence recovery: on DivergenceError "
                        "roll back to the last-good checkpoint (integrity + "
                        "finite-params validated, .old fallback) into the "
                        "trainer's captured buffers, rescale alpha "
                        "(--recover-alpha-scale), advance the shuffle seed, "
                        "and retry up to N times before exiting rc=2 "
                        "(resilience/supervisor.py; needs --checkpoint-dir "
                        "+ --checkpoint-every for rollback targets)")
    p.add_argument("--recover-alpha-scale", type=float, default=0.5,
                   metavar="S",
                   help="multiply init_alpha by S on every auto-recovery "
                        "(1.0 = keep the schedule)")
    p.add_argument("--faults", metavar="SPEC", default="",
                   help="fault-injection plan for chaos testing "
                        "(resilience/faults.py): comma-separated "
                        "kind[@step][:key=val], e.g. 'nan@40,sigterm@80', "
                        "'hang@10:secs=300', or "
                        "'ckpt_oserror:times=2,stall@10:secs=0.5'; or a "
                        ".json plan file")
    p.add_argument("--step-deadline", type=float, default=0.0, metavar="SECS",
                   help="step-deadline watchdog (resilience/watchdog.py; "
                        "0 = off): if no step/chunk boundary lands within "
                        "max(SECS, 4x rolling-p90 boundary time) — the graph "
                        "capture covered by a grace window — dump all "
                        "thread stacks + the wedged phase to --metrics-dir, "
                        "mark the manifest 'shutdown: stalled', and exit "
                        "76 (EXIT_STALLED) so schedulers requeue with "
                        "--resume. Set SECS above your worst checkpoint "
                        "write")
    p.add_argument("--sync-deadline", type=float, default=0.0, metavar="SECS",
                   help="deadline on cross-process collectives (multihost "
                        "agree/heartbeat + replica sync + the sharded "
                        "metrics drain; 0 = off/unbounded): a dead peer "
                        "turns the infinite collective hang into a "
                        "coordinated abort — survivors checkpoint where "
                        "safe and exit 75 (EXIT_PREEMPTED) for requeue "
                        "with --resume — or, with --elastic, into a "
                        "shrink-remesh that keeps training")
    p.add_argument("--elastic", choices=["off", "shrink", "shrink+grow"],
                   default="off",
                   help="elastic multi-host training "
                        "(resilience/elastic.py): off = a dead peer aborts "
                        "the fleet to requeue (exit 75/76); shrink = on "
                        "SyncTimeout the survivors agree on membership "
                        "through the elastic rendezvous (W2V_ELASTIC_COORD; "
                        "hosted by rank 0), re-form the fleet at N-1 in "
                        "place, re-shard from the last integrity-verified "
                        "checkpoint, and keep training — no scheduler "
                        "round-trip; shrink+grow additionally admits a "
                        "restarted host back at the next sync boundary. "
                        "Requires --sync-deadline and --checkpoint-dir/"
                        "--checkpoint-every (validated); single-process "
                        "runs ignore it with a warning")
    p.add_argument("--elastic-policy", metavar="RULES", default="",
                   help="signal-driven autoscale policy "
                        "(resilience/policy.py; needs --elastic): "
                        "comma-separated "
                        "'<signal><op><thr>[:for=N][:act=shrink|grow]' "
                        "clauses over the derived signals (same clause "
                        "core as --slo), e.g. "
                        "'throughput_wps<0.6*baseline:for=2:act=shrink,"
                        "throughput_wps>0.8*baseline:for=2:act=grow,"
                        "cooldown=3'. A sustained shrink breach evicts "
                        "the attributed straggler at the next sync "
                        "boundary (trigger=policy, zero failures); a "
                        "sustained grow breach opens the admission gate "
                        "for parked rejoiners. Global options: cooldown=N "
                        "windows per fresh generation, min_world=/"
                        "max_world= bounds. Implies the signal plane on")
    p.add_argument("--rejoin-window", type=int, default=0, metavar="N",
                   help="rejoin re-announce bound (resilience/elastic.py; "
                        "0 = the default 6): how many times a parked "
                        "rejoiner re-announces after the rendezvous drops "
                        "its connection (one generation turnover each) "
                        "before giving up — the exhaustion error prints "
                        "the total bounded wait N implies")
    p.add_argument("--compile-cache", metavar="DIR", default="",
                   help="warm-restart kernel cache root "
                        "(tune/compile_cache.py): exec'd elastic "
                        "generations (W2V_ELASTIC_GEN > 0) load the kernel "
                        "libraries from DIR/<topology-plan-key>, seeded "
                        "from the default build directory, so a generation "
                        "switch runs no nvcc. FENCED to next-generation "
                        "processes only: the launch process (gen 0) and "
                        "every non-elastic run use the default build "
                        "directory, and an operator-set "
                        "W2V_KERNEL_BUILD_DIR is never overridden")
    p.add_argument("--divergence-budget", type=int, default=8,
                   help="consecutive non-finite-loss steps before the run "
                        "aborts with a DivergenceError (exit 2) instead of "
                        "training on NaN parameters (0 = count only)")
    p.add_argument("--inject-nan", action="store_true", help=argparse.SUPPRESS)
    # ^ the JAX CLI's legacy alias for `--faults nan@0` (poison the initial
    #   params)
    p.add_argument("--eval-ws353", metavar="FILE",
                   help="WordSim-353 csv/tsv for post-train eval")
    p.add_argument("--eval-analogy", metavar="FILE",
                   help="google questions-words.txt for post-train eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--log-jsonl", metavar="FILE",
                   help="append machine-readable JSONL log records to FILE")
    # telemetry (word2vec_tpu/cli.py's flags, same names and defaults)
    p.add_argument("--metrics-dir", metavar="DIR",
                   help="telemetry directory (obs/): writes manifest.json "
                        "(realized config, device, versions, git sha), "
                        "metrics.jsonl and metrics.prom there, and enables "
                        "the full health counters unless --health-metrics 0")
    p.add_argument("--trace", metavar="DIR",
                   help="export this run's step-scoped span timeline as "
                        "Chrome-trace/Perfetto JSON into DIR (trace_p0.json "
                        "and the merged trace.json); diff two runs with "
                        "python -m word2vec_tpu_torch.obs.tracediff. The "
                        "flight recorder itself is always on")
    p.add_argument("--prom-textfile", metavar="FILE",
                   help="maintain a Prometheus-format textfile of the "
                        "latest metrics at FILE (obs/export.py)")
    p.add_argument("--health-metrics", type=int, choices=[0, 1], default=None,
                   help="full health counters (grad norm, per-table update "
                        "magnitudes, non-finite cells) in the step metrics, "
                        "computed inside the captured step "
                        "(config.health_metrics; default: on with "
                        "--metrics-dir — they cost a copy and two reads of "
                        "each table per step)")
    p.add_argument("--quality-probe-every", type=int, default=None,
                   metavar="STEPS",
                   help="in-training embedding-quality probe cadence "
                        "(obs/quality.py). Default: 100 when --metrics-dir "
                        "or a --probe-* file is set, else off; 0 disables. "
                        "Non-probe steps add no device sync")
    p.add_argument("--probe-pairs", metavar="FILE",
                   help="held-out word-pair golds for the quality probe "
                        "(WS-353-shaped word1,word2,score lines)")
    p.add_argument("--probe-analogies", metavar="FILE",
                   help="held-out analogy questions for the quality probe "
                        "(questions-words.txt format)")
    p.add_argument("--quality-budget", type=int, default=0, metavar="N",
                   help="degeneracy-sentinel budget: N consecutive degraded "
                        "probes -> checkpoint-and-continue, 2N -> abort "
                        "rc=3 with a QualityAlert in flight.json. 0 = warn "
                        "only")
    p.add_argument("--quality-floor", type=float, default=0.1, metavar="F",
                   help="sentinel absolute floor on the watched planted "
                        "score (analogy accuracy, else Spearman)")
    p.add_argument("--quality-drop", type=float, default=0.5, metavar="F",
                   help="sentinel relative-drop fraction: a probe below "
                        "(1-F) x the score's own peak counts as degraded")
    p.add_argument("--quality-grace", type=int, default=2, metavar="N",
                   help="scored probes ignored by the sentinel's absolute "
                        "floor before it arms")
    p.add_argument("--slo", metavar="RULES", default="",
                   help="declarative SLO rules over the derived signals "
                        "(obs/slo.py): comma-separated "
                        "'<signal><op><threshold>[:for=N][:baseline=N]' "
                        "clauses or a .json rule list. A breach is a log + "
                        "event, never an exit. Implies the signal plane on")
    p.add_argument("--signal-window", type=int, default=0, metavar="STEPS",
                   help="optimizer steps per derived-signal window "
                        "(obs/signals.py; 0 = auto: 50). On with "
                        "--metrics-dir, --prom-textfile or --slo")
    p.add_argument("--tensorboard", metavar="DIR",
                   help="write TensorBoard scalar summaries to DIR "
                        "(degrades to a warning without tensorboardX)")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler trace of training into "
                        "DIR (Chrome-trace JSON). This traces the WHOLE "
                        "run; for bounded windows use --profile-steps / "
                        "--profile-on-breach")
    p.add_argument("--profile-steps", metavar="A:B", default="",
                   help="bounded profiler window (obs/profiler.py): start "
                        "torch.profiler at step A, stop at step B, and "
                        "write a schema-checked capture manifest "
                        "(capture_<n>.json) next to flight.json in "
                        "--metrics-dir (required)")
    p.add_argument("--profile-on-breach", type=int, default=0, metavar="N",
                   help="breach-triggered profiler capture "
                        "(obs/profiler.py): when an --slo rule enters "
                        "breach, profile N step boundaries — one bounded "
                        "capture per breach episode, cooldown-gated — and "
                        "dump a capture manifest next to flight.json. "
                        "Needs --metrics-dir and --slo; SIGUSR2 requests "
                        "the same bounded window on demand (plus a "
                        "memory-ledger dump) without stopping the run")
    p.add_argument("--mem-sample-every", type=int, default=0, metavar="N",
                   help="memory-ledger cadence (obs/devmem.py; 0 = auto: "
                        "50): read the CUDA caching allocator's counters "
                        "every N step boundaries into w2v_mem_* gauges, "
                        "the mem_headroom_frac derived signal (SLO-able), "
                        "flight.json, and the manifest's per-phase "
                        "watermarks + growth-headroom forecast. Boundaries "
                        "that are not sampled add no launch and no sync; "
                        "the CPU degrades to present-from-zero gauges")
    p.add_argument("--debug-nans", action="store_true",
                   help="eager, ungraphed, one step a dispatch: raise "
                        "FloatingPointError at the first non-finite loss "
                        "or table cell (the counterpart of jax_debug_nans)")
    p.add_argument("--emit-device", action="store_true",
                   help="print one machine-readable 'device: <platform> "
                        "<kind>' line to stderr after training, even under "
                        "--quiet (proof of where the run executed)")
    p.add_argument("--quiet", action="store_true")
    return p


def _flag_diffs(parser, args, argv, flag_kwargs, ck_cfg) -> List[str]:
    """Config fields the user typed a flag for that the checkpoint's config
    overrides (the JAX CLI's resume notice, word2vec_tpu/cli.py:866-942)."""
    from .config import Word2VecConfig

    try:
        flag_cfg = Word2VecConfig(**flag_kwargs)
    except ValueError:
        return []
    opts_by_dest = {a.dest: a.option_strings for a in parser._actions}
    dest_overrides = {
        "iters": "iter", "word_dim": "size",
        "subsample_threshold": "subsample", "init_alpha": "alpha",
        "dtype": "table_dtype",
    }

    def user_set(field: str) -> bool:
        opts = opts_by_dest.get(dest_overrides.get(field, field))
        if opts is None:
            return field in flag_kwargs
        return any(
            t == o or t.startswith(o + "=") for t in argv for o in opts
        )

    def flag_value(field: str):
        if field == "micro_steps" and not args.batch_rows:
            return max(1, args.micro_steps)
        return getattr(flag_cfg, field)

    return sorted(
        f.name
        for f in dataclasses.fields(flag_cfg)
        # prng_impl warned separately; elastic and its policy are runtime
        # wiring the flag overrides on resume (never ignored)
        if f.name not in ("prng_impl", "elastic", "elastic_policy")
        and user_set(f.name)
        and flag_value(f.name) != getattr(ck_cfg, f.name)
    )


def _elastic_mesh_events(manifest_path: str, events, gen: int,
                         marks: dict) -> list:
    """An elastic generation's mesh_events: the prior generations' rows
    (they survive the exec in the manifest this one rewrites), the
    election the generation we exec'd from ran, and this generation's
    start with where it came from (the deciding rendezvous, the trigger)
    and the clock marks of its start-up: the parts of the blackout this
    process saw, from the old image's handoff (W2V_ELASTIC_HANDOFF: the
    failure's clock, the round and the snapshot) to the trainer being
    ready."""
    import json

    from .parallel import multihost

    prior = []
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path) as f:
                prior = json.load(f).get("mesh_events") or []
        except (OSError, ValueError):
            prior = []
    start = dict((events or [{}])[0])
    start.update({
        "event": "generation_start", "gen": gen,
        "rendezvous": os.environ.get(multihost.ENV_ELASTIC_COORD),
        "trigger": (
            os.environ.get(multihost.ENV_ELASTIC_TRIGGER)
            or ("launch" if gen == 0 else None)
        ),
    })
    exec_t = os.environ.get("W2V_ELASTIC_EXEC_T")
    start["startup_wall_s"] = (
        round(time.monotonic() - float(exec_t), 3)
        if exec_t and gen > 0 else None
    )
    if gen > 0:
        try:
            handoff = json.loads(os.environ.get("W2V_ELASTIC_HANDOFF") or "{}")
        except ValueError:
            handoff = {}
        start["startup"] = {
            **{k: v for k, v in marks.items()},
            "exec_t": float(exec_t) if exec_t else None,
            **multihost.init_stats(),
            "handoff": handoff,
        }
    election = None
    elected_env = os.environ.get("W2V_ELASTIC_ELECTED")
    if elected_env:
        er, _, ea = elected_env.partition(":")
        try:
            election = {"elected_rank": int(er), "rendezvous": ea}
        except ValueError:
            election = None
    return list(prior) + ([{
        "event": "rendezvous_election", "gen": gen, **election,
    }] if election else []) + [start]


def _first_boundary_hook(trainer, stop_check, manifest_path: str, gen: int,
                         marks: dict, device):
    """stop_check, recording once, at the first dispatch boundary of an
    exec'd generation, the clock, the step, the capture's seconds, the
    kernel builds this process ran (none is the contract: the libraries
    are cached) and the card memory this process holds."""
    seen = []

    def check(step: int):
        if not seen:
            seen.append(step)
            from . import _build
            from .obs.manifest import append_manifest_event

            rec = {
                "event": "generation_first_boundary", "gen": gen,
                "t": time.monotonic(), "step": step,
                "train_start_t": marks.get("train"),
                "capture_s": round(float(trainer.capture_s), 6),
                "nvcc_runs": list(_build.NVCC_RUNS),
            }
            if device.type == "cuda":
                import torch

                rec["memory_allocated"] = torch.cuda.memory_allocated(device)
                rec["memory_reserved"] = torch.cuda.memory_reserved(device)
            append_manifest_event(manifest_path, "mesh_events", rec)
        return stop_check(step)

    return check


def main(argv: Optional[List[str]] = None) -> int:
    #: the generation start-up's clock marks (the elastic blackout's parts)
    marks = {"main": time.monotonic()}
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    if not argv:
        parser.print_help()  # reference: help on no args (main.cpp:99-103)
        return 0
    args = parser.parse_args(argv)

    from . import native
    from .config import Word2VecConfig
    from .data.batcher import PackedCorpus
    from .data.corpus import load_corpus
    from .data.vocab import Vocab
    from .device import resolve_device
    from .io.checkpoint import (
        WRITER, CheckpointError, checkpoint_writer, load_checkpoint_with_path,
        read_stream_cursor, save_checkpoint,
    )
    from .io.embeddings import save_word2vec
    from .models.params import export_matrix
    from .obs.export import MetricsHub, prometheus_textfile
    from .obs.fleet import FleetAggregator
    from .obs.health import DivergenceError
    from .obs.manifest import device_info, update_manifest, write_manifest
    from .obs.quality import (
        EXIT_QUALITY, ProbeSet, QualityAlert, QualityProbe, QualitySentinel,
    )
    from .obs.signals import SignalEngine
    from .obs.slo import SloEvaluator
    from .resilience.shutdown import (
        EXIT_PREEMPTED, ShutdownHandler, install_usr1_dump, install_usr2_profile,
    )
    from .train import Trainer
    from .utils.logging import jsonl_logger, progress_logger, tensorboard_logger
    from .utils.profiling import trace

    marks["imports"] = time.monotonic()
    # The fault plan and the resilience knobs are validated before any
    # expensive work (a chaos run with a typo'd spec must fail in
    # milliseconds, not after the corpus scan), in the JAX CLI's order.
    from .resilience.faults import Fault, FaultPlan

    try:
        fault_plan = FaultPlan.parse(args.faults)
        if args.inject_nan:
            fault_plan.faults.append(Fault("nan", step=0))
    except (ValueError, OSError) as e:
        print(f"error: bad --faults spec: {e}", file=sys.stderr)
        return 1
    # SLO rules fail in milliseconds too (the parse errors name clause +
    # offset, obs/slo.py)
    from .obs.slo import SloError, parse_slo

    try:
        slo_rules = parse_slo(args.slo)
    except SloError as e:
        print(f"error: bad --slo spec: {e}", file=sys.stderr)
        return 1
    for name, val in (("--signal-window", args.signal_window),
                      ("--checkpoint-keep", args.checkpoint_keep),
                      ("--auto-recover", args.auto_recover),
                      ("--step-deadline", args.step_deadline),
                      ("--sync-deadline", args.sync_deadline),
                      ("--quality-budget", args.quality_budget),
                      ("--quality-grace", args.quality_grace),
                      ("--quality-probe-every", args.quality_probe_every or 0),
                      ("--mem-sample-every", args.mem_sample_every),
                      ("--profile-on-breach", args.profile_on_breach)):
        if val < 0:
            print(f"error: {name} must be >= 0", file=sys.stderr)
            return 1
    if args.auto_recover and not (0.0 < args.recover_alpha_scale <= 1.0):
        print("error: --recover-alpha-scale must be in (0, 1]", file=sys.stderr)
        return 1
    # bounded profiler windows need a manifest destination; parse A:B
    # before the corpus scan
    profile_window = None
    if args.profile_steps:
        try:
            a_s, _, b_s = args.profile_steps.partition(":")
            profile_window = (int(a_s), int(b_s))
        except ValueError:
            print(
                f"error: bad --profile-steps {args.profile_steps!r} "
                "(want A:B, two integer steps)",
                file=sys.stderr,
            )
            return 1
        if profile_window[1] <= profile_window[0]:
            print(
                f"error: --profile-steps window is empty: "
                f"{args.profile_steps!r}",
                file=sys.stderr,
            )
            return 1
    if (args.profile_steps or args.profile_on_breach) and not args.metrics_dir:
        print(
            "error: --profile-steps/--profile-on-breach write their capture "
            "manifests into --metrics-dir; set it",
            file=sys.stderr,
        )
        return 1
    if args.profile_on_breach and not slo_rules:
        print(
            "error: --profile-on-breach triggers on --slo breaches; set "
            "--slo rules (SIGUSR2 windows work without any)",
            file=sys.stderr,
        )
        return 1
    # Elastic mode: validated and connected BEFORE the process group and
    # the first card use — a rejoining host must be parked at the
    # rendezvous, holding no context on the card, instead of hanging on a
    # store the fleet has already moved past.
    elastic_ctl = None
    if args.rejoin_window < 0:
        print("error: --rejoin-window must be >= 0", file=sys.stderr)
        return 1
    if args.elastic_policy and args.elastic == "off":
        print(
            "error: --elastic-policy requires --elastic shrink or "
            "shrink+grow: the policy actuates through the elastic "
            "rendezvous/remesh machinery",
            file=sys.stderr,
        )
        return 1
    if args.elastic_policy:
        # fail-in-milliseconds: a typo'd policy spec dies before the
        # corpus scan (clause + offset in the message)
        from .resilience.policy import PolicyError, parse_policy

        try:
            parse_policy(args.elastic_policy)
        except PolicyError as e:
            print(f"error: bad --elastic-policy spec: {e}", file=sys.stderr)
            return 1
    if args.elastic != "off":
        if args.sync_deadline <= 0:
            print(
                "error: --elastic requires --sync-deadline > 0: peer loss "
                "is detected by the deadline-bounded collectives, and "
                "without a deadline a dead peer is an unbounded hang, not "
                "a recoverable SyncTimeout",
                file=sys.stderr,
            )
            return 1
        if not (args.checkpoint_dir and args.checkpoint_every):
            print(
                "error: --elastic requires --checkpoint-dir and "
                "--checkpoint-every (on a filesystem every host shares): "
                "survivors re-shard from the last integrity-verified "
                "checkpoint, and without one there is no agreed state to "
                "re-form from",
                file=sys.stderr,
            )
            return 1
        from .resilience.elastic import (
            ElasticController, ElasticError, inherited_sockets,
        )

        # sockets of an old image would mean the exec leaked its group
        marks["inherited_sockets"] = inherited_sockets()
        elastic_ctl = ElasticController.from_env(
            mode=args.elastic, argv=list(argv), dp=args.dp,
            ckpt_dir=args.checkpoint_dir, sync_deadline=args.sync_deadline,
            step_deadline=args.step_deadline,
            max_reannounce=args.rejoin_window,
        )
        if elastic_ctl is None:
            if not args.quiet:
                print(
                    "warning: --elastic set but the W2V_COORDINATOR/"
                    "W2V_NUM_PROCS multi-process contract is not "
                    "configured; a single-process run has no fleet to "
                    "shrink or grow — continuing non-elastic",
                    file=sys.stderr,
                )
        else:
            try:
                # rank 0 binds the rendezvous; other ranks hello — and an
                # admitted rejoiner EXECS into the grown generation here
                elastic_ctl.startup()
            except ElasticError as e:
                print(f"error: elastic startup: {e}", file=sys.stderr)
                return 1
    marks["elastic_startup"] = time.monotonic()
    from .parallel import multihost

    if args.multihost:
        # joins the process group before any card use on every process;
        # an elastic fleet's store is hosted by the shepherd rank 0 starts
        try:
            joined = (
                multihost.initialize_from_env(elastic=True)
                if elastic_ctl is not None else multihost.initialize_from_env()
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not joined and not args.quiet:
            print(
                "warning: --multihost set but W2V_COORDINATOR/W2V_NUM_PROCS "
                "not configured; continuing single-process",
                file=sys.stderr,
            )
    marks["group"] = time.monotonic()
    procs = multihost.process_count()
    # In multi-host mode only process 0 writes shared artifacts (vectors,
    # vocab, checkpoints, the metrics dir): every process reaching the
    # save paths with the same -output on a shared filesystem would
    # interleave writes.
    is_primary = multihost.process_index() == 0

    # quality-probe cadence: on by default for instrumented runs
    # (--metrics-dir) and whenever the user supplies probe material
    q_every = args.quality_probe_every
    if q_every is None:
        q_every = 100 if (
            args.metrics_dir or args.probe_pairs or args.probe_analogies
        ) else 0

    # Resume: the checkpoint's config and vocab are authoritative — resuming
    # against a rebuilt vocab would silently re-attribute embedding rows.
    state = None
    ck_cfg = None
    ck_vocab = None
    stream_doc = None
    if args.resume:
        try:
            state, ck_cfg, ck_vocab, ck_dir = load_checkpoint_with_path(
                args.resume
            )
        except CheckpointError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        # streaming checkpoints carry their replay cursor next to the
        # params (same integrity manifest, same backup rotation): read it
        # from the dir that actually loaded, which may be a .old fallback
        stream_doc = read_stream_cursor(ck_dir)
        if not args.quiet:
            print(
                f"resumed from {args.resume} at step {state.step}"
                + (
                    f" (stream segment {stream_doc.get('segment')}, "
                    f"vocab generation {stream_doc.get('vocab_generation')})"
                    if stream_doc else ""
                )
            )
        writer = checkpoint_writer(ck_dir)
        if writer is not None and writer != WRITER:
            # unconditional (even under --quiet): the run changes package
            print(
                f"resume: checkpoint written by {writer}; params, counters "
                "and the alpha schedule carry over, the draw stream "
                "continues on this package's generator (threefry cannot be "
                "reproduced in torch)",
                file=sys.stderr,
            )
    marks["checkpoint_load"] = time.monotonic()

    # validation mirrors main.cpp:164-181 (raised by Word2VecConfig)
    alpha = args.alpha
    if alpha is None:
        # word2vec.c-style default: 0.05 for cbow(+mean), 0.025 for sg
        alpha = 0.05 if (args.model == "cbow" and args.cbow_mean) else 0.025
    flag_kwargs = dict(
        iters=args.iter,
        window=args.window,
        min_count=args.min_count,
        word_dim=args.size,
        negative=args.negative,
        subsample_threshold=args.subsample,
        init_alpha=alpha,
        cbow_mean=bool(args.cbow_mean),
        train_method=args.train_method,
        model=args.model,
        batch_rows=args.batch_rows or 32,  # placeholder; auto-sized below
        # with auto batch sizing the real (rows, micro) pair is set below
        micro_steps=max(1, args.micro_steps) if args.batch_rows else 1,
        chunk_steps=args.chunk_steps,
        max_sentence_len=args.max_sentence_len,
        seed=args.seed,
        dp_sync_every=args.dp_sync_every,
        sync_mode=args.sync_mode,
        kernel=args.kernel,
        compute_dtype=args.compute_dtype,
        shared_negatives=args.shared_negatives,
        negative_scope=args.negative_scope,
        scatter_mean=bool(args.scatter_mean),
        slab_scatter=bool(args.slab_scatter),
        hs_dense_top=args.hs_dense_top,
        hs_tail_slots=args.hs_tail_slots,
        band_backend=args.band_backend,
        table_layout=args.table_layout,
        resident=args.resident,
        corpus_mode=args.corpus_mode,
        segment_tokens=args.segment_tokens,
        vocab_reserve=args.vocab_reserve,
        autotune=args.autotune,
        plan_cache=args.plan_cache,
        clip_row_update=args.clip_row_update,
        dtype=args.table_dtype,
        stochastic_rounding=bool(args.stochastic_rounding),
        # --metrics-dir implies the full health counters unless the user
        # explicitly opted out
        health_metrics=bool(
            args.health_metrics
            if args.health_metrics is not None
            else args.metrics_dir
        ),
        divergence_budget=args.divergence_budget,
        quality_probe_every=q_every,
        prng_impl=args.prng,
        elastic=args.elastic,
        elastic_policy=args.elastic_policy,
    )
    try:
        cfg = ck_cfg if ck_cfg is not None else Word2VecConfig(**flag_kwargs)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if cfg.elastic != args.elastic or cfg.elastic_policy != args.elastic_policy:
        # elasticity (and its policy) is runtime wiring, like
        # --sync-deadline: the flag is authoritative on resume (a
        # checkpoint from a non-elastic generation must not pin recovery
        # off — every elastic generation IS such a resume)
        cfg = dataclasses.replace(
            cfg, elastic=args.elastic, elastic_policy=args.elastic_policy
        )

    if args.export_side == "output" and cfg.use_hs:
        # fail BEFORE training, on the EFFECTIVE config
        print("error: --export-side output requires negative sampling "
              "(the hs output table holds internal nodes, not word rows)",
              file=sys.stderr)
        return 1

    if ck_cfg is not None and args.prng != ck_cfg.prng_impl:
        # unconditional (even under --quiet): silently switching the draw
        # streams mid-run is exactly the hazard the persisted field prevents
        print(
            f"resume: checkpoint pins prng_impl={ck_cfg.prng_impl!r}; "
            f"ignoring --prng {args.prng} (the draw streams stay on the "
            f"checkpoint's impl)",
            file=sys.stderr,
        )
    typed_prng = any(t == "--prng" or t.startswith("--prng=") for t in argv)
    if (typed_prng or cfg.prng_impl != "threefry") and not args.quiet:
        print(
            f"prng: prng_impl={cfg.prng_impl!r} is recorded in the config "
            "and the checkpoints; the port's draws come from torch's "
            "generator whatever the name (ROADMAP C5)",
            file=sys.stderr,
        )

    if not args.train:
        print("error: -train <file> is required", file=sys.stderr)
        return 1

    # the card unless the caller asks for the CPU: raises without a card,
    # before the corpus scan
    device = resolve_device("cuda" if args.backend == "gpu" else "cpu")

    if ck_cfg is not None:
        # unconditional (even under --quiet): a lever flag silently ignored
        # at resume time is how an A/B run measures the wrong configuration
        diffs = _flag_diffs(parser, args, list(argv), flag_kwargs, ck_cfg)
        if diffs:
            print(
                "resume: using checkpoint config; ignoring differing "
                f"flags {diffs}", file=sys.stderr,
            )

    t0 = time.perf_counter()
    mode = native.MODE_STREAM if args.corpus_format == "text8" else native.MODE_LINES
    if args.max_vocab and (ck_vocab is not None or args.read_vocab):
        print(
            "warning: --max-vocab applies only when the vocabulary is built "
            "from the corpus; the loaded vocabulary (checkpoint/-read-vocab) "
            "is used as-is", file=sys.stderr,
        )
    streaming = cfg.corpus_mode == "streaming"
    stream_source = None
    stream_cursor = None
    stream_run = None  # set after the trainer exists; save sites read it lazily
    if args.train == "-" and not streaming:
        print(
            "error: -train - (pipe ingestion) requires --corpus-mode "
            "streaming: a pipe cannot be packed resident",
            file=sys.stderr,
        )
        return 1
    if streaming:
        import numpy as np

        from .stream import DEFAULT_SEGMENT_TOKENS, StreamCursor, make_source
        from .stream.driver import encode_segment

        seg_tokens = cfg.segment_tokens or DEFAULT_SEGMENT_TOKENS
        spool = args.stream_spool
        if not spool and args.train == "-":
            import tempfile

            spool = (
                os.path.join(args.checkpoint_dir, "stream_spool")
                if args.checkpoint_dir
                else os.path.join(
                    tempfile.gettempdir(), f"w2v_stream_spool_{os.getpid()}"
                )
            )
            if args.checkpoint_dir and procs > 1:
                spool += f"_p{multihost.process_index()}"
        try:
            stream_source = make_source(
                args.train, fmt=args.corpus_format,
                segment_tokens=seg_tokens, spool_dir=spool,
            )
        except (FileNotFoundError, ValueError, OSError) as e:
            print(f"error: bad streaming corpus spec: {e}", file=sys.stderr)
            return 1
        stream_cursor = (
            StreamCursor.from_json(stream_doc) if stream_doc
            else StreamCursor()
        )
        if args.resume and stream_doc is None and not args.quiet:
            print(
                "warning: resuming a non-streaming checkpoint into "
                "--corpus-mode streaming: the stream starts from its "
                "beginning (no cursor to replay)",
                file=sys.stderr,
            )
        # Vocabulary bootstrap: checkpoint > -read-vocab > first segment.
        # The streaming resume skips the full-corpus rebuild guard (a
        # stream cannot be re-counted mid-flight); identity is pinned by
        # the cursor + the checkpoint's own vocab instead.
        boot = None
        if ck_vocab is not None:
            vocab = ck_vocab
        elif args.read_vocab:
            vocab = Vocab.load(args.read_vocab)
        else:
            boot = stream_source.read_segment(
                stream_cursor.segment, stream_cursor.shard,
                stream_cursor.offset, vocab=None,
            )
            if boot.raw_tokens == 0:
                print(
                    "error: the streaming corpus produced no tokens "
                    "(empty stream at the start cursor)", file=sys.stderr,
                )
                return 1
            vocab = Vocab.from_counter(
                boot.counts or {}, min_count=cfg.min_count,
                max_vocab=args.max_vocab,
            )
            if len(vocab) == 0:
                print(
                    "error: the first streaming segment built an empty "
                    "vocabulary (every word under -min-count "
                    f"{cfg.min_count}); lower -min-count or enlarge "
                    "--segment-tokens", file=sys.stderr,
                )
                return 1
        if boot is None:
            boot = stream_source.read_segment(
                stream_cursor.segment, stream_cursor.shard,
                stream_cursor.offset, vocab=vocab,
            )
        # bootstrap corpus: feeds auto geometry, the kernel selection and
        # the hazard warnings at construction; the driver replaces it per
        # segment
        flat = encode_segment(
            boot, vocab, getattr(stream_source, "fmt", "text8")
        )
        if flat.size == 0 or not (flat >= 0).any():
            flat = np.zeros(1, dtype=np.int32)
    elif ck_vocab is not None:
        vocab = ck_vocab
        if args.read_vocab and Vocab.load(
            args.read_vocab
        ).content_hash() != vocab.content_hash() and not args.allow_vocab_mismatch:
            print(
                f"error: -read-vocab {args.read_vocab} holds a different "
                f"vocabulary than the checkpoint at {args.resume} "
                "(content-hash mismatch); resuming would re-attribute "
                "embedding rows. Drop -read-vocab (the checkpoint's vocab "
                "is authoritative) or pass --allow-vocab-mismatch.",
                file=sys.stderr,
            )
            return 1
        if not args.read_vocab and not args.allow_vocab_mismatch:
            # Resume-compatibility guard: rebuild the vocabulary this corpus
            # + the checkpoint's min_count produce and compare content
            # hashes. Hash-equal vocabularies encode identically, so the
            # rebuilt ids are reused.
            rb_vocab, rb_flat = load_corpus(
                args.train, fmt=args.corpus_format, min_count=cfg.min_count,
                max_vocab=args.max_vocab,
            )
            if rb_vocab.content_hash() == vocab.content_hash():
                flat = rb_flat
            elif vocab.is_compatible_superset(rb_vocab):
                # the checkpoint's vocabulary extends what this corpus
                # rebuilds to (an online-growth checkpoint of the JAX
                # package): it stays authoritative, re-encode with it
                print(
                    f"resume: checkpoint vocabulary ({len(vocab)} words) is "
                    f"a compatible superset of the corpus rebuild "
                    f"({len(rb_vocab)} words) — an online-growth "
                    "checkpoint; resuming with the grown vocabulary",
                    file=sys.stderr,
                )
                flat = native.encode_file(args.train, vocab, mode)
            else:
                print(
                    f"error: the corpus at {args.train} rebuilds to a "
                    f"different vocabulary ({len(rb_vocab)} words) than the "
                    f"checkpoint at {args.resume} pins ({len(vocab)} words, "
                    "content-hash mismatch, not a compatible superset): "
                    "this is not the corpus the "
                    "checkpoint was trained on (or -min-count/--max-vocab "
                    "differ from the original run). Resuming would silently "
                    "re-attribute embedding rows; pass "
                    "--allow-vocab-mismatch to train the checkpoint's "
                    "vocab against this corpus anyway.",
                    file=sys.stderr,
                )
                return 1
        else:
            flat = native.encode_file(args.train, vocab, mode)
    elif args.read_vocab:
        vocab = Vocab.load(args.read_vocab)  # Word2Vec.cpp:179-196
        flat = native.encode_file(args.train, vocab, mode)
    else:
        vocab, flat = load_corpus(
            args.train, fmt=args.corpus_format, min_count=cfg.min_count,
            max_vocab=args.max_vocab,
        )
    if not args.quiet:
        print(f"vocab: {len(vocab)} words, {vocab.total_words} total "
              f"({time.perf_counter() - t0:.1f}s, "
              f"{native.implementation()} data layer)")
    corpus = PackedCorpus.from_flat(flat, cfg.max_sentence_len)
    marks["corpus"] = time.monotonic()
    if args.save_vocab and is_primary:
        vocab.save(args.save_vocab)  # Word2Vec.cpp:171-177

    if args.batch_rows == 0 and not args.resume:
        # multi-host: size from the GLOBAL token count (sum over shards) so
        # every process derives the same batch_rows and step shapes
        auto_tokens = multihost.global_agree_sum(corpus.num_tokens)
        auto_rows, auto_micro = Word2VecConfig.auto_geometry(
            auto_tokens, cfg.max_sentence_len, dp=args.dp,
            vocab_size=len(vocab),
        )
        if args.micro_steps:
            # explicit micro with auto rows: keep the auto-sized OPTIMIZER
            # block and scale the dispatch to block * micro
            block = max(1, auto_rows // auto_micro)
            auto_micro = args.micro_steps
            auto_rows = block * auto_micro
        cfg = dataclasses.replace(cfg, batch_rows=auto_rows, micro_steps=auto_micro)
        if not args.quiet:
            steps = max(
                1,
                auto_tokens * auto_micro
                // (auto_rows * cfg.max_sentence_len * args.dp),
            )
            print(
                f"batch geometry auto: {auto_rows} rows x {auto_micro} "
                f"micro-steps (~{steps} optimizer steps/epoch)"
            )

    if args.multihost and procs > 1 and args.dp * args.tp * args.sp <= 1:
        print(
            "error: --multihost with a 1-device mesh: every process would "
            "train a redundant full model; set --dp (and optionally "
            "--tp/--sp) to span the global device set",
            file=sys.stderr,
        )
        return 1

    # one MetricsHub fans every record out to the enabled sinks and is
    # their single close point (obs/export.py)
    hub = MetricsHub()
    if not args.quiet:
        hub.add(progress_logger())
    metrics_dir = args.metrics_dir if is_primary else None
    if metrics_dir:
        os.makedirs(metrics_dir, exist_ok=True)
    jsonl_path = args.log_jsonl or (
        os.path.join(metrics_dir, "metrics.jsonl") if metrics_dir else None
    )
    prom_path = args.prom_textfile or (
        os.path.join(metrics_dir, "metrics.prom") if metrics_dir else None
    )
    if jsonl_path:
        hub.add(jsonl_logger(jsonl_path))
    if prom_path:
        hub.add(prometheus_textfile(prom_path))
    if args.tensorboard:
        hub.add(tensorboard_logger(args.tensorboard))
    log_fn = hub if hub.sinks else None
    if elastic_ctl is not None:
        # the rendezvous decisions and announces land on the run's sinks
        elastic_ctl.log_fn = log_fn
        if elastic_ctl.server is not None:
            elastic_ctl.server.log_fn = log_fn

    mesh_size = args.dp * args.tp * args.sp
    sharded = mesh_size > 1
    if sharded:
        from .parallel import ShardedTrainer

        try:
            trainer = ShardedTrainer(
                cfg, vocab, corpus, dp=args.dp, tp=args.tp, sp=args.sp,
                log_fn=log_fn, device=device,
            )
        except ValueError as e:
            # the mesh's refusals: more devices than cards, a width that
            # does not divide, a route the model or seq axis cannot run
            print(f"error: {e}", file=sys.stderr)
            hub.close()
            return 1
    else:
        trainer = Trainer(cfg, vocab, corpus, log_fn=log_fn, device=device)
    if trainer.plan_resolution is not None:
        cfg = trainer.config  # the plan-applied config (checkpoints pin it)
        if not args.quiet:
            pr = trainer.plan_resolution
            hit = "cache hit" if pr.source == "cache" else "probed"
            print(f"autotune ({hit}, key {pr.key}): {pr.plan.to_json()}")
    manifest_path = (
        os.path.join(metrics_dir, "manifest.json") if metrics_dir else None
    )
    if state is not None and sharded and elastic_ctl is not None and not streaming:
        # an elastic generation's resume: the snapshot's unreplicated
        # tables into the replicas now (train() would do the same copy),
        # so the blackout's parts are named before the first dispatch
        trainer.import_params(state.params, state)
    marks["trainer"] = time.monotonic()

    elastic_gen = int(os.environ.get(multihost.ENV_ELASTIC_GEN, "0") or 0)
    # Warm-restart kernel cache: ONLY an exec'd next-generation elastic
    # process may point the kernel-library lookup at the per-(topology,
    # plan) directory (enable_warm_cache refuses for gen 0 and for an
    # operator-set W2V_KERNEL_BUILD_DIR). Enabled after plan resolution
    # (the plan is part of the key) and before the first kernel launch.
    warm_cache_dir = None
    if args.compile_cache:
        from .tune.compile_cache import enable_warm_cache, topology_key

        warm_cache_dir = enable_warm_cache(
            args.compile_cache,
            topology_key(
                procs, args.dp, args.tp, args.sp, trainer.config,
                plan_key=getattr(trainer.plan_resolution, "key", None),
            ),
            elastic_gen,
        )
        if warm_cache_dir and not args.quiet:
            print(
                f"compile cache: generation {elastic_gen} warm-restarts "
                f"from {warm_cache_dir}"
            )

    # Device telemetry (obs/devmem.py, obs/harvest.py, obs/profiler.py), on
    # for the runs the signal plane covers: the memory ledger (per-phase
    # watermarks, w2v_mem_* gauges, the mem_headroom_frac signal, the
    # growth forecast), the program harvest (banked into the manifest at
    # run end) and the bounded profiler windows (--profile-steps, SLO
    # breaches, SIGUSR2). The ledger is made before the manifest write so
    # its start block carries the init watermark; it is installed
    # process-wide for the run (swap_table and the SIGUSR2 handler find
    # it there).
    mem_ledger = cost_harvest = prof_capture = None
    if slo_rules or metrics_dir or args.prom_textfile:
        from .obs.devmem import MemoryLedger, table_row_bytes
        from .obs.harvest import CostHarvest

        mem_ledger = MemoryLedger(
            sample_every=args.mem_sample_every or 50,
            # the hub itself (not the log_fn gate): the SignalEngine is a
            # hub sink, and the mem rows must reach it under --quiet too
            log_fn=hub,
            flight=trainer.flight,
            devices=trainer.mesh.cards if sharded else [device],
            row_bytes=table_row_bytes(trainer.config),
            vocab_reserve=trainer.config.vocab_reserve,
        )
        trainer.devmem = mem_ledger
        mem_ledger.sample("init")
        cost_harvest = trainer.harvest = CostHarvest()
    if metrics_dir:  # process 0's
        from .obs.profiler import ProfilerCapture

        prof_capture = ProfilerCapture(
            metrics_dir, steps=args.profile_on_breach or 8, log_fn=hub,
            flight=trainer.flight,
        )
        trainer.profiler = prof_capture
        if profile_window is not None:
            prof_capture.schedule(*profile_window)

    if manifest_path:
        # the REALIZED config, where the run went and what it ran under
        extra = {
            "corpus_tokens": corpus.num_tokens,
            "corpus_rows": corpus.num_rows,
            "corpus_mode": cfg.corpus_mode,
            "resumed_from": args.resume or None,
            "kernel_decision": trainer.kernel_decision,
            "mesh_size": mesh_size,
            "elastic": args.elastic,
            "elastic_policy": args.elastic_policy or None,
            "elastic_generation": elastic_gen,
            "compile_cache": warm_cache_dir,
            # the memory view at run start; the end-of-run update
            # rewrites it with the full per-phase ledger
            "device_memory": (
                mem_ledger.summary() if mem_ledger is not None else None
            ),
        }
        if sharded:
            extra.update({
                "dp": args.dp, "sp": args.sp, "tp": args.tp,
                # a replica whose tp shards span devices runs eagerly
                # (ops/graphs.StepGraph.split): no graph spans two devices
                "split_shards": trainer.split_shards,
                # the mesh record of the JAX CLI's generation start
                "mesh_events": [{
                    "event": "generation_start", "gen": 0, "world": procs,
                    "mesh_size": mesh_size,
                    "dp": args.dp, "tp": args.tp, "sp": args.sp,
                    "resumed_from": args.resume or None,
                }],
            })
            if procs > 1:
                # the fleet: processes, this one's index, the collective
                # backends and why, every process's host, card and devices
                topo = multihost.topology() or {}
                extra.update({
                    "mesh_processes": procs,
                    "process_index": multihost.process_index(),
                    "collective_backend": topo.get("table_backend"),
                })
                extra["mesh_events"][0]["topology"] = topo
        if elastic_ctl is not None:
            extra["mesh_events"] = _elastic_mesh_events(
                manifest_path, extra.get("mesh_events"), elastic_gen, marks,
            )
        if streaming:
            # the data plane: corpus_tokens is the bootstrap segment, and
            # this block the stream's shape and where it resumed
            extra["stream"] = {
                "segment_tokens": seg_tokens,
                "vocab_reserve": cfg.vocab_reserve,
                "source": stream_source.describe(),
                "resume_cursor": stream_doc,
            }
        write_manifest(
            manifest_path, trainer.config, vocab_size=len(vocab),
            plan_resolution=trainer.plan_resolution, device=device,
            extra=extra,
        )
    if log_fn is not None:
        # the mesh gauges (obs/export.GAUGE_EVENTS), as the JAX CLI logs
        # them: the processes and the dp*sp*tp devices
        log_fn({"event": "mesh", "mesh_size": mesh_size,
                "mesh_processes": procs, "elastic_generation": elastic_gen})
        elected_env = os.environ.get("W2V_ELASTIC_ELECTED")
        if elected_env and elastic_gen > 0:
            # the generation we exec'd FROM ran the rendezvous election;
            # count it here, where this process has its metrics sinks
            # (w2v_rendezvous_elections_total, present from zero)
            er, _, ea = elected_env.partition(":")
            log_fn({
                "event": "rendezvous_election", "gen": elastic_gen,
                "elected_rank": er, "rendezvous": ea,
            })

    def save_ckpt(s) -> None:
        t = time.perf_counter()
        # the unreplicated tables (under --dp the synced export: a
        # pending replica sync runs first). The sync is a collective, so
        # every process enters it; only process 0 writes the files.
        s = dataclasses.replace(s, params=trainer.export_params(s))
        if not is_primary:
            return
        # the stream cursor is read at save time: the driver's cursor
        # advances per segment, and every checkpoint must carry the cursor
        # of the segment it was taken IN (None on resident runs)
        save_checkpoint(
            args.checkpoint_dir, s, trainer.config, vocab,
            keep=args.checkpoint_keep,
            stream=stream_run.cursor_meta() if stream_run is not None else None,
        )
        if log_fn is not None:
            log_fn({"event": "checkpoint", "step": s.step,
                    "seconds": time.perf_counter() - t})

    ckpt_cb = save_ckpt if args.checkpoint_dir and args.checkpoint_every else None

    # the quality probe: the CLI's flags are authoritative over the
    # trainer's config-built default (telemetry is runtime wiring); it logs
    # through the hub, rides the flight recorder, and the sentinel
    # escalates per --quality-budget with the run's checkpoint callback
    if q_every > 0:
        from .tune.planner import degeneracy_domain

        try:
            pset = (
                ProbeSet.from_files(vocab, args.probe_pairs, args.probe_analogies)
                if (args.probe_pairs or args.probe_analogies)
                else ProbeSet.synthesize(vocab)
            )
        except (OSError, ValueError) as e:
            print(f"error: bad probe file: {e}", file=sys.stderr)
            hub.close()
            return 1
        trainer.quality_probe = QualityProbe(
            vocab, pset, every=q_every, log_fn=log_fn,
            flight=trainer.flight,
            sentinel=QualitySentinel(
                budget=args.quality_budget,
                floor=args.quality_floor,
                drop=args.quality_drop,
                grace=args.quality_grace,
                in_domain=degeneracy_domain(
                    trainer.config, len(vocab), corpus.num_tokens
                ),
            ),
        )
        if ckpt_cb is not None:
            trainer.quality_probe.checkpoint_fn = (
                lambda: ckpt_cb(trainer.last_state)
            )
        if not args.quiet:
            print(
                f"quality probe: every {q_every} steps, "
                f"{len(pset.pairs)} pairs + {len(pset.analogies)} "
                f"analogies ({pset.source}), sentinel budget "
                f"{args.quality_budget}"
            )
    else:
        trainer.quality_probe = None

    # the derived-signal plane (obs/signals.py): on for instrumented runs
    # and whenever SLO rules are set; a hub sink, so the probe's gauge
    # records feed quality_planted
    if slo_rules or metrics_dir or args.prom_textfile or args.elastic_policy:
        sig_window = args.signal_window or 50
        sig_engine = SignalEngine(
            window=sig_window,
            phases=trainer.phases,
            flight=trainer.flight,
            log_fn=hub,
            metrics_dir=metrics_dir,
            slo=SloEvaluator(slo_rules) if slo_rules else None,
            aggregator=(
                FleetAggregator(metrics_dir, window_steps=sig_window)
                if metrics_dir else None
            ),
        )
        trainer.signals = sig_engine
        hub.add(sig_engine)  # hub.close() also closes the row file
        if prof_capture is not None and args.profile_on_breach:
            # an SLO breach requests one bounded profiler window, armed at
            # the next step boundary (obs/profiler.py)
            prof_capture.attach(sig_engine.bus)
        if not args.quiet and slo_rules:
            print(
                f"slo: {len(slo_rules)} rule(s) over {sig_window}-step "
                f"windows: {[str(r) for r in slo_rules]}"
            )
    trainer.debug_nans = args.debug_nans

    def dump_flight(reason: str, failure_step=None) -> None:
        """flight.json into the metrics dir (every abnormal exit)."""
        if metrics_dir and trainer.flight is not None:
            trainer.flight.dump(
                metrics_dir, reason=reason,
                extra={"failure_step": failure_step},
            )

    def export_trace() -> None:
        """--trace DIR: the run's span timeline as Chrome-trace JSON, on
        every exit path (best effort: a failed export warns and leaves
        the exit code alone)."""
        if not args.trace or trainer.flight is None:
            return
        try:
            from .obs.trace import (
                chrome_trace_doc, load_trace, merge_traces, write_trace,
            )

            os.makedirs(args.trace, exist_ok=True)
            idx = multihost.process_index()
            write_trace(
                os.path.join(args.trace, f"trace_p{idx}.json"),
                chrome_trace_doc(trainer.flight.ring.events(), process_index=idx),
            )
            if not is_primary:
                return
            # merge whatever per-process tracks share this directory
            docs = [
                load_trace(p) for p in sorted(
                    glob.glob(os.path.join(args.trace, "trace_p*.json"))
                )
            ]
            write_trace(os.path.join(args.trace, "trace.json"), merge_traces(docs))
        except Exception as e:  # noqa: BLE001 — best-effort export
            print(f"warning: trace export failed: {e}", file=sys.stderr)

    def emit_device() -> None:
        if args.emit_device:
            info = device_info(device)
            print(f"device: {info['platform']} {info['device_kind']}",
                  file=sys.stderr)

    def last_step(default):
        return getattr(trainer.last_state, "step", None) or default

    # Step-deadline watchdog: a run that stops reaching step boundaries is
    # shot (EXIT_STALLED) with stacks, the wedged phase and the flight
    # timeline in the metrics dir. flush_fn counts the stall in the
    # Prometheus sink and closes the sinks: the fire path os._exits,
    # skipping every atexit hook.
    from .resilience import watchdog as watchdog_mod

    if args.step_deadline:
        def _stall_flush(rec):
            hub({"event": "stalled", "step": rec.get("step")})
            if elastic_ctl is None:
                # the elastic path keeps the sinks open for the remesh
                # records (the jsonl sink is line-buffered and the prom
                # textfile rewrites per record: the exec loses nothing)
                hub.close()

        # Elastic shrink detection, leg 2: a dead peer that wedges the
        # dispatch itself (a collective inside it that never returns) is
        # seen only by the step watchdog. With --elastic its fire path
        # attempts the shrink-remesh FROM THE MONITOR THREAD (execve
        # replaces the whole process, the wedged main thread included) and
        # shoots EXIT_STALLED only when the rendezvous fails.
        elastic_on_fire = None
        if elastic_ctl is not None:
            def elastic_on_fire(rec):
                try:
                    elastic_ctl.remesh_and_exec(
                        "shrink", rec.get("step"),
                        manifest_path=manifest_path, hub=hub,
                        flight=trainer.flight, metrics_dir=metrics_dir,
                    )
                except Exception as e:  # noqa: BLE001 — fall through to 76
                    print(f"elastic: stall recovery failed: {e}",
                          file=sys.stderr)
                os._exit(watchdog_mod.EXIT_STALLED)

        trainer.watchdog = watchdog_mod.StepWatchdog(
            deadline=args.step_deadline,
            phases=trainer.phases,
            metrics_dir=metrics_dir,
            manifest_path=manifest_path,
            flight=trainer.flight,
            flush_fn=_stall_flush,
            on_fire=elastic_on_fire,
        )
    elif elastic_ctl is not None and not args.quiet:
        print(
            "warning: --elastic without --step-deadline: a dead peer that "
            "wedges the step dispatch itself is only detected by the step "
            "watchdog — set --step-deadline to bound that leg",
            file=sys.stderr,
        )
    if elastic_ctl is not None and args.elastic == "shrink+grow":
        # the grow channel: rank 0's pending-rejoin poll rides the
        # PeerAgreement heartbeat row install_shutdown wires below, so the
        # whole fleet admits a rejoiner at the same sync boundary
        trainer.elastic_poll = elastic_ctl.grow_pending
    # Elastic policy (resilience/policy.py): the control loop over the
    # signal plane. Only the rendezvous-hosting rank evaluates and
    # requests; every other rank reads the verdict from the heartbeat
    # rows. Wired BEFORE install_shutdown so PeerAgreement carries both
    # the policy column and the (now policy-gated) grow column.
    elastic_policy = None
    if args.elastic_policy and elastic_ctl is not None:
        from .resilience.policy import parse_policy

        if elastic_ctl.server is not None:
            elastic_policy = parse_policy(args.elastic_policy)
            elastic_policy.world = procs
            elastic_policy.log_fn = log_fn
            if trainer.signals is not None:
                elastic_policy.attach(trainer.signals.bus)
            trainer.policy_poll = elastic_policy.poll
            if trainer.elastic_poll is not None:
                grow_src = trainer.elastic_poll
                trainer.elastic_poll = lambda: (
                    grow_src() if elastic_policy.grow_gate() else 0.0
                )
            if not args.quiet:
                print(
                    f"elastic policy: {len(elastic_policy.rules)} rule(s), "
                    f"cooldown {elastic_policy.cooldown} windows, world "
                    f"[{elastic_policy.min_world}, "
                    f"{elastic_policy.max_world or 'unbounded'}]: "
                    f"{[str(r) for r in elastic_policy.rules]}"
                )
    elif args.elastic_policy and elastic_ctl is None and not args.quiet:
        print(
            "warning: --elastic-policy set but no elastic fleet is "
            "configured; a single-process run has nothing to shrink or "
            "grow — the policy is inert",
            file=sys.stderr,
        )

    # Preemption-safe shutdown: SIGTERM/SIGINT request a cooperative stop at
    # the next dispatch boundary; the run then checkpoints and exits
    # EXIT_PREEMPTED so a scheduler can requeue with --resume.
    handler = ShutdownHandler().install()
    trainer.install_shutdown(handler)
    if elastic_ctl is not None and manifest_path and elastic_gen > 0:
        # the blackout's end: this generation's first dispatch boundary
        # (after the capture and the first chunk), on the manifest
        trainer.stop_check = _first_boundary_hook(
            trainer, trainer.stop_check, manifest_path, elastic_gen,
            marks, device,
        )
    # The process-wide collective deadline (--sync-deadline): bounds the
    # multihost agree/heartbeat, the replica sync and the metrics drain.
    # Restored in the finally below: main() runs in process under tests.
    prev_sync_deadline = watchdog_mod.set_sync_deadline(
        args.sync_deadline or None
    )
    # On-demand diagnostics: SIGUSR1 dumps the flight recorder + all-thread
    # stacks into the metrics dir without stopping the run; SIGUSR2 is the
    # device-side mirror — a bounded profiler window + the memory ledger.
    uninstall_usr1 = (
        install_usr1_dump(metrics_dir, trainer.flight)
        if metrics_dir else (lambda: None)
    )
    uninstall_usr2 = (
        install_usr2_profile(metrics_dir, prof_capture, mem_ledger)
        if metrics_dir else (lambda: None)
    )

    # Supervised auto-recovery: DivergenceError rolls back to the last-good
    # checkpoint (into the trainer's captured buffers) and retries.
    run_train = trainer.train
    if streaming:
        # the continuous-training driver (stream/): segments in, the same
        # (state, report) contract out — everything below (preemption,
        # divergence, manifest, export) works unchanged, and every
        # checkpoint the run writes carries the stream cursor (save_ckpt)
        from .stream import StreamRun

        stream_run = StreamRun(
            trainer, stream_source, cursor=stream_cursor,
            fault_plan=fault_plan if fault_plan else None,
            log_fn=log_fn,
        )
        run_train = stream_run.train
    supervisor = None
    if args.auto_recover and streaming:
        print(
            "warning: --auto-recover is not supported with --corpus-mode "
            "streaming yet (the supervisor's rollback replays a resident "
            "epoch, not a stream cursor); continuing without it",
            file=sys.stderr,
        )
    elif args.auto_recover:
        from .resilience.supervisor import Supervisor

        if not (args.checkpoint_dir and args.checkpoint_every) and not args.quiet:
            print(
                "warning: --auto-recover without --checkpoint-dir/"
                "--checkpoint-every has no rollback target; recovery "
                "restarts from a fresh init",
                file=sys.stderr,
            )
        supervisor = Supervisor(
            trainer,
            checkpoint_dir=args.checkpoint_dir,
            max_retries=args.auto_recover,
            alpha_scale=args.recover_alpha_scale,
            log_fn=log_fn,
        )
        run_train = supervisor.run

    from .obs import devmem as devmem_mod
    from .resilience import faults as faults_mod

    prev_plan = None
    if fault_plan:
        trainer.fault_plan = fault_plan
        prev_plan = faults_mod.activate(fault_plan)
    prev_ledger = devmem_mod.activate(mem_ledger) if mem_ledger else None
    profile_ctx = (
        trace(args.profile) if args.profile else contextlib.nullcontext()
    )
    from .resilience.elastic import GrowRequested, PolicyShrinkRequested

    if elastic_ctl is not None:
        # from here on, a hello claiming membership of this generation is a
        # crashed member coming back, not a late starter
        elastic_ctl.mark_running()
    marks["train"] = time.monotonic()
    try:
        with profile_ctx:
            try:
                state, report = run_train(
                    state=state,
                    log_every=args.log_every,
                    checkpoint_cb=ckpt_cb,
                    checkpoint_every=args.checkpoint_every,
                )
            except Exception as e:
                # A lost peer has TWO faces: the silent hang the bounded
                # collectives turn into SyncTimeout, and an immediate
                # runtime ERROR when the peer died mid-transfer (gloo's
                # "connection closed by peer"). Route the second face into
                # the same SyncTimeout handling instead of crashing.
                if (
                    not isinstance(e, (watchdog_mod.SyncTimeout, DivergenceError))
                    and procs > 1
                    and watchdog_mod.is_peer_failure(e)
                ):
                    raise watchdog_mod.SyncTimeout(
                        "distributed runtime peer failure "
                        f"({type(e).__name__}: "
                        f"{str(e).splitlines()[0][:160]})",
                        args.sync_deadline or 0.0,
                    ) from e
                raise
    except GrowRequested as e:
        # Elastic grow: a restarted host waits at the rendezvous, and every
        # fleet member raised this at the SAME sync boundary (the verdict
        # rides one allgather). The fleet is intact, so write a collective
        # checkpoint (the admission snapshot's source), then re-form at
        # N+rejoiners. remesh_and_exec replaces the process image; it only
        # RETURNS on failure, and then the run requeues like a preemption
        # (the checkpoint just landed, nothing is lost).
        detect_t = time.monotonic()
        print(f"elastic: {e}", file=sys.stderr)
        last = trainer.last_state
        grow_saved = False
        if last is not None:
            try:
                save_ckpt(last)  # collective: every rank enters
                grow_saved = True
            except Exception as ce:  # noqa: BLE001 — degrade to last periodic
                print(
                    f"warning: grow-boundary checkpoint failed ({ce}); the "
                    "generation snapshot falls back to the last periodic "
                    "checkpoint",
                    file=sys.stderr,
                )
        if elastic_ctl is not None:
            elastic_ctl.remesh_and_exec(
                "grow", getattr(last, "step", None),
                manifest_path=manifest_path, hub=hub,
                flight=trainer.flight, metrics_dir=metrics_dir,
                # a policy-gated admission is a policy decision; the plain
                # waiter-pending admission is a rejoin
                trigger="policy" if args.elastic_policy else "rejoin",
                detect_t=detect_t,
            )
        # unreachable after a successful exec: this is the failure path
        if manifest_path:
            update_manifest(manifest_path, {
                "shutdown": "elastic_failed",
                "grow_checkpoint": grow_saved,
            })
        dump_flight("elastic_failed", failure_step=getattr(last, "step", None))
        export_trace()
        hub.close()
        return EXIT_PREEMPTED
    except PolicyShrinkRequested as e:
        # Elastic policy shrink: the rendezvous host's policy latched an
        # eviction and every rank read the same heartbeat row, so the
        # whole fleet lands here at one sync boundary with ZERO failures.
        # Write the collective checkpoint (the generation snapshot's
        # source), then split: the victim leaves (announce-only exec in
        # shrink+grow, a clean exit 0 in shrink), the survivors join a
        # policy_shrink round that closes at world-1.
        detect_t = time.monotonic()
        print(f"elastic: {e}", file=sys.stderr)
        last = trainer.last_state
        if last is not None:
            try:
                save_ckpt(last)  # collective: every rank enters
            except Exception as ce:  # noqa: BLE001 — degrade to last periodic
                print(
                    f"warning: policy-shrink checkpoint failed ({ce}); the "
                    "generation snapshot falls back to the last periodic "
                    "checkpoint",
                    file=sys.stderr,
                )
        if elastic_ctl is not None and multihost.process_index() == e.victim:
            # the evicted host: record how this run ended, then leave
            if manifest_path:
                update_manifest(manifest_path, {
                    "shutdown": "policy_evicted",
                    "policy_evict": {"step": e.step, "victim": e.victim},
                })
            dump_flight("policy_evicted", failure_step=e.step)
            export_trace()
            hub({"event": "policy_evicted", "step": e.step})
            if args.elastic == "shrink+grow":
                hub.close()
                elastic_ctl.exec_announce()  # never returns: parks + rejoins
            print(
                f"policy shrink: this host (rank {e.victim}) was evicted "
                "at a sync boundary; exiting 0 (shrink mode does not "
                "readmit)",
                file=sys.stderr,
            )
            hub.close()
            return 0
        if elastic_ctl is not None:
            elastic_ctl.remesh_and_exec(
                "policy_shrink", e.step,
                manifest_path=manifest_path, hub=hub,
                flight=trainer.flight, metrics_dir=metrics_dir,
                trigger="policy", victim=e.victim, detect_t=detect_t,
            )
        # unreachable after a successful exec: this is the failure path
        if manifest_path:
            update_manifest(manifest_path, {"shutdown": "elastic_failed"})
        dump_flight("elastic_failed", failure_step=getattr(last, "step", None))
        export_trace()
        hub.close()
        return EXIT_PREEMPTED
    except watchdog_mod.SyncTimeout as e:
        detect_t = time.monotonic()
        if procs <= 1:
            # a SyncTimeout with no peers (an injected sync_timeout fault,
            # or a --sync-deadline bounding a local operation that wedged)
            # must NOT run the peer-loss protocol: there is no fleet to
            # agree with. Fail fast, named.
            print(
                f"error: {e}\n"
                "error: SyncTimeout with num_processes == 1: no peer "
                "exists to lose or agree with. This is a misconfiguration "
                "(a --sync-deadline bounding single-host work, or an "
                "injected sync_timeout fault outside a fleet) or a wedged "
                "local device/host operation — use --step-deadline for "
                "single-host hang detection.",
                file=sys.stderr,
            )
            if manifest_path:
                update_manifest(manifest_path, {
                    "shutdown": "sync_timeout_single_host",
                    "sync_timeout": {"what": e.what, "deadline_s": e.deadline},
                })
            dump_flight("sync_timeout_single_host", failure_step=last_step(None))
            export_trace()
            hub.close()
            return 1
        if elastic_ctl is not None:
            # Elastic shrink: survivors re-form at N-1 instead of aborting.
            # remesh_and_exec replaces the process image on success; on
            # failure (rendezvous unreachable, declared late, no verified
            # checkpoint, no quorum) it returns and the run falls through
            # to the abort-to-requeue below: elasticity degrades, never
            # regresses.
            print(
                f"elastic: {e}; attempting shrink-remesh instead of abort",
                file=sys.stderr,
            )
            elastic_ctl.remesh_and_exec(
                "shrink", getattr(trainer.last_state, "step", None),
                manifest_path=manifest_path, hub=hub,
                flight=trainer.flight, metrics_dir=metrics_dir,
                detect_t=detect_t,
            )
        # Coordinated abort-to-requeue: a peer died or wedged and a bounded
        # collective timed out (or failed) on THIS process. Every survivor
        # takes this same path, so nobody is stranded. Checkpoint where
        # safe — the last boundary-consistent state, via a bounded save,
        # since the export itself runs the replica sync, a collective that
        # may hang against the dead peer — then exit the requeue rc.
        print(f"error: {e}", file=sys.stderr)
        last = trainer.last_state
        saved = False
        if args.checkpoint_dir and last is not None:
            try:
                watchdog_mod.bounded_call(
                    lambda: save_ckpt(last),
                    what="final checkpoint after peer loss",
                    deadline=args.sync_deadline or 30.0,
                )
                saved = True
            except Exception as ce:  # noqa: BLE001 — best-effort abort path
                print(
                    f"warning: final checkpoint not written ({ce}); the "
                    "last periodic checkpoint is the resume point",
                    file=sys.stderr,
                )
        if manifest_path:
            update_manifest(manifest_path, {
                "shutdown": "peer_lost",
                "sync_timeout": {"what": e.what, "deadline_s": e.deadline},
                "final_checkpoint": saved,
            })
        dump_flight("peer_lost", failure_step=getattr(last, "step", None))
        export_trace()
        hub({"event": "peer_lost", "what": e.what})
        print(
            f"peer lost: aborting at step {getattr(last, 'step', '?')} for "
            "requeue"
            + (
                f"; requeue with --resume {args.checkpoint_dir}"
                if args.checkpoint_dir else
                "; WARNING: no --checkpoint-dir, progress rides on the "
                "last periodic checkpoint only"
            ),
            file=sys.stderr,
        )
        hub.close()
        return EXIT_PREEMPTED
    except DivergenceError as e:
        # structured abort: the manifest says why (and what the supervisor
        # tried), the flight dump carries the timeline of the steps that
        # led here
        print(f"error: DivergenceError: {e}", file=sys.stderr)
        if manifest_path:
            update_manifest(manifest_path, {
                "shutdown": "diverged", "divergence": e.record(),
                "recoveries": supervisor.recoveries if supervisor else [],
            })
        dump_flight("diverged", failure_step=last_step(e.step))
        export_trace()
        hub.close()
        return 2
    except QualityAlert as e:
        # the degeneracy sentinel escalated past 2x its budget
        print(f"error: QualityAlert: {e}", file=sys.stderr)
        if manifest_path:
            update_manifest(manifest_path, {
                "shutdown": "quality_degraded",
                "quality_alert": e.record(),
            })
        dump_flight("quality_alert", failure_step=last_step(e.step))
        export_trace()
        hub.close()
        return EXIT_QUALITY
    finally:
        # restore the signal dispositions, the process-wide fault plan and
        # ledger on every exit path (main() runs in process under tests)
        handler.uninstall()
        uninstall_usr1()
        uninstall_usr2()
        watchdog_mod.set_sync_deadline(prev_sync_deadline)
        if fault_plan:
            faults_mod.activate(prev_plan)
        if mem_ledger:
            devmem_mod.activate(prev_ledger)
    if log_fn is not None:
        # the run's verdict in the log tail, one record
        summary = {
            "event": "train_report",
            "steps": report.steps,
            "words_per_sec": round(report.words_per_sec, 1),
            "final_loss": report.final_loss,
            "nonfinite_loss_steps": report.health.get("nonfinite_loss_steps"),
            "health_observations": report.health.get("observations"),
        }
        if report.phases is not None:
            summary.update(
                verdict=report.phases.get("verdict"),
                input_fraction=report.phases.get("input_fraction"),
            )
        if report.interrupted:
            summary["interrupted"] = report.interrupted
        if report.recoveries:
            summary["recoveries"] = len(report.recoveries)
        if report.stream:
            summary.update(
                stream_segments=report.stream.get("segments"),
                vocab_size=report.stream.get("vocab_size"),
                table_swaps=report.stream.get("swaps"),
            )
        if report.signals:
            fh = report.signals.get("fleet_health") or {}
            summary["fleet_health"] = fh.get("verdict")
            slo_rep = report.signals.get("slo")
            if slo_rep:
                summary["slo_state"] = slo_rep.get("state")
                summary["slo_breaches"] = slo_rep.get("breaches_total")
        if report.device_memory and report.device_memory.get("available"):
            # the device-memory one-liner: worst headroom seen this run
            summary["mem_headroom_frac_min"] = report.device_memory.get(
                "headroom_frac_min")
            summary["mem_peak_bytes"] = report.device_memory.get("peak_bytes")
        log_fn(summary)

    # the program harvest, banked after the measured loop (obs/harvest.py)
    harvest_report = None
    if cost_harvest is not None:
        harvest_report = cost_harvest.finalize()
        if log_fn is not None:
            hrec = cost_harvest.gauge_record()
            if hrec:
                log_fn(hrec)

    preempted = report.interrupted == "preempted"
    if manifest_path:
        # how the run ended, beside how it started
        end_fields = {
            "shutdown": "preempted" if preempted else "clean",
            "final_step": state.step,
            "recoveries": report.recoveries or [],
        }
        if report.device_memory is not None:
            # the full per-phase ledger replaces the start block's init
            # watermark (one manifest read answers "where did the memory go")
            end_fields["device_memory"] = report.device_memory
        if harvest_report is not None:
            end_fields["cost_harvest"] = harvest_report
        if prof_capture is not None:
            end_fields["profiler"] = prof_capture.summary()
        if trainer.flight is not None and cost_harvest is not None:
            # the anchor-drift verdict (tune/cost_model.cost_calibrate): the
            # run's measured device step inverted against the cost model's
            # anchors, as the JAX CLI banks it (word2vec_tpu/cli.py:2160-2180)
            try:
                from .obs import tracediff
                from .tune import cost_model
                from .tune.planner import device_identity

                est = cost_model.predict(
                    trainer.config, len(vocab), *device_identity(trainer.device)
                )
                end_fields["cost_calibrate"] = cost_model.cost_calibrate(
                    est,
                    cost_model.measured_device_ms(
                        tracediff.summarize(trainer.flight.ring.events())
                    ),
                )
            except Exception as ce:  # noqa: BLE001 — advisory, never fatal
                end_fields["cost_calibrate"] = {"error": str(ce)}
        if trainer.resume_fallback:
            end_fields["resume_fallback"] = trainer.resume_fallback
        if report.stream:
            # the continuous-training verdict: segments consumed, final
            # cursor, vocab generation, growth/swap counts
            end_fields["stream"] = report.stream
        if report.signals:
            if report.signals.get("slo"):
                end_fields["slo"] = report.signals["slo"]
            end_fields["fleet_health"] = report.signals.get("fleet_health")
        update_manifest(manifest_path, end_fields)

    if preempted:
        # checkpoint the stopped-at-boundary state, skip export/eval (the
        # run is not finished), exit with the distinct requeue rc
        if args.checkpoint_dir:
            save_ckpt(state)
        dump_flight("preempted", failure_step=state.step)
        export_trace()
        print(
            f"preempted (signal {handler.signum}): stopped at step "
            f"{state.step}; "
            + (
                f"checkpoint saved to {args.checkpoint_dir}; requeue with "
                f"--resume {args.checkpoint_dir}"
                if args.checkpoint_dir
                else "WARNING: no --checkpoint-dir, progress not persisted"
            ),
            file=sys.stderr,
        )
        emit_device()
        hub.close()
        return EXIT_PREEMPTED

    emit_device()
    if not args.quiet and is_primary:
        print(f"\ntrained {report.total_words} words in {report.wall_time:.1f}s "
              f"({report.words_per_sec:,.0f} words/sec), final loss "
              f"{report.final_loss:.4f}")

    if args.checkpoint_dir:
        save_ckpt(state)

    # matrix choice per main.cpp:196-202; one host copy serves the files
    # and the eval engine (its cache is keyed on this array object)
    matrix = export_matrix(state.params, cfg, side=args.export_side)
    W = matrix.float().cpu().numpy()
    if args.output and is_primary:
        save_word2vec(
            args.output, vocab, W,
            binary=bool(args.binary), layout=args.binary_layout,
        )
        if not args.quiet:
            print(f"saved {'binary' if args.binary else 'text'} vectors to "
                  f"{args.output}")
    if args.export_int8 and is_primary:
        from .io.embeddings import save_embeddings_int8

        save_embeddings_int8(args.export_int8, vocab.words, W)
        if not args.quiet:
            print(f"saved int8-quantized vectors to {args.export_int8}")

    export_trace()

    if (args.eval_ws353 or args.eval_analogy) and is_primary:
        from .eval.analogy import evaluate_analogies
        from .eval.similarity import evaluate_ws353

        if args.eval_ws353:
            r = evaluate_ws353(W, vocab, args.eval_ws353, device=device)
            print(f"WS-353 spearman: {r.spearman:.4f} ({r.pairs_used}/{r.pairs_total} pairs)")
        if args.eval_analogy:
            r = evaluate_analogies(W, vocab, args.eval_analogy, device=device)
            # skip counts are part of the verdict: a probe set full of
            # OOV/degenerate rows must not read as a clean 0-question pass
            print(
                f"analogy accuracy: {r.accuracy:.4f} ({r.correct}/{r.total}"
                f", {r.skipped_oov} oov-skipped, {r.skipped_degenerate} "
                f"degenerate-skipped)"
            )
    hub.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
