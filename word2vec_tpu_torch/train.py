"""Training loop (single device).

Port of the single-device path of word2vec_tpu/train.py: Trainer
construction, init_state, alpha_at, the mid-epoch resume skip and the
chunked dispatch driver (_train_chunked with its streaming and
device-resident dispatches). Epochs run over a shuffled corpus with the
linear alpha decay of Word2Vec.cpp:379-380,

    alpha = max(min_alpha, init_alpha * (1 - words_done / (iters * total_words)))

refreshed every step (rounded to float32 on the host, as the JAX driver
passes it). Every optimizer step goes through an ops/graphs.StepGraph: on
the card the step — its draws, the step of the config's route
(ops/steps.make_step: the band ns step, the positional hs step or the
pair step) and, on the resident path, the batch assembly — is
captured once as a CUDA graph and each step is one replay; on the CPU the
same step runs eagerly. A dispatch is config.chunk_steps steps (1, the
default, is the per-step path; 0 picks chunks of up to chunk_cap steps
per epoch, config.chunk_geometry), issued back to back. Batches reach the
device from the host ([S, B, L] chunks filled while the card runs the
previous dispatch, staged through page-locked memory) or are assembled on
the device from a resident copy of the corpus (config.resident,
ops/resident.py; chunked dispatch only). The draws of step s are a pure function of (seed, s)
(device.step_seed), so chunked, per-step, resident and resumed runs
follow the same trajectory. Metrics are fetched one dispatch late, so the
host never waits on the step it just issued.

Also here: the kernel auto-selection in the band kernel's degeneracy
domain (tune/planner.select_kernel: kernel='auto' trains 'pair' there,
Trainer.kernel_decision), the construction-time config hazard warnings
(_warn_config_hazards), the hs tail-drop warning (_note_tail_dropped),
the cooperative stop (install_shutdown with a
resilience/shutdown.ShutdownHandler; polled at every dispatch boundary,
TrainReport.interrupted = "preempted"), the checkpoint_cb hook that
io/checkpoint.save_checkpoint plugs into, and the trainer's telemetry
(word2vec_tpu/train.py's hooks):

  - the always-on flight recorder (obs/flight.FlightRecorder: a bounded
    ring of span events, counters and log records, activated process-wide
    for the run, and left as obs/flight.last() when it returns) and the
    PhaseRecorder wired to its ring (obs/phases: epoch_prep — an epoch's
    shuffle, its words a step and the order's upload on the resident
    path, the batcher's epoch start on the streaming one —, batcher_wait,
    h2d, dispatch, device_wait, checkpoint and quality_probe spans; a step
    or chunk parent span per dispatch and an epoch span;
    TrainReport.phases);
  - on the card, the dispatch timeline (obs/flight.DispatchTimeline): each
    dispatch between two timing events on the trainer's stream, one
    before its first device work and the one its metrics copy records,
    with a non-blocking query of the previous dispatch's end just before
    the start, read by the metrics drain after the wait it already makes:
    one row a dispatch (the card's seconds on it, the idle seconds before
    it, whether the host caused them) in the flight recorder, drawn on the
    ring's `device` track, and the call's totals (TrainReport.dispatch);
  - the non-finite-loss count and, with config.health_metrics, the full
    health counters, computed inside the captured step (obs/health,
    extra rows of ops/graphs.StepGraph.out), observed through the lagged
    fetch by the divergence tripwire (obs/health.HealthMonitor,
    config.divergence_budget; TrainReport.health) and written into the
    log records and the flight ring (obs/health.health_record);
  - the derived-signal plane (`signals`, obs/signals.SignalEngine, beaten
    at every boundary; TrainReport.signals) and the in-training quality
    probe (`quality_probe`, obs/quality.QualityProbe: built from
    config.quality_probe_every, run under its own span at due
    boundaries; non-probe boundaries are one integer compare, no sync);
  - `debug_nans`: an eager, ungraphed, per-step run that checks each
    step's loss and tables and raises FloatingPointError at the first
    non-finite one (the port's counterpart of jax_debug_nans);
  - the one-process resilience and device-telemetry hooks, each None
    unless a caller wires one: the step-deadline watchdog (`watchdog`,
    resilience/watchdog.StepWatchdog: armed by train(), beaten at every
    boundary, disarmed on every exit path), the fault plan (`fault_plan`,
    resilience/faults.FaultPlan: delivered at every boundary and once at
    entry; a `nan` fault fills the trainer's persistent buffers, which the
    graphs replay against), the memory ledger (`devmem`,
    obs/devmem.MemoryLedger; TrainReport.device_memory), bounded profiler
    windows (`profiler`, obs/profiler.ProfilerCapture; stopped on every
    exit path). The divergence supervisor (resilience/supervisor.Supervisor)
    drives train() across rollbacks and sets TrainReport.recoveries;
  - the streaming driver's hooks (stream/driver.StreamRun, one train()
    call a segment): `set_corpus` (the segment), `seed_offset` (the
    segment index: every seed site reads `run_seed`), and
    `refresh_vocab_tables` after an online vocabulary growth, which drops
    the captured graphs so the next dispatch captures against the new
    tables; the resident path resolves off under streaming.

The autotuned planner (config.autotune "probe" or "cached") resolves the
execution plan after the kernel selection and before anything
shape-dependent is built (tune/planner.resolve_plan: a cached plan, or
timed probes on this corpus on the trainer's device, which leave nothing
behind); the trainer then runs the plan-applied config, whose autotune
is "off" (Trainer.plan_resolution, plan_constraints, plan_shapes).

Data parallelism in one process is parallel/trainer.ShardedTrainer, a
subclass that overrides the runners, the dispatches, the resume skip and
the chunk length, and fills the seams left empty here: `_post_step` after
every dispatch and `_finalize` after the last (the replica sync),
`_detach_params` (train() returns one Params dict), `export_params` (what
a checkpoint and the quality probe take) and `fill_params` (the nan
fault); the metrics drain sums the replicas' rows when a dispatch returns
[replicas, S] each. `elastic_poll` and `policy_poll` are the elastic
layer's heartbeat columns (resilience/elastic.py, resilience/policy.py),
threaded into the multi-process stop check by install_shutdown.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .config import Word2VecConfig
from .data.batcher import BatchIterator, PackedCorpus, chunk_batches, epoch_order
from .data.vocab import Vocab
from .device import DeviceLike, generator, on_device, resolve_device
from .models.params import Params, convert_params_layout, init_params, params_layout
from .obs import flight as flight_mod
from .obs.flight import DispatchTimeline, FlightRecorder
from .obs.health import HealthMonitor, health_record
from .obs.phases import PhaseRecorder
from .ops import resident as res
from .ops.band_step import check_route
from .ops.graphs import capture_env
from .ops.tables import DeviceTables
from .ops.train_step import make_chunk_runner
from .tune.planner import select_kernel


@dataclass
class TrainState:
    params: Params
    step: int = 0
    words_done: int = 0
    epoch: int = 0


@dataclass
class TrainReport:
    words_per_sec: float
    total_words: int
    steps: int
    wall_time: float
    final_loss: float
    loss_history: List[float] = field(default_factory=list)
    # the resident-corpus resolution record (Trainer._build_resident), None
    # when the run never resolved it (per-step dispatch, resident='off')
    resident: Optional[Dict] = None
    # why the run ended before its epochs did: "preempted" when a
    # cooperative stop landed at a dispatch boundary, None for a full run
    interrupted: Optional[str] = None
    # the divergence tripwire's summary (obs/health.HealthMonitor.summary):
    # observations, nonfinite_loss_steps, max_streak, divergence_budget
    # (+ grad_norm_cumulative with config.health_metrics)
    health: Optional[Dict] = None
    # phase-timing breakdown (obs/phases.PhaseRecorder.report): per-phase
    # p50/p90 over batcher_wait / h2d / dispatch / device_wait /
    # checkpoint plus the input-bound-vs-compute-bound verdict
    phases: Optional[Dict] = None
    # derived-signal plane report (obs/signals.SignalEngine.report), None
    # unless a driver wired trainer.signals (cli.py does with
    # --metrics-dir, --prom-textfile or --slo)
    signals: Optional[Dict] = None
    # auto-recovery records, attached by resilience.Supervisor when the run
    # rolled back and retried past a DivergenceError
    recoveries: Optional[List[Dict]] = None
    # memory ledger summary (obs/devmem.MemoryLedger.summary): availability,
    # overall and per-phase watermarks, growth forecast. None unless a
    # caller wired trainer.devmem (cli.py does with the signal plane);
    # available=False with zeroed watermarks on the CPU
    device_memory: Optional[Dict] = None
    # continuous-training summary (stream.StreamRun.train): segments
    # consumed, stream cursor, vocab generation, growth/swap counts
    stream: Optional[Dict] = None
    # the dispatch timeline's totals on the card's clock
    # (obs/flight.DISPATCH_TOTALS: dispatches, device seconds, idle
    # seconds between dispatches split into starved and queued); None on
    # the CPU or with trainer.flight = None
    dispatch: Optional[Dict] = None


class Trainer:
    """End-to-end single-device trainer; device defaults to "cuda"."""

    #: resident-corpus resolution of the last chunked run (TrainReport.resident)
    resident_resolution: Optional[Dict] = None
    #: "epoch_restart" once a resumed state's step counter did not fit
    resume_fallback: Optional[str] = None
    #: replay each step as a CUDA graph on the card; False issues the same
    #: steps eagerly (an A/B arm for measurements, not a config field)
    graphs: bool = True
    #: the kernel auto-selection record when kernel='auto' resolved to
    #: 'pair' in the degeneracy domain (tune/planner.select_kernel)
    kernel_decision: Optional[Dict] = None
    #: the planner's resolution (tune/planner.PlanResolution) when
    #: config.autotune was "probe" or "cached"; self.config is then the
    #: plan-applied config
    plan_resolution = None
    #: cooperative-stop poll (resilience/shutdown.ShutdownHandler
    #: .make_stop_check): called with state.step at every dispatch
    #: boundary; True ends the run cleanly with TrainReport.interrupted =
    #: "preempted". Wire via install_shutdown().
    stop_check: Optional[Callable[[int], bool]] = None
    #: elastic grow channel (resilience/elastic.ElasticController
    #: .grow_pending): nonzero on the rendezvous host while a restarted
    #: host waits for admission. None in production; the CLI wires it on
    #: rank 0 BEFORE install_shutdown, which threads it into
    #: PeerAgreement's heartbeat row so the whole fleet admits the
    #: rejoiner at one sync boundary (one process: unused)
    elastic_poll = None
    #: elastic policy channel (resilience/policy.ElasticPolicy.poll):
    #: victim_rank + 1 when the rendezvous host's policy latched a shrink,
    #: 0 otherwise; wired like elastic_poll
    policy_poll = None
    #: in-training quality probe (obs/quality.QualityProbe): built from
    #: config.quality_probe_every > 0 (synthesized golds, a warn-only
    #: sentinel), or installed by a driver; None = off. Beaten from
    #: _check_stop: due() is one integer compare, so non-probe boundaries
    #: add no device sync.
    quality_probe = None
    #: derived-signal plane (obs/signals.SignalEngine), None unless a
    #: driver wires one. Beaten from _check_stop: one clock read and an
    #: integer compare off the window edge, no device fetch.
    signals = None
    #: the TrainState of the current / most recent train() run (the object
    #: the loop advances), for the drivers' abort paths
    last_state: Optional["TrainState"] = None
    #: eager, ungraphed per-step run that checks each step's loss and
    #: tables and raises FloatingPointError at the first non-finite one
    #: (cli.py --debug-nans; the counterpart of jax_debug_nans)
    debug_nans: bool = False
    #: fault-injection plan (resilience/faults.FaultPlan): None in
    #: production; chaos tests and `--faults` set it. Duck-typed: anything
    #: with .on_step(state, trainer).
    fault_plan = None
    #: step-deadline watchdog (resilience/watchdog.StepWatchdog): None
    #: unless --step-deadline. train() arms / disarms it; _check_stop
    #: beats it (one clock read, no device sync).
    watchdog = None
    #: memory ledger (obs/devmem.MemoryLedger): None unless a caller wires
    #: one. Non-sample boundaries are one integer compare; a sample reads
    #: the caching allocator's host-side counters.
    devmem = None
    #: bounded profiler windows (obs/profiler.ProfilerCapture): None unless
    #: a caller wires one. Idle boundaries are None-checks; a requested or
    #: scheduled window arms here, on the training thread.
    profiler = None
    #: additive offset on config.seed for the shuffle and draw streams
    #: (run_seed). The streaming driver (stream/driver.py) sets it to the
    #: SEGMENT index before each per-segment train() call, so every segment
    #: has its own streams, still a pure function of (config.seed,
    #: segment): a mid-segment resume replays exactly what the
    #: uninterrupted run drew. The seed is a replay input of the captured
    #: step, so a new offset captures nothing. 0 (resident runs) keeps the
    #: streams of config.seed.
    seed_offset: int = 0

    def __init__(
        self,
        config: Word2VecConfig,
        vocab: Vocab,
        corpus: PackedCorpus,
        log_fn: Optional[Callable[[Dict], None]] = None,
        device: DeviceLike = None,
    ):
        self.config = config
        self.vocab = vocab
        self.corpus = corpus
        self.log_fn = log_fn
        # always-on flight recorder (obs/flight.py): the last N steps of
        # span events, counters and log records, dumped as flight.json on
        # the drivers' failure paths; set trainer.flight = None to opt out.
        # The phase spans also land on its timeline (the tracer hook).
        self.flight: Optional[FlightRecorder] = FlightRecorder()
        self.phases = PhaseRecorder(tracer=self.flight.ring)
        if config.kernel == "auto":
            # inside the measured band degeneracy domain the planner
            # CHOOSES kernel='pair' instead of warning and collapsing (an
            # explicit kernel='band' overrides: select_kernel only fires
            # for 'auto'), as the JAX trainer does (train.py:225-239)
            decision = select_kernel(config, len(vocab), corpus.num_tokens)
            if decision is not None:
                self.kernel_decision = decision
                self.config = config = dataclasses.replace(
                    config, kernel=decision["selected"]
                )
                self._log(dict(decision))
        check_route(config)
        self.device = resolve_device(device)
        if config.autotune != "off":
            # the plan before anything shape-dependent is built: a cached
            # plan applies with zero probe cost, probe mode times
            # candidates on this very corpus, on this device (as the JAX
            # trainer does, train.py:241-258). The applied config has
            # autotune="off", so nothing downstream searches again.
            from .tune import resolve_plan

            self.plan_resolution = resolve_plan(
                config,
                vocab,
                corpus=corpus,
                mode=config.autotune,
                cache_path=config.plan_cache or None,
                constraints=self.plan_constraints(),
                log_fn=self._log,
                device=self.device,
            )
            self.config = config = config.apply_plan(self.plan_resolution.plan)
        self.tables = DeviceTables.build(vocab, config, self.device)
        self.total_words = corpus.num_tokens
        # the params every step updates in place: the graphs are captured
        # against these buffers, and train() copies a caller's state in
        self._params: Optional[Params] = None
        self._runners: Dict[tuple, object] = {}
        self._env = None
        self._resident_ready = False
        self._resident_cache = None
        self._resident = None
        self._warned_nonfinite = False
        self._last_chunk_loss = float("nan")
        self._tail_drop_streak = 0
        # the positional hs step emits hs_tail_dropped (the JAX hs step's
        # metric); logs and the tail-drop warning read it on that route
        self._hs_route = config.use_hs and config.resolved_kernel == "band"
        #: seconds the last run's graph took to warm up and capture, when
        #: it was captured (0 for eager steps)
        self.capture_s = 0.0
        self._health: Optional[HealthMonitor] = None
        if config.quality_probe_every > 0:
            # the default in-training probe: synthesized planted golds
            # (stats-only when the vocab carries none) and a warn-only
            # sentinel; drivers replace it (cli.py wires probe files, a
            # budgeted sentinel and the checkpoint hook)
            from .obs.quality import ProbeSet, QualityProbe, QualitySentinel
            from .tune.planner import degeneracy_domain

            self.quality_probe = QualityProbe(
                vocab,
                ProbeSet.synthesize(vocab),
                every=config.quality_probe_every,
                log_fn=log_fn,
                flight=self.flight,
                sentinel=QualitySentinel(
                    budget=0,
                    in_domain=degeneracy_domain(
                        config, len(vocab), corpus.num_tokens
                    ),
                ),
            )
        self._warn_config_hazards()

    # ------------------------------------------------------------ planning
    def plan_constraints(self) -> Dict:
        """What the planner's candidate grid must respect for this trainer:
        one device (dp = sp = tp = 1), the kernel routes allowed, and the
        corpus mode (streaming runs get their own cached plans)."""
        return {
            "dp": 1, "sp": 1, "tp": 1, "allow_pallas": True,
            "corpus_mode": self.config.corpus_mode,
        }

    def plan_shapes(self) -> Dict:
        """The realized per-dispatch step shapes (for the planner's records):
        dispatch geometry, the resolved band chunk, and the chunk length
        this corpus resolves to."""
        from .utils.profiling import step_geometry

        cfg = self.config
        g = step_geometry(cfg, len(self.vocab))
        batcher = BatchIterator(
            self.corpus, cfg.batch_rows, cfg.max_sentence_len, seed=cfg.seed
        )
        return {
            "rows_per_dispatch": cfg.batch_rows,
            "max_sentence_len": cfg.max_sentence_len,
            "micro_steps": cfg.micro_steps,
            "band_chunk_S": g["S"],
            "chunk_len": self._resolve_chunk_len(batcher),
            "dp": 1,
            "sp": 1,
            "tp": 1,
        }

    def _warn_config_hazards(self) -> None:
        """Pre-training configuration hazards, warned once at construction
        with the JAX package's text (word2vec_tpu/train.py:324-396):
        (a) optimizer blocks too token-heavy per vocabulary word (summed
        updates overshoot, measured NaN at ~15x), (b) too few optimizer
        steps per epoch to converge (measured threshold ~70), and (c) the
        degenerate-corpus domain where the band kernel's shared negative
        pool collapses planted structure (BAND_DEGENERACY_r5.md). The CLI
        auto-sizes batch_rows; library users constructing Trainer directly
        get these guards instead."""
        cfg = self.config
        tokens_per_step = cfg.batch_rows * cfg.max_sentence_len
        block_tokens = tokens_per_step // cfg.micro_steps
        if len(self.vocab) and block_tokens > 8 * len(self.vocab):
            warnings.warn(
                f"optimizer block carries ~{block_tokens // len(self.vocab)}x "
                f"tokens per vocabulary word ({block_tokens} tokens, "
                f"{len(self.vocab)} words) — duplicate-row summed updates at "
                "this ratio overshoot and can diverge (measured NaN at ~15x; "
                "config.MAX_BLOCK_TOKENS_PER_VOCAB). Raise micro_steps or "
                "shrink batch_rows; Word2VecConfig.auto_geometry(..., "
                "vocab_size=len(vocab)) sizes this automatically.",
                stacklevel=3,
            )
        # Degenerate-corpus fence: with a tiny closed vocabulary trained for
        # thousands of occurrences per word, the band kernel's SHARED
        # negative pool correlates the negative-side gradient across a
        # row's positives and collapses planted structure. Onset ~1,000+
        # occ/word at vocab < ~5k; realistic corpora are far outside it.
        # kernel='auto' selected 'pair' in __init__ wherever the planner
        # could, so this fires for a forced band config, or for band-only
        # levers that make the selection stand aside (as in JAX).
        if (
            cfg.use_ns
            and cfg.resolved_kernel == "band"
            and 0 < len(self.vocab) < 5000
            and self.total_words * cfg.iters > 1000 * len(self.vocab)
        ):
            occ = self.total_words * cfg.iters // len(self.vocab)
            warnings.warn(
                f"~{occ} training occurrences per vocabulary word on a "
                f"{len(self.vocab)}-word vocabulary: the band kernel's "
                "shared negative pool measurably degrades planted "
                "structure in this over-trained tiny-vocab regime "
                "(benchmarks/BAND_DEGENERACY_r5.md). The planner selects "
                "kernel='pair' automatically here for kernel='auto' runs "
                "(tune/planner.select_kernel); this config FORCES the band "
                "fast path, so expect planted-structure collapse — drop "
                "the explicit kernel='band' (or pass --quality-probe-every "
                "/ --quality-budget to watch and gate it live).",
                stacklevel=3,
            )
        steps_per_epoch = max(
            1, self.total_words * cfg.micro_steps // max(1, tokens_per_step)
        )
        if self.total_words and steps_per_epoch < 70:
            rows, micro = cfg.auto_geometry(
                self.total_words, cfg.max_sentence_len,
                vocab_size=len(self.vocab),
            )
            warnings.warn(
                f"batch geometry ({cfg.batch_rows} rows x "
                f"{cfg.max_sentence_len} x {cfg.micro_steps} micro-steps) "
                f"gives only ~{steps_per_epoch} optimizer steps/epoch on "
                f"this {self.total_words}-token corpus — batched updates may "
                f"not converge (threshold ~70; benchmarks/parity.py). "
                f"Suggested: Word2VecConfig.auto_geometry(...) = "
                f"(batch_rows={rows}, micro_steps={micro}).",
                stacklevel=3,
            )

    # ---------------------------------------------------------------- hooks
    def set_corpus(self, corpus: PackedCorpus) -> None:
        """Swap the training corpus between train() calls: the streaming
        driver's per-segment hook (stream/driver.py). The captured graphs
        survive (a new segment of the same chunk shape replays them); only
        the resident-corpus cache is dropped, since it held the OLD
        corpus on the device."""
        self.corpus = corpus
        self.total_words = corpus.num_tokens
        self._resident = None
        self._resident_cache = None
        self._resident_ready = False
        self.resident_resolution = None

    def refresh_vocab_tables(self) -> None:
        """Rebuild the frequency-derived device tables after an online
        vocabulary admission (the streaming driver's growth boundary): the
        keep probabilities and the alias table must cover the admitted
        rows, or new words would never be subsample-gated or drawn as
        negatives. A growth changes the total count, so every keep
        probability and the whole alias table change, and so does the
        vocabulary size each captured step read as a constant: every cached
        runner and its graphs are dropped, and the next _runner captures
        again against the new tables (a capture that fails raises; nothing
        falls back to eager steps). The embedding params are NOT touched:
        reserved rows keep the bits init_params gave them until admitted."""
        self.tables = DeviceTables.build(self.vocab, self.config, self.device)
        self._resident = None
        self._resident_cache = None
        self._resident_ready = False
        self._runners.clear()
        if self.devmem is not None:
            # the growth boundary's rebuild (new tables, one capture) is the
            # allocation spike the growth-headroom forecast exists for
            self.devmem.sample("vocab_growth")

    @property
    def run_seed(self) -> int:
        """The seed of the current train() call's shuffle and draw streams
        (config.seed + seed_offset)."""
        return int(self.config.seed) + int(self.seed_offset)

    # ------------------------------------------------------------ shutdown
    def install_shutdown(self, handler) -> None:
        """Wire a resilience.shutdown.ShutdownHandler's cooperative stop
        into this trainer: a flag read at every dispatch boundary."""
        self.stop_check = handler.make_stop_check()

    def _check_stop(self, state: TrainState) -> bool:
        """One dispatch-boundary poll, in the JAX trainer's order: beat the
        watchdog (the boundary landed), the signal plane (host clocks and
        ints only), the memory ledger (an integer compare off its cadence)
        and the profiler (None-checks when idle), deliver due faults, run
        the quality probe when it is due, then ask the cooperative-stop
        check. The beat comes BEFORE fault delivery, so an injected hang
        is measured from the boundary it wedges."""
        if self.watchdog is not None:
            self.watchdog.beat(state.step)
        if self.signals is not None:
            self.signals.on_boundary(state.step, state.words_done)
        if self.devmem is not None:
            self.devmem.on_boundary(state.step)
        if self.profiler is not None:
            self.profiler.on_boundary(state.step)
        if self.fault_plan is not None:
            self.fault_plan.on_step(state, self)
        if self.quality_probe is not None and self.quality_probe.due(state.step):
            # due() is one integer compare: non-probe boundaries stay
            # sync-free; the probe itself reads the live tables
            self._run_quality_probe(state)
        return self.stop_check is not None and self.stop_check(state.step)

    def _run_quality_probe(self, state: TrainState) -> None:
        """One in-training quality probe under its own phase span.
        QualityAlert propagates out of train() like DivergenceError
        (cli.py maps it to EXIT_QUALITY, rc 3)."""
        with self.phases.span("quality_probe"):
            # the unreplicated tables: under data parallelism the synced
            # export, so a mesh probes what one device would
            self.quality_probe.probe(self.export_params(state), state.step)

    def _post_step(self, state: TrainState) -> None:
        """Called after every dispatch, once state.step counts its steps
        (the data-parallel trainer's replica sync)."""

    def _finalize(self, state: TrainState) -> None:
        """Called once after the run's last dispatch (the data-parallel
        trainer's final sync)."""

    def _detach_params(self, params: Params) -> Params:
        """The params train() hands back: copies, the caller's to keep
        (the buffers stay the trainer's)."""
        return {k: v.clone() for k, v in params.items()}

    def export_params(self, state: TrainState) -> Params:
        """The unreplicated tables of `state` a checkpoint or an export
        takes: the params themselves here; the data-parallel trainer's
        synced export of its replicas (parallel/trainer.py)."""
        return state.params

    def fill_params(self, state: TrainState, value: float) -> None:
        """Fill every floating table the run trains with `value`, in place
        (the nan fault, resilience/faults.py): the live params here, every
        replica's under data parallelism."""
        for v in state.params.values():
            if v.is_floating_point():
                v.fill_(value)

    def _finish_signals(self, state: TrainState) -> Optional[Dict]:
        """Close the signal plane's partial tail window and return the
        TrainReport.signals payload; None when no engine is wired."""
        if self.signals is None:
            return None
        self.signals.finish(state.step, state.words_done)
        return self.signals.report()

    def init_state(self, seed: Optional[int] = None) -> TrainState:
        seed = self.config.seed if seed is None else seed
        gen = generator(self.device, seed)
        return TrainState(
            params=init_params(self.config, len(self.vocab), gen)
        )

    def alpha_at(self, words_done: int) -> float:
        cfg = self.config
        frac = words_done / max(1, cfg.iters * self.total_words)
        return max(cfg.min_alpha, cfg.init_alpha * (1.0 - frac))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _log(self, rec: Dict) -> None:
        """One log record, to the run's sink AND the flight recorder's
        record ring (a failure dump shows what the run last said)."""
        if self.flight is not None:
            self.flight.log_record(rec)
        if self.log_fn:
            self.log_fn(rec)

    # -------------------------------------------------------------- params
    def _coerce_param_layout(self, params: Params) -> Params:
        """Params in the other table layout are restacked losslessly
        (models/params.convert_params_layout), or the conversion fails
        naming both layouts."""
        target = self.config.table_layout
        src = params_layout(params)
        if src == target:
            return params
        self._log({"event": "param_layout_convert", "from": src, "to": target})
        return convert_params_layout(params, target)

    def _adopt(self, params: Params) -> Params:
        """The trainer's persistent buffers, holding `params`. The caller's
        tensors are copied in, never trained in place (the JAX trainer
        copies a handed-in state for the same reason, train.py:643-663);
        buffers of a new shape drop the graphs captured on the old ones."""
        mine = self._params
        same = mine is not None and sorted(mine) == sorted(params) and all(
            mine[k].shape == v.shape and mine[k].dtype == v.dtype
            for k, v in params.items()
        )
        if not same:
            self._params = {
                k: torch.empty_like(v, device=self.device).copy_(v)
                for k, v in params.items()
            }
            self._runners.clear()
            return self._params
        for k, v in params.items():
            if v.data_ptr() != mine[k].data_ptr():
                mine[k].copy_(v)
        return mine

    # ---------------------------------------------------------------- train
    def train(
        self,
        state: Optional[TrainState] = None,
        log_every: int = 50,
        max_steps: int = 0,
        checkpoint_cb: Optional[Callable[[TrainState], None]] = None,
        checkpoint_every: int = 0,
    ) -> Tuple[TrainState, TrainReport]:
        """Run the epochs (or stop once state.step reaches `max_steps` when
        it is > 0). A `state` from a checkpoint or an earlier call resumes
        at its step: mid-epoch at the first batch not yet trained
        (_resume_skip), with the draws of that step. checkpoint_cb(state)
        runs at each step boundary where state.step crosses a multiple of
        checkpoint_every (chunk boundaries on the chunked path), with the
        live params. Returns (state, TrainReport); the returned params are
        the caller's to keep. The flight recorder is installed process-wide
        for the run (obs/flight.activate), so a signal handler and the
        watchdog's monitor thread find the live ring. The watchdog is armed
        for exactly this stretch and disarmed on every exit path (a
        supervisor's rollback load must not count against the step
        deadline: its retry re-arms), and a profiler window the run ends
        inside is stopped on every exit path. The recorder stays readable
        as obs/flight.last() after the call returns or raises. The
        trainer's card is the current CUDA device for the call."""
        prev_flight = flight_mod.activate(self.flight)
        if self.watchdog is not None:
            self.watchdog.arm()
        try:
            # the trainer's card is the current one for the run: its kernels,
            # captures and streams land there whichever card is current
            with on_device(self.device):
                return self._train_impl(
                    state, log_every, max_steps, checkpoint_cb, checkpoint_every
                )
        finally:
            if self.watchdog is not None:
                self.watchdog.disarm()
            if self.profiler is not None:
                self.profiler.finish(getattr(self.last_state, "step", None))
            flight_mod.activate(prev_flight)
            flight_mod.set_last(self.flight)

    def _train_impl(
        self,
        state: Optional[TrainState],
        log_every: int,
        max_steps: int,
        checkpoint_cb: Optional[Callable[[TrainState], None]],
        checkpoint_every: int,
    ) -> Tuple[TrainState, TrainReport]:
        cfg = self.config
        if state is None:
            state = self.init_state()
        else:
            state.params = self._coerce_param_layout(state.params)
        state.params = self._adopt(state.params)
        self.last_state = state
        if self.devmem is not None:
            # the tables are placed by here: attribute this watermark to
            # table placement, before the first train-phase sample
            self.devmem.sample("table_place", step=state.step)
        if self.fault_plan is not None:
            # entry boundary: a fault pinned at/before the entry step
            # (nan@0, or nan@s on a resumed run) applies to the trainer's
            # buffers before the first dispatch (the --inject-nan semantics)
            self.fault_plan.on_step(state, self)
        if self.debug_nans:
            self._check_finite(state, None)
        batcher = BatchIterator(
            self.corpus, cfg.batch_rows, cfg.max_sentence_len, seed=self.run_seed
        )
        self._warned_nonfinite = False
        self._last_chunk_loss = float("nan")
        self.phases.reset()
        self._health = HealthMonitor(cfg.divergence_budget, cfg.micro_steps)
        chunk_len = self._resolve_chunk_len(batcher)
        if chunk_len == 1:
            if cfg.resident == "on" and not self.debug_nans:
                # the config contract is force-or-error; the per-step
                # loop streams from the host by construction
                raise ValueError(
                    "config.resident='on' requires chunked dispatch "
                    "(chunk_steps=0 for auto, or >1), but this run resolved "
                    "to per-step dispatch"
                )
            if cfg.fused_tables:
                warnings.warn(
                    "config.fused_tables applies to chunked dispatch only "
                    "(chunk_steps=0 or >1); the per-step path uses the "
                    "unfused step.",
                    stacklevel=2,
                )
        return self._train_chunked(
            state, batcher, chunk_len, log_every, max_steps,
            checkpoint_cb, checkpoint_every,
        )

    def _check_finite(self, state: TrainState, metrics) -> None:
        """debug_nans: raise FloatingPointError when the step that brought
        the run to state.step left a non-finite loss or table cell (at
        entry, `metrics` None: the tables handed in). A host sync."""
        what = []
        if metrics is not None and not bool(torch.isfinite(metrics["loss_sum"]).all()):
            what.append("loss")
        what += [
            k for k, v in sorted(state.params.items())
            if not bool(torch.isfinite(v).all())
        ]
        if what:
            where = f"entry (step {state.step})" if metrics is None else (
                f"step {state.step}")
            raise FloatingPointError(
                f"debug_nans: non-finite {', '.join(what)} at {where}"
            )

    # ------------------------------------------------------- resume skip
    def _resume_skip(self, state: TrainState, batcher: BatchIterator) -> int:
        """Steps of state.epoch already done per the step counter. Valid
        because epoch permutations are pure functions of (seed, epoch).
        An out-of-range value (a state from another batch geometry) falls
        back to an epoch restart, loudly (_note_resume_fallback).
        skip == steps_per_epoch is valid: a state on the epoch boundary
        resumes into an empty epoch and rolls on into the next."""
        spe = batcher.steps_per_epoch()
        skip = state.step - state.epoch * spe
        if 0 <= skip <= spe:
            return skip
        return self._note_resume_fallback(state, skip, spe)

    def _note_resume_fallback(
        self, state: TrainState, skip: int, steps_per_epoch: int
    ) -> int:
        """Restart the epoch (the only consistent recovery), with a warning
        and a log record: the restart re-trains data the state has seen."""
        self.resume_fallback = "epoch_restart"
        warnings.warn(
            f"checkpointed step counter {state.step} (epoch {state.epoch}) "
            f"is out of range for this config's {steps_per_epoch} "
            f"steps/epoch (derived skip {skip}): the checkpoint was taken "
            "under different batch geometry. Restarting the epoch from its "
            "first batch — already-trained data will be re-trained.",
            stacklevel=3,
        )
        self._log({
            "event": "resume_fallback",
            "mode": "epoch_restart",
            "step": state.step,
            "epoch": state.epoch,
            "steps_per_epoch": steps_per_epoch,
            "derived_skip": skip,
        })
        return 0

    # ------------------------------------------------------ chunked driver
    def _resolve_chunk_len(self, batcher: BatchIterator) -> int:
        """config.chunk_steps resolved against this corpus (0 = auto)."""
        cfg = self.config
        if cfg.chunk_steps == 1 or self.debug_nans:
            return 1
        steps = batcher.steps_per_epoch()
        if cfg.chunk_steps == 0:
            s, _ = cfg.chunk_geometry(steps, cap=cfg.chunk_cap)
            return s
        return min(cfg.chunk_steps, steps)

    def _runner(self, chunk_len: int):
        """The dispatch runner for chunks of `chunk_len` steps, its graph
        captured here, before the run's first dispatch."""
        graphed = self.graphs and not self.debug_nans and self.device.type == "cuda"
        resident = self._resident is not None
        key = (chunk_len, resident, graphed)
        runner = self._runners.get(key)
        if runner is None:
            if resident:
                runner = res.make_resident_chunk_runner(
                    self.config, self.tables, graphed=graphed
                )
            else:
                # the per-step path takes the unfused step (as JAX's does)
                runner = make_chunk_runner(
                    self.config, self.tables, graphed=graphed,
                    fused=self.config.fused_tables and chunk_len > 1,
                )
            if graphed:
                if self._env is None:
                    self._env = capture_env(self.device)
                runner.env = self._env
            self._runners[key] = runner
        cfg = self.config
        if resident:
            g = runner.resident_graph(
                self._params, self._resident, chunk_len, self.corpus.num_rows
            )
        else:
            g = runner.stream_graph(
                self._params, (chunk_len, cfg.batch_rows, cfg.max_sentence_len)
            )
        self.capture_s = g.capture_s
        return runner

    def _train_chunked(
        self,
        state: TrainState,
        batcher: BatchIterator,
        chunk_len: int,
        log_every: int,
        max_steps: int,
        checkpoint_cb: Optional[Callable[[TrainState], None]],
        checkpoint_every: int,
    ) -> Tuple[TrainState, TrainReport]:
        """Epochs dispatched chunk_len optimizer steps at a time (1 on the
        per-step path). The trajectory is the per-step one (the same
        step-indexed draws and per-step alphas, tests/test_torch_chunk.py);
        only dispatch granularity changes. Metrics of dispatch i are
        fetched after dispatch i+1 is issued (the device_wait span);
        logging, the checkpoint hook, the signal beat, the quality probe
        and the cooperative stop run at dispatch boundaries, each of which
        closes a step (chunk_len 1) or chunk parent span on the flight
        timeline. On the card each dispatch is also timed on the card's
        clock (the dispatch timeline: begun before the dispatch, closed by
        the drain of its metrics)."""
        cfg = self.config
        self._resident = self._setup_resident() if chunk_len > 1 else None
        runner = self._runner(chunk_len)
        timeline = self._dispatch_timeline()
        loss_hist: List[float] = []
        pending: Optional[tuple] = None

        def drain() -> None:
            nonlocal pending
            if pending is not None:
                self._note_metrics(*pending, t0, loss_hist)
                pending = None

        skip = self._resume_skip(state, batcher)
        self._sync()
        if timeline is not None:
            timeline.open()
        t0 = time.perf_counter()
        t_bound = t0
        done = False
        interrupted: Optional[str] = None
        for epoch in range(state.epoch, cfg.iters):
            state.epoch = epoch
            t_epoch = time.perf_counter()
            epoch_first = True
            for words_list, dispatch in self.phases.timed_iter(
                self._chunk_dispatches(
                    state, batcher, runner, epoch, skip, chunk_len
                ),
                "batcher_wait",
            ):
                if max_steps and state.step >= max_steps:
                    done = True
                    break
                n = len(words_list)
                if max_steps:
                    n = min(n, max_steps - state.step)
                alphas = np.zeros(chunk_len, np.float32)
                wd = state.words_done
                for i in range(n):
                    alphas[i] = self.alpha_at(wd)
                    wd += words_list[i]
                mark = None if timeline is None else timeline.begin(epoch_first)
                epoch_first = False
                metrics = dispatch(alphas, n)
                if timeline is None:
                    snap = self._snapshot(metrics)
                else:
                    snap = self._snapshot(metrics, timeline.end_event())
                    mark = timeline.issued(mark, snap[2])
                prev_step = state.step
                state.step += n
                state.words_done = wd
                self._post_step(state)
                if self.debug_nans:
                    self._check_finite(state, metrics)
                if self.flight is not None:
                    # the dispatch's parent span, boundary to boundary,
                    # carrying the step index (the trace merge/diff key);
                    # a chunk's args.steps is its width
                    now = time.perf_counter()
                    if chunk_len == 1:
                        self.flight.note_step(
                            state.step, t_bound, now - t_bound, epoch=epoch
                        )
                    else:
                        self.flight.note_step(
                            state.step, t_bound, now - t_bound, kind="chunk",
                            steps=n, epoch=epoch,
                        )
                    t_bound = now
                    tail = self._band_tail(runner)
                    if tail is not None:
                        self.flight.note_band_tail(state.step, n, tail)
                drain()
                # per-step contract: history/logs only at log_every
                # boundaries (here: once per dispatch that crosses one)
                do_log = bool(
                    log_every and state.step // log_every != prev_step // log_every
                )
                pending = (snap, state.step, epoch, float(alphas[n - 1]),
                           state.words_done, do_log, n, mark)
                if (
                    checkpoint_every
                    and checkpoint_cb
                    and state.step // checkpoint_every
                    != prev_step // checkpoint_every
                ):
                    self._run_checkpoint(checkpoint_cb, state)
                if self._check_stop(state):
                    # cooperative stop (preemption): leave at this boundary
                    # with state.step/epoch mid-epoch-consistent, so a
                    # checkpoint of this state resumes exactly here
                    interrupted = "preempted"
                    done = True
                    break
                if max_steps and state.step >= max_steps:
                    done = True
                    break
            if self.flight is not None:
                self.flight.note_step(
                    state.step, t_epoch, time.perf_counter() - t_epoch,
                    kind="epoch", epoch=epoch,
                )
            if done:
                break
            state.epoch = epoch + 1
            skip = 0  # only the resumed epoch re-enters mid-way
        self._finalize(state)
        self._sync()
        wall = time.perf_counter() - t0
        drain()
        state.params = self._detach_params(state.params)
        return state, TrainReport(
            words_per_sec=state.words_done / max(wall, 1e-9),
            total_words=state.words_done,
            steps=state.step,
            wall_time=wall,
            final_loss=self._last_chunk_loss,
            loss_history=loss_hist,
            resident=self.resident_resolution,
            interrupted=interrupted,
            health=self._health.summary(),
            phases=self.phases.report(),
            signals=self._finish_signals(state),
            device_memory=(
                self.devmem.summary() if self.devmem is not None else None
            ),
            dispatch=(
                self.flight.dispatch_totals() if timeline is not None else None
            ),
        )

    @staticmethod
    def _band_tail(runner) -> Optional[bool]:
        """Whether the runner's band steps took the gathered update tail
        (ops/band_step.BandStep.gathered_tail: its last run, a capture its
        replays repeat); None off the band ns step. A list of replica
        runners reads its first."""
        r = runner[0] if isinstance(runner, list) else runner
        return getattr(r.step, "gathered_tail", None)

    def _run_checkpoint(self, checkpoint_cb, state: TrainState) -> None:
        """The checkpoint callback under its phase span; the landing step
        becomes the divergence tripwire's last-good hint."""
        with self.phases.span("checkpoint"):
            checkpoint_cb(state)
        self._health.checkpoint_hint = f"step {state.step}"

    def _dispatch_timeline(self) -> Optional[DispatchTimeline]:
        """The call's dispatch timeline on the trainer's stream, or None:
        on the CPU (no card clock) or with trainer.flight = None."""
        if self.flight is None or self.device.type != "cuda":
            return None
        return DispatchTimeline(
            self.flight, lambda: torch.cuda.Event(enable_timing=True),
            self._stream(),
        )

    def _stream(self):
        """The stream of the trainer's card that its dispatches and their
        metrics copies run on (the trainer's card need not be the
        process's current one)."""
        return torch.cuda.current_stream(self.device)

    def _snapshot(self, metrics: Dict[str, torch.Tensor], done=None):
        """(names, host [len(names), S] tensor, event): a dispatch's
        metrics copied to the host right behind it, so that fetching them
        waits for that dispatch alone and not for the ones issued since
        (the static outputs belong to the next dispatch). On the card the
        copy lands in page-locked memory and the event marks it: `done`
        (the dispatch timeline's end event) or a new one; on the CPU there
        is nothing to wait for."""
        names = tuple(metrics)
        stacked = torch.stack([metrics[k] for k in names])
        if not stacked.is_cuda:
            return names, stacked, None
        host = torch.empty(stacked.shape, dtype=stacked.dtype, pin_memory=True)
        host.copy_(stacked, non_blocking=True)
        if done is None:
            done = torch.cuda.Event()
        done.record(self._stream())
        return names, host, done

    def _note_metrics(
        self, snap, at_step: int, at_epoch: int, at_alpha: float,
        at_words: int, do_log: bool, real_steps: int, mark, t0: float,
        loss_hist: List[float],
    ) -> None:
        """A dispatch's per-step metrics [len(names), S], fetched under the
        device_wait span (this waits only for that dispatch, already
        issued one dispatch earlier): its dispatch timeline row (`mark`,
        read after that wait: elapsed times, no further wait), the loss,
        the flight recorder's counter timeline, the divergence tripwire
        (every real step observed; raises DivergenceError at the budget,
        after the counters are recorded so a dump carries the poisoned
        observation), the non-finite warning, and the log record at the
        log_every boundaries."""
        names, host, done = snap
        with self.phases.span("device_wait"):
            if done is not None:
                self._device_get(done.synchronize)
        if mark is not None:
            DispatchTimeline.close(mark, at_step, real_steps)
        vals = host.numpy()
        if vals.ndim == 3:
            # [names, replicas, S] (parallel/trainer.py): every process's
            # replica rows, summed in replica order, in float32, as the
            # JAX trainer's replica psum sums them
            vals = self._all_replica_rows(vals)
            acc = vals[:, 0]
            for r in range(1, vals.shape[1]):
                acc = acc + vals[:, r]
            vals = acc
        # the pad slots of a partial chunk did not run: observe the real ones
        per_step = dict(zip(names, vals.astype(np.float64)[:, :real_steps]))
        m = {k: v.sum() for k, v in per_step.items()}
        micro = self.config.micro_steps
        if self._hs_route:
            # every fetched dispatch is an observation, whatever the log
            # cadence (the JAX trainer's chunk drain, train.py:1290-1296)
            self._note_tail_dropped(float(m["hs_tail_dropped"]), at_step)
        loss = float(m["loss_sum"]) / max(1.0, float(m["pairs"]))
        self._last_chunk_loss = loss
        if self.flight is not None:
            c = {"loss": loss}
            c.update(health_record(per_step, micro))
            self.flight.note_counters(at_step, c)
        self._health.observe_chunk(per_step, at_step)
        if not np.isfinite(loss) and not self._warned_nonfinite:
            self._warned_nonfinite = True
            warnings.warn(
                f"non-finite loss in the dispatch ending at step {at_step}: "
                "batched-sum updates have diverged. Known cause: extreme "
                "duplicate-row aggregation (tiny vocabulary or hot rows) — "
                "shrink the batch, or set config.scatter_mean=True (see "
                "config.py notes).",
                stacklevel=3,
            )
        if not do_log:
            return
        loss_hist.append(loss)
        if self.log_fn or self.flight is not None:
            dt = time.perf_counter() - t0
            rec = {
                "step": at_step,
                "epoch": at_epoch,
                "alpha": at_alpha,
                "loss": loss,
                "progress": at_words / (self.config.iters * max(1, self.total_words)),
                "words_per_sec": at_words / max(dt, 1e-9),
                "clip_engaged_rows": float(m["clip_engaged"]),
            }
            if self._hs_route:
                # two-tier hs tail-compaction observability
                # (config.hs_tail_slots): slots whose updates the bound
                # dropped; the JAX record carries it on the hs route only
                rec["hs_tail_dropped"] = float(m["hs_tail_dropped"])
            rec.update(health_record(per_step, micro))
            ph = self.phases.snapshot()
            if ph:
                rec["phases"] = ph
            self._log(rec)

    def _note_tail_dropped(self, dropped: float, at_step: int) -> None:
        """Escalate persistent two-tier hs tail overflow from a metric to a
        warning (word2vec_tpu/train.py:1229-1262). The auto compaction
        bound assumes tail lengths are independent across positions
        (ops/hs_step.resolve_tail_slots); bursty corpora can break that.
        One nonzero observation is a spike; two CONSECUTIVE ones mean the
        bound is too tight for this corpus, so say so once, with the fix."""
        if dropped > 0:
            self._tail_drop_streak += 1
        else:
            self._tail_drop_streak = 0
        if self._tail_drop_streak == 2:
            warnings.warn(
                f"hs tail compaction dropped updates in consecutive "
                f"observations (latest: {dropped:.0f} slots at step "
                f"{at_step}). "
                "The auto bound (mean + 6 sigma, independence "
                "approximation) is too tight for this corpus — raise "
                "config.hs_tail_slots or set hs_tail_slots=0 to disable "
                "compaction.",
                stacklevel=2,
            )

    def _device_get(self, fn: Callable):
        """The metrics fetch (`fn` waits for a dispatch): a plain call here;
        bounded across processes (parallel/trainer.py)."""
        return fn()

    def _all_replica_rows(self, vals: np.ndarray) -> np.ndarray:
        """A dispatch's replica metric rows [names, replicas, S]: this
        process's are all of them here (parallel/trainer.py gathers every
        process's)."""
        return vals

    def _setup_resident(self):
        """The device corpus when the resident path is active for this
        run, else None (config.resident; ops/resident.py). Cached: repeated
        train() calls reuse the placed corpus."""
        if not self._resident_ready:
            self._resident_cache = self._build_resident()
            self._resident_ready = True
        return self._resident_cache

    def _build_resident(self):
        cfg = self.config
        if cfg.resident == "off":
            return None
        if cfg.corpus_mode == "streaming":
            # segments replace each other: pinning one on the device would
            # train the same segment forever (resident='on' is refused by
            # the config; 'auto' resolves off here)
            return None
        # auto mode gates on free device memory at call time, so record the
        # resolution and the budget (TrainReport.resident, a log record)
        budget = res.resident_budget_bytes(self.device)
        fits = res.corpus_fits(self.corpus, max_bytes=budget)
        self.resident_resolution = {
            "event": "resident_path",
            "mode": cfg.resident,
            "resolved": "resident" if fits else "streaming",
            "budget_bytes": int(budget),
            "corpus_bytes": int(self.corpus.flat.nbytes + 8 * self.corpus.num_rows),
        }
        self._log(dict(self.resident_resolution))
        if not fits:
            if cfg.resident == "on":
                raise ValueError(
                    f"config.resident='on' but the packed corpus "
                    f"({self.corpus.flat.nbytes >> 20} MiB) exceeds the "
                    f"device-memory budget ({budget >> 20} MiB, half the "
                    f"free memory, capped at ops/resident.RESIDENT_MAX_BYTES)"
                )
            return None
        return self._make_resident_runtime()

    def _make_resident_runtime(self):
        """The corpus placed on the device, once."""
        return res.device_corpus(self.corpus, self.device)

    def _chunk_dispatches(
        self,
        state: TrainState,
        batcher: BatchIterator,
        runner,
        epoch: int,
        skip: int,
        chunk_len: int,
    ) -> Iterator[Tuple[List[int], Callable]]:
        """One epoch's dispatches: an iterator of (words per optimizer
        step, dispatch(alphas, steps) -> metrics), the epoch's preparation
        done first, under the epoch_prep span, so that the batcher_wait
        span of each next() times the batches alone.

        Streaming: host-filled [S, B, L] chunks, staged through page-locked
        memory into the graph's static input (the h2d span), then the
        replays (the dispatch span); the preparation is the batcher's epoch
        start (its shuffle). Resident: the corpus lives on the device, so
        only this epoch's [R] row order goes up (once, in the preparation,
        with the shuffle and the words of each step), and each dispatch
        carries scalars."""
        cfg = self.config
        seed = self.run_seed
        if self._resident is not None:
            with self.phases.span("epoch_prep"):
                order = epoch_order(seed, epoch, self.corpus.num_rows)
                step_words = res.epoch_step_words(
                    self.corpus, order, cfg.batch_rows)
                order_dev = torch.from_numpy(order.astype(np.int32)).to(self.device)

            def resident() -> Iterator[Tuple[List[int], Callable]]:
                for t0 in range(skip, len(step_words), chunk_len):
                    words_list = [int(w) for w in step_words[t0:t0 + chunk_len]]

                    def dispatch(al, n, t0=t0):
                        with self.phases.span("dispatch"):
                            return runner(
                                self._params, self._resident, order_dev, seed,
                                state.step, t0, al, steps=n,
                            )

                    yield words_list, dispatch

            return resident()
        with self.phases.span("epoch_prep"):
            batches = batcher.epoch(epoch, skip)

        def streaming() -> Iterator[Tuple[List[int], Callable]]:
            # filled on this thread: the fill of chunk i+1 runs while the
            # card runs chunk i (a replay returns at once); a producer
            # thread only fought this one for the GIL (slower in both arms,
            # PERF.md)
            for tokens, words_list in chunk_batches(batches, chunk_len):

                def dispatch(al, n, tokens=tokens):
                    with self.phases.span("h2d"):
                        g = runner.stage(self._params, tokens)
                    with self.phases.span("dispatch"):
                        return runner.run(g, self._params, al, seed, state.step, n)

                yield words_list, dispatch

        return streaming()
