"""The continuous-training driver: segments in, trained tables out.

A copy of word2vec_tpu/stream/driver.py for the PyTorch port, with the
same records, keys, cursor document and report. `StreamRun` composes the
pieces the trainer already has into the continuous-training data plane:

  * SEGMENTS — the source (stream/source.py) is consumed one bounded
    segment at a time; each segment is packed (data/batcher.PackedCorpus)
    and trained by one ordinary Trainer.train call (set_corpus, then
    seed_offset = the segment index), so chunked dispatch, the CUDA-graph
    replays, the watchdog, the signal plane and the quality probe all apply
    unchanged. The NEXT segment's read and count run in a producer thread
    (`prefetch` below, with the producer-death contract), so shard IO and
    tokenization overlap the card's training at segment granularity. The
    device-resident corpus path is off by construction: segments replace
    each other.

  * CURSOR — `self.cursor` always names the start of the segment being
    trained plus the run-global counters; every checkpoint written during
    a segment carries it (io/checkpoint.save_checkpoint(stream=...)), so
    SIGTERM at any step resumes by re-reading the same segment from the
    same start and re-entering it mid-epoch (Trainer._resume_skip),
    bitwise on the uninterrupted trajectory (tests/test_torch_stream.py).

  * GROWTH — at a segment boundary, words the consumed segment saw that
    are not yet in the vocabulary are admitted into reserved table rows
    (config.vocab_reserve; deterministic order: count desc, ties
    lexicographic), the frequency-derived device tables are rebuilt and
    the step is captured again (Trainer.refresh_vocab_tables), and the
    vocab generation advances. Existing rows (ids, words, counts and the
    embedding rows themselves) are untouched, which is what lets a grown
    vocabulary pass the compatible-superset resume guard
    (data/vocab.Vocab.content_hash(limit=...)). Segment encoding happens
    AFTER the boundary growth (the producer thread reads and counts raw
    tokens only), so the vocabulary that encodes segment s is always
    "every admission from segments < s", the property the mid-segment
    resume replay depends on.

  * SWAP — at boundaries, the live input table is copied to the host once
    (the logical emb_in plane, as float32) and swapped into an attached
    serve.QueryEngine, gated by the planted golds the QualityProbe scores:
    a table scoring under `swap_floor` is REFUSED and the engine keeps
    serving the previous one. No request drops either way
    (QueryEngine.swap_table flips references between batches).

The trainer may be a parallel.ShardedTrainer (one process, dp replicas):
its set_corpus restarts the sync cadence with the segment's counters, and
every segment's train() ends on a replica sync and returns the synced
tables. Growth is deterministic over one process's own stream; with
several processes (parallel/multihost.py) StreamRun refuses
vocab_reserve > 0, as the JAX driver does: ranks read different shards, so
their vocabularies would diverge.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..data.batcher import PAD, PackedCorpus
from ..train import TrainReport, TrainState
from .source import RawSegment, StreamCursor

#: config.segment_tokens == 0 resolves here
DEFAULT_SEGMENT_TOKENS = 4_000_000


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch (a copy of the JAX package's
    data/batcher.prefetch): the segment producer. The trainer's dispatches
    return at once while the card runs, so the producer's reads overlap the
    card's training. If the consumer abandons the generator early (an
    exception in the training loop, GeneratorExit), the producer thread is
    signalled to stop rather than blocking forever on the bounded queue.

    Producer-failure contract: an exception anywhere in the producer
    RE-RAISES in the consumer after the items produced before it drain; it
    never hangs the consumer or silently ends the stream short. The
    consumer's queue wait is also guarded against the producer dying
    without its sentinel (interpreter teardown killing the daemon thread):
    a dead producer with an empty queue raises RuntimeError instead of
    blocking forever.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err: List[BaseException] = []

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in iterator:
                if not _put(item):
                    return
        except BaseException as e:  # propagate into consumer
            err.append(e)
        finally:
            _put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            try:
                item = q.get(timeout=1.0)
            except queue.Empty:
                if not t.is_alive() and q.empty():
                    # sentinel never arrived: the producer was torn down
                    # without running its finally (daemon-thread kill)
                    if err:
                        raise err[0]
                    raise RuntimeError(
                        "prefetch producer thread died without a sentinel"
                    )
                continue
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def encode_segment(raw: RawSegment, vocab, fmt: str = "text8") -> np.ndarray:
    """Segment -> flat id stream with the given vocabulary. text8
    semantics: one unbroken stream (PackedCorpus cuts rows at
    max_sentence_len); lines: -1 separators between sentences. OOV drops
    silently, exactly like the resident encode (Word2Vec.cpp:223)."""
    if raw.flat is not None:
        return raw.flat
    lines = fmt == "lines"
    pieces = []
    sep = np.asarray([PAD], dtype=np.int32)
    for s in raw.sentences or []:
        ids = vocab.encode(s)
        if len(ids) == 0:
            continue
        if lines and pieces:
            pieces.append(sep)
        pieces.append(ids)
    if not pieces:
        return np.empty(0, dtype=np.int32)
    return np.concatenate(pieces)


def admission_order(
    counts: Dict[str, int], vocab, min_count: int, cap: int
) -> List[Tuple[str, int]]:
    """The deterministic admission list: candidate words (count >=
    min_count within the consumed segment, not already in the vocabulary)
    ordered by count desc, ties lexicographic — the same comparator the
    initial vocabulary sort uses (data/vocab.Vocab.from_counter) — capped
    to the remaining reserve."""
    eligible = [
        (w, int(c)) for w, c in counts.items()
        if c >= min_count and w not in vocab
    ]
    eligible.sort(key=lambda wc: (-wc[1], wc[0]))
    return eligible[: max(0, int(cap))]


def table_capacity(params: Dict) -> int:
    """Total embedding rows (live vocab + reserved), from the params
    themselves — the one place capacity survives growth and resume."""
    from ..models.params import logical_table

    return int(logical_table(params, "emb_in").shape[0])


def gate_table(
    W: np.ndarray, vocab, probe_set, floor: float, device=None
) -> Tuple[bool, Dict]:
    """Score a swap candidate through the SAME planted golds the
    QualityProbe uses (obs/quality.score_table on the serve query engine,
    on `device`: the card unless the caller asks for the CPU). The gate
    watches the planted analogy accuracy when the probe set carries
    analogies, else planted Spearman; with no golds at all the swap is
    ungated (gate='none') — refusing on missing evidence would make swaps
    impossible on unlabelled corpora."""
    from ..obs.quality import score_table

    rec, _ = score_table(W, vocab, probe_set, device=device)
    metric = None
    name = "none"
    if "quality_analogy_accuracy" in rec:
        metric, name = rec["quality_analogy_accuracy"], "analogy_accuracy"
    elif "quality_spearman" in rec:
        metric, name = rec["quality_spearman"], "spearman"
    ok = metric is None or float(metric) >= float(floor)
    return ok, {
        "gate": name,
        "score": None if metric is None else float(metric),
        "floor": float(floor),
        **{k: v for k, v in rec.items() if isinstance(v, (int, float))},
    }


class StreamRun:
    """Drive a Trainer continuously over a stream source.

    `train()` matches the Trainer.train signature the CLI already calls
    (state/log_every/checkpoint_cb/checkpoint_every -> (state, report)),
    so the streaming path drops into cli.py where `run_train` is chosen.
    The TrainState it takes/returns carries SEGMENT-LOCAL counters (the
    replay coordinate within the in-progress segment); run-global totals
    live on the cursor and the returned TrainReport.
    """

    def __init__(
        self,
        trainer,
        source,
        *,
        cursor: Optional[StreamCursor] = None,
        min_count: Optional[int] = None,
        swap_engine=None,
        swap_floor: float = 0.0,
        probe_set=None,
        fault_plan=None,
        max_segments: int = 0,
        max_tokens: int = 0,
        log_fn: Optional[Callable[[Dict], None]] = None,
    ):
        self.trainer = trainer
        self.source = source
        self.cursor = cursor or StreamCursor()
        self.min_count = (
            trainer.config.min_count if min_count is None else int(min_count)
        )
        self.swap_engine = swap_engine
        self.swap_floor = float(swap_floor)
        self.probe_set = probe_set
        self.fault_plan = fault_plan
        self.max_segments = int(max_segments)
        self.max_tokens = int(max_tokens)
        self.log_fn = log_fn
        self.swaps = 0
        self.swaps_refused = 0
        self.growths = 0
        self.segments_done = 0
        self._forced_growth = 0
        self._capacity: Optional[int] = None
        from ..parallel.multihost import process_count

        if process_count() > 1 and trainer.config.vocab_reserve > 0:
            raise ValueError(
                "vocab_reserve > 0 with process_count > 1: per-rank streams "
                "would admit divergent vocabularies (rank-local counts); "
                "online growth is single-process today — run the fleet with "
                "vocab_reserve=0 or stream through one process"
            )

    # ---------------------------------------------------------- chaos hook
    def force_growth(self, n: int) -> None:
        """`vocab_growth@k` fault (resilience/faults.py): admit `n`
        synthetic words at the next boundary even if the corpus brought
        none — the chaos matrix's way of exercising the growth path
        (table rebuild + recompile + generation bump) on any stream."""
        self._forced_growth = max(self._forced_growth, int(n))

    # ------------------------------------------------------------ plumbing
    def cursor_meta(self) -> Dict:
        """The stream.json document every checkpoint of this run carries."""
        doc = self.cursor.to_json()
        doc["schema"] = 1
        doc["source"] = self.source.describe()
        doc["capacity"] = self._capacity
        doc["swaps"] = self.swaps
        doc["growths"] = self.growths
        return doc

    def _log(self, rec: Dict) -> None:
        tr = self.trainer
        if tr.flight is not None and "event" in rec:
            tr.flight.log_record(rec)
        fn = self.log_fn or tr.log_fn
        if fn is not None:
            fn(rec)

    def _emit_stream_record(self) -> None:
        """One 'stream' gauge record (obs/export.GAUGE_EVENTS):
        w2v_vocab_size / w2v_stream_tokens_total / w2v_stream_segment /
        w2v_vocab_generation, present from the run's first boundary. When
        the HBM ledger is live (obs/devmem.py) the record also carries the
        growth-headroom forecast — rows the device could still absorb at
        the realized bytes/row — so a dashboard sees `--vocab-reserve`
        running out of budget segments before it happens."""
        rec = {
            "event": "stream",
            "vocab_size": len(self.trainer.vocab),
            "stream_tokens_total": int(self.cursor.tokens_total),
            "stream_segment": int(self.cursor.segment),
            "vocab_generation": int(self.cursor.vocab_generation),
            "stream_swaps": self.swaps,
            "stream_growths": self.growths,
        }
        ledger = getattr(self.trainer, "devmem", None)
        if ledger is not None:
            fc = ledger.forecast() or {}
            if fc.get("rows_remaining") is not None:
                rec["stream_growth_rows_remaining"] = fc["rows_remaining"]
        self._log(rec)

    # ------------------------------------------------------------- reading
    def _raw_segments(self):
        """Sequential segment reads from the cursor on — runs in the
        prefetch PRODUCER thread, so shard IO/tokenization of segment s+1
        overlaps the device training of segment s. Only reads and counts:
        ENCODING stays on the consumer side, after any boundary growth."""
        index = int(self.cursor.segment)
        shard = int(self.cursor.shard)
        offset = int(self.cursor.offset)
        read = 0
        while True:
            raw = self.source.read_segment(
                index, shard, offset, vocab=self.trainer.vocab
            )
            if raw.raw_tokens == 0:
                return
            yield raw
            if raw.exhausted:
                return
            index += 1
            shard, offset = raw.shard1, raw.offset1
            read += raw.raw_tokens
            if self.max_segments and index - self.cursor.segment >= self.max_segments:
                return
            if self.max_tokens and read >= self.max_tokens:
                return

    def _encode(self, raw: RawSegment) -> np.ndarray:
        """Segment -> flat ids, with the LIVE (post-growth) vocabulary —
        always called AFTER any boundary growth, so the encoding vocab of
        segment s is a pure function of the stream up to s (the resume
        replay invariant)."""
        return encode_segment(
            raw, self.trainer.vocab, getattr(self.source, "fmt", "text8")
        )

    # ------------------------------------------------------------ boundary
    def _advance(self, raw: RawSegment, steps: int, words: int) -> None:
        self.cursor = StreamCursor(
            segment=raw.index + 1,
            shard=raw.shard1,
            offset=raw.offset1,
            vocab_generation=self.cursor.vocab_generation,
            tokens_total=self.cursor.tokens_total + raw.raw_tokens,
            global_steps=int(steps),
            global_words=int(words),
        )

    def _maybe_grow(self, raw: RawSegment) -> int:
        cap = self._capacity or 0
        vocab = self.trainer.vocab
        reserve_left = cap - len(vocab)
        items: List[Tuple[str, int]] = []
        if raw.counts and reserve_left > 0:
            items = admission_order(
                raw.counts, vocab, self.min_count, reserve_left
            )
        if self._forced_growth and reserve_left > len(items):
            gen = self.cursor.vocab_generation
            synth = [
                (f"__chaos_g{gen}_{i}", self.min_count)
                for i in range(self._forced_growth)
            ]
            items = (items + [
                s for s in synth if s[0] not in vocab
            ])[:reserve_left]
        self._forced_growth = 0
        if not items:
            return 0
        ids = vocab.admit(items)
        self.cursor.vocab_generation += 1
        self.growths += 1
        # frequency-derived device tables (keep_probs / alias sampler) now
        # cover the admitted rows; the step is captured again at the next
        # dispatch — growth is rare, and the boundary is already a sync
        # boundary (train() ended with one)
        self.trainer.refresh_vocab_tables()
        self._log({
            "event": "vocab_growth",
            "segment": raw.index,
            "admitted": len(ids),
            "first_id": int(ids[0]),
            "vocab_size": len(vocab),
            "generation": int(self.cursor.vocab_generation),
            "reserve_left": int(cap - len(vocab)),
        })
        return len(ids)

    def _maybe_swap(self, state: TrainState, segment: int) -> None:
        if self.swap_engine is None:
            return
        from ..models.params import logical_table

        vocab = self.trainer.vocab
        # one host copy of the live rows, as float32 (the engine
        # normalizes and accumulates in float64 itself)
        W = np.asarray(
            logical_table(state.params, "emb_in")[: len(vocab)]
            .float().cpu().numpy(),
            np.float32,
        )
        probe_set = self.probe_set
        if probe_set is None:
            from ..obs.quality import ProbeSet

            probe_set = self.probe_set = ProbeSet.synthesize(vocab)
        ok, rec = gate_table(
            W, vocab, probe_set, self.swap_floor, device=self.trainer.device
        )
        if ok:
            # snapshot the vocab: the engine must not see future admits
            # mid-decode (the live object keeps growing)
            from ..data.vocab import Vocab

            snap = Vocab(list(vocab.words), vocab.counts.copy())
            self.swap_engine.swap_table(W, vocab=snap)
            self.swaps += 1
            self._log({
                "event": "table_swap", "segment": segment,
                "vocab_size": len(snap), **rec,
            })
        else:
            self.swaps_refused += 1
            self._log({
                "event": "table_swap_refused", "segment": segment, **rec,
            })

    # ----------------------------------------------------------------- api
    def train(
        self,
        state: Optional[TrainState] = None,
        log_every: int = 50,
        checkpoint_cb: Optional[Callable[[TrainState], None]] = None,
        checkpoint_every: int = 0,
    ) -> Tuple[TrainState, TrainReport]:
        tr = self.trainer
        cfg = tr.config
        t0 = time.perf_counter()
        if state is None:
            state = tr.init_state()
        tr.last_state = state
        self._capacity = table_capacity(state.params)
        self._emit_stream_record()
        interrupted: Optional[str] = None
        loss_hist: List[float] = []
        last_report: Optional[TrainReport] = None
        steps_total = int(self.cursor.global_steps)
        words_total = int(self.cursor.global_words)
        words_entry = words_total  # words trained by PRIOR generations
        gen = prefetch(self._raw_segments(), depth=1)
        try:
            for raw in gen:
                if self.fault_plan is not None:
                    self.fault_plan.on_segment(raw.index, self)
                flat = self._encode(raw)
                trainable = flat.size and bool((flat >= 0).any())
                if trainable:
                    corpus = PackedCorpus.from_flat(
                        flat, cfg.max_sentence_len
                    )
                    tr.set_corpus(corpus)
                    # per-segment draw/shuffle stream: a pure function of
                    # (config.seed, segment index), so segments do not
                    # repeat each other's negative draws and a resumed
                    # segment replays exactly (train.Trainer.seed_offset)
                    tr.seed_offset = raw.index
                    self._log({
                        "event": "stream_segment",
                        "segment": raw.index,
                        "raw_tokens": raw.raw_tokens,
                        "encoded_tokens": int(corpus.num_tokens),
                        "rows": int(corpus.num_rows),
                        "shard": raw.shard0,
                        "offset": raw.offset0,
                    })
                    state, rep = tr.train(
                        state=state, log_every=log_every,
                        checkpoint_cb=checkpoint_cb,
                        checkpoint_every=checkpoint_every,
                    )
                    last_report = rep
                    loss_hist.extend(rep.loss_history)
                    if rep.interrupted:
                        # cursor still names this segment's start; the
                        # seg-local state is the replay coordinate
                        interrupted = rep.interrupted
                        break
                    steps_total += state.step
                    words_total += state.words_done
                self._advance(raw, steps_total, words_total)
                self.segments_done += 1
                self._maybe_grow(raw)
                self._maybe_swap(state, raw.index)
                state = TrainState(params=state.params)  # fresh seg counters
                tr.last_state = state
                self._emit_stream_record()
                if checkpoint_cb is not None and checkpoint_every:
                    # boundary checkpoint: the advanced cursor, any growth,
                    # and the segment's params land together — a preemption
                    # between segments loses nothing
                    checkpoint_cb(state)
        finally:
            gen.close()
        wall = time.perf_counter() - t0
        if interrupted:
            steps_total += state.step
            words_total += state.words_done
        report = TrainReport(
            words_per_sec=(words_total - words_entry) / max(wall, 1e-9),
            total_words=words_total,
            steps=steps_total,
            wall_time=wall,
            final_loss=(
                last_report.final_loss if last_report else float("nan")
            ),
            loss_history=loss_hist,
            resident=None,
            phases=last_report.phases if last_report else None,
            health=last_report.health if last_report else None,
            interrupted=interrupted,
            signals=last_report.signals if last_report else None,
            device_memory=(
                last_report.device_memory if last_report else None
            ),
        )
        report.stream = {
            "source": self.source.describe(),
            "segments": self.segments_done,
            "tokens_total": int(self.cursor.tokens_total),
            "vocab_size": len(tr.vocab),
            "vocab_generation": int(self.cursor.vocab_generation),
            "growths": self.growths,
            "swaps": self.swaps,
            "swaps_refused": self.swaps_refused,
            "cursor": self.cursor.to_json(),
        }
        return state, report
