"""Online quality telemetry: in-training embedding-quality probes + the
degeneracy sentinel.

A copy of word2vec_tpu/obs/quality.py for the PyTorch port: scoring runs
on the port's query engine and eval/ (serve/query.get_engine,
eval/analogy, eval/similarity) on the device `device=` names (the card
unless the caller asks for the CPU), and QualityProbe.probe moves the
table planes to the host with one `.cpu()` each. The serve CLI's startup
probe (`--probe-pairs`) uses score_table; the trainer runs the probe at
its due dispatch boundaries (train.Trainer.quality_probe).

The pieces:

  ProbeSet        — the held-out probe material: graded similarity pairs,
                    planted analogy questions, and a tracked-word set for
                    neighbor-overlap drift. Synthesized from the vocabulary
                    for planted-structure corpora (utils/synthetic.
                    planted_probe_golds recovers the golds from the
                    generators' word naming) or loaded from user files
                    (--probe-pairs / --probe-analogies). With neither, the
                    probe runs stats-only.
  QualityProbe    — at a configurable cadence of step/sync boundaries
                    a read-only view of the live tables (a plane view
                    via models/params.logical_table, moved to the host
                    once per probe, nothing on non-probe steps) is
                    scored through the serve QueryEngine's batched top-k
                    kernel: planted
                    Spearman + analogy accuracy, Jaccard@k neighbor drift
                    vs the previous probe, and cheap health statistics
                    (row-norm p50/p99, in/out-plane norm ratio, spectral
                    effective rank on a sampled submatrix). Every probe
                    emits one gauge record (w2v_quality_* via the
                    MetricsHub) + one counter event (w2v_quality_probes_
                    total), a probe span + 'C' counters on the TraceRing,
                    and a row in the flight recorder's quality ring — the
                    last N rows ride in every flight.json dump.
  QualitySentinel — turns the static degeneracy fence dynamic: a sustained
                    drop of the planted score below the floor (or below a
                    fraction of its peak, or an effective-rank collapse
                    toward a rank-deficient table) escalates warn ->
                    checkpoint-and-continue -> QualityAlert, mirroring the
                    DivergenceError contract (--quality-budget; budget 0 =
                    warn only). The CLI maps an escaped QualityAlert to
                    EXIT_QUALITY (rc=3) with a flight.json dump whose
                    quality ring carries the probe rows that led there.

`score_table` is the shared scoring core: the probe and the serve CLI's
startup probe (w2v_quality_* gauges on /metrics when serving a table
exported mid-training) call the same function against the same engine
kernels.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..device import DeviceLike

#: process exit code of a QualityAlert abort (cli.py): distinct from 1
#: (usage/crash), 2 (DivergenceError), 75/76 (requeue codes)
EXIT_QUALITY = 3

#: metric keys the sentinel watches, in preference order (first present
#: wins): the planted analogy score collapses hardest in the measured
#: degeneracy domain, so it leads
SENTINEL_WATCH = ("quality_analogy_accuracy", "quality_spearman")


# ------------------------------------------------------------------ probe set
@dataclass
class ProbeSet:
    """Held-out probe material; any subset may be empty (stats-only)."""

    pairs: List[Tuple[str, str, float]] = field(default_factory=list)
    analogies: List[Tuple[str, str, str, str]] = field(default_factory=list)
    tracked: List[str] = field(default_factory=list)
    source: str = "stats-only"

    @classmethod
    def synthesize(
        cls, vocab, max_pairs: int = 64, max_analogies: int = 96,
        track: int = 24,
    ) -> "ProbeSet":
        """Probe golds recovered from a planted-structure vocabulary
        (utils/synthetic.planted_probe_golds); stats-only when the
        vocabulary carries no recognizable planted naming."""
        from ..utils.synthetic import planted_probe_golds

        pairs, questions = planted_probe_golds(
            list(vocab.words), max_pairs=max_pairs,
            max_questions=max_analogies,
        )
        src = "planted" if (pairs or questions) else "stats-only"
        return cls(
            pairs=pairs, analogies=questions,
            tracked=list(vocab.words[:track]), source=src,
        )

    @classmethod
    def from_files(
        cls, vocab, pairs_path: Optional[str] = None,
        analogies_path: Optional[str] = None, track: int = 24,
    ) -> "ProbeSet":
        """User-supplied probe files: pairs in the WS-353 shape
        (eval/similarity.load_word_pairs), analogies in questions-words
        format (eval/analogy.load_questions)."""
        pairs: List[Tuple[str, str, float]] = []
        questions: List[Tuple[str, str, str, str]] = []
        if pairs_path:
            from ..eval.similarity import load_word_pairs

            pairs = load_word_pairs(pairs_path)
        if analogies_path:
            from ..eval.analogy import load_questions

            for _name, qs in load_questions(analogies_path):
                questions.extend(qs)
        # track probe words first (they are what the golds move), padded
        # with the most frequent vocabulary words
        tracked: List[str] = []
        for w1, w2, _ in pairs:
            for w in (w1, w2):
                if w in vocab and w not in tracked:
                    tracked.append(w)
                if len(tracked) >= track:
                    break
            if len(tracked) >= track:
                break
        for w in vocab.words:
            if len(tracked) >= track:
                break
            if w not in tracked:
                tracked.append(w)
        return cls(
            pairs=pairs, analogies=questions, tracked=tracked,
            source="files",
        )


# ------------------------------------------------------------------- scoring
def _effective_rank(M: np.ndarray) -> float:
    """Spectral effective rank exp(H(p)), p = s^2 / sum s^2 — continuous in
    [0, min(M.shape)]; a table collapsing toward rank deficiency drives it
    down long before any single score does. 0.0 for a zero matrix."""
    s = np.linalg.svd(np.asarray(M, np.float64), compute_uv=False)
    tot = float((s * s).sum())
    if tot <= 0.0:
        return 0.0
    p = (s * s) / tot
    p = p[p > 0]
    return float(np.exp(-(p * np.log(p)).sum()))


def score_table(
    W: np.ndarray,
    vocab,
    probe_set: ProbeSet,
    k: int = 10,
    prev_neighbors: Optional[Dict[int, np.ndarray]] = None,
    W_out: Optional[np.ndarray] = None,
    sample_rows: int = 1024,
    rank_rows: int = 256,
    seed: int = 0,
    device: DeviceLike = None,
) -> Tuple[Dict[str, float], Dict[int, np.ndarray]]:
    """Score one table snapshot; returns (record, neighbor_id_sets).

    Everything flows through one serve/query engine on `device`
    (normalize-once, batched top-k): pair cosines for Spearman, score
    planes for the analogy protocol (eval/analogy.evaluate_analogy_sections — the exact
    file-based eval path, so in-training scores are comparable to offline
    ones), and the top-k kernel for the drift sets. Deterministic under a
    fixed seed: the sampled row sets are a pure function of (V, seed).
    """
    from ..serve.query import get_engine

    W = np.asarray(W)
    if W.shape[0] > len(vocab):
        # unadmitted online-growth reserve rows (config.vocab_reserve) are
        # not words: scoring/health stats must not see their random init
        W = W[: len(vocab)]
        if W_out is not None:
            W_out = np.asarray(W_out)[: len(vocab)]
    rec: Dict[str, float] = {}
    eng = get_engine(W, vocab, restrict=len(vocab), device=device)

    if probe_set.pairs:
        from ..eval.similarity import spearman

        ij, gold = [], []
        for w1, w2, g in probe_set.pairs:
            if w1 in vocab and w2 in vocab:
                ij.append((vocab[w1], vocab[w2]))
                gold.append(g)
        if len(gold) >= 3:
            arr = np.asarray(ij, np.int32)
            cos = eng.pair_cosines(arr[:, 0], arr[:, 1])
            rec["quality_spearman"] = round(
                spearman(cos, np.asarray(gold, np.float64)), 4
            )
            rec["quality_pairs_used"] = float(len(gold))

    if probe_set.analogies:
        from ..eval.analogy import evaluate_analogy_sections

        r = evaluate_analogy_sections(
            W, vocab, [("probe", list(probe_set.analogies))],
            restrict_vocab=len(vocab), device=device,
        )
        if r.total:
            rec["quality_analogy_accuracy"] = round(r.accuracy, 4)
            rec["quality_analogy_mean_rank"] = round(r.mean_gold_rank, 3)
        rec["quality_analogy_total"] = float(r.total)
        # computed-but-dropped no more: a probe set full of OOV/degenerate
        # rows must not read as a clean 0-question pass
        rec["quality_analogy_skipped_oov"] = float(r.skipped_oov)
        rec["quality_analogy_skipped_degenerate"] = float(
            r.skipped_degenerate
        )

    # neighbor-overlap drift vs the previous probe (Jaccard@k per tracked
    # word; absent on the first probe)
    tracked_ids = [
        vocab[w] for w in probe_set.tracked
        if w in vocab and vocab[w] < eng.V
    ]
    neighbors: Dict[int, np.ndarray] = {}
    if tracked_ids:
        sets = eng.neighbor_id_sets(np.asarray(tracked_ids, np.int32), k=k)
        neighbors = {i: s for i, s in zip(tracked_ids, sets)}
        if prev_neighbors:
            jac = []
            for i, cur in neighbors.items():
                prev = prev_neighbors.get(i)
                if prev is None:
                    continue
                a, b = set(map(int, cur)), set(map(int, prev))
                denom = len(a | b)
                jac.append(len(a & b) / denom if denom else 1.0)
            if jac:
                rec["quality_drift_jaccard_mean"] = round(
                    float(np.mean(jac)), 4
                )
                rec["quality_drift_jaccard_min"] = round(
                    float(np.min(jac)), 4
                )

    # cheap embedding-health statistics on deterministically sampled rows
    V = W.shape[0]
    rng = np.random.default_rng(seed)
    rows = (
        np.arange(V) if V <= sample_rows
        else np.sort(rng.choice(V, size=sample_rows, replace=False))
    )
    Wf = np.asarray(W, np.float32)
    norms = np.linalg.norm(Wf[rows], axis=1)
    rec["quality_row_norm_p50"] = round(float(np.percentile(norms, 50)), 6)
    rec["quality_row_norm_p99"] = round(float(np.percentile(norms, 99)), 6)
    if W_out is not None:
        out_norms = np.linalg.norm(
            np.asarray(W_out, np.float32)[rows], axis=1
        )
        # the ns output table inits to zeros, so the first probes' ratio is
        # legitimately +Inf — the Prometheus exposition spells it
        med_out = float(np.percentile(out_norms, 50))
        med_in = float(np.percentile(norms, 50))
        rec["quality_norm_ratio_in_out"] = round(
            med_in / med_out, 4
        ) if med_out > 0 else float("inf")
    r_rows = (
        np.arange(V) if V <= rank_rows
        else np.sort(rng.choice(V, size=rank_rows, replace=False))
    )
    rec["quality_effective_rank"] = round(_effective_rank(Wf[r_rows]), 3)
    return rec, neighbors


# ------------------------------------------------------------------ sentinel
class QualityAlert(RuntimeError):
    """Sustained in-training quality degradation past the budget.

    Structured payload mirroring DivergenceError: `.step`, `.metric`,
    `.value`, `.peak`, `.floor`, `.streak`, `.budget`, `.in_domain`, and
    `.record()` for manifests/JSONL."""

    def __init__(
        self,
        step: int,
        metric: str,
        value: Optional[float],
        peak: Optional[float],
        floor: float,
        streak: int,
        budget: int,
        in_domain: bool = False,
        reasons: Optional[List[str]] = None,
    ):
        self.step = step
        self.metric = metric
        self.value = value
        self.peak = peak
        self.floor = floor
        self.streak = streak
        self.budget = budget
        self.in_domain = in_domain
        self.reasons = list(reasons or [])
        domain = (
            " inside the measured band+ns degeneracy domain "
            "(benchmarks/BAND_DEGENERACY_r5.md)" if in_domain else ""
        )
        super().__init__(
            f"embedding quality degraded for {streak} consecutive probes "
            f"(budget {budget}){domain}: {metric}={value} vs peak {peak} "
            f"(floor {floor}) at step {step}; "
            + "; ".join(self.reasons)
        )

    def record(self) -> Dict:
        return {
            "event": "quality_alert",
            "step": self.step,
            "metric": self.metric,
            "value": self.value,
            "peak": self.peak,
            "floor": self.floor,
            "streak": self.streak,
            "budget": self.budget,
            "in_domain": self.in_domain,
            "reasons": self.reasons,
        }


class QualitySentinel:
    """Escalating watch over the probe's score stream.

    Degraded = the watched planted score sits below `floor` (after `grace`
    scored probes — early training legitimately scores low, so the floor
    must not fire before the model had a chance to learn), OR below
    (1 - drop) of its own peak (only once a real peak >= floor exists —
    the learn-then-collapse signature of the band degeneracy,
    BAND_DEGENERACY_r5.md's 0.9997 -> 0.085 trajectory), OR the effective
    rank collapsed below `rank_collapse` of its peak (the drift-toward-
    rank-deficiency signature). Escalation, mirroring the DivergenceError
    contract:

        budget == 0      every degraded probe -> "warn" (log only)
        streak == budget -> "checkpoint" (checkpoint-and-continue, once
                            per degradation window)
        streak >= 2*budget -> raises QualityAlert (cli.py: rc=3)
    """

    def __init__(
        self,
        budget: int = 0,
        floor: float = 0.1,
        drop: float = 0.5,
        rank_collapse: float = 0.25,
        grace: int = 0,
        in_domain: bool = False,
    ):
        self.budget = int(budget)
        self.floor = float(floor)
        self.drop = float(drop)
        self.rank_collapse = float(rank_collapse)
        self.grace = int(grace)
        self._scored = 0
        self.in_domain = bool(in_domain)
        self.peak: Optional[float] = None
        self.rank_peak: Optional[float] = None
        self.streak = 0
        self._checkpointed = False
        self.last_reasons: List[str] = []

    def observe(self, rec: Dict, step: int) -> Optional[str]:
        """One probe record -> None | "warn" | "checkpoint"; raises
        QualityAlert past 2x the budget."""
        metric = next((m for m in SENTINEL_WATCH if m in rec), None)
        score = rec.get(metric) if metric else None
        reasons: List[str] = []
        if score is not None:
            self._scored += 1
            if self.peak is None or score > self.peak:
                self.peak = float(score)
            if score < self.floor and self._scored > self.grace:
                reasons.append(
                    f"{metric} {score:.4f} < floor {self.floor:.4f}"
                )
            elif (
                self.peak is not None
                and self.peak >= self.floor
                and score < (1.0 - self.drop) * self.peak
            ):
                reasons.append(
                    f"{metric} {score:.4f} fell below "
                    f"{1.0 - self.drop:.2f}x its peak {self.peak:.4f}"
                )
        er = rec.get("quality_effective_rank")
        if er is not None:
            if self.rank_peak is None or er > self.rank_peak:
                self.rank_peak = float(er)
            elif er < self.rank_collapse * self.rank_peak:
                reasons.append(
                    f"effective rank {er:.1f} collapsed below "
                    f"{self.rank_collapse:.2f}x its peak "
                    f"{self.rank_peak:.1f}"
                )
        if not reasons:
            self.streak = 0
            self._checkpointed = False
            self.last_reasons = []
            return None
        self.streak += 1
        self.last_reasons = reasons
        if self.budget and self.streak >= 2 * self.budget:
            raise QualityAlert(
                step=step, metric=metric or "quality_effective_rank",
                value=None if score is None else float(score),
                peak=self.peak, floor=self.floor, streak=self.streak,
                budget=self.budget, in_domain=self.in_domain,
                reasons=reasons,
            )
        if self.budget and self.streak >= self.budget and not self._checkpointed:
            self._checkpointed = True
            return "checkpoint"
        return "warn"


# --------------------------------------------------------------------- probe
class QualityProbe:
    """The in-training probe the trainers beat at step/sync boundaries.

    `due(step)` is one integer compare — the non-probe-step cost; `probe()`
    moves the needed table planes to the host, one `.cpu()` each
    (logical_table views, so a unified [V, 2, d] slab is sliced, never
    copied whole host-side), and scores everything host/engine-side, on
    the device the tables live on. `timing` splits the last probe's wall
    into the host copy and the scoring.
    """

    def __init__(
        self,
        vocab,
        probe_set: Optional[ProbeSet] = None,
        every: int = 100,
        k: int = 10,
        sample_rows: int = 1024,
        rank_rows: int = 256,
        log_fn: Optional[Callable[[Dict], None]] = None,
        flight=None,
        sentinel: Optional[QualitySentinel] = None,
        seed: int = 0,
        history: int = 32,
    ):
        self.vocab = vocab
        self.set = probe_set or ProbeSet.synthesize(vocab)
        self.every = int(every)
        self.k = int(k)
        self.sample_rows = int(sample_rows)
        self.rank_rows = int(rank_rows)
        self.log_fn = log_fn
        self.flight = flight
        self.sentinel = sentinel
        self.seed = int(seed)
        self.history: collections.deque = collections.deque(
            maxlen=max(1, history)
        )
        self.probes = 0
        self.last_step = 0
        #: the last probe's wall split, ms: {"copy_ms", "score_ms"}
        self.timing: Dict[str, float] = {}
        self._prev_neighbors: Optional[Dict[int, np.ndarray]] = None
        #: checkpoint-and-continue hook (the CLI wires the run's checkpoint
        #: callback); called once per sentinel degradation window
        self.checkpoint_fn: Optional[Callable[[], None]] = None

    # ------------------------------------------------------------- cadence
    def due(self, step: int) -> bool:
        """Distance-based, not modulo: chunked dispatch advances the step
        counter by whole chunks and must not skip over a boundary."""
        return (
            self.every > 0 and step > 0
            and step - self.last_step >= self.every
        )

    # -------------------------------------------------------------- probing
    def probe(self, params: Dict, step: int) -> Dict:
        """Score the live tables at `step`. Raises QualityAlert when the
        sentinel's escalation crosses 2x its budget."""
        from ..models.params import logical_table

        t0 = time.perf_counter()
        self.last_step = int(step)
        views = {"emb_in": logical_table(params, "emb_in")}
        try:
            views["emb_out_ns"] = logical_table(params, "emb_out_ns")
        except KeyError:
            pass  # hs runs: no ns output plane, the ratio stat is skipped
        host = {k: v.detach().float().cpu().numpy() for k, v in views.items()}
        t_copy = time.perf_counter()
        rec: Dict = {"step": int(step)}
        scores, neighbors = score_table(
            host["emb_in"],
            self.vocab,
            self.set,
            k=self.k,
            prev_neighbors=self._prev_neighbors,
            W_out=host.get("emb_out_ns"),
            sample_rows=self.sample_rows,
            rank_rows=self.rank_rows,
            seed=self.seed,
            device=views["emb_in"].device,
        )
        rec.update(scores)
        self._prev_neighbors = neighbors
        dur = time.perf_counter() - t0
        rec["quality_probe_ms"] = round(1e3 * dur, 3)
        # the probe's wall split: the planes' host copy (which also waits
        # for the steps still queued on the card) and the scoring
        self.timing = {
            "copy_ms": 1e3 * (t_copy - t0),
            "score_ms": 1e3 * (t0 + dur - t_copy),
        }
        self.probes += 1
        self.history.append(dict(rec))

        if self.flight is not None:
            # probe span + counter events on the trace timeline, plus the
            # quality ring every flight.json dump embeds
            self.flight.ring.complete(
                "quality_probe", t0, dur, args={"step": int(step)}
            )
            self.flight.ring.counter(
                "quality",
                {k: v for k, v in rec.items()
                 if k != "step" and isinstance(v, (int, float))},
            )
            self.flight.note_quality(rec)
        self._log(rec)
        # present-from-zero counter (obs/export.EVENT_COUNTERS)
        self._log({"event": "quality_probe", "step": int(step)})

        if self.sentinel is not None:
            try:
                action = self.sentinel.observe(rec, step)
            except QualityAlert as e:
                self._log(e.record())
                if self.flight is not None:
                    self.flight.note_quality(e.record())
                raise
            if action == "checkpoint":
                if self.checkpoint_fn is not None:
                    self.checkpoint_fn()
                self._log({
                    "event": "quality_checkpoint",
                    "step": int(step),
                    "streak": self.sentinel.streak,
                    "reasons": self.sentinel.last_reasons,
                })
            elif action == "warn":
                self._log({
                    "event": "quality_warn",
                    "step": int(step),
                    "streak": self.sentinel.streak,
                    "budget": self.sentinel.budget,
                    "reasons": self.sentinel.last_reasons,
                })
        return rec

    def _log(self, rec: Dict) -> None:
        if self.flight is not None and "event" in rec:
            self.flight.log_record(rec)
        if self.log_fn is not None:
            self.log_fn(rec)
