"""Derived-signal plane: windowed time series over streams that already exist.

A copy of word2vec_tpu/obs/signals.py for the PyTorch port (host code).
The trainer (train.py) beats it in training mode, the serve tier in serve
mode; the training-mode phase split reads obs/phases.py's tuples.

The other telemetry layers are per-process and RAW: health counters,
trace spans, `w2v_serve_*` gauges, quality rows. A control loop (serve
autoscale, elastic shrink/grow policy) cannot subscribe to raw streams — it
needs *derived, decision-grade signals*: "throughput over the last window,
versus its own baseline", "is one host 4x slower than the fleet median". This
module is that derivation layer:

  SignalEngine  — a small windowed time-series engine. Training mode: the
                  trainers beat `on_boundary(step, words_done)` at every
                  step/chunk boundary (one clock read + integer compare off
                  the window edge — ZERO device fetches, the same contract as
                  the watchdog beat); every `window` steps the engine closes a
                  window and derives named signals from host-side state it
                  already has:

                    throughput_wps     words trained / window wall
                    step_time_p50_ms   p50/p90 of boundary-to-boundary time
                    input_bound_ratio  input-stall fraction from the
                                       PhaseRecorder's span totals delta
                    straggler_skew     worst-host p50 / fleet median, from
                                       the PeerAgreement heartbeat rows
                                       (multi-process only)
                    quality_planted    the QualityProbe's planted score
                                       (fed from its gauge records)

                  Serve mode (`window_s`): the server feeds ServeStats
                  snapshots and the engine derives serve_qps / serve_p99_ms /
                  cache_hit per wall-clock window.

  Signal        — one named series: a bounded ring of (window, value) with
                  EWMA / p50 / p90 / per-window slope stats.

  SignalBus     — subscribe(name, cb): the control-ready pub/sub surface.
                  Shipped read-only: the fleet-health verdict in TrainReport
                  and `python -m word2vec_tpu.obs.watch` consume it; serve
                  autoscale (ROADMAP 1d) and elastic policy (5b) are the
                  intended writers-of-actions later. Callbacks are isolated —
                  a raising subscriber is warned and dropped, never allowed
                  to kill a training step.

Windows are identified by `step // window` (as the trace merge aligns):
hosts share no clock, but they do share the step counter, so window ids are
comparable across the fleet and obs/fleet.py can merge per-host rows
deterministically. (Serve replicas share no step counter either; serve mode
keys windows on epoch seconds // window_s instead — NTP-grade alignment,
good enough for dashboard-and-policy aggregation.)

Each closed window emits ONE compact row: an "event":"signals" record on the
run's MetricsHub (numeric fields become `w2v_signal_*` gauges via
obs/export.GAUGE_EVENTS), a line in `signals_p<host>.jsonl` under
--metrics-dir (the fleet aggregator's input), a row on the flight recorder's
bounded signal ring (every flight.json carries the recent signal history),
and a publish on the bus. SLO rules (obs/slo.py) are evaluated against the
same row — breach maps to a structured event, NEVER an exit: the plane
observes, it does not actuate (`slo=` takes an obs/slo.SloEvaluator,
`aggregator=` an obs/fleet.FleetAggregator).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

from .phases import COMPUTE_PHASES, INPUT_PHASES

#: default optimizer steps per derived-signal window (training mode)
WINDOW_STEPS_DEFAULT = 50
#: default seconds per window (serve mode)
WINDOW_SECS_DEFAULT = 10.0
#: per-signal ring depth: stats come from the most recent windows
RING_WINDOWS = 256
#: default EWMA smoothing factor (weight of the newest window)
EWMA_ALPHA = 0.3

#: cumulative step-time histogram bucket bounds, seconds (le-style; +Inf is
#: implicit). Spans CPU-smoke chunk walls down to on-chip step times.
STEP_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
    10.0,
)


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile (same convention as serve/metrics.py and
    profiling.lap_stats: no interpolation)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))
    return s[idx]


def ewma(values: List[float], alpha: float = EWMA_ALPHA) -> float:
    """Exponentially-weighted moving average, oldest-first input."""
    if not values:
        return 0.0
    acc = float(values[0])
    for v in values[1:]:
        acc = alpha * float(v) + (1.0 - alpha) * acc
    return acc


def slope(points: List) -> float:
    """Least-squares slope of (x, y) points — the signal's per-window trend
    (value units per window). 0.0 with fewer than two distinct x."""
    if len(points) < 2:
        return 0.0
    xs = [float(x) for x, _ in points]
    ys = [float(y) for _, y in points]
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    den = sum((x - mx) ** 2 for x in xs)
    if den <= 0.0:
        return 0.0
    return sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / den


class Histogram:
    """Cumulative histogram in Prometheus semantics: per-bucket counts are
    monotonic totals (le-bounded), plus _sum and _count — the aggregatable
    form a p99 GAUGE can never be (you cannot merge per-replica p99s, but
    you can sum per-replica bucket counts). Rendered by
    obs/export.PrometheusTextfile from any record key ending in `_hist`."""

    def __init__(self, buckets=STEP_TIME_BUCKETS):
        self.le = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.le) + 1)  # last slot = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, bound in enumerate(self.le):
            if v <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def to_record(self) -> Dict:
        """The exposition payload (cumulative le counts, the wire shape the
        Prometheus sink renders as _bucket/_sum/_count)."""
        cum, acc = [], 0
        for c in self.counts:
            acc += c
            cum.append(acc)
        return {
            "le": list(self.le),
            "counts": cum,
            "sum": round(self.sum, 6),
            "count": self.count,
        }


class Signal:
    """One named windowed series with ring-bounded stats."""

    def __init__(self, name: str, ring: int = RING_WINDOWS):
        self.name = name
        self._ring: collections.deque = collections.deque(maxlen=ring)

    def observe(self, window: int, value: float) -> None:
        self._ring.append((int(window), float(value)))

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def last(self) -> Optional[float]:
        return self._ring[-1][1] if self._ring else None

    def stats(self) -> Dict:
        pts = list(self._ring)
        vals = [v for _, v in pts]
        if not vals:
            return {"n": 0}
        return {
            "n": len(vals),
            "last": round(vals[-1], 6),
            "ewma": round(ewma(vals), 6),
            "p50": round(percentile(vals, 0.50), 6),
            "p90": round(percentile(vals, 0.90), 6),
            "slope_per_window": round(slope(pts), 6),
        }


class SignalBus:
    """Named-topic pub/sub for derived signals. `subscribe` returns an
    unsubscribe callable; a raising callback is warned and DETACHED (the
    bus must never kill the step loop that publishes into it)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: Dict[str, List[Callable]] = {}

    def subscribe(self, name: str, cb: Callable[[Dict], None]) -> Callable[[], None]:
        with self._lock:
            self._subs.setdefault(name, []).append(cb)

        def unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs.get(name, []).remove(cb)
                except ValueError:
                    pass

        return unsubscribe

    def topics(self) -> List[str]:
        with self._lock:
            return sorted(k for k, v in self._subs.items() if v)

    def publish(self, name: str, payload: Dict) -> None:
        with self._lock:
            cbs = list(self._subs.get(name, ()))
        for cb in cbs:
            try:
                cb(payload)
            except Exception as e:  # noqa: BLE001 — see class docstring
                warnings.warn(
                    f"signal bus subscriber {cb!r} on {name!r} raised "
                    f"{e!r}; detaching it",
                    stacklevel=2,
                )
                with self._lock:
                    try:
                        self._subs.get(name, []).remove(cb)
                    except ValueError:
                        pass


class FleetHealth:
    """Read-only bus consumer: the fleet-health verdict TrainReport carries.
    Tracks the worst SLO state seen and the last fleet/signals row — a
    one-glance "did the run stay inside its SLOs, and who lagged"."""

    _RANK = {"ok": 0, "warn": 1, "breach": 2}

    def __init__(self, bus: SignalBus):
        self._lock = threading.Lock()
        self.state = "ok"
        self.worst_state = "ok"
        self.breaches = 0
        self.warns = 0
        self.last_fleet: Optional[Dict] = None
        self.last_window: Optional[int] = None
        self._unsubs = [
            bus.subscribe("slo", self._on_slo),
            bus.subscribe("fleet", self._on_fleet),
            bus.subscribe("signals", self._on_signals),
        ]

    def _on_slo(self, ev: Dict) -> None:
        state = {"slo_breach": "breach", "slo_warn": "warn"}.get(
            ev.get("event"), "ok"
        )
        with self._lock:
            self.state = state
            if self._RANK[state] > self._RANK[self.worst_state]:
                self.worst_state = state
            if state == "breach":
                self.breaches += 1
            elif state == "warn":
                self.warns += 1

    def _on_fleet(self, row: Dict) -> None:
        with self._lock:
            self.last_fleet = dict(row)

    def _on_signals(self, row: Dict) -> None:
        with self._lock:
            self.last_window = row.get("window")

    def verdict(self) -> Dict:
        with self._lock:
            out = {
                "verdict": self.worst_state,
                "current": self.state,
                "slo_breaches": self.breaches,
                "slo_warns": self.warns,
                "windows": self.last_window,
            }
            if self.last_fleet:
                out["fleet_hosts"] = self.last_fleet.get("fleet_hosts")
                out["fleet_throughput_wps"] = self.last_fleet.get(
                    "fleet_throughput_wps"
                )
                if self.last_fleet.get("fleet_straggler_host") is not None:
                    out["straggler_host"] = self.last_fleet.get(
                        "fleet_straggler_host"
                    )
            return out

    def close(self) -> None:
        for u in self._unsubs:
            u()


class SignalEngine:
    """The per-process signal plane: windowed derivation + row publishing.

    Training mode (the default): construct with `window` steps and beat
    `on_boundary(step, words_done)` from the step loop (Trainer._check_stop
    does this). Serve mode: construct with `window_s` seconds and feed
    `observe_serve(stats_record)` from the stats loop.

    The engine is also a MetricsHub SINK (`engine(record)`): registered on
    the run's hub it harvests the quality probe's gauge records (and, in
    serve mode, the stats snapshots) without any new plumbing. Its own
    published rows carry "event":"signals" and are ignored on re-entry.
    """

    def __init__(
        self,
        window: int = WINDOW_STEPS_DEFAULT,
        window_s: Optional[float] = None,
        phases=None,
        flight=None,
        log_fn: Optional[Callable[[Dict], None]] = None,
        metrics_dir: Optional[str] = None,
        host: int = 0,
        slo=None,
        bus: Optional[SignalBus] = None,
        aggregator=None,
    ):
        self.window = max(1, int(window))
        self.window_s = float(window_s) if window_s else None
        self.phases = phases
        self.flight = flight
        self.log_fn = log_fn
        self.metrics_dir = metrics_dir
        self.host = int(host)
        #: SLO evaluator (obs/slo.SloEvaluator) run against every closed
        #: window's signal values; its events route back through _emit_event
        self.slo = slo
        self.bus = bus or SignalBus()
        self.health = FleetHealth(self.bus)
        #: rank-0 fleet aggregator (obs/fleet.FleetAggregator) run after
        #: every window close — None on non-primary hosts
        self.aggregator = aggregator
        self._lock = threading.Lock()
        self._signals: Dict[str, Signal] = {}
        self._windows_closed = 0
        self._rows_file = None
        self._rows_path = None
        if metrics_dir:
            os.makedirs(metrics_dir, exist_ok=True)
            self._rows_path = os.path.join(
                metrics_dir, f"signals_p{self.host}.jsonl"
            )
            # line-buffered append: rows must be visible to a concurrently
            # running aggregator/watcher, like the jsonl metrics sink
            self._rows_file = open(self._rows_path, "a", buffering=1)
        # --------------------------- training-window accumulation state
        self._win_id: Optional[int] = None
        self._win_t0 = 0.0
        self._win_words0 = 0
        self._win_step0 = 0
        self._win_durs: List[float] = []
        self._last_t: Optional[float] = None
        self._last_step: Optional[int] = None
        self._phase_base: Dict[str, float] = {}
        self.step_hist = Histogram()
        # latest values harvested from other streams, picked up at close
        self._latest: Dict[str, float] = {}
        self._heartbeat: Optional[Dict] = None
        # --------------------------------------- serve-window state
        self._serve_win: Optional[int] = None
        self._serve_last: Optional[Dict] = None

    # ------------------------------------------------------ training feed
    def on_boundary(self, step: int, words_done: int) -> None:
        """One step/chunk boundary. Hot path: a clock read, a duration
        append, and an integer compare — device-free by construction (the
        zero-added-fetch pin in tests/test_signals.py)."""
        now = time.perf_counter()
        wid = int(step) // self.window
        if self._win_id is None:
            self._open_window(wid, step, words_done, now)
            self._last_t, self._last_step = now, int(step)
            return
        if self._last_t is not None and step > (self._last_step or 0):
            # per-OPTIMIZER-step duration: a chunk boundary spans many steps
            dur = (now - self._last_t) / max(1, int(step) - self._last_step)
            self._win_durs.append(dur)
            self.step_hist.observe(dur)
        self._last_t, self._last_step = now, int(step)
        if wid != self._win_id:
            self._close_window(step, words_done, now)
            self._open_window(wid, step, words_done, now)

    def note_heartbeat(self, rows, step: int) -> None:
        """One PeerAgreement heartbeat's (pid, stop, step, p50[, elastic])
        rows: derive the fleet-skew view this host will publish at its next
        window close. Host-side floats only — the allgather already paid
        the collective."""
        try:
            clean = [[float(x) for x in r] for r in rows]
        except (TypeError, ValueError):
            return
        p50s = sorted(r[3] for r in clean)
        if not p50s:
            return
        med = percentile(p50s, 0.50)
        worst = max(clean, key=lambda r: r[3])
        skew = (worst[3] / med) if med > 0 else 1.0
        with self._lock:
            self._heartbeat = {
                "straggler_skew": round(skew, 4),
                "straggler_host": int(worst[0]),
                "fleet_median_p50_ms": round(med, 3),
                "at_step": int(step),
            }

    # ----------------------------------------------------- hub-sink feed
    def __call__(self, record: Dict) -> None:
        """MetricsHub sink: harvest quality/serve streams from the records
        that already flow. Own rows (event=signals/fleet/slo_*) are ignored
        — the engine publishes through the same hub it listens on."""
        ev = record.get("event")
        if isinstance(ev, str) and (
            ev in ("signals", "fleet") or ev.startswith("slo_")
        ):
            return
        if ev == "mem":
            # memory-ledger rows (obs/devmem.py): the headroom fraction
            # becomes a derived signal, which is what makes memory
            # SLO-able ('mem_headroom_frac<0.1' breaches like any rule)
            # and fleet-mergeable with worst-host attribution. Statless
            # backends (mem_available=0) feed nothing — a zero here would
            # read as a full device and breach every headroom SLO.
            if record.get("mem_available"):
                with self._lock:
                    hf = record.get("mem_headroom_frac")
                    if isinstance(hf, (int, float)) and not isinstance(
                        hf, bool
                    ):
                        self._latest["mem_headroom_frac"] = float(hf)
                    pk = record.get("mem_peak_bytes")
                    if isinstance(pk, (int, float)) and not isinstance(
                        pk, bool
                    ):
                        self._latest["mem_peak_bytes"] = float(pk)
            return
        planted = None
        for key in ("quality_analogy_accuracy", "quality_spearman"):
            v = record.get(key)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                planted = float(v)
                break
        if planted is not None:
            with self._lock:
                self._latest["quality_planted"] = planted
        if self.window_s and "serve_qps" in record:
            self.observe_serve(record)

    # -------------------------------------------------------- serve feed
    def observe_serve(self, rec: Dict, now: Optional[float] = None) -> None:
        """One ServeStats snapshot. Windows key on epoch seconds //
        window_s so replica rows merge by window id (see module notes)."""
        if not self.window_s:
            return
        t = time.time() if now is None else float(now)
        wid = int(t // self.window_s)
        keep = {}
        for src, name in (
            ("serve_qps", "serve_qps"),
            ("serve_p99_ms", "serve_p99_ms"),
            ("serve_cache_hit_rate", "cache_hit"),
        ):
            v = rec.get(src)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                keep[name] = float(v)
        hist = rec.get("serve_latency_seconds_hist")
        if self._serve_win is None:
            self._serve_win = wid
        elif wid != self._serve_win and self._serve_last is not None:
            row = {
                "event": "signals",
                "window": self._serve_win,
                "host": self.host,
                "mode": "serve",
            }
            for name, v in self._serve_last.items():
                if name == "serve_latency_seconds_hist":
                    row[name] = v
                else:
                    self._observe_signal(name, self._serve_win, v)
                    row[f"signal_{name}"] = round(v, 6)
            self._publish_row(row)
            self._serve_win = wid
        last = dict(keep)
        if hist:
            last["serve_latency_seconds_hist"] = hist
        self._serve_last = last or self._serve_last

    # --------------------------------------------------------- windowing
    def _open_window(self, wid: int, step: int, words: int, now: float) -> None:
        self._win_id = wid
        self._win_t0 = now
        self._win_words0 = int(words)
        self._win_step0 = int(step)
        self._win_durs = []
        if self.phases is not None:
            snap = self.phases.snapshot()
            self._phase_base = {
                name: s.get("total_ms", 0.0) for name, s in snap.items()
            }

    def _close_window(self, step: int, words: int, now: float) -> None:
        wid = self._win_id
        if wid is None:
            return
        wall = max(1e-9, now - self._win_t0)
        steps = int(step) - self._win_step0
        words_done = int(words) - self._win_words0
        row: Dict = {
            "event": "signals",
            "window": wid,
            "step": int(step),
            "host": self.host,
            "window_wall_s": round(wall, 4),
            "window_steps": steps,
            "window_words": words_done,
        }
        values: Dict[str, float] = {
            "throughput_wps": words_done / wall,
        }
        if self._win_durs:
            values["step_time_p50_ms"] = 1e3 * percentile(self._win_durs, 0.5)
            values["step_time_p90_ms"] = 1e3 * percentile(self._win_durs, 0.9)
        if self.phases is not None:
            values.update(self._input_bound_ratio())
            # host-attributable loop time: window wall NOT inside any
            # loop-stalling span. On a lockstep fleet (synchronous
            # collectives — the CPU/gloo backend, or any tight sync
            # cadence) every host's step TIME equalizes to the slowest
            # host's, so p50 cannot attribute a straggler; the time a host
            # spends outside its spans (a wedged fault hook, GC, slow host
            # code between dispatches) is the share only IT can explain —
            # obs/fleet.py prefers it for worst-host attribution.
            values["host_overhead_ms"] = self._host_overhead_ms(wall)
        with self._lock:
            hb = dict(self._heartbeat) if self._heartbeat else None
            latest = dict(self._latest)
        if hb is not None:
            values["straggler_skew"] = hb["straggler_skew"]
            row["straggler_host"] = hb["straggler_host"]
        for name, v in latest.items():
            values[name] = v
        for name, v in values.items():
            self._observe_signal(name, wid, v)
            row[f"signal_{name}"] = round(float(v), 6)
        row["step_time_seconds_hist"] = self.step_hist.to_record()
        self._windows_closed += 1
        self._publish_row(row)

    def _input_bound_ratio(self) -> Dict[str, float]:
        """Input-stall fraction over THIS window, from the PhaseRecorder's
        loop-stalling span totals delta (same phases the verdict uses)."""
        snap = self.phases.snapshot()
        totals = {n: s.get("total_ms", 0.0) for n, s in snap.items()}

        def delta(names) -> float:
            return sum(
                max(0.0, totals.get(n, 0.0) - self._phase_base.get(n, 0.0))
                for n in names
            )

        inp = delta(INPUT_PHASES)
        comp = delta(COMPUTE_PHASES)
        if inp + comp <= 0.0:
            return {}
        return {"input_bound_ratio": inp / (inp + comp)}

    def _host_overhead_ms(self, wall_s: float) -> float:
        """Window wall minus the LOOP-STALLING span totals' delta (input +
        compute phases + checkpoint + quality_probe + the fleet waits
        replica_sync/agree — h2d is overlapped producer time and would
        double-subtract). Clamped at zero: span clocks and the window
        clock are read at slightly different moments."""
        snap = self.phases.snapshot()
        spans = 0.0
        for name in INPUT_PHASES + COMPUTE_PHASES + (
            "checkpoint", "quality_probe", "replica_sync", "agree",
        ):
            total = (snap.get(name) or {}).get("total_ms", 0.0)
            spans += max(0.0, total - self._phase_base.get(name, 0.0))
        return max(0.0, 1e3 * wall_s - spans)

    def _observe_signal(self, name: str, wid: int, value: float) -> None:
        with self._lock:
            sig = self._signals.get(name)
            if sig is None:
                sig = self._signals[name] = Signal(name)
            sig.observe(wid, value)

    # -------------------------------------------------------- publishing
    def _publish_row(self, row: Dict) -> None:
        if self._rows_file is not None:
            try:
                self._rows_file.write(json.dumps(row, default=str) + "\n")
            except (OSError, ValueError):
                pass
        if self.flight is not None:
            self.flight.note_signal(row)
        if self.log_fn is not None:
            self.log_fn(dict(row))
        self.bus.publish("signals", row)
        for key, v in row.items():
            if key.startswith("signal_"):
                self.bus.publish(key[len("signal_"):], {
                    "window": row.get("window"), "host": self.host,
                    "value": v,
                })
        if self.slo is not None:
            values = {
                k[len("signal_"):]: v for k, v in row.items()
                if k.startswith("signal_")
            }
            for ev in self.slo.evaluate(values, row.get("window")):
                self._emit_event(ev)
        if self.aggregator is not None:
            try:
                fleet_row = self.aggregator.aggregate()
            except Exception as e:  # noqa: BLE001 — aggregation is advisory
                warnings.warn(
                    f"fleet aggregation failed: {e!r}", stacklevel=2
                )
                fleet_row = None
            if fleet_row:
                if self.log_fn is not None:
                    self.log_fn(dict(fleet_row))
                self.bus.publish("fleet", fleet_row)

    def _emit_event(self, ev: Dict) -> None:
        """One structured SLO event: onto the run's sinks (the Prometheus
        sink counts slo_breach into w2v_slo_breaches_total), the flight
        recorder's signal ring AND record ring (every flight.json names
        the breach), and the bus."""
        if self.flight is not None:
            self.flight.note_signal(ev)
            self.flight.log_record(ev)
            ring = getattr(self.flight, "ring", None)
            if ring is not None:
                ring.instant(ev.get("event", "slo"), args={
                    k: v for k, v in ev.items() if k != "event"
                })
        if self.log_fn is not None:
            self.log_fn(dict(ev))
        self.bus.publish("slo", ev)

    # --------------------------------------------------------- reporting
    def signal_stats(self) -> Dict[str, Dict]:
        with self._lock:
            return {name: s.stats() for name, s in self._signals.items()}

    def report(self) -> Optional[Dict]:
        """TrainReport.signals payload: per-signal stats, windows closed,
        the SLO summary, and the bus-fed fleet-health verdict. None when
        no window ever closed (a run shorter than one window)."""
        stats = self.signal_stats()
        if not stats and self._windows_closed == 0:
            return None
        out: Dict = {
            "window_steps": self.window,
            "windows": self._windows_closed,
            "signals": stats,
            "fleet_health": self.health.verdict(),
        }
        if self.slo is not None:
            out["slo"] = self.slo.summary()
        return out

    def finish(self, step: Optional[int] = None,
               words_done: Optional[int] = None) -> None:
        """Close the in-flight partial window (end of the run: the tail
        still deserves a row) and flush the row file."""
        if (
            self._win_id is not None
            and step is not None
            and words_done is not None
            and int(step) > self._win_step0
        ):
            self._close_window(int(step), int(words_done), time.perf_counter())
            self._win_id = None
        if self.window_s and self._serve_last is not None:
            # serve tail: emit the last accumulated serve window
            self._serve_win = (self._serve_win or 0)
            self.observe_serve({}, now=(self._serve_win + 1) * self.window_s)
        if self._rows_file is not None:
            try:
                self._rows_file.flush()
            except (OSError, ValueError):
                pass
        if self.aggregator is not None:
            # final forced pass: mid-run aggregation is interval-throttled
            # (FleetAggregator.MIN_INTERVAL_S), so the tail windows may not
            # have been merged yet — the run-end fleet.json must be complete
            try:
                fleet_row = self.aggregator.aggregate(force=True)
            except Exception:  # noqa: BLE001 — aggregation is advisory
                fleet_row = None
            if fleet_row:
                if self.log_fn is not None:
                    self.log_fn(dict(fleet_row))
                self.bus.publish("fleet", fleet_row)

    def close(self) -> None:
        self.health.close()
        if self._rows_file is not None:
            try:
                self._rows_file.close()
            except (OSError, ValueError):
                pass
            self._rows_file = None
