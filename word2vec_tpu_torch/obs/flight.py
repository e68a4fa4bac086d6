"""Always-on flight recorder: every failure artifact carries its own timeline.

A copy of word2vec_tpu/obs/flight.py for the PyTorch port. The JAX
package's trainer-side dump paths (divergence, stall, preemption, peer
loss) come with the port's trainer telemetry; the serve paths and SIGUSR1
are here.

A bounded in-memory ring records the last N steps of span events, counters
and log records, ALWAYS — no flag, no I/O, no device interaction
(recording is a deque append under a lock). On a failure or exit path the
ring is dumped as `flight.json` into `--metrics-dir`:

    serve drain  — serve/server.py's shutdown (reason "drained", or
                   "preempted" on a forced / deadline exit)
    serve crash  — the batcher's death (reason "serve_crash")
    on demand    — SIGUSR1 (resilience/shutdown.install_usr1_dump) dumps
                   `flight_usr1.json` + all-thread stacks without stopping

The dump embeds a full Chrome-trace document (obs/trace.py), so a failure
artifact opens directly in Perfetto.

The module-level `activate()`/`active()` pair mirrors faults.activate():
an owner installs its recorder for its lifetime so signal handlers can
find the live ring without threading it through every call chain.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, Optional


def _process_index() -> int:
    """This process's rank for the trace's process track: the
    torch.distributed rank when a process group is initialized, else 0.
    Never raises: a dump must work even mid-teardown."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 — best-effort identity
        pass
    return 0


class FlightRecorder:
    """Bounded ring of the last N steps of spans + counters + log records."""

    #: steps of history kept (counters / log records ring depth; the event
    #: ring holds EVENTS_PER_STEP times as many entries)
    STEPS = 256
    EVENTS_PER_STEP = 16

    def __init__(self, steps: int = STEPS,
                 events_per_step: int = EVENTS_PER_STEP):
        from .trace import TraceRing

        self.steps = max(1, int(steps))
        self.ring = TraceRing(capacity=self.steps * max(1, events_per_step))
        self._lock = threading.Lock()
        self.counters: collections.deque = collections.deque(maxlen=self.steps)
        self.records: collections.deque = collections.deque(maxlen=self.steps)
        #: last-N quality-probe rows (obs/quality.QualityProbe) — embedded
        #: in every dump so a failure artifact shows the quality trajectory
        #: that led there, not just the perf timeline
        self.quality: collections.deque = collections.deque(maxlen=32)
        #: last-N derived-signal rows and SLO events (obs/signals.py /
        #: obs/slo.py): a failure artifact carries the windowed signal
        #: trajectory — and any warn/breach escalation — that led there
        self.signals: collections.deque = collections.deque(maxlen=64)
        #: last-N memory-ledger rows (obs/devmem.MemoryLedger): every
        #: flight.json shows the device-memory trajectory that led to the
        #: failure — an OOM artifact names its own watermark history
        self.memory: collections.deque = collections.deque(maxlen=64)
        #: the last step boundary observed (None before any)
        self.last_step: Optional[int] = None

    # ------------------------------------------------------------ recording
    def note_step(self, step: int, t0: float, dur_s: float,
                  kind: str = "step", **args) -> None:
        """One step/chunk/epoch parent span ('X' with the step index in
        args) — the trainers call this at every boundary."""
        if kind in ("step", "chunk"):
            self.last_step = int(step)
        self.ring.complete(kind, t0, dur_s, args={"step": int(step), **args})

    def note_counters(self, step: int, counters: Dict[str, float]) -> None:
        """One drained health-counter observation (the lagged metrics drain
        — obs/health.py): a counter trace event plus a ring row."""
        row: Dict[str, float] = {"step": int(step)}
        for k, v in counters.items():
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            row[k] = float(v)
        with self._lock:
            self.counters.append(row)
        self.ring.counter(
            "health", {k: v for k, v in row.items() if k != "step"}
        )

    def note_heartbeat(self, rows, step: int) -> None:
        """One multi-process heartbeat's (pid, stop, step, p50) rows —
        recorded so a peer-loss dump shows the fleet's last known state,
        and so the merged trace can attribute tracks to hosts."""
        try:
            clean = [[float(x) for x in r] for r in rows]
        except (TypeError, ValueError):
            return
        self.ring.instant(
            "heartbeat", args={"at_step": int(step), "rows": clean}
        )

    def note_quality(self, row: Dict) -> None:
        """One quality-probe row (or sentinel alert record): the bounded
        quality ring every flight.json dump carries."""
        with self._lock:
            self.quality.append(dict(row))

    def note_signal(self, row: Dict) -> None:
        """One derived-signal window row or SLO event (obs/signals.py):
        the bounded signal ring every flight.json dump carries."""
        with self._lock:
            self.signals.append(dict(row))

    def note_mem(self, row: Dict) -> None:
        """One memory-ledger sample (obs/devmem.MemoryLedger): the bounded
        memory ring every flight.json dump carries."""
        with self._lock:
            self.memory.append(dict(row))

    def log_record(self, rec: Dict) -> None:
        """One log record (sink-compatible: the trainers' _log feeds this
        alongside the run's MetricsHub)."""
        with self._lock:
            self.records.append(dict(rec))

    # ------------------------------------------------------------- dumping
    def snapshot(self, reason: str, extra: Optional[Dict] = None) -> Dict:
        """The flight.json payload: an embedded Chrome-trace doc plus the
        counter and log-record tails."""
        from .trace import chrome_trace_doc

        with self._lock:
            counters = list(self.counters)
            records = list(self.records)
            quality = list(self.quality)
            signals = list(self.signals)
            memory = list(self.memory)
        snap: Dict = {
            "event": "flight",
            "reason": reason,
            "created_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "last_step": self.last_step,
            "dropped_events": self.ring.dropped,
            "trace": chrome_trace_doc(
                self.ring.events(), process_index=_process_index()
            ),
            "counters": counters,
            "log_records": records,
            "quality": quality,
            "signals": signals,
            "memory": memory,
        }
        if extra:
            snap.update(extra)
        return snap

    def dump(self, metrics_dir: str, reason: str,
             extra: Optional[Dict] = None,
             filename: str = "flight.json") -> Optional[str]:
        """Write the snapshot into `metrics_dir` (atomic tmp+rename).
        Best-effort by contract: returns the path, or None on any failure —
        a dump must never mask the failure it documents."""
        try:
            os.makedirs(metrics_dir, exist_ok=True)
            path = os.path.join(metrics_dir, filename)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.snapshot(reason, extra), f, indent=2,
                          default=str)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 — see docstring
            return None


# ---------------------------------------------------- process-wide recorder
# The watchdog's monitor thread and the SIGUSR1 handler need the LIVE
# recorder without a reference being threaded to them; Trainer.train()
# scopes its recorder here (same pattern as faults.activate()).
_ACTIVE: Optional[FlightRecorder] = None


def activate(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install the process-wide flight recorder; returns the previous one
    (restore it in a finally when scoping)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = recorder
    return prev


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def dump_active(metrics_dir: str, reason: str,
                extra: Optional[Dict] = None,
                filename: str = "flight.json") -> Optional[str]:
    """Dump the process-wide recorder, if any (the watchdog's fallback when
    it was constructed without an explicit recorder)."""
    fr = _ACTIVE
    if fr is None:
        return None
    return fr.dump(metrics_dir, reason, extra=extra, filename=filename)
