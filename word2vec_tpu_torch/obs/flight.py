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
find the live ring without threading it through every call chain. A
trainer leaves its recorder as `last()` when its run returns, so the run's
rows stay readable after the trainer is gone (and SIGUSR1 dumps it when
no run is active).

The trainer's dispatch timeline (DispatchTimeline, on the card only) puts
each dispatch on the card's own clock: two timing events a dispatch, one
before its first device work and the one its metrics copy records, and
one non-blocking query of the previous dispatch's end before the start is
recorded. A row per dispatch (note_dispatch) says how long the card
worked on it (`device_s`), how long it sat idle before it (`gap_s`: from
the previous dispatch's end to this one's start), and whether that gap is
the host's doing (`starved`: the previous dispatch had already ended when
the host began this one; otherwise the start was queued behind it and the
gap is the stream's own). The rows are also 'X' events on a `device`
track of the ring, on the ring's time axis.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

#: the ring track (Chrome-trace thread) the dispatch rows are drawn on
DEVICE_TRACK = "device"

#: keys of FlightRecorder.dispatch_totals(): the call's dispatches; the
#: card's seconds on them; the idle seconds between them, split into
#: starved (the host had not yet begun the next dispatch when the previous
#: one ended) and queued, with the starved seconds before an epoch's first
#: dispatch (its preparation) also apart
DISPATCH_TOTALS = ("dispatches", "device_s", "gap_s", "starved_s",
                   "queued_s", "starved_epoch_s")


def _zero_totals() -> Dict[str, float]:
    tot = dict.fromkeys(DISPATCH_TOTALS, 0.0)
    tot["dispatches"] = 0
    return tot


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
    #: newest dispatch rows kept (note_dispatch); a 51 s window of the sgns
    #: benchmark cell makes about 1,000 dispatches
    DISPATCH_ROWS = 4096

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
        #: newest per-dispatch device rows of the current / last train()
        #: call (note_dispatch), and that call's totals over every one
        self.dispatches: collections.deque = collections.deque(
            maxlen=self.DISPATCH_ROWS)
        self._dispatch_totals: Dict[str, float] = _zero_totals()
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

    def note_band_tail(self, step: int, steps: int, gathered: bool) -> None:
        """The update tail a dispatch's band steps took (each step of a
        dispatch repeats one capture, so one tail): a `band_tail` counter,
        `gathered` 1 for the gathered tail (ops/band_step.gathered_tail), 0
        for the sorted one, and the dispatch's `steps`. The trainers call
        this once a dispatch of the band ns step; other steps record none."""
        self.ring.counter("band_tail", {
            "gathered": 1.0 if gathered else 0.0, "steps": float(steps),
            "at_step": float(step),
        })

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

    def open_dispatches(self) -> None:
        """Start a train() call's dispatch timeline: no rows, zero totals."""
        with self._lock:
            self.dispatches.clear()
            self._dispatch_totals = _zero_totals()

    def note_dispatch(self, step: int, steps: int, device_s: float,
                      gap_s: float, starved: bool, epoch_first: bool,
                      t0: Optional[float] = None) -> None:
        """One dispatch on the card's clock (see the module docstring):
        the step it brought the run to, its steps, the card's seconds on
        it, the idle seconds before it and whether the host caused them,
        and whether it opened an epoch. `t0`, its start as a perf_counter
        read, also draws it on the ring's device track."""
        row = {"step": int(step), "steps": int(steps),
               "device_s": float(device_s), "gap_s": float(gap_s),
               "starved": bool(starved), "epoch_first": bool(epoch_first)}
        with self._lock:
            tot = self._dispatch_totals
            self.dispatches.append(row)
            tot["dispatches"] += 1
            tot["device_s"] += row["device_s"]
            tot["gap_s"] += row["gap_s"]
            if starved:
                tot["starved_s"] += row["gap_s"]
                if epoch_first:
                    tot["starved_epoch_s"] += row["gap_s"]
            else:
                tot["queued_s"] += row["gap_s"]
        if t0 is not None:
            self.ring.complete(
                "device", t0, row["device_s"], tid=DEVICE_TRACK,
                args={"step": row["step"], "steps": row["steps"],
                      "gap_ms": 1e3 * row["gap_s"], "starved": row["starved"]},
            )

    def dispatch_totals(self) -> Optional[Dict[str, float]]:
        """The current / last train() call's totals (DISPATCH_TOTALS), None
        when no dispatch was timed (the CPU, a recorder no trainer ran)."""
        with self._lock:
            if not self.dispatches:
                return None
            return dict(self._dispatch_totals)

    def dispatch_rows(self) -> List[Dict]:
        """The newest dispatch rows, oldest first."""
        with self._lock:
            return [dict(r) for r in self.dispatches]

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
        dispatch = self.dispatch_totals()
        snap: Dict = {
            "event": "flight",
            "reason": reason,
            "created_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "last_step": self.last_step,
            "dropped_events": self.ring.dropped,
            "trace": chrome_trace_doc(
                self.ring.events(), process_index=_process_index(),
                origin_unix_s=self.ring.wall0,
            ),
            "counters": counters,
            "log_records": records,
            "quality": quality,
            "signals": signals,
            "memory": memory,
        }
        if dispatch is not None:
            # the card's view of the loop, where it was timed
            snap["dispatch"] = {"totals": dispatch,
                                "rows": self.dispatch_rows()}
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
#: the recorder of the train() call that returned last (set_last)
_LAST: Optional[FlightRecorder] = None


def activate(recorder: Optional[FlightRecorder]) -> Optional[FlightRecorder]:
    """Install the process-wide flight recorder; returns the previous one
    (restore it in a finally when scoping)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = recorder
    return prev


def active() -> Optional[FlightRecorder]:
    return _ACTIVE


def set_last(recorder: Optional[FlightRecorder]) -> None:
    """Keep `recorder` as last(): Trainer.train leaves its own when it
    returns (None when the trainer had none)."""
    global _LAST
    _LAST = recorder


def last() -> Optional[FlightRecorder]:
    """The recorder of the train() call that returned last, which outlives
    its trainer: its dispatch rows and totals stay readable after the run."""
    return _LAST


def dump_active(metrics_dir: str, reason: str,
                extra: Optional[Dict] = None,
                filename: str = "flight.json") -> Optional[str]:
    """Dump the process-wide recorder, if any (the watchdog's fallback when
    it was constructed without an explicit recorder)."""
    fr = _ACTIVE
    if fr is None:
        return None
    return fr.dump(metrics_dir, reason, extra=extra, filename=filename)


class DispatchTimeline:
    """One train() call's dispatches on the card's clock, noted into a
    FlightRecorder (see the module docstring). The trainer calls open()
    after the call's first device sync, begin() before each dispatch's
    first device work, records end_event() on `stream` behind the
    dispatch's metrics copy, calls issued() after that, and close() once
    the metrics drain has waited for that event. No call here waits for
    the device: begin() makes one non-blocking query, close() reads the
    elapsed time between events that have completed. The call's first
    dispatch has no gap: the span the rows tile starts at its start.

    `new_event()` makes a timing event (anything with record(stream),
    query() and elapsed_time(other) in ms, as torch.cuda.Event); `stream`
    is the stream the trainer's dispatches run on. Every event is recorded
    on it: a card's events time only against events of the same card.
    The events are made once and recorded again POOL dispatches later,
    after their last read (a start is read one dispatch later, an end two).
    A mark (begin(), issued()) carries its timeline, so the drain closes it
    with DispatchTimeline.close(mark, ...) alone.
    """

    POOL = 4

    def __init__(self, flight: FlightRecorder, new_event: Callable[[], object],
                 stream):
        self.flight = flight
        self.stream = stream
        self._anchor = new_event()
        self._starts = [new_event() for _ in range(self.POOL)]
        self._ends = [new_event() for _ in range(self.POOL)]
        self._n = 0
        self._t_anchor = 0.0
        self._last_end = None

    def open(self) -> None:
        """After the call's device sync: the anchor event and the host
        clock read beside it, which place every later event on the ring's
        time axis."""
        self._anchor.record(self.stream)
        self._t_anchor = time.perf_counter()
        self._last_end = None
        self.flight.open_dispatches()

    def begin(self, epoch_first: bool) -> Tuple:
        """Before a dispatch's first device work: whether the previous
        dispatch had already ended (the card ran dry), then its start."""
        prev = self._last_end
        starved = prev is not None and bool(prev.query())
        start = self._starts[self._n % self.POOL]
        start.record(self.stream)
        return (self, start, prev, starved, bool(epoch_first))

    def end_event(self):
        """The event that is to close the dispatch begun last: the trainer
        records it on `stream` behind the dispatch's metrics copy."""
        return self._ends[self._n % self.POOL]

    def issued(self, mark: Tuple, end) -> Tuple:
        """After a dispatch's last device work: `end`, end_event() as
        recorded there, closes it and is what the next begin() queries."""
        self._last_end = end
        self._n += 1
        return mark + (end,)

    @staticmethod
    def close(mark: Tuple, step: int, steps: int) -> None:
        """The dispatch's row, once its end event has completed. Its start
        on the ring's axis is read against the anchor each time: placing
        it after the previous row by their device time and gap drifted
        from a profiler trace of the same run by ≈ 37 µs a second on an
        H100."""
        tl, start, prev, starved, epoch_first, end = mark
        tl.flight.note_dispatch(
            step, steps,
            device_s=start.elapsed_time(end) / 1e3,
            gap_s=prev.elapsed_time(start) / 1e3 if prev is not None else 0.0,
            starved=starved, epoch_first=epoch_first,
            t0=tl._t_anchor + tl._anchor.elapsed_time(start) / 1e3,
        )
