"""Step-deadline watchdog: bounded detection of the hang.

The port's counterpart of word2vec_tpu/resilience/watchdog.py for one
process. A wedged device or a stuck host phase stalls the step loop
silently: from a scheduler's point of view a hung run looks like a healthy
one that has stopped producing steps. This module turns the hang into a
bounded, requeue-able abort:

  StepWatchdog   — a monitor thread armed per train() run. The trainer
                   calls `beat(step)` at every dispatch boundary (one
                   clock read and a lock: no device sync, no launch). If
                   no boundary lands within `max(deadline, factor x
                   rolling-p90 boundary time)` — with a one-off grace
                   window covering the first graph capture — the monitor
                   fires: it dumps ALL thread stacks into the metrics dir,
                   names the wedged phase from obs/phases.PhaseRecorder's
                   open spans (batcher_wait vs device_wait vs checkpoint
                   vs dispatch), dumps the flight recorder, marks the run
                   manifest `shutdown: stalled`, and exits EXIT_STALLED so
                   an external scheduler requeues with `--resume` (the
                   resume is bitwise, so the retry loses nothing). A hang
                   inside the device shows as the host blocked in the
                   `device_wait` span, the lagged metrics fetch.

  bounded_call   — deadline-bounded execution of a host call. The
                   deadline is process-wide (`set_sync_deadline`), default
                   None = unbounded. Here a runtime error is re-raised
                   unchanged: classifying a peer's death is the
                   multi-process layer's work, which the port does not
                   have yet.

Also here: `SyncTimeout` (the error the `sync_timeout` fault kind raises,
resilience/faults.py) and `dump_all_stacks` (the all-thread stack dump
behind the SIGUSR1 on-demand dump, resilience/shutdown.install_usr1_dump,
and the watchdog's fire path).

`os._exit` is deliberate in the fire path: a wedged main thread cannot run
`sys.exit` cleanup, and the artifacts (stacks, stall record, manifest) are
written by the monitor thread *before* the exit. atexit hooks are skipped;
the JSONL sink flushes per record, and `flush_fn` closes the others.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ..utils.profiling import lap_stats

#: exit code of a stalled-and-shot run. Distinct from EXIT_PREEMPTED (75):
#: both mean "requeue me with --resume", but a stall says the hardware or
#: the input pipeline wedged, not that the fleet evicted the run (76 =
#: EX_PROTOCOL: the step protocol, "a boundary lands every deadline", was
#: violated).
EXIT_STALLED = 76


class SyncTimeout(RuntimeError):
    """A deadline-bounded collective did not complete: a peer is dead or
    wedged. Carries `.what` (which collective) and `.deadline` (seconds)."""

    def __init__(self, what: str, deadline: float):
        self.what = what
        self.deadline = float(deadline)
        super().__init__(
            f"{what} did not complete within the {deadline:g}s sync "
            "deadline: a peer process is dead or wedged; aborting for "
            "requeue instead of hanging"
        )


# ------------------------------------------------------ process-wide deadline
_SYNC_DEADLINE: Optional[float] = None


def set_sync_deadline(secs: Optional[float]) -> Optional[float]:
    """Install the process-wide deadline of bounded_call (None/0
    disables); returns the previous value (restore it in a finally when
    scoping)."""
    global _SYNC_DEADLINE
    prev = _SYNC_DEADLINE
    _SYNC_DEADLINE = float(secs) if secs else None
    return prev


def sync_deadline() -> Optional[float]:
    return _SYNC_DEADLINE


def dump_all_stacks(path: Optional[str]) -> None:
    """All-thread stack dump via faulthandler — signal-safe C-level
    formatting that works even when a wedged thread holds arbitrary
    Python-level locks (a traceback.format_stack walk could block on the
    very lock the hang is about). None writes to stderr."""
    import faulthandler

    try:
        if path is None:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        else:
            with open(path, "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
    except Exception:
        pass


def bounded_call(fn: Callable, what: str = "collective",
                 deadline: Optional[float] = None):
    """Run `fn()` under a deadline; raise SyncTimeout if it doesn't return.

    `deadline` defaults to the process-wide one; with neither set this is
    a plain call (no thread). The bounded path runs `fn` in a daemon
    thread and joins with a timeout — the call itself cannot be
    cancelled, so on expiry the thread is ABANDONED and the caller must
    treat the process as lost: checkpoint what is safe and exit. An error
    out of `fn` is re-raised unchanged.
    """
    if deadline is None:
        deadline = _SYNC_DEADLINE
    if not deadline:
        return fn()
    out: Dict = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:  # surfaced to the caller below
            out["error"] = e

    t = threading.Thread(target=run, name=f"bounded:{what}", daemon=True)
    t.start()
    t.join(deadline)
    if t.is_alive():
        raise SyncTimeout(what, deadline)
    if "error" in out:
        raise out["error"]
    return out.get("value")


# ---------------------------------------------------------------- watchdog
class StepWatchdog:
    """Step-deadline monitor: fire when no step boundary lands in time.

    Usage (the trainer does this via `Trainer.watchdog`):

        wd = StepWatchdog(deadline=30, phases=trainer.phases,
                          metrics_dir=..., manifest_path=...)
        wd.arm()                 # at train() entry (starts the monitor)
        wd.beat(step)            # at every dispatch boundary
        wd.disarm()              # at train() exit (any path)

    The effective deadline is `max(deadline, factor x p90(recent boundary
    intervals))`, so a configured 5 s deadline does not false-fire on a
    run whose chunks legitimately take 8 s. Until `min_beats` boundaries
    have landed the GRACE deadline applies instead (default max(60 s, 6 x
    deadline)), covering the graph capture. Set `deadline` above the worst
    checkpoint write; the adaptive term handles drift, not cliffs.

    On fire (monitor thread): write `stall_stacks.txt` (faulthandler dump
    of every thread), `flight.json` (reason `stalled`) and `stall.json`
    (step, elapsed, effective deadline, the wedged phase from the
    PhaseRecorder's open spans, boundary-time stats) into `metrics_dir`,
    merge `shutdown: stalled` + the stall record into the manifest, run
    `flush_fn`, then `os._exit(EXIT_STALLED)` — unless `on_fire` is set
    (tests), which receives the record instead of the exit.
    """

    #: boundary-interval samples kept for the rolling p90
    MAX_SAMPLES = 256

    def __init__(
        self,
        deadline: float,
        factor: float = 4.0,
        grace_secs: Optional[float] = None,
        min_beats: int = 2,
        phases=None,
        metrics_dir: Optional[str] = None,
        manifest_path: Optional[str] = None,
        on_fire: Optional[Callable[[Dict], None]] = None,
        flight=None,
        flush_fn: Optional[Callable[[Dict], None]] = None,
    ):
        if deadline <= 0:
            raise ValueError(f"deadline must be > 0, got {deadline}")
        self.deadline = float(deadline)
        self.factor = float(factor)
        self.grace_secs = (
            max(60.0, 6.0 * self.deadline) if grace_secs is None
            else float(grace_secs)
        )
        self.min_beats = int(min_beats)
        self.phases = phases
        self.metrics_dir = metrics_dir
        self.manifest_path = manifest_path
        self.on_fire = on_fire
        #: flight recorder (obs/flight.FlightRecorder) dumped as flight.json
        #: next to stall.json on fire; falls back to the process-wide active
        #: recorder (the one train() installs) when None
        self.flight = flight
        #: called with the stall record on the fire path BEFORE os._exit —
        #: the CLI flushes and closes its MetricsHub sinks here
        self.flush_fn = flush_fn
        #: set once the watchdog has fired (observable by tests / harnesses)
        self.fired = threading.Event()
        self._lock = threading.Lock()
        self._laps: List[float] = []
        self._beats = 0
        self._last_beat = 0.0
        self._last_step = -1
        self._armed = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- control
    def arm(self) -> "StepWatchdog":
        """(Re)start monitoring; the deadline clock starts now. Idempotent
        per train() run — a supervisor retry re-arms after its rollback, so
        checkpoint-load time never counts against the step deadline."""
        with self._lock:
            self._armed = True
            self._last_beat = time.monotonic()
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._monitor, name="step-watchdog", daemon=True
            )
            self._thread.start()
        return self

    def disarm(self) -> None:
        """Stop monitoring (idempotent; safe from any thread)."""
        with self._lock:
            self._armed = False
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self._thread = None

    def beat(self, step: int) -> None:
        """One dispatch boundary: re-arm the deadline. One clock read and a
        lock — no device interaction whatsoever."""
        now = time.monotonic()
        with self._lock:
            if self._beats > 0:
                # interval between BOUNDARIES only: the arm->first-beat gap
                # holds the graph capture and would poison the rolling p90
                # (the grace window covers that stretch instead)
                lap = now - self._last_beat
                if len(self._laps) < self.MAX_SAMPLES:
                    self._laps.append(lap)
                else:
                    self._laps[(self._beats - 1) % self.MAX_SAMPLES] = lap
            self._beats += 1
            self._last_beat = now
            self._last_step = int(step)

    # ----------------------------------------------------------- deadlines
    def step_stats(self) -> Dict:
        """lap_stats over the recent boundary intervals (p50/p90 in ms)."""
        with self._lock:
            laps = list(self._laps)
        return lap_stats(laps)

    def effective_deadline(self) -> float:
        with self._lock:
            beats, laps = self._beats, list(self._laps)
        if beats < self.min_beats:
            return max(self.deadline, self.grace_secs)
        s = lap_stats(laps)
        return max(self.deadline, self.factor * s.get("p90_ms", 0.0) / 1e3)

    # ------------------------------------------------------------- monitor
    def _interval(self) -> float:
        return min(1.0, max(0.02, self.deadline / 5.0))

    def _monitor(self) -> None:
        while not self._stop.wait(self._interval()):
            with self._lock:
                if not self._armed:
                    continue
                last, step = self._last_beat, self._last_step
            elapsed = time.monotonic() - last
            eff = self.effective_deadline()
            if elapsed > eff:
                self._fire(step, elapsed, eff)
                return  # one fire per arm (on_fire path keeps the process)

    def _fire(self, step: int, elapsed: float, effective: float) -> None:
        record = {
            "event": "stalled",
            "step": step,
            "elapsed_s": round(elapsed, 3),
            "effective_deadline_s": round(effective, 3),
            "configured_deadline_s": self.deadline,
            "phase": self._wedged_phase(),
            "open_spans": self._open_spans(),
            "boundary_stats": self.step_stats(),
        }
        stacks_path = None
        flight = self.flight
        if flight is None:
            from ..obs import flight as _flight_mod

            flight = _flight_mod.active()
        if self.metrics_dir:
            try:
                os.makedirs(self.metrics_dir, exist_ok=True)
                stacks_path = os.path.join(self.metrics_dir, "stall_stacks.txt")
                dump_all_stacks(stacks_path)
                record["stacks"] = stacks_path
                if flight is not None:
                    # the stall's timeline: what the run was doing in the
                    # steps before the boundary stopped landing
                    fpath = flight.dump(
                        self.metrics_dir, reason="stalled",
                        extra={"failure_step": step},
                    )
                    if fpath:
                        record["flight"] = fpath
                with open(os.path.join(self.metrics_dir, "stall.json"), "w") as f:
                    json.dump(record, f, indent=2, default=str)
                    f.write("\n")
            except OSError:
                pass  # the exit code still tells the scheduler what happened
        else:
            dump_all_stacks(None)  # stderr
        if self.manifest_path:
            from ..obs.manifest import update_manifest

            update_manifest(
                self.manifest_path, {"shutdown": "stalled", "stall": record}
            )
        print(
            f"watchdog: no step boundary for {elapsed:.1f}s "
            f"(effective deadline {effective:.1f}s) after step {step}; "
            f"wedged phase: {record['phase']}"
            + (f"; stacks: {stacks_path}" if stacks_path else "")
            + f"; exiting {EXIT_STALLED} for requeue with --resume",
            file=sys.stderr, flush=True,
        )
        self.fired.set()
        if self.flush_fn is not None:
            # the os._exit below skips atexit: flush the metrics sinks NOW
            try:
                self.flush_fn(record)
            except Exception:  # noqa: BLE001 — flushing must not block the exit
                pass
        if self.on_fire is not None:
            self.on_fire(record)
            return
        os._exit(EXIT_STALLED)

    def _wedged_phase(self) -> str:
        if self.phases is not None:
            wedged = self.phases.wedged_phase()
            if wedged:
                return wedged
        # no open host-side span: the main loop itself is wedged (a stuck
        # fault/stop hook, a hang between spans)
        return "main-loop (no open phase span)"

    def _open_spans(self) -> Dict[str, float]:
        if self.phases is None:
            return {}
        return {
            k: round(v, 3) for k, v in self.phases.open_spans().items()
        }
