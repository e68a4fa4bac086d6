"""Step-deadline watchdog and the peer layer: bounded detection of the hang.

The port's counterpart of word2vec_tpu/resilience/watchdog.py. A wedged
device or a stuck host phase stalls the step loop silently, and a dead
peer strands the survivors of a multi-process run in a collective that
never completes: from a scheduler's point of view a hung run looks like a
healthy one that has stopped producing steps. This module turns every hang
into a bounded, requeue-able abort:

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

  bounded_call   — deadline-bounded execution of host-side collectives.
                   parallel/multihost's agreements, heartbeat, metrics
                   gather and table gather route through it, so a dead
                   peer turns an infinite hang into a `SyncTimeout` the
                   CLI converts into checkpoint-where-safe +
                   EXIT_PREEMPTED. The deadline is process-wide
                   (`set_sync_deadline`), default None = unbounded. An
                   error the distributed runtime raises for a dead peer
                   (is_peer_failure) becomes the same SyncTimeout.

  PeerAgreement  — the multi-process cooperative-stop check with a
                   liveness heartbeat: at the agreement cadence every
                   process allgathers (process id, stop flag, step,
                   step-time p50, elastic flag, policy action), so a
                   lagging peer is logged as a straggler WITH its process
                   id and the stop verdict is the any-of vote.

Also here: `SyncTimeout` (also the error the `sync_timeout` fault kind
raises, resilience/faults.py) and `dump_all_stacks` (the all-thread stack
dump behind the SIGUSR1 on-demand dump, resilience/shutdown.install_usr1_dump,
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


#: message fragments of the distributed runtime's peer-death errors. A lost
#: process surfaces in TWO flavors: a collective that silently never
#: completes (the hang SyncTimeout bounds) — and, when the peer died
#: mid-transfer, an IMMEDIATE error out of the data plane. Gloo says
#: "Connection closed by peer [127.0.0.1]:N. This is typically caused by a
#: remote worker crashing" (pair.cc; seen when a rank is SIGKILLed during
#: an all_gather) or "Connection reset by peer"; the JAX package's
#: coordination-service spellings are kept. Matching is fragment AND type:
#: is_peer_failure also requires the exception to come from
#: torch.distributed (_from_distributed_runtime), so an unrelated socket
#: error sharing a fragment stays a program error.
_PEER_FAILURE_FRAGMENTS = (
    "gloo",
    "connection reset by peer",
    "connection closed by peer",
    "remote worker crashing",
    "heartbeat timeout",
    "barrier timeout",
    "barrier timed out",
    "coordination service",
    "socket closed",
    "connection refused",
    "peer closed",
)


def _from_distributed_runtime(exc: BaseException) -> bool:
    """Was this exception raised by the distributed runtime itself rather
    than by application code? torch.distributed's DistError family
    (DistBackendError, DistNetworkError, DistStoreError), any class of the
    torch.distributed modules, and the XLA runtime's types (a JAX-side
    error handed in) vouch for it. The fragments above are deliberately
    broad ('gloo', 'connection refused'), so the TYPE must vouch for the
    source: an auxiliary socket failing with 'Connection refused' in a sink
    or server is not a peer loss."""
    for klass in type(exc).__mro__:
        mod = getattr(klass, "__module__", "") or ""
        if mod == "torch.distributed" or mod.startswith("torch.distributed."):
            return True
        if mod.split(".", 1)[0] in ("jax", "jaxlib"):
            return True
        if "xlaruntimeerror" in klass.__name__.lower():
            return True
    return False


def is_peer_failure(exc: BaseException) -> bool:
    """Does this exception look like the distributed runtime reporting a
    dead/unreachable peer (as opposed to a genuine program error)? Both
    the message (a known peer-death fragment) and the type (the runtime
    raised it) must agree."""
    msg = str(exc).lower()
    if not any(f in msg for f in _PEER_FAILURE_FRAGMENTS):
        return False
    return _from_distributed_runtime(exc)


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
    treat the process as lost: checkpoint what is safe and exit. A
    peer-death error out of `fn` (is_peer_failure) becomes a SyncTimeout,
    bounded or not; any other error is re-raised unchanged.
    """
    if deadline is None:
        deadline = _SYNC_DEADLINE
    if not deadline:
        try:
            return fn()
        except Exception as e:
            # even unbounded, a peer-death ERROR (vs hang) out of the
            # runtime is a SyncTimeout-equivalent — same recovery path
            if is_peer_failure(e):
                raise SyncTimeout(
                    f"{what} failed on a peer error "
                    f"({str(e).splitlines()[0][:160]})", 0.0
                ) from e
            raise
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
        err = out["error"]
        if isinstance(err, Exception) and is_peer_failure(err):
            raise SyncTimeout(
                f"{what} failed on a peer error "
                f"({str(err).splitlines()[0][:160]})", deadline
            ) from err
        raise err
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


# ----------------------------------------------------------- peer liveness
class PeerAgreement:
    """Multi-process cooperative-stop check with a liveness heartbeat.

    At each agreement boundary every process contributes (process id,
    stop flag, step, step-time p50 ms, elastic flag, policy action)
    through ONE allgather (parallel/multihost.global_heartbeat). The stop
    verdict is the any-of vote (any process's flag stops everyone at the
    same boundary); the extra columns buy attribution — a peer whose p50
    is `straggler_factor` x the fleet median is logged as a straggler BY
    PROCESS ID, and a desynchronized step counter (which would eventually
    hang a collective) is reported the moment it is visible instead of
    when it deadlocks.

    A DEAD peer never reaches the allgather: with a sync deadline set
    (`set_sync_deadline` / `--sync-deadline`) the collective raises
    SyncTimeout out of `check`, which the trainer lets propagate — the CLI
    converts it into checkpoint-where-safe + EXIT_PREEMPTED on every
    surviving process. Without a deadline a dead peer still raises when
    the runtime reports it (is_peer_failure); a wedged one blocks.

    The elastic column is the GROW channel of elastic training
    (resilience/elastic.py): the rendezvous-hosting process sets it when a
    restarted host has announced itself, and since every process reads
    the same allgather rows, the whole fleet raises GrowRequested at the
    SAME sync boundary. The policy column is the SHRINK channel of the
    elastic policy (resilience/policy.py): the rendezvous host encodes a
    pending policy shrink as victim_rank + 1 (0 = none) and the whole
    fleet raises PolicyShrinkRequested at the same boundary. Precedence:
    a requested stop beats everything, a policy shrink beats a pending
    grow. `inspect()` keeps accepting 4-column rows so synthetic fleets
    and recorded heartbeats still parse.
    """

    def __init__(
        self,
        handler,
        agree_every: int = 16,
        step_time_fn: Optional[Callable[[], float]] = None,
        straggler_factor: float = 4.0,
        straggler_min_ms: float = 50.0,
        log_fn=None,
        flight=None,
        elastic_fn: Optional[Callable[[], float]] = None,
        policy_fn: Optional[Callable[[], float]] = None,
        signals=None,
        phases=None,
    ):
        self.handler = handler
        self.every = max(1, int(agree_every))
        self.step_time_fn = step_time_fn
        self.straggler_factor = float(straggler_factor)
        self.straggler_min_ms = float(straggler_min_ms)
        self.log_fn = log_fn
        #: derived-signal plane (obs/signals.SignalEngine): every
        #: heartbeat's rows also feed the straggler_skew signal.
        #: Duck-typed: anything with .note_heartbeat(rows, step).
        self.signals = signals
        #: phase recorder: the heartbeat allgather runs under an "agree"
        #: span — it is FLEET wait (blocked on the slowest peer), so it
        #: belongs on the timeline and outside host-attributable overhead
        self.phases = phases
        #: flight recorder: every heartbeat's rows land on the timeline, so
        #: a peer-loss dump shows the fleet's last agreed state
        self.flight = flight
        #: elastic grow channel: nonzero when THIS process wants the fleet
        #: to grow-remesh at this boundary (the rendezvous host polls its
        #: parked rejoiners; everyone else contributes 0 and reads the
        #: verdict from the allgather rows)
        self.elastic_fn = elastic_fn
        #: elastic policy channel (resilience/policy.ElasticPolicy.poll):
        #: victim_rank + 1 when the rendezvous host's policy decided to
        #: shrink, 0 otherwise
        self.policy_fn = policy_fn
        self._warned: set = set()

    def check(self, step: int) -> bool:
        """The trainers' stop_check: heartbeat + agreed stop verdict at the
        cadence, False (no collective) off it. Raises
        PolicyShrinkRequested / GrowRequested when the fleet-agreed policy
        / elastic column is set and no stop is pending."""
        if step % self.every != 0:
            return False
        import contextlib

        import numpy as np

        from ..parallel import multihost

        p50 = 0.0
        if self.step_time_fn is not None:
            p50 = float(self.step_time_fn() or 0.0)
        grow = 0.0
        if self.elastic_fn is not None:
            grow = float(self.elastic_fn() or 0.0)
        policy = 0.0
        if self.policy_fn is not None:
            policy = float(self.policy_fn() or 0.0)
        agree_span = (
            self.phases.span("agree") if self.phases is not None
            else contextlib.nullcontext()
        )
        with agree_span:
            rows = multihost.global_heartbeat([
                float(multihost.process_index()),
                1.0 if self.handler.requested else 0.0,
                float(step),
                p50,
                grow,
                policy,
            ])
        if self.flight is not None:
            self.flight.note_heartbeat(np.asarray(rows).tolist(), step)
        if self.signals is not None:
            self.signals.note_heartbeat(np.asarray(rows).tolist(), step)
        self.inspect(rows, step)
        stop = bool(rows[:, 1].max() > 0)
        if not stop and rows.shape[1] >= 6 and rows[:, 5].max() > 0:
            # a policy shrink outranks a pending grow: the encoded value is
            # victim_rank + 1, and every process decodes the same rows
            from .elastic import PolicyShrinkRequested

            raise PolicyShrinkRequested(
                step=step, victim=int(rows[:, 5].max()) - 1
            )
        if not stop and rows.shape[1] >= 5 and rows[:, 4].max() > 0:
            from .elastic import GrowRequested

            raise GrowRequested(step=step)
        return stop

    def inspect(self, rows, step: int) -> None:
        """Straggler / desync detection over one heartbeat's [P, 4..6]
        rows (public so tests can feed synthetic fleets; the elastic and
        policy columns, when present, are not inspected here)."""
        import numpy as np

        rows = np.asarray(rows)
        p50s = rows[:, 3]
        med = float(np.median(p50s))
        bar = max(self.straggler_min_ms, self.straggler_factor * med)
        for pid_f, _flag, peer_step, p50 in rows[:, :4]:
            pid = int(pid_f)
            if med > 0 and p50 > bar and ("straggler", pid) not in self._warned:
                self._warned.add(("straggler", pid))
                self._note({
                    "event": "straggler",
                    "process": pid,
                    "p50_ms": round(float(p50), 3),
                    "fleet_median_ms": round(med, 3),
                    "at_step": step,
                }, f"process {pid} is a straggler: p50 step time "
                   f"{p50:.1f}ms vs fleet median {med:.1f}ms")
            if int(peer_step) != int(step) and ("desync", pid) not in self._warned:
                self._warned.add(("desync", pid))
                self._note({
                    "event": "peer_desync",
                    "process": pid,
                    "peer_step": int(peer_step),
                    "at_step": step,
                }, f"process {pid} reports step {int(peer_step)} at the "
                   f"step-{step} agreement boundary — step counters have "
                   "desynchronized and the next collective may deadlock")

    def _note(self, record: Dict, msg: str) -> None:
        import warnings

        warnings.warn(msg, stacklevel=3)
        if self.log_fn:
            self.log_fn(dict(record))
