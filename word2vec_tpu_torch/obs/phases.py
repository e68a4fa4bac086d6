"""Host-side phase-timing breakdown: where does a training step's wall time go?

A copy of word2vec_tpu/obs/phases.py for the PyTorch port (host code; the
spans' names, stats and verdict are the JAX package's).

`utils/profiling.annotate` puts named regions on the torch.profiler
timeline, but reading them requires capturing and opening a trace.
`PhaseRecorder` is the always-on counterpart: a thread-safe span recorder the trainers wrap around
the same regions —

    batcher_wait — the training loop blocked pulling the next batch/chunk
                   from the prefetch queue (the host input pipeline could
                   not keep ahead of the device)
    h2d          — host->device placement of a batch/chunk (in the port:
                   the copy into the step graph's static input, issued
                   behind the running dispatch)
    dispatch     — host time spent issuing the (async) device work (in
                   the port: the graph replays of one dispatch)
    device_wait  — the loop blocked fetching already-dispatched metrics
                   (the lagged drain): device-side backpressure
    checkpoint   — checkpoint callback wall time
    epoch_prep   — an epoch's preparation, before its first batch is
                   asked for (the port's trainer: the shuffle, the words
                   of each step and the row order's upload on the resident
                   path, the batcher's epoch start on the streaming one)

— and aggregates into per-phase p50/p90 (shared percentile math with
profiling.StepTimer) plus an input-bound-vs-compute-bound verdict. The
verdict compares only the phases that STALL the training loop:
batcher_wait (input side) against dispatch + device_wait (device side);
h2d, checkpoint and epoch_prep are reported but excluded (overlapped
producer time stalls nothing; the verdict's phases are the JAX
package's).

Recording one span is two perf_counter reads and a lock — cheap enough to
leave on for every run.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, Iterator, Optional

from ..utils.profiling import annotate, lap_stats

#: phases that stall the training loop on the input side / device side
INPUT_PHASES = ("batcher_wait",)
COMPUTE_PHASES = ("dispatch", "device_wait")


class PhaseRecorder:
    """Thread-safe named-span recorder with bounded per-phase sample rings."""

    #: per-phase sample cap: percentiles come from the most recent samples
    #: (ring overwrite), totals/counts from every span ever recorded
    MAX_SAMPLES = 4096

    def __init__(self, tracer=None):
        #: optional span sink (obs/trace.TraceRing, duck-typed: anything
        #: with .complete(name, t0, dur_s)): every closed span also becomes
        #: one timeline event — the flight recorder's feed. reset() leaves
        #: it alone; set to None to detach.
        self.tracer = tracer
        self._lock = threading.Lock()
        self._laps: Dict[str, list] = {}
        self._counts: Dict[str, int] = {}
        self._totals: Dict[str, float] = {}
        # currently-OPEN spans per thread: {thread id: [(name, t0), ...]}.
        # The stall watchdog (resilience/watchdog.py) reads this to name the
        # wedged phase of a hung step — a span that never closes is exactly
        # the evidence completed-lap stats can't show.
        self._active: Dict[int, list] = {}

    def reset(self) -> None:
        with self._lock:
            self._laps.clear()
            self._counts.clear()
            self._totals.clear()
            self._active.clear()

    # ------------------------------------------------------------ recording
    def note(self, name: str, seconds: float) -> None:
        """Record one externally-timed span."""
        with self._lock:
            n = self._counts.get(name, 0)
            self._counts[name] = n + 1
            self._totals[name] = self._totals.get(name, 0.0) + seconds
            laps = self._laps.setdefault(name, [])
            if len(laps) < self.MAX_SAMPLES:
                laps.append(seconds)
            else:
                laps[n % self.MAX_SAMPLES] = seconds

    def _enter(self, name: str, t0: float) -> None:
        tid = threading.get_ident()
        with self._lock:
            self._active.setdefault(tid, []).append((name, t0))

    def _exit(self) -> None:
        tid = threading.get_ident()
        with self._lock:
            stack = self._active.get(tid)
            if stack:
                stack.pop()
            if not stack:
                self._active.pop(tid, None)

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time a region (and annotate it on the profiler timeline)."""
        with annotate(name):
            t0 = time.perf_counter()
            self._enter(name, t0)
            try:
                yield
            finally:
                self._exit()
                dur = time.perf_counter() - t0
                self.note(name, dur)
                if self.tracer is not None:
                    self.tracer.complete(name, t0, dur)

    def timed_iter(self, iterable: Iterable, name: str) -> Iterator:
        """Yield from `iterable`, recording each next() as one `name` span
        (the consumer-side blocked-on-producer time of a prefetch queue)."""
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            self._enter(name, t0)
            try:
                item = next(it)
            except StopIteration:
                return
            finally:
                self._exit()
            dur = time.perf_counter() - t0
            self.note(name, dur)
            if self.tracer is not None:
                self.tracer.complete(name, t0, dur)
            yield item

    # ------------------------------------------------------- liveness view
    def open_spans(self) -> Dict[str, float]:
        """{phase: seconds open} of every currently-OPEN span, keeping the
        oldest occurrence per name across threads. Empty between spans."""
        now = time.perf_counter()
        with self._lock:
            out: Dict[str, float] = {}
            for stack in self._active.values():
                for name, t0 in stack:
                    age = now - t0
                    if age > out.get(name, -1.0):
                        out[name] = age
            return out

    def wedged_phase(self) -> Optional[str]:
        """The phase most plausibly responsible for a stalled step: the
        longest-open LOOP-STALLING span (batcher_wait / dispatch /
        device_wait / checkpoint — overlapped producer h2d stalls nothing),
        falling back to the longest-open span of any name, or None when no
        span is open (the hang is in the loop body itself or on device)."""
        opens = self.open_spans()
        if not opens:
            return None
        stalling = {
            n: a for n, a in opens.items()
            if n in INPUT_PHASES + COMPUTE_PHASES + ("checkpoint",)
        }
        pick = stalling or opens
        return max(pick, key=lambda n: pick[n])

    # ----------------------------------------------------------- reporting
    def snapshot(self) -> Dict[str, Dict]:
        """{phase: {count, total_ms, p50_ms, p90_ms, ...}} — {} before any
        span lands, so log records can include it conditionally."""
        with self._lock:
            out = {}
            for name, laps in self._laps.items():
                s = lap_stats(laps)
                s["count"] = self._counts[name]
                s["total_ms"] = 1e3 * self._totals[name]
                out[name] = s
            return out

    def verdict(self) -> Dict:
        """Input-bound vs compute-bound, from loop-stalling totals only."""
        with self._lock:
            inp = sum(self._totals.get(p, 0.0) for p in INPUT_PHASES)
            comp = sum(self._totals.get(p, 0.0) for p in COMPUTE_PHASES)
        if inp + comp <= 0.0:
            return {"verdict": "indeterminate", "input_fraction": None}
        frac = inp / (inp + comp)
        return {
            "verdict": "input-bound" if frac > 0.5 else "compute-bound",
            "input_fraction": round(frac, 4),
        }

    def report(self) -> Optional[Dict]:
        """TrainReport.phases payload: per-phase stats + the verdict.
        None when nothing was recorded (a trainer that never ran)."""
        snap = self.snapshot()
        if not snap:
            return None
        return {"phases": snap, **self.verdict()}
