"""Bounded profiler windows: device evidence, armed at step boundaries.

The port's counterpart of word2vec_tpu/obs/profiler.py, on
torch.profiler. An SLO breach (obs/slo.py) says a run regressed; the
artifact that says WHY is a device trace of the run while it regressed.
A ProfilerCapture starts `torch.profiler.profile` (CPU and, on the card,
CUDA activity: the kernels launched inside CUDA graph replays appear by
name) for a BOUNDED window and writes a schema-checked capture manifest
(`capture_<n>.json`, the JAX package's schema) next to flight.json, the
window's Chrome trace (`profile_<n>/trace.json`) beside it.

Discipline:

  bounded      — a capture runs for exactly `steps` step boundaries
                 (`--profile-on-breach N`), then stops; `finish()` stops a
                 window the run ended inside. Never an unbounded trace.
                 The card is synchronized at both edges (the only syncs
                 the profiler adds), so a window holds exactly the steps
                 dispatched between its boundaries.
  one per      — the breach episode's single `slo_breach` event requests
  episode        one capture; a cooldown additionally gates re-arming.
  boundary-    — triggers only REQUEST a capture (`request()` is a flag
  armed          write); arming happens at the next step boundary on the
                 training thread (`on_boundary` from Trainer._check_stop),
                 so signal handlers (SIGUSR2) and bus callbacks never start
                 the profiler themselves. Idle boundaries are two checks.
  structural   — a profiler that cannot start (another one is running, as
  degrade        under --profile) writes the capture manifest with
                 `status: "error"` and the exception, rc untouched.

Programmatic windows ride the same machinery: `schedule(a, b)` arms at
step >= a and stops at step >= b (`--profile-steps A:B`), and SIGUSR2
(resilience/shutdown.install_usr2_profile) requests an on-demand window
plus a memory-ledger dump without stopping the run.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

SCHEMA = 1

#: default bounded window, in step boundaries
CAPTURE_STEPS_DEFAULT = 8
#: default seconds between captures (breach episodes inside the cooldown
#: are counted but not captured)
COOLDOWN_S_DEFAULT = 120.0
#: hard cap on captures per process — a run-away trigger cannot fill a disk
MAX_CAPTURES_DEFAULT = 8
#: the window's Chrome trace, inside profile_<n>/
TRACE_FILE = "trace.json"


def validate_capture_doc(doc: Dict) -> Dict[str, int]:
    """Schema gate for capture_<n>.json; returns summary counts, raises
    ValueError naming the first offending field."""
    if not isinstance(doc, dict):
        raise ValueError("not a capture manifest: not an object")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"bad schema {doc.get('schema')!r} (want {SCHEMA})")
    if doc.get("event") != "profiler_capture":
        raise ValueError(f"bad event {doc.get('event')!r}")
    if not isinstance(doc.get("reason"), str) or not doc["reason"]:
        raise ValueError("missing reason")
    if doc.get("status") not in ("ok", "error"):
        raise ValueError(f"bad status {doc.get('status')!r}")
    if doc["status"] == "ok":
        for key in ("armed_step", "stopped_step"):
            if not isinstance(doc.get(key), int):
                raise ValueError(f"missing integer {key}")
        if doc["stopped_step"] < doc["armed_step"]:
            raise ValueError(
                f"stopped_step {doc['stopped_step']} precedes armed_step "
                f"{doc['armed_step']}"
            )
        if not isinstance(doc.get("trace_dir"), str):
            raise ValueError("missing trace_dir")
        if not isinstance(doc.get("files"), list):
            raise ValueError("missing files list")
    else:
        if not isinstance(doc.get("error"), str):
            raise ValueError("status=error without error text")
    if not isinstance(doc.get("steps_budget"), int):
        raise ValueError("missing steps_budget")
    return {
        "files": len(doc.get("files") or ()),
        "steps": (
            doc.get("stopped_step", 0) - doc.get("armed_step", 0)
            if doc["status"] == "ok" else 0
        ),
    }


def _sync() -> None:
    """Wait for the card: a window holds exactly the steps dispatched
    between its two boundaries, not the tail of the dispatch before it."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _start_profiler():
    """A started torch.profiler.profile over the host and, when there is
    a card, the device."""
    import torch

    from ..utils.profiling import activities

    _sync()
    prof = torch.profiler.profile(activities=activities())
    prof.start()
    return prof


class ProfilerCapture:
    """Bounded torch.profiler windows with a schema-checked manifest each."""

    def __init__(
        self,
        out_dir: str,
        steps: int = CAPTURE_STEPS_DEFAULT,
        cooldown_s: float = COOLDOWN_S_DEFAULT,
        max_captures: int = MAX_CAPTURES_DEFAULT,
        log_fn: Optional[Callable[[Dict], None]] = None,
        flight=None,
    ):
        self.out_dir = out_dir
        self.steps = max(1, int(steps))
        self.cooldown_s = float(cooldown_s)
        self.max_captures = max(1, int(max_captures))
        self.log_fn = log_fn
        self.flight = flight
        self._lock = threading.Lock()
        #: pending request reason (signal handlers / bus callbacks write it;
        #: the training thread consumes it at the next boundary)
        self._requested: Optional[str] = None
        #: scheduled [a, b) step window (--profile-steps)
        self._window: Optional[tuple] = None
        self.active = False
        self._prof = None
        self._reason = ""
        self._armed_step = 0
        self._stop_after: Optional[int] = None
        self._trace_dir = ""
        self.captures = 0
        self.suppressed = 0
        self._last_capture_t: Optional[float] = None
        self.manifests: List[str] = []
        #: host ms of the last window's profiler start and stop (the stop
        #: includes writing its trace)
        self.timing: Dict[str, float] = {}

    # ------------------------------------------------------------ triggers
    def request(self, reason: str) -> bool:
        """Ask for a capture at the next step boundary. Safe from any
        thread or signal context — a flag write, nothing else. Returns
        False (and counts `suppressed`) inside the cooldown, when a
        capture is already active/pending, or past the capture cap."""
        with self._lock:
            if self.active or self._requested is not None:
                self.suppressed += 1
                return False
            if self.captures >= self.max_captures:
                self.suppressed += 1
                return False
            if (
                self._last_capture_t is not None
                and time.monotonic() - self._last_capture_t < self.cooldown_s
            ):
                self.suppressed += 1
                return False
            self._requested = str(reason)
            return True

    def schedule(self, start_step: int, stop_step: int) -> None:
        """Programmatic window: arm at step >= start, stop at step >= stop
        (`--profile-steps A:B`). Cooldown does not apply — the operator
        asked for exactly this window."""
        if stop_step <= start_step:
            raise ValueError(
                f"--profile-steps window is empty: [{start_step}, "
                f"{stop_step})"
            )
        with self._lock:
            self._window = (int(start_step), int(stop_step))

    def attach(self, bus) -> Callable[[], None]:
        """Subscribe the breach trigger to a SignalBus's `slo` topic: one
        capture request per breach episode. Returns the unsubscribe
        callable."""
        def on_slo(ev: Dict) -> None:
            if ev.get("event") == "slo_breach":
                self.request(
                    f"slo_breach:{ev.get('rule', ev.get('signal', '?'))}"
                )

        return bus.subscribe("slo", on_slo)

    # ------------------------------------------------------------ boundary
    def on_boundary(self, step: int) -> None:
        """The trainer beat (Trainer._check_stop). Idle boundaries (no
        request, no window, not active) are None-checks — no profiler, no
        clock, no device work."""
        if self.active:
            if self._stop_after is not None and step >= self._stop_after:
                self._stop(step)
            return
        if self._window is not None:
            a, b = self._window
            if step >= b:
                self._window = None
            elif step >= a:
                self._window = None
                self._arm("scheduled", step, stop_after=b)
                return
        if self._requested is not None:
            with self._lock:
                reason, self._requested = self._requested, None
            self._arm(reason, step, stop_after=int(step) + self.steps)

    def finish(self, step: Optional[int] = None) -> None:
        """Run end: stop a window the run ended inside (the bounded
        contract holds on every exit path)."""
        if self.active:
            self._stop(int(step) if step is not None else self._armed_step)

    # ------------------------------------------------------------ internals
    def _arm(self, reason: str, step: int, stop_after: int) -> None:
        self.captures += 1
        n = self.captures
        self._reason = reason
        self._armed_step = int(step)
        self._stop_after = int(stop_after)
        self._trace_dir = os.path.join(self.out_dir, f"profile_{n}")
        self._last_capture_t = time.monotonic()
        err: Optional[str] = None
        t0 = time.perf_counter()
        try:
            os.makedirs(self._trace_dir, exist_ok=True)
            self._prof = _start_profiler()
            self.active = True
        except Exception as e:  # noqa: BLE001 — structural degrade
            err = f"{type(e).__name__}: {e}"
        self.timing = {"start_ms": (time.perf_counter() - t0) * 1e3}
        if err is not None:
            # the manifest is still the contract — status carries the why
            self._write_manifest(n, step, err=err)
            self.active = False
        self._note({"event": "profiler_armed", "reason": reason,
                    "step": int(step), "capture": n,
                    "status": "error" if err else "ok"})

    def _stop(self, step: int) -> None:
        err: Optional[str] = None
        t0 = time.perf_counter()
        try:
            prof, self._prof = self._prof, None
            _sync()
            prof.stop()
            prof.export_chrome_trace(os.path.join(self._trace_dir, TRACE_FILE))
        except Exception as e:  # noqa: BLE001 — structural degrade
            err = f"{type(e).__name__}: {e}"
        self.timing["stop_ms"] = (time.perf_counter() - t0) * 1e3
        self.active = False
        self._stop_after = None
        path = self._write_manifest(
            self.captures, step, err=err, stopped=True
        )
        self._note({
            "event": "profiler_capture",
            "reason": self._reason,
            "capture": self.captures,
            "armed_step": self._armed_step,
            "stopped_step": int(step),
            "manifest": path,
            "status": "error" if err else "ok",
        })

    def _write_manifest(self, n: int, step: int,
                        err: Optional[str] = None,
                        stopped: bool = False) -> Optional[str]:
        files: List[str] = []
        if stopped and err is None:
            for root, _dirs, names in os.walk(self._trace_dir):
                for name in names:
                    files.append(os.path.relpath(
                        os.path.join(root, name), self._trace_dir
                    ))
        doc: Dict = {
            "schema": SCHEMA,
            "event": "profiler_capture",
            "created_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            "capture": n,
            "reason": self._reason,
            "steps_budget": self.steps,
            "status": "error" if err else "ok",
        }
        if err:
            doc["error"] = err
        else:
            doc.update({
                "armed_step": self._armed_step,
                "stopped_step": int(step),
                "trace_dir": self._trace_dir,
                "files": sorted(files),
            })
        path = os.path.join(self.out_dir, f"capture_{n}.json")
        try:
            os.makedirs(self.out_dir, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, default=str)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            return None
        self.manifests.append(path)
        return path

    def _note(self, rec: Dict) -> None:
        if self.flight is not None:
            self.flight.log_record(rec)
        if self.log_fn is not None:
            try:
                self.log_fn(dict(rec))
            except Exception:  # noqa: BLE001 — telemetry about telemetry
                pass

    def summary(self) -> Dict:
        """Manifest end-field: how many windows ran, how many triggers the
        cooldown swallowed, where the manifests are."""
        return {
            "captures": self.captures,
            "suppressed": self.suppressed,
            "steps_budget": self.steps,
            "cooldown_s": self.cooldown_s,
            "manifests": list(self.manifests),
        }
