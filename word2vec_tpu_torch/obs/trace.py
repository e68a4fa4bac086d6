"""Step-scoped structured tracing: a bounded event ring + Chrome-trace export.

A copy of word2vec_tpu/obs/trace.py for the PyTorch port (host code; the
track pid is the process index, obs/flight._process_index). The
PhaseRecorder answers *where does step time go on average*; what it cannot
answer is *what was this process doing in the seconds before it died* —
that needs the TIMELINE, not the aggregate. This module is that timeline:

  TraceRing         — a thread-safe bounded ring of Chrome-trace events.
                      Recording one event is a dict build + a deque append
                      under a lock (no allocation cliffs, no I/O, no device
                      interaction), cheap enough to leave on for every run —
                      the flight recorder (obs/flight.py) does exactly that.
  chrome_trace_doc  — ring events -> a Chrome-trace/Perfetto JSON document
                      (one process track per host, threads renumbered to
                      stable small tids). Open in ui.perfetto.dev or
                      chrome://tracing.
  merge_traces      — merge per-process docs into one multi-track doc,
                      aligned BY STEP INDEX: hosts share no clock, but they
                      do share the global step counter (the same invariant
                      the collective cadence rides), so the earliest step
                      boundary every host recorded becomes the common t0.
                      Host identity comes from each doc's process_index
                      metadata.
  validate_trace_doc — the schema check CI and tests run against every
                      exported artifact (an unopenable trace is not evidence).

Event vocabulary (all host-side wall clock, ts/dur in microseconds):
  'X' complete spans — the PhaseRecorder phases (batcher_wait / h2d /
      dispatch / device_wait / checkpoint / epoch_prep) plus the step/chunk/epoch parents
      the trainers emit at boundaries (args carry the step index); on the
      card, one `device` span a dispatch on a `device` track: the card's
      own start and length of it (obs/flight.DispatchTimeline);
  'C' counter events — the health counters from the trainers' lagged
      metrics drain (loss, grad_norm, nonfinite counts);
  'i' instant events — one-off marks (multi-process heartbeat rows).

"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, Iterable, List, Optional

#: default event capacity of a ring (~16 events/step x 512 steps)
DEFAULT_CAPACITY = 8192

#: X-event names that are step-scoped PARENTS, not phase spans: their args
#: carry the optimizer-step index ("step", and "steps" for the chunk width),
#: which is what the cross-host merge and tracediff's per-step math key on
STEP_PARENTS = ("step", "chunk")


class TraceRing:
    """Thread-safe bounded ring of Chrome-trace events.

    Timestamps are `time.perf_counter()` microseconds relative to the ring's
    construction (`t0`), so they compose directly with the PhaseRecorder's
    span clocks; `wall0` anchors the axis to wall (Unix) time, for humans and
for laying a torch.profiler trace over it (chrome_trace_doc's
`origin_unix_s`). When the
    ring is full the oldest event is overwritten (`dropped` counts how many)
    — the flight recorder wants the LAST N steps, not the first.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(1, int(capacity))
        )
        self.t0 = time.perf_counter()
        self.wall0 = time.time()
        self.dropped = 0

    def _push(self, ev: Dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    # ------------------------------------------------------------ recording
    def complete(
        self,
        name: str,
        t0: float,
        dur_s: float,
        args: Optional[Dict] = None,
        tid=None,
    ) -> None:
        """One finished span ('X'): `t0` is a perf_counter read, `dur_s`
        seconds. This is the PhaseRecorder's emission hook (obs/phases.py).
        `tid` names a track of its own (a string: the trainer's `device`
        track) in place of the calling thread's."""
        ev: Dict = {
            "name": name,
            "ph": "X",
            "ts": round(1e6 * (t0 - self.t0), 1),
            "dur": round(1e6 * dur_s, 1),
            "tid": threading.get_ident() if tid is None else tid,
        }
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """One counter sample ('C'): numeric series (the health drain)."""
        self._push({
            "name": name,
            "ph": "C",
            "ts": round(1e6 * (time.perf_counter() - self.t0), 1),
            "tid": threading.get_ident(),
            "args": {k: float(v) for k, v in values.items()},
        })

    def instant(self, name: str, args: Optional[Dict] = None) -> None:
        """One instantaneous mark ('i')."""
        ev: Dict = {
            "name": name,
            "ph": "i",
            "ts": round(1e6 * (time.perf_counter() - self.t0), 1),
            "tid": threading.get_ident(),
            "s": "p",  # process-scoped mark
        }
        if args:
            ev["args"] = args
        self._push(ev)

    # ------------------------------------------------------------ reporting
    def events(self) -> List[Dict]:
        """Snapshot of the ring's events, oldest first."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# --------------------------------------------------------------- documents
def chrome_trace_doc(
    events: Iterable[Dict],
    process_index: int = 0,
    process_name: Optional[str] = None,
    metadata: Optional[Dict] = None,
    origin_unix_s: Optional[float] = None,
) -> Dict:
    """Assemble ring events into one Chrome-trace/Perfetto JSON document.

    One process track (`pid` = the process index — the torch.distributed
    rank, which is what lets merge_traces name hosts);
    thread ids are renumbered to stable small ints in order of first
    appearance, with 'M' metadata events naming the tracks (a track given
    by name, as the trainer's `device` track, keeps its name).
    `origin_unix_s`, the Unix time of ts 0 (a ring's `wall0`), goes into
    the metadata as `clock_origin_unix_us`: torch.profiler stamps its
    events on the Unix clock, so a profiler trace of the same run lays
    over this one by that offset.
    """
    pid = int(process_index)
    tid_map: Dict = {}
    out: List[Dict] = []
    for ev in events:
        ev = dict(ev)
        raw_tid = ev.pop("tid", 0)
        tid = tid_map.setdefault(raw_tid, len(tid_map))
        ev["pid"] = pid
        ev["tid"] = tid
        out.append(ev)
    meta_events: List[Dict] = [{
        "name": "process_name",
        "ph": "M",
        "pid": pid,
        "tid": 0,
        "args": {"name": process_name or f"host {pid}"},
    }]
    for raw, tid in tid_map.items():
        meta_events.append({
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": raw if isinstance(raw, str)
                     else "main" if tid == 0 else f"thread-{tid}"},
        })
    if origin_unix_s is not None:
        metadata = {"clock_origin_unix_us": round(1e6 * origin_unix_s, 1),
                    **(metadata or {})}
    return {
        "traceEvents": meta_events + out,
        "displayTimeUnit": "ms",
        "metadata": {
            "process_index": pid,
            "exported_utc": time.strftime(
                "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
            ),
            **(metadata or {}),
        },
    }


def write_trace(path: str, doc: Dict) -> str:
    """Atomic write (tmp + rename, like the manifest writer)."""
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"), default=str)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_trace(path: str) -> Dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome-trace document")
    return doc


def validate_trace_doc(doc: Dict) -> Dict[str, int]:
    """Schema check over a Chrome-trace document; returns per-phase event
    counts. Raises ValueError naming the first offending event — the same
    validation CI's trace job runs on every exported artifact."""
    if not isinstance(doc, dict) or not isinstance(
        doc.get("traceEvents"), list
    ):
        raise ValueError("not a Chrome-trace document: no traceEvents list")
    counts: Dict[str, int] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object")
        for field in ("name", "ph"):
            if not isinstance(ev.get(field), str) or not ev[field]:
                raise ValueError(f"event {i}: missing {field!r}")
        ph = ev["ph"]
        if not isinstance(ev.get("pid"), int) or not isinstance(
            ev.get("tid"), int
        ):
            raise ValueError(f"event {i} ({ev['name']!r}): pid/tid not ints")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, (int, float)) or ts < 0:
                raise ValueError(
                    f"event {i} ({ev['name']!r}): bad ts {ts!r}"
                )
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(
                    f"event {i} ({ev['name']!r}): bad dur {dur!r}"
                )
        counts[ph] = counts.get(ph, 0) + 1
    return counts


# ------------------------------------------------------------------- merge
def _doc_pid(doc: Dict) -> int:
    md = doc.get("metadata") or {}
    pid = md.get("process_index")
    if isinstance(pid, int):
        return pid
    for ev in doc.get("traceEvents", []):
        if isinstance(ev.get("pid"), int):
            return ev["pid"]
    return 0


def _step_starts(doc: Dict) -> Dict[int, float]:
    """{step index: start ts} from a doc's step/chunk parent events (first
    occurrence wins; step counters only advance, so first == earliest)."""
    starts: Dict[int, float] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("name") in STEP_PARENTS:
            s = (ev.get("args") or {}).get("step")
            if isinstance(s, (int, float)):
                starts.setdefault(int(s), float(ev["ts"]))
    return starts


def merge_traces(docs: List[Dict]) -> Dict:
    """Merge per-process trace docs into one multi-track document.

    Hosts share no wall clock, but the global step counter advances in
    lockstep across the fleet (the collective cadence depends on it), so
    timelines are aligned by STEP INDEX: the earliest step boundary present
    in EVERY doc becomes the common anchor and each doc's timestamps shift
    so its anchor lands at the reference doc's. Docs with no common step
    (or none at all) fall back to aligning their earliest event. Process
    identity (the track pid) comes from each doc's process_index metadata —
    the same pid the heartbeat rows carry. Deterministic: docs are sorted
    by pid first, so input order never changes the output.
    """
    docs = [d for d in docs if d and d.get("traceEvents")]
    if not docs:
        return {
            "traceEvents": [],
            "displayTimeUnit": "ms",
            "metadata": {"merged": True, "processes": []},
        }
    docs = sorted(docs, key=_doc_pid)
    step_maps = [_step_starts(d) for d in docs]
    common = set(step_maps[0])
    for m in step_maps[1:]:
        common &= set(m)
    anchor = min(common) if common else None

    def doc_min_ts(d: Dict) -> float:
        return min(
            (
                float(e["ts"])
                for e in d["traceEvents"]
                if e.get("ph") != "M" and "ts" in e
            ),
            default=0.0,
        )

    ref_min = doc_min_ts(docs[0])
    events: List[Dict] = []
    pids: List[int] = []
    seen: set = set()
    for d, m in zip(docs, step_maps):
        if anchor is not None:
            off = step_maps[0][anchor] - m[anchor]
        else:
            off = ref_min - doc_min_ts(d)
        pid = _doc_pid(d)
        while pid in seen:  # collision: keep tracks distinct, deterministic
            pid += 1
        seen.add(pid)
        pids.append(pid)
        for ev in d["traceEvents"]:
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") != "M" and "ts" in ev:
                ev["ts"] = round(float(ev["ts"]) + off, 1)
            events.append(ev)
    # normalize: alignment offsets can push pre-anchor events negative
    tmin = min(
        (e["ts"] for e in events if e.get("ph") != "M" and "ts" in e),
        default=0.0,
    )
    if tmin < 0:
        for e in events:
            if e.get("ph") != "M" and "ts" in e:
                e["ts"] = round(e["ts"] - tmin, 1)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "merged": True,
            "processes": pids,
            "anchor_step": anchor,
        },
    }
