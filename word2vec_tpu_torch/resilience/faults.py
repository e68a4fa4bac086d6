"""Declarative fault injection: the chaos plan behind the chaos tests.

A copy of word2vec_tpu/resilience/faults.py for the PyTorch port: the
same spec grammar, kinds and firing log. Two deliveries are torch's: `nan`
writes NaN into the param tensors in place — in the trainer those are its
persistent buffers, the ones its CUDA graphs replay against, so the next
replay reads the poison — and the `oom` event raises
torch.OutOfMemoryError, the type a real CUDA allocation failure raises, so
the server treats an injected and a real one alike. The injection points:
the trainer's dispatch boundaries (train.Trainer._check_stop and its entry,
for the step kinds), each checkpoint save attempt (io/checkpoint.py,
`ckpt_oserror`) and the serve batch executor (`oom`).

A `FaultPlan` is a list of `Fault`s, each naming WHAT breaks and WHEN,
parsed from a compact spec string:

    nan@40                  poison the params with NaN at step-boundary 40
    stall@10:secs=0.5       sleep 0.5s at step-boundary 10 (slow batcher)
    hang@10:secs=300        wedge the main loop for 300s (default 3600) at
                            boundary 10 — the step watchdog's prey: past
                            --step-deadline the run is shot EXIT_STALLED
    sigterm@25              deliver SIGTERM to this process at boundary 25
    peer_dead@25            SIGKILL this process at boundary 25 (a lost
                            host: uncatchable, no cleanup — survivors of a
                            multi-process run must abort via the bounded
                            collectives / watchdog instead of hanging)
    peer_rejoin@25          SIGKILL this process at boundary 25, like
                            peer_dead — the distinct kind tells the chaos
                            HARNESS (benchmarks/multiproc.py --chaos
                            elastic) to relaunch the victim afterwards, so
                            the elastic grow path (announce -> sync-boundary
                            admission, resilience/elastic.py) is exercised;
                            in-process delivery is identical to peer_dead
    rank0_dead@25           SIGKILL this process at boundary 25, like
                            peer_dead — the distinct kind documents that
                            the victim is the RENDEZVOUS HOST (rank 0),
                            so the harness (benchmarks/multiproc.py
                            --chaos rank0) injects it into rank 0 and
                            asserts the survivors RE-ELECT the rendezvous
                            (lowest surviving rank binds its standby
                            address) and shrink cleanly instead of the
                            old abort-to-requeue degrade; in-process
                            delivery is identical to peer_dead
    sync_timeout@25         raise resilience.watchdog.SyncTimeout at
                            boundary 25 — a dead-peer detection without
                            needing a real fleet; also the repro for the
                            single-host hole (a SyncTimeout with
                            num_processes == 1 must fail fast with a
                            structured error, not pretend a peer was lost)
    ckpt_oserror:times=2    the next 2 checkpoint writes raise OSError

Tokens are comma-separated; `@k` pins the optimizer-step boundary at (or
after — chunked dispatch observes boundaries per chunk) which the fault
fires, `:key=val` sets extras (`times` = firings before the fault is spent,
default 1; `secs` = stall duration). A spec that is a path to a `.json`
file is loaded as `[{"kind": ..., "step": ..., ...}, ...]`.

Two delivery channels:
  * step faults (nan/stall/sigterm) — the trainers call
    `FaultPlan.on_step(state)` at every observed step boundary (per-step
    loop: every optimizer step; chunked: every chunk boundary, plus once
    before the first dispatch so `nan@0` poisons the initial params the way
    `--inject-nan` did).
  * event faults (ckpt_oserror, oom) — code with an injection point
    calls `faults.raise_if_active(kind)`; the module-level active plan
    (set with `activate()`) decides.

Every firing is appended to `plan.log` so tests and the bench's fault run
can assert WHAT actually fired, not just observe the wreckage.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, List, Optional

#: fault kinds delivered at optimizer-step boundaries by the trainers
STEP_KINDS = (
    "nan", "stall", "hang", "sigterm", "peer_dead", "peer_rejoin",
    "rank0_dead", "sync_timeout",
)
#: fault kinds delivered at named injection points via raise_if_active()
#: (oom: a torch.OutOfMemoryError allocation failure — the serve
#: batch executor's injection point; the server must fail the affected
#: requests 503 and keep serving, never die)
EVENT_KINDS = ("ckpt_oserror", "oom")
#: fault kinds delivered at streaming SEGMENT boundaries by the
#: continuous-training driver (stream/driver.py calls
#: FaultPlan.on_segment at every segment start; `@k` pins the segment
#: index, not an optimizer step):
#:   stream_stall@k[:secs=S]  sleep S in the segment pipeline — an ingest
#:                            hiccup (slow shard storage, a stalled pipe
#:                            producer) the run must absorb as batcher
#:                            wait, never as a crash
#:   vocab_growth@k[:n=N]     force an online-growth admission of N
#:                            synthetic words at the next boundary, so the
#:                            chaos matrix exercises the growth path
#:                            (reserved-row admission, device-table
#:                            rebuild, generation bump) on any stream
STREAM_KINDS = ("stream_stall", "vocab_growth")
KINDS = STEP_KINDS + EVENT_KINDS + STREAM_KINDS

#: default `secs` per kind: a stall is a measured slow-batcher blip, a hang
#: is meant to OUTLIVE any sane step deadline (the watchdog shoots the
#: process long before the sleep returns)
_DEFAULT_SECS = {"hang": 3600.0}


@dataclasses.dataclass
class Fault:
    kind: str
    step: int = 0                    # boundary at/after which a step fault fires
    times: int = 1                   # firings before the fault is spent
    secs: Optional[float] = None     # stall/hang duration (kind default)
    n: int = 1                       # vocab_growth: synthetic words to admit
    fired: int = 0                   # firings so far (mutable state)

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (known: {', '.join(KINDS)})"
            )
        if self.step < 0:
            raise ValueError(f"fault step must be >= 0, got {self.step}")
        if self.times < 1:
            raise ValueError(f"fault times must be >= 1, got {self.times}")
        if self.secs is None:
            self.secs = _DEFAULT_SECS.get(self.kind, 0.25)
        if self.secs < 0:
            raise ValueError(f"fault secs must be >= 0, got {self.secs}")
        if self.n < 1:
            raise ValueError(f"fault n must be >= 1, got {self.n}")

    @property
    def spent(self) -> bool:
        return self.fired >= self.times

    def to_json(self) -> Dict:
        return {
            "kind": self.kind, "step": self.step, "times": self.times,
            "secs": self.secs, "n": self.n, "fired": self.fired,
        }


def _parse_token(tok: str) -> Fault:
    """One spec clause: kind[@step][:key=val]... (error messages omit the
    clause text — FaultPlan.parse wraps them with clause + offset context)."""
    parts = tok.strip().split(":")
    head, extras = parts[0], parts[1:]
    if "@" in head:
        kind, _, step_s = head.partition("@")
        try:
            step = int(step_s)
        except ValueError:
            raise ValueError(f"step {step_s!r} is not an integer") from None
    else:
        kind, step = head, 0
    kwargs: Dict = {"kind": kind.strip(), "step": step}
    for ex in extras:
        key, sep, val = ex.partition("=")
        if not sep:
            raise ValueError(f"expected key=val, got {ex!r}")
        key = key.strip()
        try:
            if key == "times":
                kwargs["times"] = int(val)
            elif key == "secs":
                kwargs["secs"] = float(val)
            elif key == "n":
                kwargs["n"] = int(val)
            else:
                raise ValueError(
                    f"unknown key {key!r} (known: times, secs, n)"
                )
        except ValueError as e:
            if "unknown key" in str(e):
                raise
            raise ValueError(
                f"bad value {val!r} for key {key!r}"
            ) from None
    return Fault(**kwargs)


class FaultPlan:
    """An ordered set of injections plus a log of what actually fired."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults: List[Fault] = list(faults or [])
        #: every firing: {"kind", "step", "at_step"} (at_step = observed
        #: boundary for step faults; the injection point's name for events)
        self.log: List[Dict] = []

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Parse a comma-separated spec string, or a path to a JSON file.

        Parse errors name the offending CLAUSE and its character offset in
        the spec (`nan@40,bogus@x` -> "clause 2 ('bogus@x') at offset 7:
        unknown fault kind 'bogus'"), so a typo'd chaos plan fails with a
        pointer, not a generic ValueError.
        """
        spec = (spec or "").strip()
        if not spec:
            return cls()
        if spec.endswith(".json") or os.path.isfile(spec):
            with open(spec) as f:
                raw = json.load(f)
            faults = []
            for i, d in enumerate(raw):
                try:
                    if not isinstance(d, dict):
                        raise ValueError(
                            f"expected an object, got {type(d).__name__}"
                        )
                    faults.append(
                        Fault(**{k: v for k, v in d.items() if k != "fired"})
                    )
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        f"bad fault plan {spec!r} entry {i}: {e}"
                    ) from None
            return cls(faults)
        faults = []
        pos = 0
        for i, tok in enumerate(spec.split(",")):
            clause = tok.strip()
            if clause:
                offset = pos + (len(tok) - len(tok.lstrip()))
                try:
                    faults.append(_parse_token(clause))
                except ValueError as e:
                    raise ValueError(
                        f"clause {i + 1} ({clause!r}) at offset {offset}: {e}"
                    ) from None
            pos += len(tok) + 1  # +1 for the comma
        return cls(faults)

    def __bool__(self) -> bool:
        return bool(self.faults)

    def to_json(self) -> List[Dict]:
        return [f.to_json() for f in self.faults]

    # ----------------------------------------------------- step delivery
    def on_step(self, state, trainer=None) -> None:
        """Deliver every due, unspent step fault at this boundary.

        `state` is a train.TrainState (needs .step and .params, a dict of
        tensors: the trainer's own buffers); `trainer`, when given, fills
        its tables for a nan fault (train.Trainer.fill_params), and a fault
        that needs the config or the phase recorder can reach them. Chunked
        dispatch calls this at chunk boundaries, so a fault pinned inside a
        chunk fires at the first boundary past its step — the plan's step is
        a not-before bound, not an exact landing."""
        for f in self.faults:
            if f.kind not in STEP_KINDS or f.spent or state.step < f.step:
                continue
            f.fired += 1
            self.log.append(
                {"kind": f.kind, "step": f.step, "at_step": state.step}
            )
            if f.kind == "nan":
                if trainer is not None:
                    # the trainer's live buffers (every replica's under
                    # data parallelism: Trainer.fill_params)
                    trainer.fill_params(state, float("nan"))
                else:
                    for v in state.params.values():
                        if v.is_floating_point():
                            v.fill_(float("nan"))
            elif f.kind in ("stall", "hang"):
                # same mechanism, different intent: a stall is a short blip
                # the run absorbs (bench measures it as overhead); a hang's
                # default 3600s sleep wedges the main loop past any sane
                # --step-deadline so the watchdog's EXIT_STALLED path runs
                time.sleep(f.secs)
            elif f.kind == "sigterm":
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind in ("peer_dead", "peer_rejoin", "rank0_dead"):
                # a LOST host, not an evicted one: SIGKILL is uncatchable,
                # so no cooperative stop, no final checkpoint, no collective
                # farewell — exactly what the survivors' bounded collectives
                # and step watchdog must turn into a bounded abort (or, with
                # --elastic, into a shrink-remesh). peer_rejoin differs only
                # in what the harness does next: it relaunches the victim;
                # rank0_dead only in WHO dies: the rendezvous host, so the
                # survivors must re-elect before they can agree.
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "sync_timeout":
                from .watchdog import SyncTimeout

                raise SyncTimeout(
                    f"injected sync_timeout fault at step {state.step}",
                    f.secs,
                )

    # -------------------------------------------------- segment delivery
    def on_segment(self, segment_index: int, driver=None) -> None:
        """Deliver due stream faults at a streaming segment boundary
        (stream/driver.py). `@k` pins the SEGMENT index — the stream
        plane's boundary unit, like the chunk is the dispatch atom."""
        for f in self.faults:
            if (
                f.kind not in STREAM_KINDS or f.spent
                or segment_index < f.step
            ):
                continue
            f.fired += 1
            self.log.append({
                "kind": f.kind, "step": f.step, "at_step": segment_index,
            })
            if f.kind == "stream_stall":
                time.sleep(f.secs)
            elif f.kind == "vocab_growth" and driver is not None:
                driver.force_growth(f.n)

    # ---------------------------------------------------- event delivery
    def fire_event(self, kind: str, where: str = "") -> bool:
        """Consume one firing of an unspent event fault of `kind`; returns
        whether one fired (the injection point decides what to raise)."""
        for f in self.faults:
            if f.kind == kind and not f.spent:
                f.fired += 1
                self.log.append(
                    {"kind": kind, "step": f.step, "at_step": where or kind}
                )
                return True
        return False


# ------------------------------------------------------ module-level plan
# Event-fault injection points (the checkpoint save, the serve batch
# executor) consult the process-wide active plan: threading a plan object
# through every call chain that might write a checkpoint would couple the
# io layer to the chaos harness for no benefit. Tests activate/deactivate around the block
# under test.
_ACTIVE: Optional[FaultPlan] = None


def activate(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install `plan` as the process-wide event-fault plan; returns the
    previous one (restore it in a finally when scoping)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    return prev


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def raise_if_active(kind: str, where: str = "") -> None:
    """Injection point: raise the fault's error if the active plan has an
    unspent fault of `kind`. No-op (and zero overhead beyond a None check)
    without an active plan."""
    if _ACTIVE is not None and _ACTIVE.fire_event(kind, where):
        if kind == "ckpt_oserror":
            raise OSError(f"injected fault: {kind} at {where or 'checkpoint'}")
        if kind == "oom":
            # the type a real CUDA allocation failure raises, so the catch
            # sites that classify by type treat it as the real thing
            import torch

            raise torch.OutOfMemoryError(
                "injected fault: out of memory "
                f"allocating device buffer at {where or 'oom'}"
            )
        raise RuntimeError(f"injected fault: {kind}")
