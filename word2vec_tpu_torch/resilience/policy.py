"""Signal-driven elastic policy: shrink/grow the fleet on PURPOSE.

Port of word2vec_tpu/resilience/policy.py. The elastic protocol
(resilience/elastic.py) reacts to failure; the signal plane publishes the
inputs a control loop needs (windowed `throughput_wps`, straggler
attribution, SLO breach events on `obs/signals.SignalBus`). This module is
that loop: an `ElasticPolicy` subscribes to the bus, evaluates declarative rules per closed signal window, and requests a
shrink (evict a named victim) or opens the grow gate (admit a parked
rejoiner) at the next sync boundary — delivered fleet-wide on the same
PeerAgreement heartbeat allgather the grow channel already rides, and
executed through the rendezvous + ShardedTrainer.remesh machinery the
failure path built. No failures involved: the mesh event records
`trigger: policy`.

Rule grammar (`--elastic-policy`; comma list or a `.json` list file):

    <signal><op><threshold>[:for=N][:baseline=N][:act=shrink|grow][...]

    throughput_wps<0.6*baseline:for=2:act=shrink
        sustained throughput collapse -> evict the attributed straggler
    straggler_skew>4:for=3:act=shrink
        one host 4x the fleet median for 3 windows -> evict it
    throughput_wps>0.8*baseline:for=2:act=grow
        sustained recovery -> open the grow gate for parked rejoiners
    slo_breach>0:for=1:act=shrink
        any SLO breach event (obs/slo.py) -> shrink (slo_breach is a
        per-window pseudo-signal: 1.0 when a breach event arrived since
        the last window, else 0.0)

The `<signal><op><threshold>[:for=][:baseline=]` core is parsed by the SLO
clause parser (obs/slo.SloRule.parse) — same escalation state machine, same
`F*baseline` thresholds, same clause+offset parse errors. Policy-only keys
are split off first:

  act=shrink|grow   what a sustained breach requests (default shrink)
  victim=straggler|highest
                    shrink victim selection: the worst-host attribution
                    from the fleet/signals rows (host_overhead-preferred,
                    falling back to heartbeat p50), else the highest rank;
                    never rank 0 (evicting the rendezvous host by choice
                    would force an election for no benefit)
  cooldown=N        (global) windows a FRESH GENERATION must observe before
                    the policy may act (default 3). Cooldown is counted
                    from generation start, so it survives the exec between
                    generations by construction — the hysteresis leg that
                    prevents shrink/grow flapping on an oscillating signal,
                    on top of each rule's own for=N streak.
  min_world=N       (global) never shrink below N processes (default 2)
  max_world=N       (global) never grow past N processes (default 0 = no
                    bound; grow is naturally bounded by parked rejoiners)

Delivery: only the rendezvous-hosting rank (rank 0) runs the policy — its
`poll()` feeds the heartbeat's policy column (victim+1, latched until the
generation execs) and `grow_gate()` gates the existing grow channel. Every
other rank reads the verdict from the same allgather rows, so the whole
fleet acts at one sync boundary. A rule breach with the gate closed
(cooldown, bounds) is recorded (`policy_suppressed`) but requests nothing.

In-process leg: `apply_inprocess(trainer, state)` drives
`ShardedTrainer.remesh(dp=...)` directly for single-process multi-device
runs (halve dp on shrink, clamped to what the trainer may place replicas
on: one a visible card on the card, any number on the CPU) — the same
decision surface without the exec machinery; callers invoke it BETWEEN
train() calls (a mid-epoch in-process dp change would desynchronize the
batch stream).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ..obs.slo import FOR_DEFAULT, SloEvaluator, SloRule

#: default windows a fresh generation observes before the policy may act
COOLDOWN_DEFAULT = 3
#: default floor the fleet never policy-shrinks below
MIN_WORLD_DEFAULT = 2

_POLICY_KEYS = ("act", "victim", "cooldown", "min_world", "max_world")


def placeable_devices(trainer) -> float:
    """How many mesh devices (replica shards) a ShardedTrainer of this
    process may take, by the port's rule (parallel/mesh.make_mesh): one a
    visible card on the card (a --dp above the cards is refused), any
    number on the CPU."""
    dev = trainer.mesh.devices[0]
    if dev.type == "cuda":
        import torch

        return float(torch.cuda.device_count())
    return float("inf")


class PolicyError(ValueError):
    """A malformed --elastic-policy spec (clause + offset in the message,
    the fault-spec/SLO contract)."""


class PolicyRule:
    """One policy clause: an SLO rule (condition + for=N hysteresis) plus
    the action a sustained breach requests."""

    def __init__(self, slo_rule: SloRule, action: str = "shrink",
                 victim: str = "straggler"):
        if action not in ("shrink", "grow"):
            raise ValueError(
                f"act must be 'shrink' or 'grow', got {action!r}"
            )
        if victim not in ("straggler", "highest"):
            raise ValueError(
                f"victim must be 'straggler' or 'highest', got {victim!r}"
            )
        self.rule = slo_rule
        self.action = action
        self.victim = victim

    def __str__(self) -> str:
        return f"{self.rule}:act={self.action}"

    def to_json(self) -> Dict:
        return {**self.rule.to_json(), "act": self.action,
                "victim": self.victim}


def _split_clause(clause: str):
    """Split policy-only key=val options off a clause; the remainder goes
    to the SLO parser verbatim."""
    parts = clause.split(":")
    core, policy_opts = [parts[0]], {}
    for kv in parts[1:]:
        key, sep, val = kv.partition("=")
        if sep and key.strip() in _POLICY_KEYS:
            policy_opts[key.strip()] = val.strip()
        else:
            core.append(kv)
    return ":".join(core), policy_opts


def parse_policy(spec: str) -> "ElasticPolicy":
    """`--elastic-policy` spec -> an (unattached) ElasticPolicy. Errors
    name clause + offset like the fault/SLO parsers; a clause that is ONLY
    global options (`cooldown=6`) contributes no rule."""
    spec = (spec or "").strip()
    if not spec:
        return ElasticPolicy([])
    if spec.endswith(".json"):
        import json

        try:
            with open(spec) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise PolicyError(f"cannot read policy file {spec!r}: {e}")
        if not isinstance(doc, list):
            raise PolicyError(
                f"policy file {spec!r}: expected a JSON list of rule "
                f"strings, got {type(doc).__name__}"
            )
        spec = ",".join(str(s) for s in doc)
    rules: List[PolicyRule] = []
    options: Dict[str, int] = {}
    offset = 0
    for i, tok in enumerate(spec.split(",")):
        clause = tok.strip()
        if clause:
            try:
                if "<" not in clause and ">" not in clause:
                    # a global-option clause: cooldown=6 / min_world=2
                    key, sep, val = clause.partition("=")
                    key = key.strip()
                    if not sep or key not in (
                        "cooldown", "min_world", "max_world"
                    ):
                        raise ValueError(
                            "expected <signal><op><threshold> or a global "
                            "option (cooldown= / min_world= / max_world=)"
                        )
                    options[key] = int(val)
                else:
                    core, opts = _split_clause(clause)
                    for key in ("cooldown", "min_world", "max_world"):
                        if key in opts:
                            options[key] = int(opts.pop(key))
                    rules.append(PolicyRule(
                        SloRule.parse(core),
                        action=opts.pop("act", "shrink"),
                        victim=opts.pop("victim", "straggler"),
                    ))
            except ValueError as e:
                raise PolicyError(
                    f"rule {i + 1} ({clause!r}) at offset {offset}: {e}"
                )
        offset += len(tok) + 1
    return ElasticPolicy(rules, **options)


class ElasticPolicy:
    """The control loop: evaluate rules per closed signal window, latch a
    shrink request / open the grow gate when a rule sustains its breach
    and the gate conditions (cooldown, world bounds) allow it."""

    def __init__(
        self,
        rules: List[PolicyRule],
        cooldown: int = COOLDOWN_DEFAULT,
        min_world: int = MIN_WORLD_DEFAULT,
        max_world: int = 0,
        world: int = 1,
        log_fn: Optional[Callable[[Dict], None]] = None,
    ):
        self.rules = list(rules)
        self.cooldown = max(0, int(cooldown))
        self.min_world = max(1, int(min_world))
        self.max_world = max(0, int(max_world))
        self.world = int(world)
        self.log_fn = log_fn
        # one evaluator over the underlying SLO rules: same ok->warn->
        # breach escalation, the breach event IS the trigger
        self._eval = SloEvaluator([r.rule for r in self.rules])
        self._by_text = {r.rule.text: r for r in self.rules}
        self._lock = threading.Lock()
        self._windows_seen = 0
        self._slo_breached = False  # since the last window close
        self._straggler: Optional[int] = None
        #: latched shrink request: {"victim", "rule", "window"} — stays
        #: pending until the generation execs (the process image dies with
        #: the request; nothing to unlatch)
        self._pending_shrink: Optional[Dict] = None
        self._grow_open = not any(r.action == "grow" for r in self.rules)
        self._suppressed_noted: set = set()
        self._unsubs: List[Callable[[], None]] = []

    def __bool__(self) -> bool:
        return bool(self.rules)

    # ------------------------------------------------------------ wiring
    def attach(self, bus) -> "ElasticPolicy":
        """Subscribe to the signal plane: per-window "signals" rows drive
        rule evaluation, "fleet" rows supply the worst-host attribution
        (host_overhead-preferred — the p50 columns equalize on a lockstep
        fleet), "slo" events feed the slo_breach pseudo-signal."""
        self._unsubs = [
            bus.subscribe("signals", self.on_window),
            bus.subscribe("fleet", self.on_fleet),
            bus.subscribe("slo", self.on_slo),
        ]
        return self

    def detach(self) -> None:
        for u in self._unsubs:
            u()
        self._unsubs = []

    # ------------------------------------------------------ bus consumers
    def on_slo(self, ev: Dict) -> None:
        if ev.get("event") == "slo_breach":
            with self._lock:
                self._slo_breached = True

    def on_fleet(self, row: Dict) -> None:
        host = row.get("fleet_straggler_host")
        if isinstance(host, int):
            with self._lock:
                self._straggler = host

    def on_window(self, row: Dict) -> None:
        """One closed signal window: evaluate every rule, act on breaches.
        Runs on the training thread (bus publish from the window close) —
        cheap: a dict scan plus the SLO state machine."""
        values = {
            k[len("signal_"):]: v for k, v in row.items()
            if k.startswith("signal_")
            and isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        with self._lock:
            values["slo_breach"] = 1.0 if self._slo_breached else 0.0
            self._slo_breached = False
            if isinstance(row.get("straggler_host"), int):
                # per-window heartbeat attribution (may be overridden by
                # the fleet row's host_overhead-preferred verdict)
                if self._straggler is None:
                    self._straggler = int(row["straggler_host"])
            self._windows_seen += 1
            seen = self._windows_seen
        self._eval.evaluate(values, row.get("window"))
        # Act on every rule CURRENTLY in breach, not just on the one-shot
        # breach transition event: a breach that lands during the cooldown
        # must still drive the action once the cooldown expires, for as
        # long as the condition sustains. The latch (shrink) and the gate
        # (grow) make repeated attempts idempotent.
        for srow in self._eval.summary()["rules"]:
            if srow.get("state") != "breach":
                continue
            rule = self._by_text.get(srow.get("rule"))
            if rule is None:
                continue
            self._act(rule, {
                "window": row.get("window"),
                "value": srow.get("last_value"),
                "streak": srow.get("streak"),
            }, seen)

    # ------------------------------------------------------------ actions
    def _act(self, rule: PolicyRule, ev: Dict, windows_seen: int) -> None:
        blocked = None
        if windows_seen <= self.cooldown:
            blocked = (
                f"cooldown ({windows_seen}/{self.cooldown} windows into "
                "this generation)"
            )
        elif rule.action == "shrink" and self.world - 1 < self.min_world:
            blocked = f"min_world={self.min_world} (world {self.world})"
        elif (
            rule.action == "grow" and self.max_world
            and self.world + 1 > self.max_world
        ):
            blocked = f"max_world={self.max_world} (world {self.world})"
        if blocked is not None:
            key = (str(rule), blocked.split(" ", 1)[0])
            if key not in self._suppressed_noted:  # once per (rule, cause)
                self._suppressed_noted.add(key)
                self._note({
                    "event": "policy_suppressed", "rule": str(rule),
                    "action": rule.action, "reason": blocked,
                    "window": ev.get("window"),
                })
            return
        if rule.action == "grow":
            with self._lock:
                already = self._grow_open
                self._grow_open = True
            if not already:
                self._note({
                    "event": "policy_grow_gate", "rule": str(rule),
                    "window": ev.get("window"), "value": ev.get("value"),
                    "threshold": ev.get("threshold"),
                })
            return
        with self._lock:
            if self._pending_shrink is not None:
                return  # latched: one eviction per generation
            victim = self._pick_victim(rule)
            if victim is None:
                self._note({
                    "event": "policy_suppressed", "rule": str(rule),
                    "action": "shrink",
                    "reason": "no evictable victim (world too small or "
                              "only rank 0 attributed)",
                    "window": ev.get("window"),
                })
                return
            self._pending_shrink = {
                "victim": victim, "rule": str(rule),
                "window": ev.get("window"),
            }
        self._note({
            "event": "policy_shrink_request", "rule": str(rule),
            "victim": victim, "window": ev.get("window"),
            "value": ev.get("value"), "threshold": ev.get("threshold"),
        })

    def _pick_victim(self, rule: PolicyRule) -> Optional[int]:
        """The evicted CURRENT rank: the attributed straggler when asked
        for and known, else the highest rank; never rank 0 (the rendezvous
        host), never out of the current world."""
        if self.world <= 1:
            return None
        if rule.victim == "straggler":
            s = self._straggler
            if isinstance(s, int) and 0 < s < self.world:
                return s
        return self.world - 1 if self.world - 1 > 0 else None

    # ---------------------------------------------------- boundary feeds
    def poll(self) -> float:
        """The heartbeat's policy column (PeerAgreement policy_fn):
        victim_rank + 1 while a shrink is latched, 0 otherwise."""
        with self._lock:
            if self._pending_shrink is None:
                return 0.0
            return float(self._pending_shrink["victim"] + 1)

    def grow_gate(self) -> bool:
        """Whether a parked rejoiner may be admitted now. Open by default
        when no act=grow rule exists (failure-driven admission); with one, it
        opens only after that rule sustains its breach — and respects the
        cooldown via _act."""
        with self._lock:
            return self._grow_open

    def pending(self) -> Optional[Dict]:
        with self._lock:
            return dict(self._pending_shrink) if self._pending_shrink else None

    # ------------------------------------------------------- in-process
    def apply_inprocess(self, trainer, state=None) -> Optional[Dict]:
        """Drive ShardedTrainer.remesh directly for single-process
        multi-device runs: a pending shrink halves dp, an open grow gate
        (with a pending grow target) doubles it, clamped to the device
        count. Call BETWEEN train() invocations only. Returns the applied
        action record, or None."""
        req = self.pending()
        if req is None:
            return None
        new_dp = max(1, trainer.dp // 2)
        if new_dp == trainer.dp or new_dp * trainer.tp * trainer.sp < 1:
            return None
        if new_dp * trainer.tp * trainer.sp > placeable_devices(trainer):
            return None
        trainer.remesh(dp=new_dp, state=state)
        with self._lock:
            self._pending_shrink = None
        rec = {"event": "policy_remesh", "kind": "shrink",
               "trigger": "policy", "dp": new_dp, "in_process": True,
               "rule": req.get("rule")}
        self._note(rec)
        return rec

    def summary(self) -> Dict:
        """Manifest/report payload."""
        with self._lock:
            return {
                "rules": [str(r) for r in self.rules],
                "cooldown_windows": self.cooldown,
                "min_world": self.min_world,
                "max_world": self.max_world or None,
                "windows_seen": self._windows_seen,
                "pending_shrink": dict(self._pending_shrink)
                if self._pending_shrink else None,
                "grow_gate_open": self._grow_open,
            }

    def _note(self, rec: Dict) -> None:
        if self.log_fn is not None:
            try:
                self.log_fn(dict(rec))
            except Exception:  # noqa: BLE001 — telemetry must not kill it
                pass
