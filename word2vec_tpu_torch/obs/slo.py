"""Declarative SLO rules over derived signals (obs/signals.py).

A copy of word2vec_tpu/obs/slo.py for the PyTorch port (host code: the
grammar, the state machine and the event records are the JAX package's).

Rule grammar (one clause; `--slo` takes a comma-separated list or a path to
a `.json` file):

    <signal><op><threshold>[:key=val]...

    throughput_wps<0.8*baseline:for=5     sustained-throughput SLO: breach
                                          when throughput sits below 80% of
                                          its own established baseline for
                                          5 consecutive windows
    serve_p99_ms>250:for=3                latency SLO against a literal bound
    quality_planted<0.5                   quality floor (default for=3)

  op          `<` (breach when value drops below) or `>` (breach when value
              exceeds)
  threshold   a literal float, or `F*baseline` — `baseline` is established
              per rule as the median of the first `baseline=N` observed
              windows (default 3); until established the rule is pending
              and never fires
  :for=N      consecutive breaching windows before `warn` escalates to
              `breach` (default 3); the FIRST breaching window is `warn`
  :baseline=N windows used to establish the baseline (default 3)

Escalation is a per-rule state machine evaluated once per closed window:

    ok -> warn   (first breaching window)
    warn -> breach (N consecutive breaching windows)
    * -> ok      (any conforming window resets the streak — structured
                 `slo_recovered` event when leaving warn/breach)

Every transition emits a structured SloEvent record (`event`:
slo_warn | slo_breach | slo_recovered) that lands on the run's sinks, the
flight ring, and the signal bus; `slo_breach` increments the
present-from-zero `w2v_slo_breaches_total` counter (obs/export.py). A breach
maps to a log + event, NEVER an exit — this layer observes; the control
loops that will subscribe to it (serve autoscale, elastic policy) actuate.

Parse errors follow the fault-spec contract (resilience/faults.py): they name the clause and
its character offset in the spec (`SloError: rule 2 ('qps>>5') at offset
21: ...`) so a typo'd rule fails in milliseconds, not after the corpus scan.
"""

from __future__ import annotations

import json
import re
from typing import Callable, Dict, List, Optional

#: default consecutive breaching windows before warn escalates to breach
FOR_DEFAULT = 3
#: default windows used to establish a `baseline`-relative threshold
BASELINE_DEFAULT = 3

_SIGNAL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_NUM_RE = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


class SloError(ValueError):
    """A malformed SLO rule spec (clause + offset in the message)."""


class SloRule:
    """One parsed rule: signal, comparison, threshold (literal or
    baseline-relative), escalation budget."""

    def __init__(self, signal: str, op: str, factor: float,
                 relative: bool, for_n: int = FOR_DEFAULT,
                 baseline_n: int = BASELINE_DEFAULT, text: str = ""):
        self.signal = signal
        self.op = op
        self.factor = float(factor)
        #: True = threshold is factor * established baseline
        self.relative = bool(relative)
        self.for_n = max(1, int(for_n))
        self.baseline_n = max(1, int(baseline_n))
        self.text = text or str(self)

    def __str__(self) -> str:
        thr = f"{self.factor:g}*baseline" if self.relative else f"{self.factor:g}"
        return f"{self.signal}{self.op}{thr}:for={self.for_n}"

    def to_json(self) -> Dict:
        return {
            "rule": self.text,
            "signal": self.signal,
            "op": self.op,
            "factor": self.factor,
            "relative": self.relative,
            "for": self.for_n,
            "baseline_windows": self.baseline_n,
        }

    # ------------------------------------------------------------ parsing
    @classmethod
    def parse(cls, clause: str) -> "SloRule":
        """One clause (no clause/offset context — parse_slo wraps that)."""
        m = re.match(r"^([^<>]+)([<>])(.+)$", clause)
        if not m:
            raise ValueError(
                "expected <signal><op><threshold> with op '<' or '>'"
            )
        signal, op, rest = m.group(1).strip(), m.group(2), m.group(3)
        if not _SIGNAL_RE.match(signal):
            raise ValueError(f"bad signal name {signal!r}")
        if "<" in rest or ">" in rest:
            raise ValueError(f"more than one comparison operator in {clause!r}")
        parts = rest.split(":")
        thr = parts[0].strip()
        relative = False
        if "*" in thr:
            fac, _, base = thr.partition("*")
            if base.strip() != "baseline":
                raise ValueError(
                    f"threshold {thr!r}: only '<factor>*baseline' is "
                    "supported on the right of '*'"
                )
            thr = fac.strip()
            relative = True
        elif thr == "baseline":
            thr, relative = "1.0", True
        if not _NUM_RE.match(thr):
            raise ValueError(f"threshold {parts[0].strip()!r} is not a number")
        kwargs = {"for_n": FOR_DEFAULT, "baseline_n": BASELINE_DEFAULT}
        for kv in parts[1:]:
            key, sep, val = kv.partition("=")
            key = key.strip()
            if not sep:
                raise ValueError(f"option {kv!r} is not key=value")
            if key == "for":
                dest = "for_n"
            elif key == "baseline":
                dest = "baseline_n"
            else:
                raise ValueError(
                    f"unknown option {key!r} (expected for= or baseline=)"
                )
            try:
                n = int(val)
            except ValueError:
                raise ValueError(f"option {key}={val!r} is not an integer")
            if n < 1:
                raise ValueError(f"option {key}={n} must be >= 1")
            kwargs[dest] = n
        return cls(signal, op, float(thr), relative, text=clause.strip(),
                   **kwargs)


def parse_slo(spec: str) -> List[SloRule]:
    """`--slo` spec -> rules. A spec that is a path to a `.json` file loads
    rules from it (a JSON list of rule strings, or of objects with a
    "rule" field). Errors name clause + offset, the fault-spec contract."""
    spec = (spec or "").strip()
    if not spec:
        return []
    if spec.endswith(".json"):
        try:
            with open(spec) as f:
                doc = json.load(f)
        except OSError as e:
            raise SloError(f"cannot read SLO file {spec!r}: {e}")
        except json.JSONDecodeError as e:
            raise SloError(f"SLO file {spec!r} is not valid JSON: {e}")
        if not isinstance(doc, list):
            raise SloError(
                f"SLO file {spec!r}: expected a JSON list of rules, got "
                f"{type(doc).__name__}"
            )
        clauses = []
        for i, item in enumerate(doc):
            if isinstance(item, str):
                clauses.append(item)
            elif isinstance(item, dict) and isinstance(item.get("rule"), str):
                clauses.append(item["rule"])
            else:
                raise SloError(
                    f"SLO file {spec!r}: rule {i + 1} must be a string or "
                    'an object with a "rule" field'
                )
        spec_text = ",".join(clauses)
    else:
        spec_text = spec
    rules: List[SloRule] = []
    offset = 0
    for i, tok in enumerate(spec_text.split(",")):
        clause = tok.strip()
        if clause:
            try:
                rules.append(SloRule.parse(clause))
            except ValueError as e:
                raise SloError(
                    f"rule {i + 1} ({clause!r}) at offset {offset}: {e}"
                )
        offset += len(tok) + 1
    return rules


class _RuleState:
    def __init__(self, rule: SloRule):
        self.rule = rule
        self.state = "ok"
        self.streak = 0
        self.baseline: Optional[float] = None
        self.baseline_samples: List[float] = []
        self.breaches = 0
        self.warns = 0
        self.last_value: Optional[float] = None


class SloEvaluator:
    """Evaluate parsed rules against each closed window's signal values.

    `evaluate` returns the structured event records for this window (empty
    most of the time); the caller routes them to sinks/flight/bus. The
    evaluator never raises out of evaluate() and never exits — observe,
    don't actuate."""

    def __init__(self, rules: List[SloRule],
                 clock: Optional[Callable[[], float]] = None):
        self.rules = list(rules)
        self._states = [_RuleState(r) for r in self.rules]

    def __bool__(self) -> bool:
        return bool(self.rules)

    def threshold(self, st: _RuleState) -> Optional[float]:
        r = st.rule
        if not r.relative:
            return r.factor
        if st.baseline is None:
            return None
        return r.factor * st.baseline

    def evaluate(self, values: Dict[str, float],
                 window: Optional[int]) -> List[Dict]:
        events: List[Dict] = []
        for st in self._states:
            r = st.rule
            v = values.get(r.signal)
            if v is None or isinstance(v, bool):
                continue
            v = float(v)
            st.last_value = v
            if r.relative and st.baseline is None:
                st.baseline_samples.append(v)
                if len(st.baseline_samples) >= r.baseline_n:
                    s = sorted(st.baseline_samples)
                    st.baseline = s[len(s) // 2]  # median
                continue  # baseline windows never count against the rule
            thr = self.threshold(st)
            if thr is None:
                continue
            breached = v < thr if r.op == "<" else v > thr
            base = {
                "rule": r.text,
                "signal": r.signal,
                "value": round(v, 6),
                "threshold": round(thr, 6),
                "window": window,
            }
            if st.baseline is not None:
                base["baseline"] = round(st.baseline, 6)
            if breached:
                st.streak += 1
                if st.streak >= r.for_n and st.state != "breach":
                    st.state = "breach"
                    st.breaches += 1
                    events.append({
                        "event": "slo_breach", "streak": st.streak, **base,
                    })
                elif st.streak < r.for_n and st.state == "ok":
                    st.state = "warn"
                    st.warns += 1
                    events.append({
                        "event": "slo_warn", "streak": st.streak, **base,
                    })
            else:
                if st.state != "ok":
                    events.append({
                        "event": "slo_recovered",
                        "from": st.state,
                        "streak": st.streak,
                        **base,
                    })
                st.state = "ok"
                st.streak = 0
        return events

    def summary(self) -> Dict:
        """Manifest / TrainReport payload: per-rule state + totals."""
        worst = "ok"
        rank = {"ok": 0, "warn": 1, "breach": 2}
        rows = []
        for st in self._states:
            if rank[st.state] > rank[worst]:
                worst = st.state
            row = {
                "rule": st.rule.text,
                "state": st.state,
                "streak": st.streak,
                "breaches": st.breaches,
                "warns": st.warns,
            }
            if st.baseline is not None:
                row["baseline"] = round(st.baseline, 6)
            if st.last_value is not None:
                row["last_value"] = round(st.last_value, 6)
            rows.append(row)
        return {
            "state": worst,
            "breaches_total": sum(st.breaches for st in self._states),
            "warns_total": sum(st.warns for st in self._states),
            "rules": rows,
        }
