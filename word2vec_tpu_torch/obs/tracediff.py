"""Trace-diff attribution: WHICH span explains a step-time delta.

A copy of word2vec_tpu/obs/tracediff.py for the PyTorch port; it reads
the port's obs/trace documents (the same Chrome-trace schema).

The question every A/B throughput comparison ends at is "plan B is 1.4
ms/step slower — where?". Without it, answering means capturing two profiler
traces and eyeballing timelines. This module answers it from the exported
Chrome-trace artifacts (obs/trace.py) directly:

    python -m word2vec_tpu_torch.obs.tracediff A.json B.json [--json] [--top N]

`summarize` reduces a trace to per-span stats normalized PER OPTIMIZER STEP
(the step/chunk parent events carry the step count, so per-step and chunked
traces compare on the same axis); `diff` subtracts two summaries and ranks
spans by the magnitude of their signed per-step delta — the top row IS the
attribution. In the JAX package the same `summarize` also feeds its bench's banked
`trace_summary` and its planner's measured-vs-predicted cost rows, so the
number a human reads in a diff is the number the records bank.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Optional, Union

from .trace import STEP_PARENTS, load_trace


def _events_of(trace: Union[Dict, Iterable[Dict]]) -> List[Dict]:
    if isinstance(trace, dict):
        return list(trace.get("traceEvents", []))
    return list(trace)


def summarize(trace: Union[Dict, Iterable[Dict]], top: int = 3) -> Dict:
    """Per-span stats over one trace (doc or raw ring events).

    Returns {steps, step_ms, spans: {name: {count, total_ms, p50_ms,
    ms_per_step}}, top_contributors: [{span, ms_per_step, share_of_step}]}.
    `steps` sums the step/chunk parents' widths (a chunk parent carries
    args.steps), so ms_per_step is per OPTIMIZER step on both dispatch
    paths; without parents (a bare span trace) the per-step fields are None
    and contributors rank by total time.
    """
    events = _events_of(trace)
    parents = [
        e for e in events
        if e.get("ph") == "X" and e.get("name") in STEP_PARENTS
    ]
    n_steps = sum(
        int((e.get("args") or {}).get("steps", 1)) for e in parents
    )
    parent_ms = sum(float(e.get("dur", 0.0)) for e in parents) / 1e3
    durs_by_span: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        name = e.get("name")
        if name in STEP_PARENTS or name == "epoch":
            continue  # parents would double-count their children
        durs_by_span.setdefault(name, []).append(
            float(e.get("dur", 0.0)) / 1e3
        )
    spans: Dict[str, Dict] = {}
    for name in sorted(durs_by_span):
        durs = sorted(durs_by_span[name])
        total = sum(durs)
        spans[name] = {
            "count": len(durs),
            "total_ms": round(total, 4),
            "p50_ms": round(durs[len(durs) // 2], 4),
            "ms_per_step": round(total / n_steps, 4) if n_steps else None,
        }
    step_ms = round(parent_ms / n_steps, 4) if n_steps else None
    ranked = sorted(spans, key=lambda n: -spans[n]["total_ms"])[:top]
    contributors = [
        {
            "span": n,
            "ms_per_step": spans[n]["ms_per_step"],
            "share_of_step": (
                round(spans[n]["ms_per_step"] / step_ms, 4)
                if step_ms else None
            ),
        }
        for n in ranked
    ]
    return {
        "steps": n_steps,
        "step_ms": step_ms,
        "spans": spans,
        "top_contributors": contributors,
    }


def diff(trace_a: Union[Dict, Iterable[Dict]],
         trace_b: Union[Dict, Iterable[Dict]]) -> Dict:
    """Attribute the B-minus-A step-time delta to named spans.

    Every span present in either trace gets a signed per-step delta row;
    rows are ranked by |delta|, and each carries its share of the total
    step delta (shares can exceed 1 when spans moved in opposite
    directions — the signs say which)."""
    sa, sb = summarize(trace_a), summarize(trace_b)
    step_a, step_b = sa.get("step_ms"), sb.get("step_ms")
    step_delta = (
        round(step_b - step_a, 4)
        if step_a is not None and step_b is not None else None
    )
    rows: List[Dict] = []
    for name in sorted(set(sa["spans"]) | set(sb["spans"])):
        a_ms = (sa["spans"].get(name) or {}).get("ms_per_step") or 0.0
        b_ms = (sb["spans"].get(name) or {}).get("ms_per_step") or 0.0
        delta = round(b_ms - a_ms, 4)
        row = {
            "span": name,
            "a_ms_per_step": round(a_ms, 4),
            "b_ms_per_step": round(b_ms, 4),
            "delta_ms_per_step": delta,
        }
        if step_delta:
            row["share_of_step_delta"] = round(delta / step_delta, 4)
        rows.append(row)
    rows.sort(key=lambda r: -abs(r["delta_ms_per_step"]))
    return {
        "steps_a": sa["steps"],
        "steps_b": sb["steps"],
        "step_ms_a": step_a,
        "step_ms_b": step_b,
        "step_delta_ms": step_delta,
        "spans": rows,
        "top_attribution": rows[0]["span"] if rows else None,
    }


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:9.4f}"


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m word2vec_tpu_torch.obs.tracediff",
        description="attribute a step-time delta between two exported "
                    "traces (--trace DIR artifacts or flight.json's "
                    "embedded trace) to named spans",
    )
    ap.add_argument("trace_a", help="baseline trace JSON (A)")
    ap.add_argument("trace_b", help="candidate trace JSON (B)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable diff instead of a table")
    ap.add_argument("--top", type=int, default=10,
                    help="span rows shown in the table (all rows in --json)")
    args = ap.parse_args(argv)
    docs = []
    for path in (args.trace_a, args.trace_b):
        try:
            doc = load_trace(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            # flight.json embeds its trace one level down — accept it too
            try:
                with open(path) as f:
                    raw = json.load(f)
                doc = raw["trace"]
            except Exception:  # noqa: BLE001 — report the original error
                print(f"error: {path}: {e}", file=sys.stderr)
                return 1
        docs.append(doc)
    d = diff(docs[0], docs[1])
    if args.json:
        print(json.dumps(d, indent=2))
        return 0
    print(
        f"step time: A {_fmt_ms(d['step_ms_a'])} ms  ->  "
        f"B {_fmt_ms(d['step_ms_b'])} ms  "
        f"(delta {_fmt_ms(d['step_delta_ms'])} ms/step; "
        f"{d['steps_a']} vs {d['steps_b']} steps)"
    )
    print(f"{'span':>14}  {'A ms/step':>9}  {'B ms/step':>9}  "
          f"{'delta':>9}  share")
    for row in d["spans"][:args.top]:
        share = row.get("share_of_step_delta")
        print(
            f"{row['span']:>14}  {_fmt_ms(row['a_ms_per_step'])}  "
            f"{_fmt_ms(row['b_ms_per_step'])}  "
            f"{_fmt_ms(row['delta_ms_per_step'])}  "
            f"{'' if share is None else f'{100 * share:+.1f}%'}"
        )
    if d["top_attribution"]:
        print(f"attribution: {d['top_attribution']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
