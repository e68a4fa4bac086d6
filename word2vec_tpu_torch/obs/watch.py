"""Terminal fleet dashboard: `python -m word2vec_tpu_torch.obs.watch --dir DIR`.

A copy of word2vec_tpu/obs/watch.py for the PyTorch port (host code).

The second shipped read-only consumer of the signal plane (the first is the
fleet-health verdict in TrainReport): tails `fleet.json` (obs/fleet.py) in a
metrics directory and renders the fleet's derived signals as a compact
refreshing table — throughput trend, straggler attribution, SLO state from
the run's manifest — with zero interaction with the run itself (it reads
artifacts the signal plane already writes; killing the watcher changes
nothing).

`--once` renders a single snapshot and exits (testable / pipe-friendly);
the default loop refreshes every `--interval` seconds with an ANSI
clear-home, no curses dependency.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

#: windows shown in the trend table
SHOW_WINDOWS = 12


def _load(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _sparkline(vals: List[float]) -> str:
    blocks = "▁▂▃▄▅▆▇█"
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        blocks[min(len(blocks) - 1, int((v - lo) / span * (len(blocks) - 1)))]
        for v in vals
    )


def render(doc: Dict, slo: Optional[Dict] = None) -> str:
    """fleet.json (+ optional manifest slo summary) -> the dashboard text.
    Pure string assembly, so tests can pin it without a terminal."""
    lines: List[str] = []
    windows = doc.get("windows", [])
    last = doc.get("last") or {}
    hosts = doc.get("hosts", [])
    lines.append(
        f"fleet: {len(hosts)} host(s) {hosts} · "
        f"{doc.get('windows_total', 0)} window(s)"
        + (f" · {doc.get('window_steps')} steps/window"
           if doc.get("window_steps") else "")
        + f" · generated {doc.get('generated_utc', '?')}"
    )
    tp = [w["throughput_wps"] for w in windows if "throughput_wps" in w]
    if tp:
        lines.append(
            f"  throughput_wps   {tp[-1]:>12,.1f}  {_sparkline(tp[-SHOW_WINDOWS:])}"
        )
    for key, label in (
        ("step_time_p50_ms_median", "step_p50_ms"),
        ("input_bound_ratio_mean", "input_bound"),
        ("quality_planted_min", "quality_min"),
        ("serve_qps", "serve_qps"),
        ("serve_p99_ms_max", "serve_p99_ms"),
        ("cache_hit_mean", "cache_hit"),
        # device-memory rows (obs/devmem.py via the signal plane): the
        # fleet's worst-host headroom and peak HBM watermark
        ("mem_headroom_frac_min", "mem_headroom"),
        ("mem_peak_bytes_max", "mem_peak_bytes"),
    ):
        series = [w[key] for w in windows if key in w]
        if series:
            lines.append(
                f"  {label:<16} {series[-1]:>12,.3f}  "
                f"{_sparkline(series[-SHOW_WINDOWS:])}"
            )
    if last.get("mem_worst_host") is not None:
        lines.append(
            f"  mem worst host   host {last['mem_worst_host']} "
            f"({last.get('mem_headroom_frac_min', '?')} headroom frac)"
        )
    s = doc.get("straggler")
    if s:
        lines.append(
            f"  straggler        host {s['host']} "
            f"(worst in {s['windows_worst']} window(s), "
            f"{s['max_vs_median']}x fleet median)"
        )
    elif last:
        lines.append("  straggler        none named")
    if slo:
        lines.append(
            f"  slo              {slo.get('state', '?')} "
            f"({slo.get('breaches_total', 0)} breach(es), "
            f"{slo.get('warns_total', 0)} warn(s))"
        )
        for r in slo.get("rules", ()):
            lines.append(
                f"    {r.get('state', '?'):<7} {r.get('rule', '?')}"
                + (f"  last={r['last_value']}" if "last_value" in r else "")
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m word2vec_tpu_torch.obs.watch",
        description="tail fleet.json as a terminal dashboard",
    )
    ap.add_argument("--dir", required=True,
                    help="metrics directory holding fleet.json "
                         "(and optionally manifest.json for SLO state)")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="render one snapshot and exit")
    args = ap.parse_args(argv)
    fleet_path = os.path.join(args.dir, "fleet.json")
    man_path = os.path.join(args.dir, "manifest.json")
    while True:
        doc = _load(fleet_path)
        man = _load(man_path) or {}
        slo = man.get("slo")
        if doc is None:
            out = f"waiting for {fleet_path} ..."
        else:
            out = render(doc, slo)
        if args.once:
            print(out)
            return 0 if doc is not None else 1
        print("\x1b[2J\x1b[H" + out, flush=True)
        time.sleep(max(0.2, args.interval))


if __name__ == "__main__":
    raise SystemExit(main())
