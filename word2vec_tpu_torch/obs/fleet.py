"""Cross-host signal aggregation: per-host rows -> one fleet view.

A copy of word2vec_tpu/obs/fleet.py for the PyTorch port (host code: the
row merge, fleet.json and its schema are the JAX package's).

Each process's SignalEngine (obs/signals.py) writes one compact row per
closed window into its own `signals_p<host>.jsonl` under `--metrics-dir` —
the same shared-directory, per-process-file discipline as the trace
export (`trace_p<i>.json`), and for the same reason: hosts share no clock,
but they DO share the window id (steps advance in lockstep across a fleet;
serve replicas key on epoch seconds), so rows merge deterministically BY
WINDOW ID no matter how skewed the wall clocks are.

Two consumers run the merge:

  rank 0, in-training  — the trainer's SignalEngine carries a
                         FleetAggregator and re-aggregates after every
                         window close: `fleet.json` in --metrics-dir plus
                         one "event":"fleet" record whose numeric fields
                         become `w2v_fleet_*` gauges (obs/export).
  standalone           — `python -m word2vec_tpu_torch.obs.fleet --dir DIR`
                         aggregates a directory of serve-replica (or
                         training) signal files on an interval, for fleets
                         with no rank 0 (N serve processes behind a front).

The merged view derives the decision-grade aggregates the per-host rows
cannot express alone: fleet throughput (sum), the WORST STRAGGLER with host
attribution (max per-host step-time p50 vs the fleet median, plus the
heartbeat-derived skew when present), input-bound fraction (mean), planted
quality (min — the fleet is only as good as its worst replica's table), and
serve qps (sum) / p99 (max) / cache hit (mean).

`validate_fleet_doc` is the schema gate CI runs against every fleet.json —
same contract as obs/trace.validate_trace_doc: an unreadable artifact is
not evidence.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Dict, List, Optional

SCHEMA = 1

#: windows kept in the fleet.json window list (the full per-host history
#: stays in the signals_p*.jsonl files)
KEEP_WINDOWS = 64

#: straggler attribution floor: a host is only named when its step-time p50
#: exceeds the fleet median by this factor (median-of-one fleets never name)
STRAGGLER_FACTOR = 1.5
#: absolute floor for the host-overhead discriminator (ms per window):
#: below it the spread is clock crumbs, not a straggler
STRAGGLER_MIN_OVERHEAD_MS = 100.0


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    if not s:
        return 0.0
    mid = len(s) // 2
    # true median (even n averages the middle pair): with the upper-middle
    # convention a 2-host fleet's "median" IS its worst host, so a straggler
    # could never be named at the smallest fleet size that has one
    return s[mid] if len(s) % 2 else 0.5 * (s[mid - 1] + s[mid])


def read_signal_rows(path: str, offset: int = 0):
    """Parse one signals_p*.jsonl from `offset`; returns (rows, new_offset).
    Tolerates a torn last line (the writer appends concurrently)."""
    rows: List[Dict] = []
    try:
        with open(path) as f:
            f.seek(offset)
            while True:
                pos = f.tell()
                line = f.readline()
                if not line:
                    break
                if not line.endswith("\n"):
                    return rows, pos  # torn tail: re-read next pass
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(row, dict) and row.get("event") == "signals":
                    rows.append(row)
            return rows, f.tell()
    except OSError:
        return rows, offset


def merge_rows(rows: List[Dict]) -> List[Dict]:
    """Per-host signal rows -> per-window fleet rows, sorted by window id.

    Deterministic by construction: grouping keys on the window id (never a
    timestamp), hosts sort numerically inside a window, and every aggregate
    is order-independent (sum/min/max/mean/median) — pinned by the skewed
    3-host test in tests/test_signals.py."""
    by_window: Dict[int, Dict[int, Dict]] = {}
    for row in rows:
        w = row.get("window")
        h = row.get("host", 0)
        if not isinstance(w, int):
            continue
        # latest row wins per (window, host): a re-published window (resume,
        # aggregator re-read) must not double-count
        by_window.setdefault(w, {})[int(h)] = row
    out: List[Dict] = []
    for w in sorted(by_window):
        hosts = by_window[w]
        merged: Dict = {
            "window": w,
            "hosts": sorted(hosts),
        }

        def vals(key: str) -> List:
            return [
                (h, hosts[h][f"signal_{key}"]) for h in sorted(hosts)
                if isinstance(hosts[h].get(f"signal_{key}"), (int, float))
                and not isinstance(hosts[h].get(f"signal_{key}"), bool)
            ]

        tp = vals("throughput_wps")
        if tp:
            merged["throughput_wps"] = round(sum(v for _, v in tp), 3)
            slowest = min(tp, key=lambda kv: kv[1])
            merged["throughput_min_host"] = slowest[0]
        p50 = vals("step_time_p50_ms")
        if p50:
            med = _median([v for _, v in p50])
            worst_host, worst_v = max(p50, key=lambda kv: kv[1])
            merged["step_time_p50_ms_median"] = round(med, 3)
            merged["step_time_p50_ms_max"] = round(worst_v, 3)
            if med > 0 and worst_v / med >= STRAGGLER_FACTOR and len(p50) > 1:
                merged["straggler"] = {
                    "host": worst_host,
                    "step_time_p50_ms": round(worst_v, 3),
                    "vs_median": round(worst_v / med, 3),
                }
        ov = vals("host_overhead_ms")
        if ov and len(ov) > 1:
            # the lockstep-fleet discriminator (obs/signals.py notes): on a
            # synchronous-collective backend every host's step time
            # equalizes to the slowest host's, so p50 cannot name the
            # straggler — but the time a host spends OUTSIDE its spans is
            # attributable to it alone. Preferred over the p50 pick when
            # it clears both an absolute floor (clock-skew crumbs stay
            # anonymous) and the factor bar.
            med = _median([v for _, v in ov])
            worst_host, worst_v = max(ov, key=lambda kv: kv[1])
            merged["host_overhead_ms_max"] = round(worst_v, 3)
            if worst_v > max(STRAGGLER_MIN_OVERHEAD_MS,
                             STRAGGLER_FACTOR * med):
                merged["straggler"] = {
                    "host": worst_host,
                    "host_overhead_ms": round(worst_v, 3),
                    "vs_median": round(worst_v / max(med, 1.0), 3),
                }
        skew = vals("straggler_skew")
        if skew:
            merged["straggler_skew_max"] = round(max(v for _, v in skew), 3)
        ibr = vals("input_bound_ratio")
        if ibr:
            merged["input_bound_ratio_mean"] = round(
                sum(v for _, v in ibr) / len(ibr), 4
            )
        q = vals("quality_planted")
        if q:
            merged["quality_planted_min"] = round(min(v for _, v in q), 4)
        qps = vals("serve_qps")
        if qps:
            merged["serve_qps"] = round(sum(v for _, v in qps), 3)
        p99 = vals("serve_p99_ms")
        if p99:
            merged["serve_p99_ms_max"] = round(max(v for _, v in p99), 3)
        ch = vals("cache_hit")
        if ch:
            merged["cache_hit_mean"] = round(
                sum(v for _, v in ch) / len(ch), 4
            )
        mh = vals("mem_headroom_frac")
        if mh:
            # device-memory view (obs/devmem.py): the fleet has the
            # headroom of its WORST host — that host is where the next
            # vocab growth or table swap OOMs, so it gets the attribution
            # (the host_overhead straggler discipline, applied to memory)
            worst_host, worst_v = min(mh, key=lambda kv: kv[1])
            merged["mem_headroom_frac_min"] = round(worst_v, 6)
            merged["mem_worst_host"] = worst_host
        mp = vals("mem_peak_bytes")
        if mp:
            merged["mem_peak_bytes_max"] = max(v for _, v in mp)
        out.append(merged)
    return out


def fleet_doc(windows: List[Dict], window_steps: Optional[int] = None) -> Dict:
    """Assemble the fleet.json document from merged windows."""
    hosts = sorted({h for w in windows for h in w.get("hosts", ())})
    # overall straggler attribution: the host most often named worst, with
    # its peak skew — "who do I go look at" in one field
    counts: Dict[int, int] = {}
    peak: Dict[int, float] = {}
    for w in windows:
        s = w.get("straggler")
        if s:
            counts[s["host"]] = counts.get(s["host"], 0) + 1
            peak[s["host"]] = max(peak.get(s["host"], 0.0), s["vs_median"])
    straggler = None
    if counts:
        worst = max(counts, key=lambda h: (counts[h], peak[h]))
        straggler = {
            "host": worst,
            "windows_worst": counts[worst],
            "max_vs_median": round(peak[worst], 3),
        }
    doc: Dict = {
        "schema": SCHEMA,
        "event": "fleet_doc",
        "generated_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "hosts": hosts,
        "windows_total": len(windows),
        "windows": windows[-KEEP_WINDOWS:],
        "last": windows[-1] if windows else None,
        "straggler": straggler,
    }
    if window_steps:
        doc["window_steps"] = int(window_steps)
    return doc


def validate_fleet_doc(doc: Dict) -> Dict[str, int]:
    """Schema gate for fleet.json (CI + tests); returns summary counts.
    Raises ValueError naming the first offending field."""
    if not isinstance(doc, dict):
        raise ValueError("not a fleet document: not an object")
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"bad schema {doc.get('schema')!r} (want {SCHEMA})")
    if not isinstance(doc.get("hosts"), list):
        raise ValueError("missing hosts list")
    windows = doc.get("windows")
    if not isinstance(windows, list):
        raise ValueError("missing windows list")
    last_w = None
    for i, w in enumerate(windows):
        if not isinstance(w, dict) or not isinstance(w.get("window"), int):
            raise ValueError(f"window {i}: missing integer window id")
        if not isinstance(w.get("hosts"), list) or not w["hosts"]:
            raise ValueError(f"window {i}: missing hosts")
        if last_w is not None and w["window"] <= last_w:
            raise ValueError(
                f"window {i}: ids not strictly increasing "
                f"({w['window']} after {last_w})"
            )
        last_w = w["window"]
        s = w.get("straggler")
        if s is not None and not isinstance(s.get("host"), int):
            raise ValueError(f"window {i}: straggler without integer host")
    return {
        "hosts": len(doc["hosts"]),
        "windows": len(windows),
        "stragglers": sum(1 for w in windows if w.get("straggler")),
    }


class FleetAggregator:
    """Incremental merge of every signals_p*.jsonl in a directory.

    `aggregate()` tail-reads new rows (per-file byte offsets, so repeated
    aggregation is O(new rows), not O(history^2)), re-merges, atomically
    rewrites `fleet.json`, and returns one flat "event":"fleet" gauge
    record for the hub (None when nothing merged yet)."""

    #: minimum seconds between aggregation passes: the caller may invoke
    #: aggregate() at every window close, but re-merging + rewriting
    #: fleet.json that often would dominate the signal plane's cost on
    #: fast-step shapes (the <1% contract); `force=True` (run end) always
    #: runs so the final artifact is complete
    MIN_INTERVAL_S = 1.0

    def __init__(self, metrics_dir: str, out_name: str = "fleet.json",
                 window_steps: Optional[int] = None):
        self.metrics_dir = metrics_dir
        self.out_path = os.path.join(metrics_dir, out_name)
        self.window_steps = window_steps
        self._offsets: Dict[str, int] = {}
        self._rows: List[Dict] = []
        self._last_run = 0.0

    def aggregate(self, force: bool = False) -> Optional[Dict]:
        now = time.monotonic()
        if not force and now - self._last_run < self.MIN_INTERVAL_S:
            return None
        self._last_run = now
        for path in sorted(
            glob.glob(os.path.join(self.metrics_dir, "signals_p*.jsonl"))
        ):
            rows, off = read_signal_rows(path, self._offsets.get(path, 0))
            self._offsets[path] = off
            self._rows.extend(rows)
        if not self._rows:
            return None
        windows = merge_rows(self._rows)
        doc = fleet_doc(windows, window_steps=self.window_steps)
        tmp = self.out_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, default=str)
                f.write("\n")
            os.replace(tmp, self.out_path)
        except OSError:
            pass  # the gauge record below still carries the fleet view
        return self.gauge_record(doc)

    @staticmethod
    def gauge_record(doc: Dict) -> Optional[Dict]:
        """fleet.json -> one flat record whose numeric fields become
        `w2v_fleet_*` gauges (obs/export.GAUGE_EVENTS)."""
        last = doc.get("last")
        if not last:
            return None
        rec: Dict = {
            "event": "fleet",
            "fleet_hosts": len(doc.get("hosts", ())),
            "fleet_window": last["window"],
            "fleet_windows_total": doc.get("windows_total", 0),
        }
        for src, dst in (
            ("throughput_wps", "fleet_throughput_wps"),
            ("step_time_p50_ms_median", "fleet_step_time_p50_ms"),
            ("step_time_p50_ms_max", "fleet_step_time_p50_ms_max"),
            ("straggler_skew_max", "fleet_straggler_skew"),
            ("input_bound_ratio_mean", "fleet_input_bound_ratio"),
            ("quality_planted_min", "fleet_quality_planted_min"),
            ("serve_qps", "fleet_serve_qps"),
            ("serve_p99_ms_max", "fleet_serve_p99_ms"),
            ("cache_hit_mean", "fleet_cache_hit"),
            ("mem_headroom_frac_min", "fleet_mem_headroom_frac"),
            ("mem_peak_bytes_max", "fleet_mem_peak_bytes"),
            ("mem_worst_host", "fleet_mem_worst_host"),
        ):
            if src in last:
                rec[dst] = last[src]
        s = (doc.get("straggler") or last.get("straggler"))
        if s:
            rec["fleet_straggler_host"] = s["host"]
        return rec


def main(argv=None) -> int:
    """Standalone aggregator: `python -m word2vec_tpu_torch.obs.fleet --dir DIR`
    — the serve-replica form, where no training rank 0 exists to host the
    merge. `--once` aggregates and exits (CI); the default loops."""
    ap = argparse.ArgumentParser(
        prog="python -m word2vec_tpu_torch.obs.fleet",
        description="merge per-host signal rows into fleet.json",
    )
    ap.add_argument("--dir", required=True,
                    help="directory holding signals_p*.jsonl (each host's "
                         "--metrics-dir, shared or collected)")
    ap.add_argument("--out", default="fleet.json",
                    help="output filename inside --dir")
    ap.add_argument("--interval", type=float, default=5.0,
                    help="seconds between aggregation passes")
    ap.add_argument("--once", action="store_true",
                    help="aggregate one pass and exit (CI / cron form)")
    ap.add_argument("--json", action="store_true",
                    help="print the fleet gauge record per pass")
    args = ap.parse_args(argv)
    agg = FleetAggregator(args.dir, out_name=args.out)
    while True:
        rec = agg.aggregate()
        if args.json and rec:
            print(json.dumps(rec))
        if args.once:
            if rec is None:
                print(
                    f"no signal rows under {args.dir} "
                    "(expected signals_p*.jsonl)",
                )
                return 1
            return 0
        time.sleep(max(0.2, args.interval))


if __name__ == "__main__":
    raise SystemExit(main())
