"""Metric exporters: one fan-out hub, many sinks.

A copy of word2vec_tpu/obs/export.py for the PyTorch port (host code; the
metric names and the exposition bytes are the JAX package's).

`MetricsHub`: drivers hold ONE callable, sinks are registered once, and
everything closeable is flushed/closed in one place at run end (a single
close point, so no file handle leaks). Any callable is a sink —
`progress_logger`, `jsonl_logger`, and the Prometheus textfile exporter
below.

`prometheus_textfile(path)` maintains a node-exporter-style textfile: every
record updates a gauge set, and the whole exposition is atomically
rewritten (tmp + rename, so a scraping collector never reads a torn file).
Numeric top-level record keys become `w2v_<key>` gauges; the nested
per-phase stats dict (obs/phases.PhaseRecorder.snapshot) flattens to
`w2v_phase_<stat>{phase="..."}`. Non-numeric values are skipped — gauges
are for continuous signals — but RESILIENCE EVENT records increment
monotonic counters (EVENT_COUNTERS below: recoveries / stalls / peer losses
/ resume fallbacks), always present in the exposition from zero so a
dashboard can alert on `increase()` without waiting for the first incident.
Every rewrite stamps `w2v_exposition_timestamp_seconds` so a scraper can
tell a live file from a dead run's last exposition.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Dict, List, Optional

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")

#: event-record kinds counted as monotonic counters. The events arrive on
#: the same hub the JSONL sees: the supervisor logs auto_recover, the
#: trainers log resume_fallback, cli.py feeds stalled / peer_lost on the
#: corresponding abort paths (the stall path via the watchdog's flush_fn,
#: since os._exit skips every atexit hook), and the quality probe
#: (obs/quality.py) logs quality_probe on every probe and quality_alert
#: when the sentinel escalates past its budget. All present in the
#: exposition from zero so a dashboard can alert on `increase()` without
#: waiting for the first incident.
EVENT_COUNTERS = {
    "auto_recover": "w2v_recoveries_total",
    "stalled": "w2v_stalls_total",
    "peer_lost": "w2v_peer_lost_total",
    "resume_fallback": "w2v_resume_fallbacks_total",
    "quality_probe": "w2v_quality_probes_total",
    "quality_alert": "w2v_quality_alerts_total",
    # elastic shrink/grow (resilience/elastic.py): a remesh event fires on
    # both legs — the recovering generation counts it before its in-place
    # exec, and in-process ShardedTrainer.remesh() calls count here too; a
    # rejoined host's admission counts peer_rejoin on every fleet member.
    # (The w2v_mesh_size GAUGE rides the ordinary record path: the CLI logs
    # a numeric mesh_size record at every generation start.)
    "remesh": "w2v_remesh_total",
    "peer_rejoin": "w2v_peer_rejoin_total",
    # rank-0 survival (resilience/elastic.py): a rendezvous re-election —
    # the incumbent host died and the lowest surviving rank bound its
    # standby address to host the round. Counted by every survivor that
    # participated (elected host and joiners alike).
    "rendezvous_election": "w2v_rendezvous_elections_total",
    # purpose-driven remeshes (resilience/policy.py): a shrink/grow whose
    # trigger was the elastic policy, not a failure. Fires alongside the
    # plain remesh counter on the recovering generation's hub.
    "policy_remesh": "w2v_policy_remesh_total",
    # SLO breaches (obs/slo.py): a rule that stayed breached for its `for=`
    # budget of consecutive windows. A breach is a log + event, never an
    # exit — but a dashboard must be able to alert on increase() from zero.
    "slo_breach": "w2v_slo_breaches_total",
    # continuous training (stream/driver.py): online-growth admissions,
    # and hot table swaps into a live serve engine — accepted swaps and
    # quality-gate refusals counted separately, so a dashboard can alert
    # on refusals climbing while swaps stall (a degrading trainer).
    "vocab_growth": "w2v_vocab_growth_total",
    "table_swap": "w2v_table_swaps_total",
    "table_swap_refused": "w2v_table_swap_refused_total",
    # device-truth observability (obs/profiler.py): completed bounded
    # profiler windows — a dashboard alerting on breaches can confirm the
    # evidence capture actually ran (increase() on both counters together).
    "profiler_capture": "w2v_profiler_captures_total",
}

#: event kinds whose NUMERIC fields also land as gauges. Mesh topology
#: (w2v_mesh_size / w2v_mesh_processes / w2v_elastic_generation) is a
#: continuous signal that only changes at remesh boundaries, so it rides
#: the event channel (one record per generation, rendered as a labelled
#: line by the console sink) but must still be scrapeable as a gauge.
#: "signals" rows (obs/signals.py, one per closed window: w2v_signal_*)
#: and "fleet" rows (obs/fleet.py rank-0 aggregation: w2v_fleet_*) are the
#: signal plane's continuous outputs and ride the same channel. "stream"
#: rows (stream/driver.py, one per segment boundary) carry the
#: continuous-training gauges: w2v_vocab_size / w2v_stream_tokens_total /
#: w2v_stream_segment / w2v_vocab_generation — emitted once at run start
#: too, so the gauges are present from zero.
#: "mem" rows (obs/devmem.MemoryLedger, one per ledger sample) carry the
#: device-memory watermarks: w2v_mem_bytes_in_use / w2v_mem_peak_bytes /
#: w2v_mem_bytes_limit / w2v_mem_headroom_frac / w2v_mem_available —
#: present from zero (a statless CPU backend emits zeroed rows rather
#: than nothing).
GAUGE_EVENTS = ("mesh", "signals", "fleet", "stream", "mem")

#: seconds one sink call may take before the hub detaches it as wedged —
#: generous (a prom textfile rewrite is microseconds; a hung NFS mount or
#: a blocking network sink is what this catches)
SLOW_SINK_S = 5.0


class MetricsHub:
    """Fan out one log record to every registered sink; close them once.

    Sink failures are ISOLATED: a sink that raises, or whose single call
    exceeds `slow_sink_s` wall seconds, is warned about and DETACHED — the
    hub sits inside the training step loop and the serve batch path, and a
    full disk or a wedged remote sink must degrade telemetry, never kill
    the work it observes (regression-pinned with a poisoned sink in
    tests/test_signals.py). A detached sink is still closed by close(), so
    a half-written file gets its flush."""

    def __init__(self, *sinks: Optional[Callable[[Dict], None]],
                 slow_sink_s: float = SLOW_SINK_S):
        self._sinks: List[Callable[[Dict], None]] = []
        self._detached: List[Callable[[Dict], None]] = []
        self.slow_sink_s = float(slow_sink_s)
        for s in sinks:
            self.add(s)

    @property
    def sinks(self) -> List[Callable[[Dict], None]]:
        return list(self._sinks)

    def add(self, sink: Optional[Callable[[Dict], None]]):
        """Register a sink (None is ignored, so callers can pass optional
        sinks unconditionally). Returns the sink for chaining."""
        if sink is not None:
            self._sinks.append(sink)
        return sink

    def _detach(self, sink, why: str) -> None:
        import warnings

        try:
            self._sinks.remove(sink)
        except ValueError:
            return
        self._detached.append(sink)
        warnings.warn(
            f"metrics sink {sink!r} detached: {why}. Telemetry from this "
            "sink stops here; the run continues.",
            stacklevel=3,
        )

    def __call__(self, record: Dict) -> None:
        for s in list(self._sinks):
            t0 = time.perf_counter()
            try:
                s(record)
            except Exception as e:  # noqa: BLE001 — see class docstring
                self._detach(s, f"raised {e!r}")
                continue
            if (
                self.slow_sink_s
                and time.perf_counter() - t0 > self.slow_sink_s
            ):
                self._detach(
                    s,
                    f"one call took > {self.slow_sink_s:g}s "
                    "(wedged or blocking sink)",
                )

    def close(self) -> None:
        """Flush/close every sink that supports it — detached sinks
        included (their files deserve a flush). Best-effort: a sink
        failing to close must not mask a training result that is already
        computed (the failure is warned, not raised)."""
        for s in self._sinks + self._detached:
            close = getattr(s, "close", None)
            if close is None:
                continue
            try:
                close()
            except Exception as e:  # noqa: BLE001 — see docstring
                import warnings

                warnings.warn(
                    f"metrics sink {s!r} failed to close: {e}", stacklevel=2
                )


def _metric_name(key: str) -> str:
    name = "w2v_" + _NAME_OK.sub("_", str(key))
    return name


def _label_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class PrometheusTextfile:
    """Gauge-set sink writing the Prometheus text exposition format."""

    def __init__(self, path: str):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(parent, exist_ok=True)
        # (name, labels-tuple) -> float; insertion order = exposition order
        self._gauges: Dict = {}
        # resilience counters, present from zero (see EVENT_COUNTERS)
        self._counters: Dict[str, float] = {
            name: 0.0 for name in EVENT_COUNTERS.values()
        }
        # real cumulative histograms (name -> {"le", "counts", "sum",
        # "count"}): the latest cumulative state per metric — the feeder
        # (obs/signals.Histogram, serve/metrics.ServeStats) accumulates;
        # this sink only renders _bucket/_sum/_count. A p99-as-gauge cannot
        # be aggregated across replicas; bucket counts can be summed.
        self._hists: Dict[str, Dict] = {}

    @staticmethod
    def _is_hist(key: str, val) -> bool:
        return (
            key.endswith("_hist")
            and isinstance(val, dict)
            and isinstance(val.get("le"), list)
            and isinstance(val.get("counts"), list)
            and len(val["counts"]) == len(val["le"]) + 1
            and "sum" in val
            and "count" in val
        )

    def _set_hist(self, key: str, val: Dict) -> None:
        self._hists[_metric_name(key[: -len("_hist")])] = val

    def __call__(self, record: Dict) -> None:
        if "event" in record:
            # one-off notices are not gauges — but resilience events count,
            # and GAUGE_EVENTS carry continuous signals worth scraping
            dirty = False
            name = EVENT_COUNTERS.get(record["event"])
            if name is not None:
                self._counters[name] += 1.0
                dirty = True
            if record["event"] in GAUGE_EVENTS:
                for key, val in record.items():
                    if self._is_hist(key, val):
                        self._set_hist(key, val)
                        dirty = True
                        continue
                    if key == "event" or isinstance(val, bool) or not (
                        isinstance(val, (int, float))
                    ):
                        continue
                    self._set(_metric_name(key), (), val)
                    dirty = True
            if dirty:
                self._write()
            return
        for key, val in record.items():
            if key == "phases" and isinstance(val, dict):
                for phase, stats in val.items():
                    if not isinstance(stats, dict):
                        continue
                    for stat, sv in stats.items():
                        if isinstance(sv, bool) or not isinstance(sv, (int, float)):
                            continue
                        self._set(
                            f"w2v_phase_{_NAME_OK.sub('_', stat)}",
                            (("phase", str(phase)),),
                            sv,
                        )
                continue
            if self._is_hist(key, val):
                self._set_hist(key, val)
                continue
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            self._set(_metric_name(key), (), val)
        self._write()

    def _set(self, name: str, labels, value) -> None:
        self._gauges[(name, labels)] = float(value)

    @staticmethod
    def _fmt(value: float) -> str:
        # the exposition format spells non-finite values NaN/+Inf/-Inf
        if value != value:
            return "NaN"
        if value == float("inf"):
            return "+Inf"
        if value == float("-inf"):
            return "-Inf"
        return repr(value)

    def render(self) -> str:
        """The full text exposition as a string — the serve HTTP
        `/metrics` endpoint returns this directly; `_write` persists the
        same bytes to the textfile."""
        return "\n".join(self._render_lines()) + "\n"

    def _render_lines(self) -> List[str]:
        by_name: Dict[str, List] = {}
        for (name, labels), value in self._gauges.items():
            by_name.setdefault(name, []).append((labels, value))
        lines = []
        for name, series in by_name.items():
            lines.append(f"# HELP {name} word2vec_tpu training metric")
            lines.append(f"# TYPE {name} gauge")
            for labels, value in series:
                if labels:
                    lbl = ",".join(
                        f'{k}="{_label_escape(v)}"' for k, v in labels
                    )
                    lines.append(f"{name}{{{lbl}}} {self._fmt(value)}")
                else:
                    lines.append(f"{name} {self._fmt(value)}")
        for name, hist in self._hists.items():
            lines.append(f"# HELP {name} word2vec_tpu latency histogram")
            lines.append(f"# TYPE {name} histogram")
            for bound, count in zip(hist["le"], hist["counts"]):
                lines.append(
                    f'{name}_bucket{{le="{float(bound):g}"}} '
                    f"{self._fmt(float(count))}"
                )
            lines.append(
                f'{name}_bucket{{le="+Inf"}} '
                f"{self._fmt(float(hist['counts'][-1]))}"
            )
            lines.append(f"{name}_sum {self._fmt(float(hist['sum']))}")
            lines.append(f"{name}_count {self._fmt(float(hist['count']))}")
        for name, value in self._counters.items():
            lines.append(f"# HELP {name} word2vec_tpu event counter")
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {self._fmt(value)}")
        # when this exposition was last rewritten (a scraper's liveness check)
        ts_name = "w2v_exposition_timestamp_seconds"
        lines.append(f"# HELP {ts_name} unix time of the last exposition write")
        lines.append(f"# TYPE {ts_name} gauge")
        lines.append(f"{ts_name} {self._fmt(time.time())}")
        return lines

    def _write(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.render())
        os.replace(tmp, self.path)

    def close(self) -> None:
        if self._gauges or self._hists or any(self._counters.values()):
            self._write()


def prometheus_textfile(path: str) -> PrometheusTextfile:
    """Factory matching the utils.logging sink-constructor idiom."""
    return PrometheusTextfile(path)
