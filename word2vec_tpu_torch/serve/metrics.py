"""Serve-side observability primitives: latency/QPS stats + the LRU cache.

A copy of word2vec_tpu/serve/metrics.py for the PyTorch port (host code).

`ServeStats` is the serving counterpart of obs/phases.PhaseRecorder: a
thread-safe accumulator the server feeds per request and per coalesced
batch, snapshotted into MetricsHub records (one flat dict -> Prometheus
gauges `w2v_serve_*` via obs/export) and the `/stats` endpoint. Percentiles
come from a bounded sample ring (most recent LAT_SAMPLES requests), QPS
from a sliding window of completion times — "sustained" throughput, not
lifetime average, so a burst followed by idle doesn't flatter the number.

`LRUCache` is the hot-query result cache: (op, words, k) -> response dict.
A plain OrderedDict under a lock — hit/miss counters live here so the
hit-rate gauge can't drift from the cache that produced it.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

#: latency sample ring size (percentiles over the most recent N requests)
LAT_SAMPLES = 8192
#: sliding QPS window seconds
QPS_WINDOW_S = 30.0

#: serve-latency histogram bucket bounds, seconds (le-style; +Inf implicit).
#: Cumulative bucket counts are the AGGREGATABLE latency form: per-replica
#: p99 gauges cannot be merged, but bucket counts sum across a fleet —
#: exactly what obs/fleet.py's replica aggregation needs.
LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5,
)


def percentile(samples: List[float], q: float) -> float:
    """Nearest-rank percentile over an unsorted sample list (0 <= q <= 1).
    A p99 needs finer resolution than the p50/p90 of profiling's
    lap_stats, hence a local helper sharing its convention (nearest
    rank, no interpolation)."""
    if not samples:
        return 0.0
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(q * len(s) + 0.5) - 1))
    return s[idx]


class ServeStats:
    """Thread-safe serving counters + latency ring + sliding QPS window."""

    def __init__(self):
        self._lock = threading.Lock()
        self.t_start = time.monotonic()
        self.requests_total = 0
        self.errors_total = 0
        self.shed_429_total = 0
        self.batches_total = 0
        self.batch_items_total = 0
        self.batch_padded_total = 0
        self.inflight = 0
        self._lat: collections.deque = collections.deque(maxlen=LAT_SAMPLES)
        self._done_ts: collections.deque = collections.deque()
        #: per-op request counts ({"neighbors": n, ...})
        self.by_op: Dict[str, int] = {}
        # cumulative latency histogram (obs/signals.Histogram): monotonic
        # per-bucket totals + _sum/_count, rendered by the Prometheus sink
        # as w2v_serve_latency_seconds_{bucket,sum,count}
        from ..obs.signals import Histogram

        self._hist = Histogram(buckets=LATENCY_BUCKETS)

    # ------------------------------------------------------------ feeding
    def observe_request(self, op: str, dur_s: float, error: bool = False):
        now = time.monotonic()
        with self._lock:
            self.requests_total += 1
            self.by_op[op] = self.by_op.get(op, 0) + 1
            if error:
                self.errors_total += 1
            else:
                self._lat.append(dur_s)
                self._hist.observe(dur_s)
            self._done_ts.append(now)
            cutoff = now - QPS_WINDOW_S
            while self._done_ts and self._done_ts[0] < cutoff:
                self._done_ts.popleft()

    def observe_shed(self):
        with self._lock:
            self.shed_429_total += 1

    def observe_batch(self, items: int, padded: int):
        with self._lock:
            self.batches_total += 1
            self.batch_items_total += items
            self.batch_padded_total += max(items, padded)

    def adjust_inflight(self, delta: int):
        with self._lock:
            self.inflight += delta

    # --------------------------------------------------------- reporting
    def snapshot(self, cache: Optional["LRUCache"] = None) -> Dict:
        """One flat record: every numeric key becomes a `w2v_serve_*`
        Prometheus gauge through the hub (obs/export gauge naming)."""
        now = time.monotonic()
        with self._lock:
            lat = list(self._lat)
            cutoff = now - QPS_WINDOW_S
            window = [t for t in self._done_ts if t >= cutoff]
            span = min(QPS_WINDOW_S, max(1e-9, now - self.t_start))
            rec: Dict = {
                "serve_requests_total": self.requests_total,
                "serve_errors_total": self.errors_total,
                "serve_shed_429_total": self.shed_429_total,
                "serve_inflight": self.inflight,
                "serve_batches_total": self.batches_total,
                "serve_batch_fill_mean": (
                    self.batch_items_total / self.batches_total
                    if self.batches_total else 0.0
                ),
                "serve_batch_pad_efficiency": (
                    self.batch_items_total / self.batch_padded_total
                    if self.batch_padded_total else 0.0
                ),
                "serve_qps": len(window) / span,
                "serve_p50_ms": 1e3 * percentile(lat, 0.50),
                "serve_p90_ms": 1e3 * percentile(lat, 0.90),
                "serve_p99_ms": 1e3 * percentile(lat, 0.99),
                "serve_uptime_s": now - self.t_start,
                # the aggregatable latency form (see LATENCY_BUCKETS):
                # rendered as a real cumulative Prometheus histogram
                "serve_latency_seconds_hist": self._hist.to_record(),
            }
            for op, n in self.by_op.items():
                rec[f"serve_requests_{op}"] = n
        if cache is not None:
            rec.update(cache.stats())
        return rec


class LRUCache:
    """Bounded (op, words, k) -> response cache with hit/miss counters."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(0, int(capacity))
        self._lock = threading.Lock()
        self._d: "collections.OrderedDict" = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[Dict]:
        if self.capacity == 0:
            return None
        with self._lock:
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, key: Tuple, value: Dict) -> None:
        if self.capacity == 0:
            return
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)

    def stats(self) -> Dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "serve_cache_size": len(self._d),
                "serve_cache_hits": self.hits,
                "serve_cache_misses": self.misses,
                "serve_cache_hit_rate": self.hits / total if total else 0.0,
            }
