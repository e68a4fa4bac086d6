"""HBM memory ledger: the card's memory accounting on the run's planes.

The port's counterpart of word2vec_tpu/obs/devmem.py. Every other
telemetry layer observes the host's view of the run; this one records what
the card's memory holds, per phase:

  device_memory_stats — the ONE funnel for the card's memory report:
                        normalized {bytes_in_use, peak_bytes_in_use,
                        bytes_limit, bytes_reserved} or None where there is
                        nothing to report (the CPU). The stats come from
                        the CUDA caching allocator's host-side counters
                        (torch.cuda.memory_stats: allocated_bytes.all
                        .current / .peak, reserved_bytes.all.current), read
                        without a device sync; the captured graphs' private
                        pools count as reserved. The limit is the card's
                        total memory (torch.cuda.mem_get_info, a device
                        query, made once per device and kept).

  MemoryLedger        — per-phase watermark accounting, beaten from
                        Trainer._check_stop at dispatch boundaries.
                        Non-sample boundaries are ONE integer compare: no
                        launch, no sync, no allocator read. Every sample
                        attributes the live/peak bytes to the phase that
                        produced them (init, table placement, train step,
                        serve table swap, SIGUSR2) and emits ONE "mem"
                        record whose numeric fields become `w2v_mem_*`
                        gauges (obs/export.GAUGE_EVENTS), a row on the
                        flight recorder's memory ring, and — through the
                        SignalEngine's hub-sink harvest — the
                        `mem_headroom_frac` derived signal, which makes
                        memory SLO-able (`--slo 'mem_headroom_frac<0.1'`).

  growth headroom     — `forecast()` projects the rows of table growth the
                        free memory could still hold at the realized
                        bytes/row of the configured table layout.

The module keeps an `activate()`/`active()` process-wide slot so call
sites that cannot thread a reference (the serve engine's `swap_table`, the
SIGUSR2 dump) find the live ledger.

`W2V_FAKE_MEMORY_STATS` (a `key=value,...` spec) substitutes for the
card's report — the test hook that lets a CPU run exercise the
available-stats path. It is a test hook by contract, never set in
production.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Dict, List, Optional

#: default step boundaries between train-phase samples
SAMPLE_EVERY_DEFAULT = 50

#: bounded per-ledger row history (flight keeps its own ring; this one
#: backs summary() and the SIGUSR2 dump)
ROWS_KEPT = 256

#: the phase of the samples on_boundary takes (the others are named by
#: their call sites: init, table_place, serve_swap, sigusr2)
PHASE_TRAIN = "train_step"

#: the test substitution hook (see module docstring)
FAKE_STATS_ENV = "W2V_FAKE_MEMORY_STATS"

_STAT_KEYS = (
    "bytes_in_use", "peak_bytes_in_use", "bytes_limit", "bytes_reserved",
)

#: device index -> total bytes (one mem_get_info per card and process)
_LIMITS: Dict[int, int] = {}


def _fake_stats() -> Optional[Dict[str, int]]:
    spec = os.environ.get(FAKE_STATS_ENV)
    if not spec:
        return None
    out: Dict[str, int] = {}
    for clause in spec.split(","):
        key, _, val = clause.partition("=")
        key = key.strip()
        if key in _STAT_KEYS:
            try:
                out[key] = int(float(val))
            except ValueError:
                continue
    return out or None


def _default_device():
    """The current CUDA device, or None without one."""
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def device_memory_stats(device=None) -> Optional[Dict[str, int]]:
    """Normalized memory stats of one device, or None when there is none
    to report (a CPU device, no CUDA). Never raises: callers gate on the
    result, not on exceptions."""
    fake = _fake_stats()
    if fake is not None:
        return dict(fake)
    import torch

    try:
        dev = _default_device() if device is None else torch.device(device)
        if dev is None or dev.type != "cuda":
            return None
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        stats = torch.cuda.memory_stats(idx)
        limit = _LIMITS.get(idx)
        if limit is None:
            limit = _LIMITS[idx] = int(torch.cuda.mem_get_info(idx)[1])
    except Exception:  # noqa: BLE001 — stats are advisory
        return None
    out = {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
        "bytes_limit": limit,
    }
    return out


def headroom_fraction(stats: Dict[str, int]) -> Optional[float]:
    """free / limit of one normalized stats dict; None without a limit."""
    limit = stats.get("bytes_limit")
    if not limit:
        return None
    free = max(0, int(limit) - int(stats.get("bytes_in_use", 0)))
    return free / float(limit)


def table_row_bytes(config) -> int:
    """Realized bytes one vocabulary row costs in the embedding tables:
    both planes (input + output — split pair or unified slab, same total)
    at the configured storage dtype. The growth-forecast denominator."""
    itemsize = 2 if str(config.dtype) == "bfloat16" else 4
    return 2 * int(config.word_dim) * itemsize


class MemoryLedger:
    """Per-phase device-memory watermarks on the run's existing planes."""

    def __init__(
        self,
        sample_every: int = SAMPLE_EVERY_DEFAULT,
        devices=None,
        log_fn: Optional[Callable[[Dict], None]] = None,
        flight=None,
        host: int = 0,
        row_bytes: int = 0,
        vocab_reserve: int = 0,
    ):
        self.sample_every = max(1, int(sample_every))
        #: explicit device list (None = the current CUDA device, resolved
        #: per sample; no device on the CPU)
        self.devices = devices
        self.log_fn = log_fn
        self.flight = flight
        self.host = int(host)
        #: growth-forecast inputs (0 disables the forecast fields)
        self.row_bytes = int(row_bytes)
        self.vocab_reserve = int(vocab_reserve)
        #: False until a sample actually returned stats; the CPU degrade is
        #: available=False with zeroed gauges, never an error
        self.available = False
        self._lock = threading.Lock()
        self.rows: collections.deque = collections.deque(maxlen=ROWS_KEPT)
        #: phase -> {"samples", "bytes_in_use_max", "peak_bytes_max"}
        self.phases: Dict[str, Dict[str, float]] = {}
        self.samples = 0
        self._next_sample_step: Optional[int] = None
        self._last_stats: Optional[Dict[str, int]] = None

    # ------------------------------------------------------------- sampling
    def _device_list(self) -> List:
        if self.devices is not None:
            return list(self.devices)
        dev = _default_device()
        return [] if dev is None else [dev]

    def _read(self) -> Optional[Dict[str, int]]:
        """Worst-device stats: max bytes_in_use/peak/reserved, min limit."""
        fake = _fake_stats()
        if fake is not None:
            return dict(fake)
        per_dev = [
            s for s in (
                device_memory_stats(d) for d in self._device_list()
            ) if s
        ]
        if not per_dev:
            return None
        out: Dict[str, int] = {}
        for key in ("bytes_in_use", "peak_bytes_in_use", "bytes_reserved"):
            vals = [s[key] for s in per_dev if key in s]
            if vals:
                out[key] = max(vals)
        limits = [s["bytes_limit"] for s in per_dev if "bytes_limit" in s]
        if limits:
            out["bytes_limit"] = min(limits)
        return out or None

    def sample(self, phase: str, step: Optional[int] = None) -> Dict:
        """One ledger sample attributed to `phase`. Always returns a row
        (and emits the gauges) — without stats the byte fields are zero
        and `mem_available` is 0, so dashboards see the series exist from
        the first scrape (present-from-zero), and nothing crashes."""
        stats = self._read()
        row: Dict = {
            "event": "mem",
            "phase": str(phase),
            "host": self.host,
            "mem_available": int(stats is not None),
            "mem_bytes_in_use": 0,
            "mem_peak_bytes": 0,
            "mem_bytes_limit": 0,
        }
        if step is not None:
            row["step"] = int(step)
        if stats is not None:
            self.available = True
            self._last_stats = dict(stats)
            row["mem_bytes_in_use"] = int(stats.get("bytes_in_use", 0))
            row["mem_peak_bytes"] = int(
                stats.get("peak_bytes_in_use", stats.get("bytes_in_use", 0))
            )
            if stats.get("bytes_limit"):
                row["mem_bytes_limit"] = int(stats["bytes_limit"])
                hf = headroom_fraction(stats)
                if hf is not None:
                    row["mem_headroom_frac"] = round(hf, 6)
            rows_left = self._rows_remaining(stats)
            if rows_left is not None:
                row["mem_growth_rows_remaining"] = rows_left
        with self._lock:
            self.samples += 1
            self.rows.append(dict(row))
            ph = self.phases.setdefault(
                str(phase),
                {"samples": 0, "bytes_in_use_max": 0, "peak_bytes_max": 0},
            )
            ph["samples"] += 1
            ph["bytes_in_use_max"] = max(
                ph["bytes_in_use_max"], row["mem_bytes_in_use"]
            )
            ph["peak_bytes_max"] = max(
                ph["peak_bytes_max"], row["mem_peak_bytes"]
            )
        if self.flight is not None:
            self.flight.note_mem(row)
        if self.log_fn is not None:
            self.log_fn(dict(row))
        return row

    def on_boundary(self, step: int) -> None:
        """The trainer beat (Trainer._check_stop): one integer compare on
        non-sample boundaries — no allocator read, no launch, nothing."""
        if self._next_sample_step is None:
            # first boundary: sample immediately so short runs still land
            # one train-phase row
            self._next_sample_step = int(step) + self.sample_every
            self.sample(PHASE_TRAIN, step=step)
            return
        if step < self._next_sample_step:
            return
        self._next_sample_step = int(step) + self.sample_every
        self.sample(PHASE_TRAIN, step=step)

    # ------------------------------------------------------------ forecast
    def _rows_remaining(self, stats: Dict[str, int]) -> Optional[int]:
        """Rows of table growth the CURRENT free memory could still hold at
        the realized bytes/row (None without row-bytes wiring or a limit)."""
        if self.row_bytes <= 0:
            return None
        limit = stats.get("bytes_limit")
        if not limit:
            return None
        free = max(0, int(limit) - int(stats.get("bytes_in_use", 0)))
        return int(free // self.row_bytes)

    def forecast(self) -> Optional[Dict]:
        """The manifest's growth-headroom block (None without row-bytes
        wiring)."""
        if self.row_bytes <= 0:
            return None
        stats = self._last_stats
        rows_left = self._rows_remaining(stats) if stats else None
        out: Dict = {
            "row_bytes": self.row_bytes,
            "vocab_reserve": self.vocab_reserve,
            "reserve_bytes": self.row_bytes * self.vocab_reserve,
            "rows_remaining": rows_left,
        }
        if rows_left is not None and self.vocab_reserve > 0:
            out["reserve_fits"] = bool(rows_left >= 0)
        return out

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict:
        """TrainReport.device_memory / manifest payload: availability, the
        overall and per-phase watermarks, and the growth forecast."""
        with self._lock:
            rows = list(self.rows)
            phases = {k: dict(v) for k, v in self.phases.items()}
        out: Dict = {
            "available": self.available,
            "samples": self.samples,
            "sample_every": self.sample_every,
            "phases": phases,
        }
        if rows:
            out["peak_bytes"] = max(r["mem_peak_bytes"] for r in rows)
            out["last_bytes_in_use"] = rows[-1]["mem_bytes_in_use"]
            hfs = [
                r["mem_headroom_frac"] for r in rows
                if "mem_headroom_frac" in r
            ]
            if hfs:
                out["headroom_frac_min"] = round(min(hfs), 6)
                out["headroom_frac_last"] = hfs[-1]
        fc = self.forecast()
        if fc is not None:
            out["growth_forecast"] = fc
        return out

    def dump(self, path: str, reason: str = "on_demand") -> Optional[str]:
        """Write the ledger (summary + recent rows) as one JSON file — the
        SIGUSR2 on-demand artifact. Best-effort like a flight dump."""
        import json

        try:
            parent = os.path.dirname(os.path.abspath(path)) or "."
            os.makedirs(parent, exist_ok=True)
            doc = {
                "event": "mem_ledger",
                "reason": reason,
                "created_utc": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                ),
                "summary": self.summary(),
                "rows": list(self.rows),
            }
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, default=str)
                f.write("\n")
            os.replace(tmp, path)
            return path
        except Exception:  # noqa: BLE001 — a dump must never kill the run
            return None


# ----------------------------------------------------- process-wide ledger
# swap_table (serve/query.py) and the SIGUSR2 handler need the live ledger
# without a reference threaded through their call chains — the same pattern
# as obs/flight.activate().
_ACTIVE: Optional[MemoryLedger] = None


def activate(ledger: Optional[MemoryLedger]) -> Optional[MemoryLedger]:
    """Install the process-wide ledger; returns the previous one."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = ledger
    return prev


def active() -> Optional[MemoryLedger]:
    return _ACTIVE


def sample_active(phase: str, step: Optional[int] = None) -> Optional[Dict]:
    """Sample the process-wide ledger, if any (the swap call site's
    no-op-when-unwired form)."""
    led = _ACTIVE
    if led is None:
        return None
    return led.sample(phase, step=step)
