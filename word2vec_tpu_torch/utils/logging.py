"""Structured training logs.

A copy of word2vec_tpu/utils/logging.py for the PyTorch port: the console,
JSONL and fan-out sinks (the TensorBoard sink and the obs/ MetricsHub are
not ported).

The reference's observability is a single in-place printf of alpha +
percent every 100 sentences (Word2Vec.cpp:382-385). Here every log record
is a dict (step, epoch, alpha, loss, progress, words_per_sec, ...) routed
through a callback; `progress_logger` renders the reference-style
single-line console view with the north-star words/sec added, and
`jsonl_logger` writes machine-readable JSONL for dashboards. Every sink
that holds a resource exposes `.close()`; `tee` fans records out and
closes its sinks.
"""

from __future__ import annotations

import atexit
import json
import sys
from typing import Callable, Dict, IO, Optional


def progress_logger(stream: Optional[IO] = None) -> Callable[[Dict], None]:
    """Reference-style one-line progress (Word2Vec.cpp:384) + words/sec,
    to `stream` (sys.stderr as it is when a record is written, by default).

    Tolerates partial records: event records need not carry
    loss/words_per_sec, and a missing key renders as its neutral value
    instead of raising KeyError mid-training."""

    def log(m: Dict) -> None:
        out = stream if stream is not None else sys.stderr
        if "event" in m:
            # one-off event records (e.g. the resident-path resolution) get
            # their own line instead of crashing the \r progress format
            detail = " ".join(f"{k}={v}" for k, v in m.items() if k != "event")
            out.write(f"\n[{m['event']}] {detail}\n")
        else:
            tail = ""
            if "hs_tail_dropped" in m:
                # the two-tier hs tail compaction's dropped slots (its
                # records carry the key on that route only)
                tail = f" hs_tail_dropped: {m['hs_tail_dropped']:.0f} "
            out.write(
                f"\ralpha: {m.get('alpha', float('nan')):.6f}  "
                f"progress: {100 * m.get('progress', 0):6.2f}%  "
                f"loss: {m.get('loss', float('nan')):.4f}  "
                f"{m.get('words_per_sec', 0.0):,.0f} words/sec {tail}"
            )
        out.flush()

    return log


def jsonl_logger(path: str) -> Callable[[Dict], None]:
    """Append machine-readable JSONL records to `path`.

    The returned callable carries a `.close()` (idempotent) that flushes and
    releases the file handle; it is also registered with atexit as a
    fallback, so a caller that never reaches its close point still flushes
    the log on interpreter exit instead of leaking the handle."""
    f = open(path, "a", buffering=1)
    state = {"open": True}

    def log(m: Dict) -> None:
        if state["open"]:
            f.write(json.dumps(m, default=str) + "\n")

    def close() -> None:
        if state["open"]:
            state["open"] = False
            try:
                f.flush()
            finally:
                f.close()

    log.close = close
    atexit.register(close)
    return log


def tee(*loggers: Optional[Callable[[Dict], None]]) -> Callable[[Dict], None]:
    """Fan one record out to every sink; `.close()` closes the sinks that
    hold a resource."""
    active = [l for l in loggers if l is not None]

    def log(m: Dict) -> None:
        for l in active:
            l(m)

    def close() -> None:
        for l in active:
            getattr(l, "close", lambda: None)()

    log.close = close
    return log
