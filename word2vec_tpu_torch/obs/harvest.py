"""Program cost harvest: the structure of word2vec_tpu/obs/harvest.py.

The JAX package banks what XLA says each compiled executable costs
(`compiled.cost_analysis()`: flops, bytes accessed; `memory_analysis()`:
argument/output/temp/code sizes) next to its analytic counters. The port's
programs are captured CUDA graphs of hand-written kernels and torch ops,
and torch attaches no such analysis to a graph. So the structure is kept —
the trainer CAPTURES each dispatched program the first time it runs (one
set lookup on later dispatches), `finalize()` walks the captured programs
after the run, `report()` and `gauge_record()` feed the
manifest and the `w2v_cost_harvest_*` gauges — and every row degrades as
the JAX module documents for a backend without cost analysis:
`{"program": name, "ok": false, "error": ...}`. No number is made up; the
analytic counters (utils/profiling.step_flops / step_hbm_bytes) stay the
place for the arithmetic.

The programs: `train_step` (a per-step dispatch), `train_chunk` (a
streamed chunk), `resident_chunk` (a chunk assembled on the device).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

#: why every row is ok=False
NO_COST_ANALYSIS = (
    "NotImplementedError: torch exposes no compiled cost analysis for a "
    "captured CUDA graph (no flops / bytes accessed / memory analysis to "
    "read)"
)


class CostHarvest:
    """Registry of programs captured at dispatch, reported at end."""

    def __init__(self, host: int = 0):
        self.host = int(host)
        self._lock = threading.Lock()
        #: captured programs not reported yet
        self._pending: list = []
        #: name -> finished row
        self.programs: Dict[str, Dict] = {}
        self._seen: set = set()

    def want(self, name: str) -> bool:
        """Hot-loop gate: has this program been captured yet? One set
        lookup — the only cost the dispatch path pays after the first."""
        return name not in self._seen

    def capture(self, name: str) -> None:
        """Record that program `name` was dispatched (idempotent per
        name). The JAX harvest keeps the call's avals to lower and compile
        later; a captured graph offers nothing to analyze, so the name is
        all a row needs."""
        with self._lock:
            if name not in self._seen:
                self._seen.add(name)
                self._pending.append(name)

    def finalize(self) -> Dict:
        """Bank a row for every captured program. Runs AFTER training.
        Returns report(). Idempotent: finished programs skip."""
        with self._lock:
            for name in self._pending:
                self.programs[name] = {
                    "program": name, "ok": False, "error": NO_COST_ANALYSIS,
                }
            self._pending.clear()
        return self.report()

    # ------------------------------------------------------------- output
    def report(self) -> Dict:
        """The manifest payload: per-program rows plus cross-program totals
        (the JAX report's keys; the totals stay empty, no row carries a
        number)."""
        with self._lock:
            rows = [dict(r) for _, r in sorted(self.programs.items())]
        return {
            "host": self.host,
            "programs": rows,
            "programs_ok": sum(1 for r in rows if r.get("ok")),
            "programs_failed": sum(1 for r in rows if not r.get("ok", False)),
            "totals": {},
        }

    def gauge_record(self) -> Optional[Dict]:
        """One flat "cost_harvest" event record -> `w2v_cost_harvest_*`
        gauges (obs/export.GAUGE_EVENTS). None before any program banked."""
        rep = self.report()
        if not rep["programs"]:
            return None
        return {
            "event": "cost_harvest",
            "cost_harvest_programs": len(rep["programs"]),
            "cost_harvest_programs_ok": rep["programs_ok"],
        }
