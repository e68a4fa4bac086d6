"""The host-side divergence tripwire.

A copy of the host half of word2vec_tpu/obs/health.py for the PyTorch
port. The device half there, `instrument_step`, extends the step's metrics
inside the jitted program; in the port the always-on `nonfinite_loss`
counter is computed inside the captured step instead (ops/graphs.METRICS:
1 per micro sub-step whose loss_sum is not finite, summed over the step).
The full table-diff counters of config.health_metrics are not ported.

`HealthMonitor` consumes the counters through the trainer's
one-dispatch-lagged metrics fetch, counts CONSECUTIVE non-finite steps,
and raises a structured `DivergenceError` once the streak reaches
config.divergence_budget (0 = count only). No new host syncs: the monitor
only sees metrics the fetch already brought over.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class DivergenceError(RuntimeError):
    """Training diverged: the non-finite streak reached the budget.

    Structured payload: `.step` (the observation that tripped the budget),
    `.streak`, `.first_step` (first non-finite observation of the streak),
    `.counters` (the last fetched metrics, summed over their dispatch).
    """

    def __init__(
        self,
        step: int,
        streak: int,
        first_step: Optional[int] = None,
        counters: Optional[Dict[str, float]] = None,
    ):
        self.step = step
        self.streak = streak
        self.first_step = first_step
        self.counters = dict(counters or {})
        shown = {
            k: v for k, v in self.counters.items()
            if k in ("loss_sum", "nonfinite_loss")
        }
        super().__init__(
            f"training diverged: non-finite loss for {streak} consecutive "
            f"observations (first at step {first_step}), failing at step "
            f"{step}; counters: {shown}"
        )


class HealthMonitor:
    """Consecutive-non-finite tracking over the trainer's lagged fetch:
    `observe_chunk` is called once per FETCHED dispatch with its real
    steps' metrics, independent of log_every. budget == 0 disables the
    tripwire (counting still runs, for TrainReport.health)."""

    def __init__(self, budget: int = 0):
        self.budget = int(budget)
        self.streak = 0
        self.max_streak = 0
        self.observations = 0
        self.nonfinite_steps = 0
        self.first_nonfinite_step: Optional[int] = None
        self.last: Dict[str, float] = {}

    # ------------------------------------------------------------ observing
    def observe_chunk(self, m: Dict, end_step: int) -> None:
        """One fetched dispatch's metrics, [S]-stacked over its real steps,
        the last of which is `end_step`."""
        self.last = {k: float(np.sum(v)) for k, v in m.items()}
        arr = np.atleast_1d(np.asarray(m["nonfinite_loss"]))
        start = end_step - len(arr)
        for i, v in enumerate(arr):
            self._advance(float(v) > 0, start + i + 1)

    def _advance(self, bad: bool, at_step: int) -> None:
        self.observations += 1
        if not bad:
            self.streak = 0
            return
        if self.streak == 0:
            self.first_nonfinite_step = at_step
        self.streak += 1
        self.nonfinite_steps += 1
        self.max_streak = max(self.max_streak, self.streak)
        if self.budget and self.streak >= self.budget:
            raise DivergenceError(
                at_step,
                self.streak,
                first_step=self.first_nonfinite_step,
                counters=self.last,
            )

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict:
        """TrainReport.health payload."""
        return {
            "observations": self.observations,
            "nonfinite_loss_steps": self.nonfinite_steps,
            "max_streak": self.max_streak,
            "divergence_budget": self.budget,
        }
