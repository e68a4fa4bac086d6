"""Health counters inside the captured step + the host-side divergence
tripwire.

A port of word2vec_tpu/obs/health.py, in two layers:

  device side — `instrument_step` wraps a step object of the router
    (ops/steps.make_step: BandStep, HsStep, PairStep, all with the draw /
    apply contract) and EXTENDS ITS METRICS inside the step, so on the card
    the counters are computed inside the captured CUDA graph (extra rows of
    ops/graphs.StepGraph.out), with no host sync and no launch of the
    port's own kernels:

      nonfinite_loss    always (ops/train_step.finish_metrics: a scalar
                        compare on the loss the step already computes)
      alpha_sum, grad_sq, update_sq_<table>, nonfinite_params
                        only with config.health_metrics: Σ(new − old)² per
                        public table, their sum, the non-finite cells of
                        every table (whole tables, each step: a row that
                        went non-finite at an earlier step still counts),
                        and the step's learning rate.

    The port's steps update the tables IN PLACE, so the pre-step values
    are gone once the step has run. The wrapper therefore snapshots every
    table (one device copy each) before the step and diffs after it — the
    JAX step's own arithmetic (f32 deltas, whole tables): a copy, then per
    table one pass for Σ(new − old)² and one for the non-finite count. The alternative, gathering only the rows the scatters touch,
    would need a hook in every route's update tail; the snapshot is route-
    agnostic, and the counters are opt-in. The unified [V, 2, d] slab
    reports as its two FUSED_SUBTABLES, as in JAX, so the keys do not
    depend on the layout or on the chunk runner's fusion.

    All counters are float32 and ADDITIVE (the graph sums micro sub-steps;
    the chunk runner stacks steps): alpha_sum is micro_steps alphas per
    step, `health_record` divides.

  host side — `HealthMonitor` consumes the counters through the trainer's
    one-dispatch-lagged metrics fetch, counts CONSECUTIVE non-finite
    steps, and raises a structured `DivergenceError` (offending step, last
    counters, last-good checkpoint hint) once the streak reaches
    config.divergence_budget (0 = count only). No new host syncs: the
    monitor only sees metrics the fetch already brought over.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.params import FUSED_KEY, FUSED_SUBTABLES

#: metrics key prefix of the per-table update-magnitude counters
UPDATE_SQ_PREFIX = "update_sq_"


class DivergenceError(RuntimeError):
    """Training diverged: the non-finite streak reached the budget.

    Structured payload: `.step` (the observation that tripped the budget),
    `.streak`, `.first_step` (first non-finite observation of the streak),
    `.counters` (the last fetched metrics, summed over their dispatch) and
    `.checkpoint_hint` (where to resume from, when the run checkpointed).
    """

    def __init__(
        self,
        step: int,
        streak: int,
        first_step: Optional[int] = None,
        counters: Optional[Dict[str, float]] = None,
        checkpoint_hint: Optional[str] = None,
    ):
        self.step = step
        self.streak = streak
        self.first_step = first_step
        self.counters = dict(counters or {})
        self.checkpoint_hint = checkpoint_hint
        shown = {
            k: v for k, v in self.counters.items()
            if k in ("loss_sum", "nonfinite_loss", "nonfinite_params", "grad_sq")
        }
        super().__init__(
            f"training diverged: non-finite loss for {streak} consecutive "
            f"observations (first at step {first_step}), failing at step "
            f"{step}; counters: {shown}; last good checkpoint: "
            f"{checkpoint_hint or 'none taken this run'}"
        )

    def record(self) -> Dict:
        """Structured event payload (what a manifest carries for a
        divergence), without re-parsing the message string."""
        return {
            "event": "divergence",
            "step": self.step,
            "streak": self.streak,
            "first_step": self.first_step,
            "checkpoint_hint": self.checkpoint_hint,
        }


def _subtables(params):
    """(public name, table) pairs in the JAX instrument's order: sorted
    param names, the fused [V, 2, d] slab as its FUSED_SUBTABLES planes."""
    for name in sorted(params):
        t = params[name]
        if name == FUSED_KEY:
            for i, sub in enumerate(FUSED_SUBTABLES):
                yield sub, t[:, i]
        else:
            yield name, t


def _nonfinite(t: torch.Tensor) -> torch.Tensor:
    """The non-finite cells of `t`, as a float32 scalar: t − t is 0 in a
    finite cell and NaN in a non-finite one (inf − inf included), so one
    elementwise pass and one float sum count them, at half the device
    time of isfinite and a bool sum on the card. Exact below 2^24
    cells."""
    return torch.nan_to_num(t - t, nan=1.0).sum(dtype=torch.float32)


def health_names(params) -> Tuple[str, ...]:
    """The metrics keys `instrument_step` adds over `params`."""
    return ("alpha_sum", "grad_sq", "nonfinite_params") + tuple(
        UPDATE_SQ_PREFIX + sub for sub, _ in _subtables(params)
    )


class HealthStep:
    """A step of the router whose metrics carry the health counters
    (word2vec_tpu/obs/health.instrument_step, with config.health_metrics):
    `apply` snapshots the tables, runs the step, and adds alpha_sum,
    grad_sq, nonfinite_params and update_sq_<table>, all float32 device
    scalars. Everything else (draw, sr_rows, pairs, config, ...) is the
    wrapped step's."""

    def __init__(self, base):
        self.base = base

    def __getattr__(self, name):
        return getattr(self.base, name)

    def apply(self, params, tokens, draws, alpha):
        before = {k: v.clone() for k, v in params.items()}
        m = dict(self.base.apply(params, tokens, draws, alpha))
        dev = tokens.device
        m["alpha_sum"] = torch.as_tensor(alpha, dtype=torch.float32).to(dev).reshape(())
        grad_sq = torch.zeros((), dtype=torch.float32, device=dev)
        old = dict(_subtables(before))
        for sub, new in _subtables(params):
            # Σ(new − old)² over f32 deltas, the JAX counter's arithmetic,
            # in one elementwise pass and one sum
            sq = F.mse_loss(new.float(), old[sub].float(), reduction="sum")
            m[UPDATE_SQ_PREFIX + sub] = sq
            grad_sq = grad_sq + sq
        m["grad_sq"] = grad_sq
        m["nonfinite_params"] = sum(_nonfinite(t) for t in params.values())
        return m


def instrument_step(step, config):
    """The router's step with the full counters when config.health_metrics
    is on; the step itself otherwise (the captured graph, its METRICS and
    its launches are then exactly the uninstrumented ones)."""
    if not getattr(config, "health_metrics", False):
        return step
    return HealthStep(step)


def health_record(m: Dict, micro_steps: int = 1) -> Dict[str, float]:
    """Host-side log-record fields from a fetched metrics dict.

    Works on per-step scalars and chunk-stacked [S] arrays alike (sums over
    the window; norms are sqrt-of-summed-squares, i.e. the window's
    cumulative update magnitude). Without the full counters only
    nonfinite_loss_steps is there."""
    rec: Dict[str, float] = {}
    if "nonfinite_loss" in m:
        rec["nonfinite_loss_steps"] = float(np.sum(m["nonfinite_loss"]))
    if "nonfinite_params" in m:
        rec["nonfinite_params"] = float(np.sum(m["nonfinite_params"]))
    if "grad_sq" in m:
        rec["grad_norm"] = float(np.sqrt(np.sum(m["grad_sq"])))
    if "alpha_sum" in m:
        rec["alpha_device"] = float(
            np.mean(np.asarray(m["alpha_sum"])) / max(1, micro_steps)
        )
    for k in m:
        if k.startswith(UPDATE_SQ_PREFIX):
            rec["update_norm_" + k[len(UPDATE_SQ_PREFIX):]] = float(
                np.sqrt(np.sum(m[k]))
            )
    return rec


class HealthMonitor:
    """Consecutive-non-finite tracking over the trainer's lagged fetch:
    `observe_chunk` is called once per FETCHED dispatch with its real
    steps' metrics, independent of log_every. budget == 0 disables the
    tripwire (counting still runs, for TrainReport.health)."""

    def __init__(self, budget: int = 0, micro_steps: int = 1):
        self.budget = int(budget)
        self.micro_steps = max(1, int(micro_steps))
        self.streak = 0
        self.max_streak = 0
        self.observations = 0
        self.nonfinite_steps = 0
        self.first_nonfinite_step: Optional[int] = None
        self.grad_sq_total = 0.0
        self.last: Dict[str, float] = {}
        #: set by the trainer whenever a checkpoint lands (the error's hint)
        self.checkpoint_hint: Optional[str] = None

    # ------------------------------------------------------------ observing
    def observe_chunk(self, m: Dict, end_step: int) -> None:
        """One fetched dispatch's metrics, [S]-stacked over its real steps,
        the last of which is `end_step`."""
        self.last = {k: float(np.sum(v)) for k, v in m.items()}
        self.grad_sq_total += float(np.sum(m.get("grad_sq", 0.0)))
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
                checkpoint_hint=self.checkpoint_hint,
            )

    # ------------------------------------------------------------- summary
    def summary(self) -> Dict:
        """TrainReport.health payload."""
        out = {
            "observations": self.observations,
            "nonfinite_loss_steps": self.nonfinite_steps,
            "max_streak": self.max_streak,
            "divergence_budget": self.budget,
        }
        if self.grad_sq_total > 0.0:
            out["grad_norm_cumulative"] = float(np.sqrt(self.grad_sq_total))
        return out
