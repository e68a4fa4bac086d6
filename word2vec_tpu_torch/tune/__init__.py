"""The autotuned execution planner (config.autotune), on the card.

Port of word2vec_tpu/tune/ (its exported names):

    cost_model  — analytic bytes + FLOPs per step (the shared counters of
                  utils/profiling.py) -> roofline milliseconds with the
                  card's own anchors, used to prune the candidate grid
                  without running anything; cost_calibrate checks the
                  anchors against a run's measured device time
    planner     — grid -> prune -> timed probes on CUDA graphs over the
                  hand-written routes -> winner (resolve_plan, the single
                  entry point)
    cache       — persistent JSON plan cache keyed by (device_kind,
                  backend, kernel, vocab, dim, layout, KP, band route),
                  backed by the packaged seed_plans.json

Consumers: train.Trainer (config.autotune != "off") and cli.py
(--autotune, --plan-cache; cost_calibrate in the run-end manifest).
"""

from .cache import default_cache_path, lookup, plan_key, store
from .cost_model import CostEstimate, predict, predicted_words_per_sec
from .planner import (
    PlanResolution, candidate_grid, config_fingerprint, kernel_route,
    probe_plan, resolve_plan,
)

__all__ = [
    "CostEstimate",
    "PlanResolution",
    "candidate_grid",
    "config_fingerprint",
    "default_cache_path",
    "kernel_route",
    "lookup",
    "plan_key",
    "predict",
    "predicted_words_per_sec",
    "probe_plan",
    "resolve_plan",
    "store",
]
