"""The step router: the step object of a config, the counterpart of
_make_base_step (word2vec_tpu/ops/train_step.py:306-336)."""

from __future__ import annotations

from ..config import Word2VecConfig
from ..obs.health import instrument_step
from .band_step import BandStep
from .hs_step import HsStep
from .pair_step import PairStep


def make_step(
    config: Word2VecConfig, tables, fused: bool = False, tp: int = 1, sp: int = 1
):
    """The step object of a config (_make_base_step, train_step.py:306-336):
    'band' resolves to the objective's fast path — the banded ns step
    (ops/band_step.BandStep) or the positional hs step (ops/hs_step
    .HsStep) — and 'pair' to PairStep. fused=True (chunk runners under
    fused_tables) and the unified layout apply to the ns band step only,
    as in the JAX package. With config.health_metrics the step carries
    the full health counters (obs/health.instrument_step, applied where
    the JAX package applies it: under the micro sub-steps, inside every
    runner's step). tp / sp > 1 make the step of one tensor-parallel
    shard and one sequence shard (ops/shards.py; parallel/trainer.py)."""
    return instrument_step(_route(config, tables, fused, tp, sp), config)


def _route(config: Word2VecConfig, tables, fused: bool, tp: int, sp: int):
    fused = fused or config.table_layout == "unified"
    if config.resolved_kernel == "band":
        if config.use_hs:
            if fused:
                raise ValueError("fused_tables applies to the ns band kernel only")
            return HsStep(config, tables, tp=tp, sp=sp)
        return BandStep(config, tables, fused=fused, tp=tp, sp=sp)
    if fused:
        raise ValueError("fused_tables applies to the ns band kernel only")
    return PairStep(config, tables, tp=tp, sp=sp)
