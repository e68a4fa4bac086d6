"""Analytic step-cost model: the planner's pruning stage.

Port of word2vec_tpu/tune/cost_model.py: the same structure, names and
formulas, with the card's own numbers. It ranks candidate plans WITHOUT
running anything: per-step FLOPs and memory traffic come from the shared
counters in utils/profiling.py (pinned equal to the JAX package's by
tests/test_torch_profiling.py), and a two-term roofline turns them into
milliseconds:

    step_ms     = max(flops / peak_flops, bytes / hbm_bw) + copy_ms
                  + scatter_ms + dma_ms + program_gap_ms
    dispatch_ms = per-dispatch overhead / chunk_cap   (amortized share)
    total_ms    = step_ms + dispatch_ms

Four terms lean on measurements instead of first principles: the
inefficiency of the torch-op chain's layout copies, the per-row cost of
the sorted table scatters, the per-row cost of the fused step's in-kernel
row transfers and the gap between the separately scheduled programs of a
step. Each is an anchor fitted on the card by chip_smoke.py phase 12,
which inverts a measured step against the model (cost_calibrate below) on
the route where the anchor's term is largest. The model's job is
ORDERING (which few candidates deserve a timed probe), not absolute
truth: the probes decide the winner, and cost_calibrate flags an anchor
that a run's measured device time no longer supports.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..utils.profiling import step_flops, step_geometry, step_hbm_bytes

# device_kind prefix -> (peak bf16 dense FLOP/s, HBM bytes/s, per-dispatch
# overhead ms). The H100 SXM row: the data-sheet peaks chip_smoke.py uses
# for its bounds (989e12 bf16 dense, 3.35e12 B/s), and the host cost of one
# graphed ChunkRunner dispatch of 6 flagship pallas_fused steps beyond its
# device time (host clock less CUDA events, median of 20), measured by
# chip_smoke.py phase 12 (f) on an NVIDIA H100 80GB HBM3 at 700.00 W
# (torch 2.11, CUDA 12.8). Any other GPU takes this row.
DEVICE_SPECS: Dict[str, Tuple[float, float, float]] = {
    "NVIDIA H100": (989e12, 3.35e12, 0.0615),
}
# 1-core host fallback (the JAX package's CPU row): compute, not
# bandwidth, binds the plain versions on a host.
CPU_SPEC: Tuple[float, float, float] = (15e9, 2e10, 0.3)

# The torch-op chain's layout copies (the xla route's overlap-add chain:
# 3 x [B, C, S+2W, d] f32 of copy bytes) cost this many times their raw
# bytes at the card's streaming rate. Fitted by chip_smoke.py phase 12 (f)
# as the xla route's measured step (the mean of two flagship CLI runs'
# dispatch + device_wait spans, cost_calibrate's measure) less every other
# predicted term, over the copies' streaming time, on an NVIDIA H100 80GB
# HBM3 at 700.00 W: it carries the chain's copies, casts and fills, which
# the roofline does not see (the copy kernels alone take 24x their
# streaming time under torch.profiler in the same phase).
LAYOUT_COPY_INEFFICIENCY = 25.35

# The sorted table scatters' machinery per row (the term the table LAYOUT
# moves: utils/profiling.step_hbm_bytes scatter_rows). Fitted by phase 12
# (f) as the xla/split step's scatter machinery under torch.profiler (the
# ordered slab scatter, its run lists, the ordered row sums and the sorts)
# over its scatter_rows (114,688 at the flagship), on an NVIDIA H100 80GB
# HBM3 at 700.00 W.
SCATTER_SEC_PER_ROW = 3.08e-9

# The gap between the separately scheduled programs of a step
# (step_hbm_bytes "programs": 9 for the xla chain, 3 for the fused step).
# Fitted by phase 12 (f) as the graphed xla step's device window less its
# busy time (10 steps replayed back to back under torch.profiler), over its
# 9 programs, on an NVIDIA H100 80GB HBM3 at 700.00 W.
PROGRAM_GAP_MS = 0.0247

# The fused step's in-kernel row transfers (step_hbm_bytes "dma_rows":
# gathers and the doubled-width scatter's read-modify-writes inside
# csrc/fused_step.cu). Fitted by phase 12 (f) as the pallas_fused step's
# residual: the mean measured step of two flagship CLI runs (chunk 6) less
# every other predicted term, over dma_rows, the inversion cost_calibrate
# makes, on an NVIDIA H100 80GB HBM3 at 700.00 W.
DMA_SEC_PER_ROW = 2.36e-9


def device_spec(
    device_kind: str, platform: str
) -> Tuple[float, float, float]:
    for prefix, spec in DEVICE_SPECS.items():
        if device_kind.startswith(prefix):
            return spec
    if platform == "gpu":
        return DEVICE_SPECS["NVIDIA H100"]  # the one card row there is
    return CPU_SPEC


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    flops: float
    hbm_bytes: float
    copy_bytes: float
    scatter_rows: float  # rows fed to table scatter-adds (a count)
    scatter_ms: float    # scatter_rows * SCATTER_SEC_PER_ROW (per-layout)
    dma_rows: float      # in-kernel per-row transfers (pallas_fused only)
    dma_ms: float        # dma_rows * DMA_SEC_PER_ROW
    programs: float      # separately scheduled device programs per step
    program_gap_ms: float  # programs * PROGRAM_GAP_MS
    step_ms: float       # compute + traffic + copies + row terms, per step
    dispatch_ms: float   # per-step share of dispatch overhead
    total_ms: float

    def to_json(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "copy_bytes": self.copy_bytes,
            "scatter_rows": self.scatter_rows,
            "scatter_ms": round(self.scatter_ms, 4),
            "dma_rows": self.dma_rows,
            "dma_ms": round(self.dma_ms, 4),
            "programs": self.programs,
            "program_gap_ms": round(self.program_gap_ms, 4),
            "step_ms": round(self.step_ms, 4),
            "dispatch_ms": round(self.dispatch_ms, 4),
            "total_ms": round(self.total_ms, 4),
        }


def layout_copy_ms(copy_bytes: float, hbm_bw: float) -> float:
    return 1e3 * copy_bytes * LAYOUT_COPY_INEFFICIENCY / hbm_bw


def table_scatter_ms(scatter_rows: float) -> float:
    """The per-layout scatter term: row machinery the byte roofline cannot
    see (SCATTER_SEC_PER_ROW)."""
    return 1e3 * scatter_rows * SCATTER_SEC_PER_ROW


def kernel_dma_ms(dma_rows: float) -> float:
    """The fused step's in-kernel per-row transfer term (DMA_SEC_PER_ROW)."""
    return 1e3 * dma_rows * DMA_SEC_PER_ROW


def program_gap_ms(programs: float) -> float:
    """Inter-program gaps in the step's device op chain (PROGRAM_GAP_MS
    each)."""
    return programs * PROGRAM_GAP_MS


def predict(
    config,
    vocab_size: int,
    device_kind: str = "",
    platform: str = "cpu",
    chunk_cap: Optional[int] = None,
) -> CostEstimate:
    """CostEstimate for one optimizer step of `config` on the named device.

    chunk_cap overrides the config's scan megastep cap (the planner sweeps
    it without rebuilding configs).
    """
    peak, bw, overhead = device_spec(device_kind, platform)
    flops = step_flops(config, vocab_size)
    traffic = step_hbm_bytes(config, vocab_size)
    streamed = traffic["total"] - traffic["layout_copies"]
    scatter_rows = traffic.get("scatter_rows", 0.0)
    scatter_ms = table_scatter_ms(scatter_rows)
    dma_rows = traffic.get("dma_rows", 0.0)
    dma_ms = kernel_dma_ms(dma_rows)
    programs = traffic.get("programs", 0.0)
    gap_ms = program_gap_ms(programs)
    step_ms = (
        1e3 * max(flops / peak, streamed / bw)
        + layout_copy_ms(traffic["layout_copies"], bw)
        + scatter_ms
        + dma_ms
        + gap_ms
    )
    cap = chunk_cap if chunk_cap is not None else config.chunk_cap
    dispatch_ms = overhead / max(1, cap)
    return CostEstimate(
        flops=flops,
        hbm_bytes=traffic["total"],
        copy_bytes=traffic["layout_copies"],
        scatter_rows=scatter_rows,
        scatter_ms=scatter_ms,
        dma_rows=dma_rows,
        dma_ms=dma_ms,
        programs=programs,
        program_gap_ms=gap_ms,
        step_ms=step_ms,
        dispatch_ms=dispatch_ms,
        total_ms=step_ms + dispatch_ms,
    )


def predicted_words_per_sec(
    config, vocab_size: int, device_kind: str = "", platform: str = "cpu"
) -> float:
    """The ranking metric: tokens per dispatched step over predicted step
    time. Row-packing fill is a corpus property shared by all candidates, so
    a constant factor drops out of the ordering."""
    est = predict(config, vocab_size, device_kind, platform)
    words_per_step = config.batch_rows * config.max_sentence_len
    return 1e3 * words_per_step / max(est.total_ms, 1e-9)


def geometry(config, vocab_size: int) -> Dict:
    """Re-export of the shared shape resolution (utils/profiling) so planner
    callers need one import."""
    return step_geometry(config, vocab_size)


# ---------------------------------------------------- anchor calibration
# An anchor fitted from one measurement cannot detect its own drift: a new
# torch or CUDA, a kernel change or another card silently invalidates it
# while the model keeps ranking plans with stale constants. cost_calibrate
# inverts the prediction against a run's measured device time: assuming
# the OTHER anchors are right, the residual the measurement leaves for
# anchor `a`'s term implies a value for `a`; implied/hand outside
# DRIFT_FACTOR is drift. One scalar measurement cannot separate three
# anchors: a drifted total flags EVERY active anchor whose term could carry
# the residual, and the verdict means "re-measure the anchors", not "this
# one constant moved". Terms contributing less than CALIBRATE_MIN_SHARE of
# the measured step are 'stale': there is not enough signal at this shape
# to judge them (the CPU outcome, where compute dwarfs every anchor term).

#: implied/hand ratio beyond which an anchor reads as drifted
DRIFT_FACTOR = 2.0
#: minimum fraction of the measured device step an anchor's predicted term
#: must carry before its implied value is meaningful
CALIBRATE_MIN_SHARE = 0.02

#: anchor name -> (module constant name, CostEstimate count field,
#: CostEstimate term-ms field)
ANCHORS = {
    "scatter_sec_per_row": (
        "SCATTER_SEC_PER_ROW", "scatter_rows", "scatter_ms"
    ),
    "program_gap_ms": ("PROGRAM_GAP_MS", "programs", "program_gap_ms"),
    "dma_sec_per_row": ("DMA_SEC_PER_ROW", "dma_rows", "dma_ms"),
}


def measured_device_ms(trace_summary: Dict) -> Optional[float]:
    """The measured device-side step time cost_calibrate inverts against:
    the loop-stalling dispatch + device_wait spans per optimizer step
    (the same mapping attribution_rows' device_step row uses). None when
    the summary carries neither span."""
    spans = (trace_summary or {}).get("spans", {})
    vals = [
        spans.get(n, {}).get("ms_per_step")
        for n in ("dispatch", "device_wait")
    ]
    vals = [float(v) for v in vals if isinstance(v, (int, float))]
    if not vals:
        return None
    return sum(vals)


def _anchor_unit_ms(name: str, value: float) -> float:
    """An anchor's per-count cost in ms (the sec-per-row anchors convert)."""
    return value * (1e3 if name.endswith("_sec_per_row") else 1.0)


def cost_calibrate(
    est: CostEstimate,
    measured_ms: Optional[float],
    anchors: Optional[Dict[str, float]] = None,
    drift_factor: float = DRIFT_FACTOR,
    min_share: float = CALIBRATE_MIN_SHARE,
) -> Dict:
    """Per-anchor drift verdict (ok | drift | stale) for one run.

    `est` is the model's prediction at the run's realized shape (its term
    counts are the inversion's denominators); `measured_ms` is the run's
    measured device step (measured_device_ms over its trace summary).
    `anchors` overrides the module constants: how tests inject a perturbed
    anchor and pin the counterfactual flip.

    Verdicts:
      stale — no measurement, zero count for the term, or the term's
              predicted share of the measurement is below `min_share`
      ok    — implied/hand within [1/drift_factor, drift_factor]
      drift — outside; `attribution_trusted` goes False and
              apply_calibration refuses the affected attribution rows
    """
    hand = {
        name: anchors[name] if anchors and name in anchors else globals()[const]
        for name, (const, _, _) in ANCHORS.items()
    }
    # the predicted total REBUILT on the `hand` anchors: est's own term
    # fields embed the module constants, and an overridden anchor must
    # price its term consistently everywhere or the inversion leaks the
    # module value back in
    terms = {
        name: float(getattr(est, count_field))
        * _anchor_unit_ms(name, hand[name])
        for name, (_c, count_field, _t) in ANCHORS.items()
    }
    base_ms = (
        est.step_ms + est.dispatch_ms
        - est.scatter_ms - est.program_gap_ms - est.dma_ms
    )
    total_pred = base_ms + sum(terms.values())
    rows = []
    worst = "ok"
    for name, (_const, count_field, _term_field) in ANCHORS.items():
        count = float(getattr(est, count_field))
        unit = _anchor_unit_ms(name, hand[name])
        term_pred = terms[name]
        row: Dict = {
            "anchor": name,
            "hand_value": hand[name],
            "count": count,
            "predicted_term_ms": round(term_pred, 4),
        }
        if measured_ms is None or count <= 0:
            row["verdict"] = "stale"
            row["why"] = (
                "no measured device time" if measured_ms is None
                else "term inactive at this shape (count 0)"
            )
        else:
            share = term_pred / max(measured_ms, 1e-9)
            row["share_of_measured"] = round(share, 4)
            if share < min_share:
                row["verdict"] = "stale"
                row["why"] = (
                    f"term is {share:.2%} of the measured step "
                    f"(< {min_share:.0%}): no signal at this shape"
                )
            else:
                other = total_pred - term_pred
                implied_ms = measured_ms - other
                implied_unit = implied_ms / count
                implied_value = implied_unit / (
                    1e3 if name.endswith("_sec_per_row") else 1.0
                )
                ratio = implied_unit / unit if unit > 0 else float("inf")
                row["implied_value"] = implied_value
                row["ratio"] = round(ratio, 4)
                row["verdict"] = (
                    "drift"
                    if ratio > drift_factor or ratio < 1.0 / drift_factor
                    else "ok"
                )
        if row["verdict"] == "drift":
            worst = "drift"
        elif row["verdict"] == "stale" and worst == "ok":
            worst = "stale"
        rows.append(row)
    return {
        "anchors": rows,
        "measured_device_ms": (
            round(measured_ms, 4) if measured_ms is not None else None
        ),
        "predicted_device_ms": round(total_pred, 4),
        "drift_factor": drift_factor,
        "min_share": min_share,
        "verdict": worst,
        # the refusal gate: attributions built on a drifted anchor are
        # silently wrong — apply_calibration marks them refused
        "attribution_trusted": all(r["verdict"] != "drift" for r in rows),
    }


#: attribution-row term -> the anchor that prices it
_TERM_ANCHOR = {
    "table_scatter": "scatter_sec_per_row",
    "program_gap": "program_gap_ms",
    "kernel_dma": "dma_sec_per_row",
}


def apply_calibration(rows: list, calib: Dict) -> list:
    """Stamp attribution_rows with their anchors' calibration verdicts,
    and REFUSE the prediction of any row whose anchor drifted (the
    predicted number moves to `predicted_ms_uncalibrated`, the row says
    why): a silently wrong attribution is worse than none."""
    verdicts = {a["anchor"]: a["verdict"] for a in calib.get("anchors", ())}
    out = []
    for row in rows:
        row = dict(row)
        anchor = _TERM_ANCHOR.get(row.get("term"))
        if anchor is not None and anchor in verdicts:
            row["calibration"] = verdicts[anchor]
            if verdicts[anchor] == "drift":
                row["predicted_ms_uncalibrated"] = row.get("predicted_ms")
                row["predicted_ms"] = None
                row["refused"] = (
                    f"anchor {anchor} drifted (cost_calibrate): this "
                    "attribution would be silently wrong — re-measure the "
                    "anchor before trusting the term"
                )
        out.append(row)
    return out


def attribution_rows(est: CostEstimate, trace_summary: Dict) -> list:
    """Measured-vs-predicted cost rows from a run's trace summary
    (obs/tracediff.summarize over the flight ring). The device-side
    prediction (step_ms + the amortized dispatch_ms) is measured by the
    loop-stalling dispatch + device_wait spans; batcher_wait is input wait
    the model prices at zero (a large value there is an input-bound
    verdict, not model error). The scatter, program-gap and in-kernel
    transfer terms are sub-terms of device_step with no span of their
    own: they are measured DIFFERENTIALLY, by a tracediff A/B of two runs
    that differ in the term (split vs unified tables, fused vs xla)."""
    spans = (trace_summary or {}).get("spans", {})

    def per_step(name: str) -> float:
        return float(spans.get(name, {}).get("ms_per_step") or 0.0)

    rows = [
        {
            "term": "device_step",
            "spans": ["dispatch", "device_wait"],
            "predicted_ms": round(est.step_ms + est.dispatch_ms, 4),
            "measured_ms": round(
                per_step("dispatch") + per_step("device_wait"), 4
            ),
        },
        {
            "term": "input_wait",
            "spans": ["batcher_wait"],
            "predicted_ms": 0.0,
            "measured_ms": round(per_step("batcher_wait"), 4),
        },
    ]
    for r in rows:
        r["delta_ms"] = round(r["measured_ms"] - r["predicted_ms"], 4)
    rows.append({
        "term": "table_scatter",
        "spans": [],
        "predicted_ms": round(est.scatter_ms, 4),
        "scatter_rows": est.scatter_rows,
        "measured_ms": None,
        "delta_ms": None,
        "note": "sub-term of device_step; measure via split-vs-unified "
                "tracediff A/B",
    })
    rows.append({
        "term": "program_gap",
        "spans": [],
        "predicted_ms": round(est.program_gap_ms, 4),
        "programs": est.programs,
        "measured_ms": None,
        "delta_ms": None,
        "note": "sub-term of device_step; measure via fused-vs-xla "
                "tracediff A/B (the dispatch-span delta)",
    })
    rows.append({
        "term": "kernel_dma",
        "spans": [],
        "predicted_ms": round(est.dma_ms, 4),
        "dma_rows": est.dma_rows,
        "measured_ms": None,
        "delta_ms": None,
        "note": "sub-term of device_step; nonzero only for "
                "band_backend='pallas_fused'",
    })
    return rows
