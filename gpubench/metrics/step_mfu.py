"""The whole training step's share of the card's peak, in %: the published
algorithm's FLOPs for the traced window's trained pairs (counts/work.py:
6 d (1 + K) a skip-gram pair with negative sampling, 6 d a (pair, node)
term with hierarchical softmax) over that window's seconds, between the
host's two marks, times the peak of the configuration's compute type
(counts/peaks.py)."""

from gpubench.counts.peaks import PEAK_FLOPS


def read(rec):
    flops = rec.get("work", {}).get("model_flops")
    if rec.get("kind") != "train" or not flops or not rec.get("window_s"):
        return None
    return 100.0 * flops / (rec["window_s"] * PEAK_FLOPS[rec["compute_dtype"]])
