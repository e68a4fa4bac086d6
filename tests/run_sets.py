"""Adversarial sorted id sets for the ordered sums, and the work-split
constants of their kernels read from the CUDA sources (numpy only: the
card tests import this without JAX).

Each set targets one edge of the kernels' work split (csrc/runs.cu,
csrc/row_sum.cu, csrc/fused_step.cu slab_scatter_kernel): one run of every
id, all ids distinct, a -1 prefix, runs one below, at and one above the
long-run threshold and each stage size, and trainer-shaped ids whose row 0
collects the padding.
"""

import re
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "word2vec_tpu_torch" / "csrc"


def const(src: str, name: str) -> int:
    """The value of `constexpr int <name> = <value>;` in csrc/<src>."""
    m = re.search(rf"constexpr int {name} = (\d+);", (CSRC / src).read_text())
    assert m, f"{name} not found in csrc/{src}"
    return int(m.group(1))


LONG_RUN = const("runs.cu", "kLongRun")
ROW_STAGE = const("row_sum.cu", "kStage")
TILE_COLS = const("fused_step.cu", "kTileCols")
STAGE_TERMS = const("fused_step.cu", "kStageTerms")

SCATTER_SETS = ["one_run", "distinct", "neg_prefix", "long_edges",
                "stage_edges", "trainer"]
ROW_SUM_SETS = ["one_run", "distinct", "neg_prefix", "long_edges",
                "row_stage_edges", "trainer"]


def _runs_of(lengths, rng, first=1):
    """Sorted ids: one run per length, at distinct ascending ids, with a
    single id between runs."""
    ids, row = [], first
    for n in lengths:
        ids += [row] * n
        ids.append(row + 1)
        row += 2 + int(rng.integers(0, 3))
    return ids


def zipf(n, rng, nv):
    p = 1.0 / np.arange(1, nv + 1)
    return rng.choice(nv, size=n, p=p / p.sum())


def id_set(name: str, rng, nv: int = 600, scale: int = 1) -> np.ndarray:
    """Sorted int32 ids of one set over nv rows; `scale` multiplies the
    sizes of the sets that have no edge to hold (one run, distinct, the -1
    prefix set, trainer rows)."""
    if name == "one_run":
        ids = [min(7, nv - 1)] * (300 * scale)
    elif name == "distinct":
        ids = list(rng.choice(nv, size=min(nv, 200 * scale), replace=False))
    elif name == "neg_prefix":
        ids = [-1] * 7 + list(zipf(400 * scale, rng, nv))
    elif name == "long_edges":
        ids = _runs_of([LONG_RUN - 1, LONG_RUN, LONG_RUN + 1, 1, 2 * LONG_RUN + 1], rng)
    elif name == "stage_edges":
        s = STAGE_TERMS
        ids = _runs_of([s - 1, s, s + 1, 2 * s - 1, 2 * s, 2 * s + 1], rng)
    elif name == "row_stage_edges":
        s = ROW_STAGE
        # crosses the prepass's tile of 16384 positions too
        ids = _runs_of([s - 1, s, s + 1, 2 * s + 1, LONG_RUN + 1], rng)
    elif name == "trainer":
        # grad_inputs-shaped: ragged rows padded with -1, mapped to row 0
        # as the step's gate does, flattened and stably sorted
        rows, cols = 8 * scale, 40
        tok = zipf(rows * cols, rng, nv).reshape(rows, cols)
        for r, n in enumerate(rng.integers(cols // 2, cols + 1, size=rows)):
            tok[r, n:] = -1
        ids = list(np.where(tok >= 0, tok, 0).reshape(-1))
    else:
        raise KeyError(name)
    return np.sort(np.asarray(ids, dtype=np.int32), kind="stable")
