"""Nearest-neighbor queries — the `distance` tool the reference lacks
(SURVEY §3.5: "no nearest-neighbor query ... equivalents from the original
google toolkit").

A copy of word2vec_tpu/eval/neighbors.py for the PyTorch port: thin
shims over the port's batched top-k query (serve/query.QueryEngine, on
the card unless `device=` asks for the CPU) — the code path the analogy
evaluator uses too. The engine cache means two
successive queries against the same exported array normalize the table
ONCE instead of recomputing `W / ||W||` per call (pinned by a regression
test), and tied scores come back in deterministic ascending-index order
instead of argpartition's arbitrary one.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..data.vocab import Vocab
from ..device import DeviceLike


def nearest_neighbors(
    W: np.ndarray, vocab: Vocab, word: str, k: int = 10,
    device: DeviceLike = None,
) -> List[Tuple[str, float]]:
    """Top-k cosine neighbors of `word`, excluding itself."""
    from ..serve.query import get_engine

    return get_engine(W, vocab, device=device).neighbors_batch([word], k=k)[0]


def analogy_query(
    W: np.ndarray, vocab: Vocab, a: str, b: str, c: str, k: int = 5,
    device: DeviceLike = None,
) -> List[Tuple[str, float]]:
    """a:b :: c:? via 3CosAdd (word-analogy tool equivalent)."""
    from ..serve.query import get_engine

    return get_engine(W, vocab, device=device).analogy_batch(
        [(a, b, c)], k=k
    )[0]
