"""Word-similarity evaluation (WordSim-353 and compatible datasets).

The reference has no eval tooling at all (SURVEY §3.5); WS-353 Spearman is
half of the BASELINE.json parity gate, so it is a first-class component here.

A copy of word2vec_tpu/eval/similarity.py for the PyTorch port: host
numpy, with the cosines from the port's query engine (serve/query.py) on
the engine's device (`device=`, the card unless the caller asks for the
CPU).

Dataset format: one pair per line, `word1 word2 score`, separated by commas,
tabs or spaces; an optional header line is skipped. Pairs with OOV words are
dropped (standard protocol) and reported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..data.vocab import Vocab
from ..device import DeviceLike


@dataclass
class SimilarityResult:
    spearman: float
    pearson: float
    pairs_used: int
    pairs_total: int


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average ranks with tie handling (scipy-free)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty(len(x), dtype=np.float64)
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i : j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    return ranks


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra, rb = _rankdata(a), _rankdata(b)
    return pearson(ra, rb)


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    a = a - a.mean()
    b = b - b.mean()
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    return float((a * b).sum() / denom) if denom > 0 else 0.0


def _split_pair_line(
    line: str, min_cols: int, delimiter: str | None = None
) -> List[str]:
    """The one delimiter sniff shared by the reader and the converter:
    comma, then tab, then whitespace — first split yielding min_cols
    fields wins. An explicit delimiter skips the sniff; when that
    delimiter is whitespace, consecutive separators count as ONE (the
    split(None) convention), so a MEN-style file padded with runs of
    spaces keeps its columns aligned instead of dying on an empty-string
    "non-numeric score" (ADVICE r5 #3 — `--delimiter ' '` previously
    produced ['w1', '', 'w2', ...])."""
    if delimiter is not None:
        if delimiter.isspace():
            return [p for p in line.split(delimiter) if p != ""]
        return line.split(delimiter)
    for sep in (",", "\t", None):
        parts = line.split(sep)
        if len(parts) >= min_cols:
            break
    return parts


def load_word_pairs(path: str) -> List[Tuple[str, str, float]]:
    pairs: List[Tuple[str, str, float]] = []
    with open(path, "r", encoding="utf-8") as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            parts = _split_pair_line(line, 3)
            try:
                score = float(parts[2])
            except (ValueError, IndexError):
                if ln == 0:
                    continue  # header
                raise
            pairs.append((parts[0].lower(), parts[1].lower(), score))
    return pairs


def convert_pairs_file(
    src: str,
    dst: str,
    cols: Tuple[int, int, int] = (0, 1, 2),
    delimiter: str | None = None,
    lower: bool = True,
) -> int:
    """Normalize any word-pair similarity file into the canonical
    `word1,word2,score` CSV that load_word_pairs (and the --eval-ws353
    training gate) reads.

    Handles the real datasets' quirks without shipping the datasets (the
    build env is offline — BASELINE.md's ±1% gate runs the moment a user
    supplies one):
      - WordSim-353 `combined.csv`: comma-separated with a
        `Word 1,Word 2,Human (mean)` header — default cols work.
      - SimLex-999: tab-separated, header, score in column 3 —
        `--cols 0,1,3`.
      - MEN: space-separated `word1 word2 score`, no header.
    A header line (non-numeric score cell) is skipped; blank lines are
    skipped; returns the number of pairs written. The output is written to
    a temp file and renamed into place only on success, so a malformed row
    mid-file cannot leave a silently truncated dst behind for a later
    eval run to consume.
    """
    import os

    n = 0
    tmp = dst + ".tmp"
    try:
        with open(src, "r", encoding="utf-8") as f, \
                open(tmp, "w", encoding="utf-8") as out:
            for ln, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                parts = _split_pair_line(line, max(cols) + 1, delimiter)
                if len(parts) <= max(cols):
                    raise ValueError(
                        f"{src}:{ln + 1}: expected at least {max(cols) + 1} "
                        f"columns, got {len(parts)}"
                    )
                w1, w2, s = parts[cols[0]], parts[cols[1]], parts[cols[2]]
                try:
                    score = float(s)
                except ValueError:
                    if ln == 0:
                        continue  # header
                    raise ValueError(
                        f"{src}:{ln + 1}: non-numeric score {s!r}"
                    ) from None
                if lower:
                    w1, w2 = w1.lower(), w2.lower()
                out.write(f"{w1},{w2},{score}\n")
                n += 1
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, dst)
    return n


def cosine_rows(W: np.ndarray, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    a, b = W[i], W[j]
    na = np.linalg.norm(a, axis=-1)
    nb = np.linalg.norm(b, axis=-1)
    return (a * b).sum(-1) / np.maximum(na * nb, 1e-12)


def evaluate_pairs(
    W: np.ndarray, vocab: Vocab, pairs: List[Tuple[str, str, float]],
    device: DeviceLike = None,
) -> SimilarityResult:
    idx_a, idx_b, gold = [], [], []
    for w1, w2, score in pairs:
        if w1 in vocab and w2 in vocab:
            idx_a.append(vocab[w1])
            idx_b.append(vocab[w2])
            gold.append(score)
    if not gold:
        return SimilarityResult(0.0, 0.0, 0, len(pairs))
    # the query engine's resident normalized table: one unit_norm pass for
    # every eval query against this array, cosines on the device as a
    # pair-dot (rows are unit). cosine_rows stays as the host-side
    # reference implementation (and for callers without a vocab).
    from ..serve.query import get_engine

    eng = get_engine(W, vocab, device=device)
    sims = eng.pair_cosines(np.asarray(idx_a), np.asarray(idx_b))
    gold_arr = np.asarray(gold)
    return SimilarityResult(
        spearman=spearman(sims, gold_arr),
        pearson=pearson(sims, gold_arr),
        pairs_used=len(gold),
        pairs_total=len(pairs),
    )


def evaluate_ws353(
    W: np.ndarray, vocab: Vocab, path: str, device: DeviceLike = None
) -> SimilarityResult:
    return evaluate_pairs(W, vocab, load_word_pairs(path), device=device)
