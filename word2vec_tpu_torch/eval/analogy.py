"""Google analogy evaluation (questions-words.txt format).

The other half of the BASELINE.json parity gate (the reference ships nothing
comparable, SURVEY §3.5). Protocol matches the original compute-accuracy tool:
3CosAdd over unit-normalized vectors, question words excluded from candidates,
questions with any OOV word skipped.

A copy of word2vec_tpu/eval/analogy.py for the PyTorch port: the score
planes come from the port's query engine (serve/query.py) on the engine's
device (`device=`, the card unless the caller asks for the CPU); the mask
and rank math stays on the host.

File format: `: section-name` headers, then `a b c d` lines meaning
a:b :: c:d  (predict d from b - a + c).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..data.vocab import Vocab
from ..device import DeviceLike


@dataclass
class AnalogyResult:
    accuracy: float
    correct: int
    total: int
    skipped_oov: int
    by_section: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    # Mean rank of the gold answer among candidates (1 = top). Accuracy
    # saturates once every gold ranks first; the rank stays continuous, so
    # parity harnesses keep sensitivity after both sides hit 100%. Tied
    # similarities take the average of their tied ranks
    # (count(>) + (count(==)+1)/2), so quantized embeddings (bf16 tables)
    # don't rank optimistically.
    mean_gold_rank: float = 0.0
    # Questions whose gold answer repeats a question word (d in {a,b,c}):
    # the exclusion mask makes them unanswerable by construction, so they
    # are skipped rather than scored at rank ~V. Generated grids never
    # produce these; malformed file-based question sets can.
    skipped_degenerate: int = 0


def load_questions(path: str) -> List[Tuple[str, List[Tuple[str, str, str, str]]]]:
    sections: List[Tuple[str, List]] = []
    current: List = []
    name = "(default)"
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == ":":
                if current:
                    sections.append((name, current))
                name = " ".join(parts[1:]) or "(unnamed)"
                current = []
            elif len(parts) == 4:
                current.append(tuple(p.lower() for p in parts))
    if current:
        sections.append((name, current))
    return sections


def evaluate_analogies(
    W: np.ndarray,
    vocab: Vocab,
    path: str,
    batch_size: int = 512,
    restrict_vocab: int = 30000,
    method: str = "3cosadd",
    device: DeviceLike = None,
) -> AnalogyResult:
    """3CosAdd (default) or 3CosMul over a questions-words.txt file; see
    evaluate_analogy_sections for the protocol."""
    return evaluate_analogy_sections(
        W, vocab, load_questions(path), batch_size, restrict_vocab, method,
        device=device,
    )


def evaluate_analogy_sections(
    W: np.ndarray,
    vocab: Vocab,
    sections: List[Tuple[str, List[Tuple[str, str, str, str]]]],
    batch_size: int = 512,
    restrict_vocab: int = 30000,
    method: str = "3cosadd",
    device: DeviceLike = None,
) -> AnalogyResult:
    """3CosAdd (compute-accuracy) or 3CosMul (Levy & Goldberg 2014) with
    the compute-accuracy conventions.

    3CosMul scores each candidate d' as
    cos01(d',b) * cos01(d',c) / (cos01(d',a) + 1e-3) with cosines shifted
    to [0,1] — the multiplicative objective amplifies small differences in
    the larger terms and is the other standard protocol (gensim
    most_similar_cosmul); published numbers differ between the two, so
    the method is explicit in the result and CLI output.

    Takes in-memory (section, questions) lists so harnesses with generated
    questions (benchmarks/parity.py planted-relation corpus) share the exact
    scoring path the file-based CLI eval uses.

    restrict_vocab: candidate answers come from the most frequent N words
    (the original tool's `threshold`, default 30000), which also decides OOV
    skips — matching how published text8 numbers are produced.
    """
    if method not in ("3cosadd", "3cosmul"):
        raise ValueError(f"method must be 3cosadd or 3cosmul, got {method!r}")
    V = min(len(vocab), restrict_vocab) if restrict_vocab else len(vocab)
    # shared query kernel (serve/query): the restricted table is
    # row-normalized once and resident on the device; score planes come
    # back as writable [chunk, V] f32 arrays for the mask/rank math below.
    from ..serve.query import get_engine

    eng = get_engine(W, vocab, restrict=V, device=device)

    correct = total = skipped = degenerate = 0
    rank_sum = 0.0
    by_section: Dict[str, Tuple[int, int]] = {}
    for name, questions in sections:
        ids = []
        for a, b, c, d in questions:
            if not all(w in vocab and vocab[w] < V for w in (a, b, c, d)):
                skipped += 1
            elif d in (a, b, c):
                # gold is excluded from candidates below — unanswerable
                degenerate += 1
            else:
                ids.append((vocab[a], vocab[b], vocab[c], vocab[d]))
        sec_correct = 0
        for i in range(0, len(ids), batch_size):
            chunk = np.asarray(ids[i : i + batch_size])
            if len(chunk) == 0:
                continue
            a, b, c, d = chunk.T
            if method == "3cosmul":
                # all three candidate-cosine planes, shifted to [0, 1]
                ca = (eng.cosine_planes(a) + 1.0) / 2.0
                cb = (eng.cosine_planes(b) + 1.0) / 2.0
                cc = (eng.cosine_planes(c) + 1.0) / 2.0
                sims = cb * cc / (ca + 1e-3)  # [chunk, V]
            else:
                sims = eng.analogy_planes(a, b, c)  # [chunk, V]
            rows = np.arange(len(chunk))
            sims[rows, a] = -np.inf  # exclude question words
            sims[rows, b] = -np.inf
            sims[rows, c] = -np.inf
            pred = sims.argmax(axis=1)
            sec_correct += int((pred == d).sum())
            gold = sims[rows, d][:, None]
            # average-of-tied-ranks: count(==) includes gold itself, so the
            # tie-free case reduces to the familiar count(>) + 1
            rank_sum += float(
                ((sims > gold).sum(axis=1) + ((sims == gold).sum(axis=1) + 1) / 2.0).sum()
            )
        by_section[name] = (sec_correct, len(ids))
        correct += sec_correct
        total += len(ids)
    return AnalogyResult(
        accuracy=correct / total if total else 0.0,
        correct=correct,
        total=total,
        skipped_oov=skipped,
        by_section=by_section,
        mean_gold_rank=rank_sum / total if total else 0.0,
        skipped_degenerate=degenerate,
    )
