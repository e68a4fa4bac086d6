"""Zipf(1) vocabularies and token streams, made from the seed on the device.

A copy, rewritten for the device, of the synthetic text8 stand-in the
program ships (word2vec_tpu_torch/utils/synthetic.py: zipf_vocab and
zipf_corpus_ids): counts proportional to 1 / rank over `vocab` words
scaled to `total_words` and floored at 5 (text8's min_count), and a token
stream drawn i.i.d. from those counts. The stream is drawn by inverse CDF
from one torch.Generator on the card in one call, so the same seed gives
the same tokens on the same device type.
"""

from __future__ import annotations

import numpy as np
import torch


def zipf_counts(vocab: int, total_words: int, s: float = 1.0) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** -s
    return np.maximum((w / w.sum() * total_words).astype(np.int64), 5)


def zipf_tokens(counts: np.ndarray, n: int, seed: int, device) -> torch.Tensor:
    """[n] int32 token ids drawn from the counts' distribution."""
    cdf = torch.as_tensor(np.cumsum(counts / counts.sum()), dtype=torch.float64, device=device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u).clamp_max(len(counts) - 1).to(torch.int32)


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each of a run's streams (the corpus, the
    tables), from the run's seed: a splitmix64 step."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return (x ^ (x >> 31)) & ((1 << 63) - 1)
