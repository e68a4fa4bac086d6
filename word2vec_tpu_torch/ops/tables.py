"""Frequency-derived constant tables, resident in device memory.

Port of word2vec_tpu/ops/tables.py: the device images of the reference's
host structures, as torch tensors on the training device:
  keep_probs   <- Word::sample_probability   (Word.h:14, Word2Vec.cpp:115-130)
  alias_*      <- the 1e8-slot unigram table (Word2Vec.cpp:81-113), replaced
                  by an exact O(V) alias table sampled on device (ns only)
  hs_codes/points/len <- Word::codes/points  (Word.h:21-22, Word2Vec.cpp:52-78)
                  (hs only; data/huffman.py), with the two-tier split of
                  config.hs_dense_top > 0
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import Word2VecConfig
from ..data.huffman import build_huffman, split_dense_tier
from ..data.negative import build_alias_table
from ..data.vocab import Vocab


@dataclass
class DeviceTables:
    keep_probs: torch.Tensor                # [V] f32
    alias_accept: Optional[torch.Tensor]    # [V] f32 (ns only)
    alias_idx: Optional[torch.Tensor]       # [V] i32 (ns only)
    hs_codes: Optional[torch.Tensor] = None   # [V, Lc] i8  (hs only)
    hs_points: Optional[torch.Tensor] = None  # [V, Lc] i32 (hs only)
    hs_len: Optional[torch.Tensor] = None     # [V] i32     (hs only)
    # two-tier hs split (config.hs_dense_top > 0; data/huffman.py
    # split_dense_tier): signed multi-hot over the top-P node slice, padded
    # per-word path tails, and host-side tail-length stats for sizing
    # compacted tail buffers (ops/hs_step.resolve_tail_slots)
    hs_msig: Optional[torch.Tensor] = None         # [V, P] i8 in {-1,0,+1}
    hs_tail_codes: Optional[torch.Tensor] = None   # [V, Ct] i8
    hs_tail_points: Optional[torch.Tensor] = None  # [V, Ct] i32
    hs_tail_len: Optional[torch.Tensor] = None     # [V] i32
    hs_tail_mean: float = 0.0
    hs_tail_var: float = 0.0
    hs_dense_coverage: float = 0.0

    @property
    def vocab_size(self) -> int:
        return self.keep_probs.shape[0]

    @property
    def max_code_len(self) -> int:
        return 0 if self.hs_codes is None else self.hs_codes.shape[1]

    @classmethod
    def build(
        cls, vocab: Vocab, config: Word2VecConfig, device: torch.device
    ) -> "DeviceTables":
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        keep = dev(vocab.keep_probs(config.subsample_threshold))
        alias_accept = alias_idx = None
        if config.use_ns:
            at = build_alias_table(vocab.unigram_probs(config.ns_power))
            alias_accept, alias_idx = dev(at.accept), dev(at.alias)
        hs = {}
        if config.use_hs:
            counts = np.asarray(vocab.counts)
            hc = build_huffman(counts)
            hs = dict(
                hs_codes=dev(hc.codes.astype(np.int8)),
                hs_points=dev(hc.points),
                hs_len=dev(hc.code_len),
            )
            if config.hs_dense_top > 0:
                split = split_dense_tier(hc, counts, config.hs_dense_top)
                hs.update(
                    hs_msig=dev(split.msig),
                    hs_tail_codes=dev(split.tail_codes.astype(np.int8)),
                    hs_tail_points=dev(split.tail_points),
                    hs_tail_len=dev(split.tail_len),
                    hs_tail_mean=split.tail_mean,
                    hs_tail_var=split.tail_var,
                    hs_dense_coverage=split.coverage,
                )
        return cls(keep, alias_accept, alias_idx, **hs)
