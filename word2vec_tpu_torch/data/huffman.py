"""Huffman coding for hierarchical softmax, as padded dense arrays.

The reference builds a pointer tree with a std heap and walks it with an
explicit stack (reference: Word2Vec.cpp:32-79 `create_huffman_tree`). The
TPU-native representation is three dense arrays sized for one device gather:

    codes  [V, L] uint8  — binary code of each word, 0=left / 1=right
                           (reference: Word2Vec.cpp:69-70), padded with 0
    points [V, L] int32  — internal-node index along the root->leaf path
                           (reference: Word2Vec.cpp:72-73), padded with 0
    code_len [V] int32   — true path length; positions >= code_len are masked

L = max code length (~log2 V for Zipfian corpora). Internal nodes are numbered
0..V-2 in merge order, matching the reference's `index - vocab_size`
(Word2Vec.cpp:73), so `points` rows index straight into the [V-1, d] hs output
matrix (reference `synapses1`, Word2Vec.cpp:207).

Port of word2vec_tpu/data/huffman.py (numpy only, copied so the port
imports nothing of the JAX package): the codes, points, lengths and the
two-tier split are bitwise the JAX package's (tests/test_torch_huffman.py).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np


@dataclass
class HuffmanCoding:
    codes: np.ndarray      # [V, L] uint8
    points: np.ndarray     # [V, L] int32
    code_len: np.ndarray   # [V] int32

    @property
    def max_code_len(self) -> int:
        return self.codes.shape[1]

    @property
    def num_internal(self) -> int:
        return self.codes.shape[0] - 1


@dataclass
class DenseTierSplit:
    """Two-tier split of a Huffman coding around the top-P internal nodes.

    Internal-node ids are assigned in merge order (build_huffman), so ids
    along every root->leaf path strictly DECREASE — membership of the top-P
    ids (the last-created, highest-frequency region of the tree) is a true
    PREFIX of every path. That yields two disjoint row sets of the [V-1, d]
    hs output matrix:

      dense tier — the CONTIGUOUS top slice out[V-1-P:], touched by ~3/4 of
        all token-weighted path entries (measured: top-512 covers 73% on a
        zipf-71k vocab). Represented as a per-word signed multi-hot
        msig[V, P] int8: +1 where the word's path visits node (V-1-P)+p with
        code bit 0 (label 1, Word2Vec.cpp:241), -1 for code bit 1, else 0.
        A kernel can therefore score/update the whole tier with dense
        matmuls and a contiguous slice add — no gather/scatter at all.
      tail tier — the per-word path REMAINDER below the top slice, as padded
        arrays tail_codes/tail_points[V, Ct] (Ct = max tail length, ~13 vs
        the full C ~ 25 at zipf-71k/P=512) for the usual positional
        gather/scatter path, now over ~4x fewer padded slots.

    coverage / tail_mean / tail_var are count-weighted corpus expectations
    used for reporting and for sizing compacted tail buffers
    (E[slots per position] = tail_mean, var for the +6-sigma bound).
    """

    msig: np.ndarray         # [V, P] int8 in {-1, 0, +1}
    tail_codes: np.ndarray   # [V, Ct] uint8
    tail_points: np.ndarray  # [V, Ct] int32
    tail_len: np.ndarray     # [V] int32
    coverage: float          # token-weighted share of path entries in dense tier
    tail_mean: float         # E[tail_len] under the unigram distribution
    tail_var: float          # Var[tail_len] under the unigram distribution


def split_dense_tier(
    hc: HuffmanCoding, counts: np.ndarray, top_p: int
) -> DenseTierSplit:
    """Split `hc` into dense/tail tiers around the top_p largest node ids.

    top_p is clamped to the internal-node count (then the whole tree is
    dense and every tail is empty, Ct = 0).
    """
    if top_p < 1:
        raise ValueError(f"top_p must be >= 1, got {top_p}")
    V, C = hc.points.shape
    n_internal = V - 1
    P = min(top_p, n_internal)
    thresh = n_internal - P

    cmask = np.arange(C, dtype=np.int32)[None, :] < hc.code_len[:, None]
    in_dense = (hc.points >= thresh) & cmask
    plen = in_dense.sum(axis=1).astype(np.int32)
    # the monotone-id property makes in_dense a per-row prefix; the whole
    # tier split is unsound if that ever breaks, so verify at build time
    prefix = (np.arange(C, dtype=np.int32)[None, :] < plen[:, None]) & cmask
    if not np.array_equal(in_dense, prefix):
        raise AssertionError(
            "path node ids are not monotone decreasing; dense-tier prefix "
            "split is invalid for this tree"
        )
    tail_len = (hc.code_len - plen).astype(np.int32)
    Ct = int(tail_len.max()) if V else 0

    msig = np.zeros((V, P), dtype=np.int8)
    w_idx, c_idx = np.nonzero(in_dense)
    p_idx = hc.points[w_idx, c_idx] - thresh
    msig[w_idx, p_idx] = np.where(
        hc.codes[w_idx, c_idx] == 0, 1, -1
    ).astype(np.int8)

    tail_codes = np.zeros((V, max(Ct, 1)), dtype=np.uint8)[:, :Ct]
    tail_points = np.zeros((V, max(Ct, 1)), dtype=np.int32)[:, :Ct]
    if Ct:
        rows = np.arange(V)[:, None]
        src = np.minimum(plen[:, None] + np.arange(Ct)[None, :], C - 1)
        tmask = np.arange(Ct, dtype=np.int32)[None, :] < tail_len[:, None]
        tail_codes = np.where(tmask, hc.codes[rows, src], 0).astype(np.uint8)
        tail_points = np.where(tmask, hc.points[rows, src], 0).astype(np.int32)

    w = counts.astype(np.float64)
    w = w / max(w.sum(), 1.0)
    total_len = float((w * hc.code_len).sum())
    tail_mean = float((w * tail_len).sum())
    tail_var = float((w * tail_len.astype(np.float64) ** 2).sum()) - tail_mean**2
    return DenseTierSplit(
        msig=msig,
        tail_codes=tail_codes,
        tail_points=tail_points,
        tail_len=tail_len,
        coverage=1.0 - tail_mean / max(total_len, 1e-12),
        tail_mean=tail_mean,
        tail_var=max(tail_var, 0.0),
    )


def build_huffman(counts: np.ndarray) -> HuffmanCoding:
    """Build Huffman codes from word counts (descending-sorted vocab order).

    Merge semantics match the reference (Word2Vec.cpp:39-49): repeatedly pop
    the two lowest-count nodes; the first popped becomes the left child
    (code bit 0), the second the right child (code bit 1); the merged node's
    internal index is the merge step i, i.e. reference node index i+V minus V.
    Heap ties are broken by node creation order (deterministic), where the
    reference inherits std::make_heap's unspecified tie order — codes can
    differ on ties but are equally optimal.
    """
    V = len(counts)
    if V < 2:
        raise ValueError("Huffman tree needs at least 2 words")

    # heap entries: (count, creation_order, node_id)
    # node ids: 0..V-1 leaves, V..2V-2 internal (merge step i -> id V+i)
    heap = [(int(counts[i]), i, i) for i in range(V)]
    heapq.heapify(heap)
    left = np.empty(V - 1, dtype=np.int64)
    right = np.empty(V - 1, dtype=np.int64)
    for i in range(V - 1):
        c1, _, n1 = heapq.heappop(heap)
        c2, _, n2 = heapq.heappop(heap)
        left[i] = n1
        right[i] = n2
        heapq.heappush(heap, (c1 + c2, V + i, V + i))

    # Iterative root->leaf walk assigning codes/points
    # (reference: Word2Vec.cpp:52-78; points hold internal indices from root).
    code_len = np.zeros(V, dtype=np.int32)
    codes_list: list = [None] * V
    points_list: list = [None] * V
    root = 2 * V - 2
    stack = [(root, [], [])]
    while stack:
        node, code, points = stack.pop()
        if node < V:
            codes_list[node] = code
            points_list[node] = points
            code_len[node] = len(code)
        else:
            k = node - V
            child_points = points + [k]
            stack.append((int(left[k]), code + [0], child_points))
            stack.append((int(right[k]), code + [1], child_points))

    L = int(code_len.max())
    codes = np.zeros((V, L), dtype=np.uint8)
    pts = np.zeros((V, L), dtype=np.int32)
    for w in range(V):
        n = code_len[w]
        codes[w, :n] = codes_list[w]
        pts[w, :n] = points_list[w]
    return HuffmanCoding(codes=codes, points=pts, code_len=code_len)
