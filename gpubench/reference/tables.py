"""The frequency tables a step draws through, built by the reference from
the vocabulary's counts, and compared with the program's.

The program samples its negatives through an alias table and walks a
Huffman code for hierarchical softmax. Both are valid in many forms (any
alias table with the right distribution, any optimal prefix code); the
reference builds the one the program documents (Vose's method over
count^power, word2vec's merge of the two least frequent nodes with ties
taken in creation order), draws through its own, and counts the entries
where the program's differs: a run compares those counts with 0.
`alias_gap` and `huffman_faults` check a table against the distribution
or the optimal cost alone (the reference's own builders are tested by
them).
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np


def unigram(counts: np.ndarray, power: float) -> np.ndarray:
    p = np.asarray(counts, np.float64) ** power
    return p / p.sum()


def alias_table(counts: np.ndarray, power: float) -> Tuple[np.ndarray, np.ndarray]:
    """(accept [V] float32, alias [V] int32): Vose's alias method over
    count^power normalized (and normalized once more, as the program's
    builder takes any weights): the buckets below 1 and those at or above
    it in index order, each pairing the last of both lists, the large
    bucket's rest going back to the list it now falls in."""
    p = unigram(counts, power)
    p = p / p.sum()
    n = len(p)
    scaled = (p * n).tolist()
    accept = [1.0] * n
    alias = list(range(n))
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, l = small.pop(), large.pop()
        accept[s], alias[s] = scaled[s], l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in small + large:
        accept[i], alias[i] = 1.0, i
    return np.asarray(accept, np.float64).astype(np.float32), np.asarray(alias, np.int32)


def huffman_code(counts: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes [V, C] int8, points [V, C] int32, lens [V] int32) of the
    Huffman tree over the counts: each merge takes the two least frequent
    nodes, ties in creation order (the words by index, then the internal
    nodes by merge), the first taken the left child (code 0); merge k makes
    internal node k; a word's points and codes run from the root (node
    V - 2) down, padded with 0. Two queues: the words by (count, index) and
    the merged nodes, whose counts never fall."""
    c = np.asarray(counts, np.int64)
    V = len(c)
    order = np.lexsort((np.arange(V), c))
    leaf_c = c[order].tolist()
    leaf_id = order.tolist()
    node_c = [0] * (V - 1)
    parent = np.zeros(2 * V - 1, np.int64)
    bit = np.zeros(2 * V - 1, np.int8)
    i = j = 0

    def take(k):
        nonlocal i, j
        if i < V and (j >= k or leaf_c[i] <= node_c[j]):
            i += 1
            return leaf_id[i - 1], leaf_c[i - 1]
        j += 1
        return V + j - 1, node_c[j - 1]

    for k in range(V - 1):
        a, ca = take(k)
        b, cb = take(k)
        node_c[k] = ca + cb
        parent[a], bit[a] = k, 0
        parent[b], bit[b] = k, 1
    root = 2 * V - 2
    up_p, up_c = [], []          # leaf to root: each word's ancestors and bits
    cur = np.arange(V, dtype=np.int64)
    live = cur != root
    while live.any():
        up_p.append(np.where(live, parent[cur], -1))
        up_c.append(np.where(live, bit[cur], 0))
        cur = np.where(live, V + parent[cur], root)
        live = cur != root
    up_p, up_c = np.stack(up_p, 1), np.stack(up_c, 1)   # [V, C]
    lens = (up_p >= 0).sum(1).astype(np.int32)
    C = up_p.shape[1]
    lane = np.arange(C)[None, :]
    src = np.clip(lens[:, None] - 1 - lane, 0, C - 1)     # reversed: the root first
    inside = lane < lens[:, None]
    points = np.where(inside, np.take_along_axis(up_p, src, 1), 0).astype(np.int32)
    codes = np.where(inside, np.take_along_axis(up_c, src, 1), 0).astype(np.int8)
    return codes, points, lens


def alias_mismatch(accept: np.ndarray, alias: np.ndarray, ref: Tuple[np.ndarray, np.ndarray]) -> int:
    """Buckets whose threshold (bit for bit) or alias differ from the
    reference's table."""
    a = np.asarray(accept, np.float32)
    if a.shape != ref[0].shape or np.asarray(alias).shape != ref[1].shape:
        return len(ref[0])
    return int(((a.view(np.int32) != ref[0].view(np.int32))
                | (np.asarray(alias, np.int64) != ref[1])).sum())


def huffman_mismatch(codes: np.ndarray, points: np.ndarray, lens: np.ndarray,
                     ref: Tuple[np.ndarray, np.ndarray, np.ndarray]) -> int:
    """Words whose code length, code bits or node ids differ from the
    reference's code."""
    rc, rp, rl = ref
    lens = np.asarray(lens, np.int64)
    if lens.shape != rl.shape or lens.max() != rl.max() or np.asarray(codes).shape[1] < rl.max():
        return len(rl)
    C = int(rl.max())
    inside = np.arange(C)[None, :] < rl[:, None]
    bad = (lens != rl) | ((np.asarray(codes)[:, :C].astype(np.int64) != rc) & inside).any(1) \
        | ((np.asarray(points)[:, :C].astype(np.int64) != rp) & inside).any(1)
    return int(bad.sum())


def alias_gap(accept: np.ndarray, alias: np.ndarray, p: np.ndarray) -> float:
    """The largest gap, over words, between the probability the alias table
    gives a word and p, in units of 1/V (one bucket)."""
    V = len(p)
    a = np.asarray(accept, np.float64)
    got = a.copy()
    np.add.at(got, np.asarray(alias, np.int64), 1.0 - a)
    return float(np.abs(got - p * V).max())


def huffman_cost(counts: np.ndarray) -> int:
    """The optimal code's total count-weighted length (the sum of every
    merge), which every Huffman code of these counts shares."""
    h = [int(c) for c in counts]
    heapq.heapify(h)
    cost = 0
    while len(h) > 1:
        s = heapq.heappop(h) + heapq.heappop(h)
        cost += s
        heapq.heappush(h, s)
    return cost


def huffman_faults(codes: np.ndarray, points: np.ndarray, lens: np.ndarray,
                   counts: np.ndarray) -> int:
    """0 when (codes, points, lens) are a full binary code tree over the
    vocabulary (every word's path starts at the root V-2, node ids fall
    along it, each internal node has one child of each bit and no word is
    a prefix of another) whose count-weighted length is optimal; otherwise
    the number of faults found."""
    V = len(counts)
    faults = 0
    lens = np.asarray(lens, np.int64)
    if lens.min() < 1:
        return 1
    faults += int((points[:, 0] != V - 2).sum())
    child = {}
    for w in range(V):
        n = lens[w]
        p, c = points[w, :n].astype(np.int64), codes[w, :n].astype(np.int64)
        faults += int((np.diff(p) >= 0).sum())
        nxt = np.append(p[1:] + V, w)  # the node each step leads to (a leaf: w)
        for a, bit, to in zip(p, c, nxt):
            prev = child.setdefault((int(a), int(bit)), int(to))
            faults += prev != int(to)
    # V - 1 internal nodes, each with both children, every leaf reached once
    faults += abs(len(child) - 2 * (V - 1))
    leaves = sorted(t for t in child.values() if t < V)
    faults += int(leaves != list(range(V)))
    cost = int((np.asarray(counts, np.int64) * lens).sum())
    faults += int(cost != huffman_cost(counts))
    return faults
