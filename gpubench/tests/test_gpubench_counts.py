"""The yardstick's arithmetic against hand counts at small shapes."""

from __future__ import annotations

import pytest
import torch

from gpubench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS, bound_s
from gpubench.counts.trace import digest, union
from gpubench.counts.work import hs_counts, sgns_counts


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bound_s(HBM_BYTES_PER_S, 0, "float32") == pytest.approx(1.0)
    assert bound_s(0, PEAK_FLOPS["bfloat16"], "bfloat16") == pytest.approx(1.0)
    assert bound_s(HBM_BYTES_PER_S, 2 * PEAK_FLOPS["float32"], "float32") == pytest.approx(2.0)


def test_union_counts_overlap_once():
    busy, merged = union([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)])
    assert busy == pytest.approx(4.0) and merged == [(0.0, 3.0), (5.0, 6.0)]


def test_digest_names_gaps_by_the_innermost_host_op():
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 2.5), ("k1", 4.0, 5.0)]
    host = [("outer", 0.0, 10.0), ("inner", 2.4, 3.5)]
    d = digest(dev, host, (0.0, 6.0))
    assert d["busy_s"] == pytest.approx(2.5) and d["window_s"] == pytest.approx(6.0)
    assert d["ops"] == {"k1": pytest.approx(2.0), "k2": pytest.approx(1.0)}
    assert d["calls"] == {"k1": 2, "k2": 1}
    # gaps: [0, 1] under outer, [2.5, 4] under inner, [5, 6] under outer
    assert d["gaps"]["inner"] == pytest.approx(1.5)
    assert d["gaps"]["outer"] == pytest.approx(2.0)


def one_row():
    # one row of 6 tokens, window 1, every center kept, all window draws 1
    tokens = torch.tensor([[3, 4, 3, 5, -1, -1]], dtype=torch.int32)
    keep = tokens >= 0
    w_eff = torch.ones_like(tokens)
    return tokens, keep, w_eff


def test_sgns_counts_by_hand():
    tokens, keep, w_eff = one_row()
    negs = torch.tensor([[7, 3]], dtype=torch.int32)
    d, K = 4, 5
    c = sgns_counts(tokens, keep, w_eff, negs, d, K, 1, V=10, B=1)
    # pairs: (0,1) (1,0) (1,2) (2,1) (2,3) (3,2)
    assert c["pairs"] == 6
    assert c["model_flops"] == 6 * d * (1 + K) * 6
    n_c, n_x, pool = 4, 4, 2           # centers 0..3, contexts 0..3, one pool of 2
    u_ctr, u_ctx, u_neg, u_out = 3, 3, 2, 4   # {3,4,5}, {3,4,5}, {7,3}, {3,4,5,7}
    assert c["core_flops"] == 2 * d * (3 * n_c * 2 + 3 * 6)
    # updates of 4 centers, 4 contexts and one pool of 2, each d + 1 floats
    assert c["core_bytes"] == ((u_ctr + u_ctx + u_neg) * d * 4 + 6 * 6 + 2 * 4
                               + 4 * ((d + 1) * (n_c + n_x + pool) + 2))
    assert c["scatter_bytes"] == 4 * (d + 1) * (n_c + n_x + pool) + 2 * d * 4 * (u_ctr + u_out)
    assert c["scatter_flops"] == d * (n_c + n_x + pool)


def test_sgns_counts_sum_over_steps():
    tokens, keep, w_eff = one_row()
    negs = torch.tensor([[7, 3]], dtype=torch.int32)
    one = sgns_counts(tokens, keep, w_eff, negs, 4, 5, 1, V=10, B=1)
    two = sgns_counts(tokens.repeat(2, 1), keep.repeat(2, 1), w_eff.repeat(2, 1),
                      negs.repeat(2, 1), 4, 5, 1, V=10, B=1)
    assert all(two[k] == 2 * one[k] for k in one)


def test_hs_counts_by_hand():
    tokens, keep, w_eff = one_row()
    # words 3, 4, 5 with paths of 2, 3, 1 nodes; nodes >= 8 are the top tier
    lens = torch.zeros(10, dtype=torch.int32)
    lens[3], lens[4], lens[5] = 2, 3, 1
    points = torch.zeros(10, 3, dtype=torch.int32)
    points[3, :2] = torch.tensor([8, 2])
    points[4, :3] = torch.tensor([8, 6, 1])
    points[5, :1] = torch.tensor([8])
    d = 4
    c = hs_counts(tokens, keep, w_eff, lens, points, d, 1, top_p=1, B=1)
    # contexts of the 6 pairs: 4, 3, 3, 4, 5, 3 -> terms 3+2+2+3+1+2
    assert c["pairs"] == 6 and c["terms"] == 13
    assert c["model_flops"] == 6 * d * 13
    # tail slots touched: positions 0 (word 3: node 2), 1 (4: 6, 1), 2 (3: 2); 3 (5) none
    n_tail, u_tail, n_c, u_ctr = 4, 3, 4, 3
    assert c["scatter_bytes"] == 4 * (d + 1) * (n_c + n_tail) + 2 * d * 4 * (u_ctr + u_tail)
    assert c["scatter_flops"] == d * (n_c + n_tail)

