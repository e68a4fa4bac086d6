"""The plain reference against small hand cases, and against the program
on the CPU at a tiny size."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gpubench.reference import hs as ref_hs
from gpubench.reference import sgns as ref_sgns
from gpubench.gen.zipf import zipf_counts
from gpubench.reference import streams, tables


def test_sentence_rows_cut_each_sentence():
    starts, lens = streams.sentence_rows(2500, 1000, 192)
    # 1000 = 5 x 192 + 40, twice, then 500 = 2 x 192 + 116
    assert list(lens) == [192] * 5 + [40] + [192] * 5 + [40] + [192, 192, 116]
    assert list(starts[:7]) == [0, 192, 384, 576, 768, 960, 1000]
    assert starts[-1] == 2000 + 384


def test_batches_follow_the_epoch_order():
    flat = torch.arange(50, dtype=torch.int32)
    rows = streams.Rows(flat, 10, 4, 2, seed=3)
    order = streams.epoch_order(3, 0, len(rows.starts))
    b = rows.batch(0)
    for r in range(2):
        s, n = rows.starts[order[r]], rows.lens[order[r]]
        assert b[r, :n].tolist() == list(range(s, s + n))
        assert (b[r, n:] == -1).all()
    assert rows.words(0) == int(rows.lens[order[:2]].sum())
    # the last step of an epoch is padded with empty rows
    last = rows.steps_per_epoch - 1
    assert rows.batches([0, 1]).shape == (4, 4)
    assert rows.batch(last).shape == (2, 4)


def test_alpha_and_keep_probabilities():
    assert streams.alpha_at(0.025, None, 0, 5, 100) == pytest.approx(0.025)
    assert streams.alpha_at(0.025, None, 500, 5, 100) == pytest.approx(0.025 * 1e-4)
    c = np.array([1000, 10, 1])
    k = streams.keep_probs(c, 1e-3)
    tc = 1e-3 * 1011
    assert k[0] == pytest.approx((math.sqrt(1000 / tc) + 1) * tc / 1000, rel=1e-6)
    assert k[2] == 1.0


def test_sgns_step_one_pair_by_hand():
    # two positions, window 1, only position 0 trains; one pool entry
    E_in = torch.tensor([[0.1, 0.2], [0.3, -0.1], [0.0, 0.5]])
    E_out = torch.tensor([[0.2, 0.1], [-0.4, 0.3], [0.1, 0.1]])
    tokens = torch.tensor([[0, 1]], dtype=torch.int32)
    keep = torch.tensor([[True, False]])
    w_eff = torch.ones_like(tokens)
    negs = torch.tensor([[2]], dtype=torch.int32)
    a, K = 0.5, 3
    h, c, n = E_in[0].clone(), E_out[1].clone(), E_out[2].clone()
    gp = (1 - torch.sigmoid(h @ c)) * a
    w = 1 * K / 1                      # n_ctx K / KP
    gn = -torch.sigmoid(h @ n) * w * a
    loss = -F.logsigmoid(h @ c) + w * F.softplus(h @ n)
    pairs = 1 + w
    ei, eo = E_in.clone(), E_out.clone()
    ls, pr = ref_sgns.step(ei, eo, tokens, keep, w_eff, negs, a, K, 1, tau=0.0)
    assert ls == pytest.approx(float(loss), rel=1e-6) and pr == pytest.approx(pairs)
    assert torch.allclose(ei[0], E_in[0] + gp * c + gn * n, atol=1e-7)
    assert torch.allclose(eo[1], E_out[1] + gp * h, atol=1e-7)
    assert torch.allclose(eo[2], E_out[2] + gn * h, atol=1e-7)
    assert torch.equal(ei[1:], E_in[1:]) and torch.equal(eo[0], E_out[0])


def test_sgns_pool_entries_hitting_a_context_are_left_out():
    E_in = torch.randn(4, 3)
    E_out = torch.randn(4, 3)
    tokens = torch.tensor([[0, 1]], dtype=torch.int32)
    keep = torch.tensor([[True, False]])
    g = ref_sgns.step_grads(E_in, E_out, tokens, keep, torch.ones_like(tokens),
                            torch.tensor([[1, 0]], dtype=torch.int32), 0.1, 5, 1)
    assert torch.equal(g["d_neg"], torch.zeros_like(g["d_neg"]))


def test_trust_region_scales_a_row_by_its_summed_norms():
    idx = torch.tensor([0, 0, 1])
    vals = torch.tensor([[3.0, 4.0], [0.0, 5.0], [0.3, 0.4]])
    s = ref_sgns.clip_scale(2, 1.0, (idx, vals))
    assert s.tolist() == pytest.approx([0.1, 1.0])


def test_hs_step_one_pair_by_hand():
    # context word 1's path: node 1 (top tier, code 0), node 0 (tail, code 1)
    E_in = torch.tensor([[0.1, 0.2], [0.3, -0.1]])
    E_out = torch.tensor([[0.2, 0.1], [-0.4, 0.3]])
    codes = torch.tensor([[1, 0], [0, 1]], dtype=torch.int8)
    points = torch.tensor([[1, 0], [1, 0]], dtype=torch.int32)
    lens = torch.tensor([1, 2], dtype=torch.int32)
    tokens = torch.tensor([[0, 1]], dtype=torch.int32)
    keep = torch.tensor([[True, False]])
    a = 0.5
    h = E_in[0].clone()
    g1 = (1.0 - torch.sigmoid(h @ E_out[1])) * a   # node 1, label 1
    g0 = (0.0 - torch.sigmoid(h @ E_out[0])) * a   # node 0, label 0
    loss = -F.logsigmoid(h @ E_out[1]) - F.logsigmoid(-(h @ E_out[0]))
    ei, eo = E_in.clone(), E_out.clone()
    ls, pr = ref_hs.step(ei, eo, tokens, keep, torch.ones_like(tokens), codes, points,
                         lens, a, 1, top_p=1, tau=0.0)
    assert ls == pytest.approx(float(loss), rel=1e-6) and pr == 2
    assert torch.allclose(ei[0], E_in[0] + g1 * E_out[1] + g0 * E_out[0], atol=1e-7)
    assert torch.allclose(eo[1], E_out[1] + g1 * h, atol=1e-7)
    assert torch.allclose(eo[0], E_out[0] + g0 * h, atol=1e-7)


def test_hs_top_tier_clips_by_per_term_norms():
    # two centers on one context: the top node's S is the sum of the two
    # terms' norms, the tail node's the norm of their sum
    E_in = torch.tensor([[1.0, 0.0], [-1.0, 0.0], [0.0, 0.0]])
    E_out = torch.zeros(2, 2)
    codes = torch.tensor([[0, 0], [0, 0], [0, 1]], dtype=torch.int8)
    points = torch.tensor([[1, 0], [1, 0], [1, 0]], dtype=torch.int32)
    lens = torch.tensor([2, 2, 2], dtype=torch.int32)
    tokens = torch.tensor([[0, 2, 1]], dtype=torch.int32)
    keep = torch.tensor([[True, False, True]])
    g = ref_hs.step_grads(E_in, E_out, tokens, keep, torch.ones_like(tokens), codes,
                          points, lens, 1.0, 1, top_p=1)
    # both centers score word 2's nodes: node 1 label 1 (g 0.5), node 0 label 0 (g -0.5)
    assert g["top_norm"].tolist() == pytest.approx([1.0])       # 0.5 |h| + 0.5 |h|
    assert g["top_sum"].tolist() == [[0.0, 0.0]]                # 0.5 h0 + 0.5 h2, h2 = -h0
    assert g["tail_vals"].abs().sum() == 0                      # one (position, slot) sum: 0


def test_alias_gap_and_huffman_checks():
    p = np.array([0.5, 0.25, 0.25])
    accept = np.array([1.0, 0.75, 0.75], np.float32)
    alias = np.array([0, 0, 0], np.int32)
    assert tables.alias_gap(accept, alias, p) < 1e-6
    assert tables.alias_gap(np.array([1.0, 1.0, 0.5], np.float32), alias, p) > 0.1
    counts = np.array([5, 3, 2])
    # tree: root 1 -> (leaf 0, node 0), node 0 -> (leaf 1, leaf 2)
    codes = np.array([[0, 0], [1, 0], [1, 1]])
    points = np.array([[1, 0], [1, 0], [1, 0]])
    lens = np.array([1, 2, 2])
    assert tables.huffman_cost(counts) == 15
    assert tables.huffman_faults(codes, points, lens, counts) == 0
    assert tables.huffman_faults(codes, points, np.array([2, 1, 2]), counts) > 0
    bad = codes.copy()
    bad[2, 1] = 0  # two words on one leaf
    assert tables.huffman_faults(bad, points, lens, counts) > 0



def test_the_reference_tables_by_hand():
    # p = (8, 1, 1)^1 / 10: bucket 1 and 2 take 0.3 of themselves, the rest word 0
    accept, alias = tables.alias_table(np.array([8, 1, 1]), 1.0)
    assert accept.tolist() == pytest.approx([1.0, 0.3, 0.3]) and alias.tolist() == [0, 0, 0]
    # counts 5, 3, 2: merge 0 = (2, 3) -> node 0, merge 1 = (5, node 0) -> root 1
    codes, points, lens = tables.huffman_code(np.array([5, 3, 2]))
    assert lens.tolist() == [1, 2, 2]
    assert codes.tolist() == [[0, 0], [1, 1], [1, 0]]
    assert points.tolist() == [[1, 0], [1, 0], [1, 0]]


COUNTS = {
    "text8": zipf_counts(71000, 17_000_000),
    "small": zipf_counts(2000, 2_000_000),
    "ties": np.sort(np.random.default_rng(0).integers(5, 8, 500))[::-1].copy(),
    "equal": np.full(6, 4),
}


@pytest.mark.parametrize("name", list(COUNTS))
def test_the_reference_tables_are_valid(name):
    c = COUNTS[name]
    accept, alias = tables.alias_table(c, 0.75)
    assert tables.alias_gap(accept, alias, tables.unigram(c, 0.75)) < 1e-4
    if len(c) <= 2000:  # huffman_faults walks every word in Python
        assert tables.huffman_faults(*tables.huffman_code(c), c) == 0


@pytest.mark.parametrize("name", list(COUNTS))
def test_the_reference_tables_equal_the_programs_builders(name):
    from word2vec_tpu_torch.data.huffman import build_huffman
    from word2vec_tpu_torch.data.negative import build_alias_table
    from word2vec_tpu_torch.data.vocab import Vocab

    c = COUNTS[name]
    v = Vocab([f"w{i}" for i in range(len(c))], c)
    at = build_alias_table(v.unigram_probs(0.75))
    assert tables.alias_mismatch(at.accept, at.alias, tables.alias_table(c, 0.75)) == 0
    hc = build_huffman(c)
    ref = tables.huffman_code(c)
    assert tables.huffman_mismatch(hc.codes.astype(np.int8), hc.points, hc.code_len, ref) == 0


def test_a_table_that_differs_is_counted():
    c = COUNTS["small"]
    accept, alias = tables.alias_table(c, 0.75)
    low = torch.tensor(accept).to(torch.bfloat16).float().numpy()   # thresholds in bfloat16
    assert tables.alias_mismatch(low, alias, (accept, alias)) > 1000
    moved = alias.copy()
    moved[7] += 1
    assert tables.alias_mismatch(accept, moved, (accept, alias)) == 1
    codes, points, lens = ref = tables.huffman_code(c)
    flipped = codes.copy()
    flipped[3, 0] ^= 1
    assert tables.huffman_mismatch(flipped, points, lens, ref) == 1
    assert tables.huffman_mismatch(codes, points, lens + 1, ref) == len(c)
