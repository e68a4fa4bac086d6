"""The port's Huffman coding (word2vec_tpu_torch/data/huffman.py) against
the JAX package's, BITWISE: codes, points, code lengths, and the two-tier
split (msig, tail codes / points / lengths, and the coverage and tail
statistics) on Zipf, tied, uniform, two-word and random count vectors,
at every top-P from 1 past the internal-node count; the error paths."""

import numpy as np
import pytest

from word2vec_tpu.data import huffman as jh
from word2vec_tpu_torch.data import huffman as th

COUNTS = {
    "zipf64": np.maximum(1, np.round(3000.0 / np.arange(1, 65))).astype(np.int64),
    "ties": np.array([9, 9, 9, 5, 5, 5, 5, 2, 2, 1, 1, 1], np.int64),
    "uniform": np.full(17, 4, np.int64),
    "two": np.array([3, 1], np.int64),
    "random": np.sort(np.random.default_rng(1).integers(1, 500, 50))[::-1].astype(np.int64),
}


@pytest.mark.parametrize("name", list(COUNTS))
def test_codes_and_split_match_jax_bitwise(name):
    counts = COUNTS[name]
    got, want = th.build_huffman(counts), jh.build_huffman(counts)
    for f in ("codes", "points", "code_len"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (got.max_code_len, got.num_internal) == (want.max_code_len, want.num_internal)
    V = len(counts)
    for top in sorted({1, 2, 8, V - 2, V - 1, V + 5} - {0}):
        if top < 1:
            continue
        s, t = th.split_dense_tier(got, counts, top), jh.split_dense_tier(want, counts, top)
        for f in ("msig", "tail_codes", "tail_points", "tail_len"):
            a, b = getattr(s, f), getattr(t, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (top, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{top} {f}")
        for f in ("coverage", "tail_mean", "tail_var"):
            assert getattr(s, f) == getattr(t, f), (top, f)


def test_error_paths_match_jax():
    with pytest.raises(ValueError, match="at least 2 words"):
        th.build_huffman(np.array([5]))
    hc = th.build_huffman(COUNTS["ties"])
    with pytest.raises(ValueError, match="top_p must be >= 1"):
        th.split_dense_tier(hc, COUNTS["ties"], 0)
