"""The traffic generators: deterministic from the seed."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.gen.zipf import sub_seed, zipf_counts, zipf_tokens
from gpubench.reference import streams


def test_zipf_counts_follow_one_over_rank():
    c = zipf_counts(1000, 1_000_000)
    assert c[0] == int(1_000_000 / sum(1.0 / r for r in range(1, 1001)))
    assert (np.diff(c) <= 0).all() and c[-1] == int(c[0] / 1000)
    assert zipf_counts(100_000, 1_000_000).min() == 5  # floored at text8's min_count


def test_zipf_tokens_repeat_from_the_seed():
    c = zipf_counts(500, 100_000)
    a = zipf_tokens(c, 20_000, 7, "cpu")
    b = zipf_tokens(c, 20_000, 7, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32
    assert not torch.equal(a, zipf_tokens(c, 20_000, 8, "cpu"))
    assert int(a.min()) >= 0 and int(a.max()) < 500
    # rank 1 about as often as its count says
    share = float((a == 0).float().mean())
    assert abs(share - c[0] / c.sum()) < 0.01


def test_sub_seeds_differ_by_stream_and_take_large_seeds():
    s = 2**31 + 12345
    assert len({sub_seed(s, k) for k in range(4)}) == 4
    assert all(0 <= sub_seed(s, k) < 2**63 for k in range(4))
    assert sub_seed(s, 1) == sub_seed(s, 1)


def test_step_draws_repeat_and_depend_on_the_step():
    a = streams.draws("cpu", 2**33 + 5, 3, 4, 16, 5, 100, 8)
    b = streams.draws("cpu", 2**33 + 5, 3, 4, 16, 5, 100, 8)
    c = streams.draws("cpu", 2**33 + 5, 4, 4, 16, 5, 100, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert int(a[1].min()) >= 1 and int(a[1].max()) <= 5

