"""The port's band helpers (ops/banded.py) against the JAX package's (CPU).

Same numpy-seeded inputs through both, in the dense (S == 0) and chunked
representations, at L=40, W=3 (chunked at S=10, dense at S=0):

  * geometry, masks and every sum of 0/1 operands (band_row_sum,
    band_col_sum, band_col_sum_slab, band_loss_sum of the mask, the
    collision contraction band_sv(mask, hits)) EXACT;
  * contractions of real values (band_qk, band_sv, band_vs, band_vs_slab)
    within rtol 2e-5 / atol 1e-6 — both round the operands to the compute
    dtype and accumulate in f32, in another order.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.ops import banded as jb  # noqa: E402

from word2vec_tpu_torch.ops import banded as tb  # noqa: E402

torch.set_num_threads(1)

B, L, W, D = 3, 40, 3, 8
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs():
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, 30, size=(B, L)).astype(np.int32)
    tokens[1, 31:] = -1
    valid = tokens >= 0
    keep = valid & (rng.random((B, L)) < 0.8)
    w_eff = rng.integers(1, W + 1, size=(B, L)).astype(np.int32)
    a = rng.normal(size=(B, L, D)).astype(np.float32)
    b = rng.normal(size=(B, L, D)).astype(np.float32)
    hits = (rng.random((B, L, 5)) < 0.3).astype(np.float32)
    return tokens, valid, keep, w_eff, a, b, hits


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("S", [0, 10, 6])
def test_geometry_and_masks_exact(S):
    tokens, valid, keep, w_eff, *_ = _inputs()
    np.testing.assert_array_equal(tb.band_dist(L, W, S), jb.band_dist(L, W, S))
    ref = np.asarray(jb.band_mask(jnp.asarray(keep), jnp.asarray(valid),
                                  jnp.asarray(w_eff), W, S))
    got = tb.band_mask(_t(keep), _t(valid), _t(w_eff), W, S)
    np.testing.assert_array_equal(got.numpy(), ref)
    f = got.float()
    jf = jnp.asarray(ref).astype(jnp.float32)
    np.testing.assert_array_equal(tb.band_row_sum(f, L).numpy(),
                                  np.asarray(jb.band_row_sum(jf, L)))
    np.testing.assert_array_equal(tb.band_col_sum(f, L, W, S).numpy(),
                                  np.asarray(jb.band_col_sum(jf, L, W, S)))
    assert float(tb.band_loss_sum(f)) == float(jb.band_loss_sum(jf))
    if S:
        np.testing.assert_array_equal(tb.band_col_sum_slab(f).numpy(),
                                      np.asarray(jb.band_col_sum_slab(jf)))
        np.testing.assert_array_equal(
            tb.slab_token_ids(_t(tokens), W, S).numpy(),
            np.asarray(jb.slab_token_ids(jnp.asarray(tokens), W, S)))
        C, P = tb._geom(L, W, S)
        x = np.arange(B * L * 2, dtype=np.float32).reshape(B, L, 2)
        np.testing.assert_array_equal(tb._pad_rows(_t(x), C * S).numpy(),
                                      np.asarray(jb._pad_rows(jnp.asarray(x), C * S)))
        np.testing.assert_array_equal(tb._pad_ctx(_t(x), W, P).numpy(),
                                      np.asarray(jb._pad_ctx(jnp.asarray(x), W, P)))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [0, 10])
def test_contractions_match(S, cdt):
    tokens, valid, keep, w_eff, a, b, hits = _inputs()
    jc, tc = JDT[cdt], TDT[cdt]
    mask = np.asarray(jb.band_mask(jnp.asarray(keep), jnp.asarray(valid),
                                   jnp.asarray(w_eff), W, S)).astype(np.float32)
    ja, jbv, jm = jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)
    ta, tbv, tm = _t(a), _t(b), _t(mask)
    plog = jb.band_qk(ja, jbv, W, S, jc)
    _close(tb.band_qk(ta, tbv, W, S, tc), plog)
    scores = np.asarray(plog) * mask  # a real-valued band plane
    js, ts = jnp.asarray(scores), _t(scores)
    _close(tb.band_sv(ts, tbv, W, S, tc), jb.band_sv(js, jbv, W, S, jc))
    _close(tb.band_vs(ts, ta, W, S, tc), jb.band_vs(js, ja, W, S, jc))
    if S:
        _close(tb.band_vs_slab(ts, ta, W, S, tc), jb.band_vs_slab(js, ja, W, S, jc))
    else:
        with pytest.raises(ValueError, match="chunked"):
            tb.band_vs_slab(ts, ta, W, S, tc)
    # the collision contraction: 0/1 operands, exact in any order and dtype
    np.testing.assert_array_equal(
        tb.band_sv(tm, _t(hits), W, S, tc).numpy(),
        np.asarray(jb.band_sv(jm, jnp.asarray(hits), W, S, jc)),
    )


def test_cdot_rounds_operands_and_accumulates_in_f32():
    """bf16 operands, f32 products and sums: 1 + 2^-8 rounds to 1 in bf16,
    and the f32 sum keeps a term a bf16 accumulator would drop."""
    x = torch.tensor([[1.0 + 2.0 ** -8, 1.0]])
    y = torch.tensor([[1.0], [2.0 ** -9]])
    got = tb.cdot("ij,jk->ik", x, y, torch.bfloat16)
    assert got.dtype == torch.float32
    assert float(got) == 1.0 + 2.0 ** -9
