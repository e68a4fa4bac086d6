"""The port's overlap-add (ops/overlap.py) against the JAX package's Pallas
kernel (CPU).

On the CPU the wrapper takes its plain version (the XLA chain's
pad/add/slice composition, ops/banded._overlap_add); the CUDA kernel of
csrc/overlap.cu is held against that version on the card
(tests/test_torch_cuda.py, chip_smoke.py). Here the plain version meets
`pallas_overlap.overlap_add_slabs(interpret=True)` on numpy-seeded inputs
over tests/test_pallas_overlap.py's geometries. Tolerance: BITWISE — every
output row sums the same <= 2 slab slots in both.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.ops.pallas_overlap import (  # noqa: E402
    overlap_add_slabs as j_slabs,
    overlap_add_tokens as j_tokens,
)

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.ops import band_step, banded  # noqa: E402
from word2vec_tpu_torch.ops import overlap as ov  # noqa: E402
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.launch import LAUNCHES  # noqa: E402

torch.set_num_threads(1)

GEOMETRIES = [
    (3, 40, 3, 10, 16),    # ragged: C*S = 40 exactly
    (2, 33, 5, 10, 4),     # ragged tail: C*S = 40 > L
    (1, 25, 2, 4, 8),      # S = 2W, the tightest legal slab
    (2, 192, 5, 118, 12),  # flagship chunk geometry
    (1, 300, 10, 108, 8),  # wide window
]


@pytest.mark.parametrize("B,L,W,S,d", GEOMETRIES)
def test_overlap_add_plain_bitwise_matches_jax_kernel(B, L, W, S, d):
    C, _ = banded._geom(L, W, S)
    rng = np.random.default_rng(B * 1000 + L)
    y = rng.normal(size=(B, C, S + 2 * W, d)).astype(np.float32)
    ref = np.asarray(j_slabs(jnp.asarray(y), W=W, S=S, interpret=True))
    got = ov.overlap_add_slabs(torch.from_numpy(y), W, S)
    assert got.shape == (B, C * S, d)
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_t = np.asarray(j_tokens(jnp.asarray(y), W=W, S=S, L=L, interpret=True))
    np.testing.assert_array_equal(
        ov.overlap_add_tokens(torch.from_numpy(y), W, S, L).numpy(), ref_t
    )
    assert LAUNCHES["overlap_add_slabs"] == 0  # the CPU never launches


@pytest.mark.parametrize("B,L,W,S,d", GEOMETRIES[:3])
def test_overlap_add_tokens_is_band_vs_tail(B, L, W, S, d):
    """band_vs = band_vs_slab + overlap-add: the pallas_oa fan-out equals
    the XLA chain's, bitwise."""
    C, _ = banded._geom(L, W, S)
    rng = np.random.default_rng(7)
    scores = torch.from_numpy(
        rng.normal(size=(B, C, S, S + 2 * W)).astype(np.float32))
    u = torch.from_numpy(rng.normal(size=(B, L, d)).astype(np.float32))
    ref = banded.band_vs(scores, u, W, S, torch.float32)
    got = ov.overlap_add_tokens(
        banded.band_vs_slab(scores, u, W, S, torch.float32), W, S, L)
    assert torch.equal(got, ref)


def test_overlap_add_rejects_bad_slab_geometry():
    with pytest.raises(ValueError, match="slab width"):
        ov.overlap_add_slabs(torch.zeros(1, 2, 16, 4), 3, 12)  # 12+6 != 16
    with pytest.raises(ValueError, match="slab decomposition"):
        ov.overlap_add_slabs(torch.zeros(1, 2, 11, 4), 4, 3)  # S < 2W


# --------------------------------------------------- the pallas_oa route
# one and three steps of band_backend='pallas_oa' against the JAX
# package's pallas_oa step (its overlap-add kernel in interpret mode), same
# params and draws (tests/torch_parity.py); tolerances as there: f32
# tables atol 1e-6, bf16 tables exact for sg (cbow: assert_bf16_tables_close)
OA_CASES = {
    "f32-batch-mean-clip": dict(negative_scope="batch", scatter_mean=True,
                                clip_row_update=0.0002),
    "bf16compute": dict(compute_dtype="bfloat16"),
    "bf16-sr": dict(dtype="bfloat16", stochastic_rounding=True, scatter_mean=True),
}


@pytest.mark.parametrize("case", list(OA_CASES))
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_pallas_oa_step_matches_jax(model, case, monkeypatch):
    monkeypatch.setattr(band_step, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.kw(model=model, band_backend="pallas_oa", **OA_CASES[case])
    steps = 3 if (model, case) == ("sg", "f32-batch-mean-clip") else 1
    jp, jm, tp, tm = tp_.run(kw, steps)
    tp_.assert_params_close(tp, jp, kw)
    if steps == 1:
        tp_.assert_metrics_close(tm, jm)


def test_pallas_oa_refuses_dense_rows():
    _, tt = tp_.tables()
    step = BandStep(Word2VecConfig(**tp_.kw(band_backend="pallas_oa",
                                            band_chunk=0)), tt)
    params = {"emb_in": torch.zeros(tp_.V, tp_.D),
              "emb_out_ns": torch.zeros(tp_.V, tp_.D)}
    with pytest.raises(ValueError, match="chunked band"):
        step(params, torch.zeros(2, 12, dtype=torch.int32),
             torch.Generator().manual_seed(0), 0.03)
