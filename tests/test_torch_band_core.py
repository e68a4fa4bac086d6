"""The port's band core (ops/band_core.py) against the JAX package's Pallas
kernel (CPU).

On the CPU the wrapper takes its plain version; the CUDA kernel of
csrc/band_core.cu is held against that version on the card
(tests/test_torch_cuda.py, chip_smoke.py). Here the plain version meets
`pallas_band.band_core(interpret=True)` on the same numpy-seeded inputs at
small shapes (d=16, B=6, L=40, W=3, S=10, KP=8), across sg/cbow x row/batch
negative scope x f32/bf16 compute x f32/bf16 tables:

  * n_ctx and ctx_w EXACT (0/1 sums), and so the slab zeros: d_ctx is 0
    at every slot whose token is invalid;
  * gradients within rtol 2e-5 / atol 1e-6, w_neg_sum within rtol 1e-6 —
    the f32 reduction order differs between XLA's dot and torch's matmul,
    the operand rounding to the compute dtype is the same;
  * losses within rtol 1e-5 (a different grouping of the same f32 sum).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.ops import banded as jbanded  # noqa: E402
from word2vec_tpu.ops.pallas_band import band_core as j_band_core  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.ops import band_core as bc, band_step  # noqa: E402
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.launch import LAUNCHES  # noqa: E402

torch.set_num_threads(1)

V, D, B, L, W, S, KP, K = 60, 16, 6, 40, 3, 10, 8, 3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("d_h", "d_ctx", "d_neg", "n_ctx", "ctx_w", "w_neg_sum", "losses")


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _inputs(table_dtype, scope, model):
    """The pallas route's pre-chunked inputs (band_step.py:635-663)."""
    rng = np.random.default_rng(13)
    C, P = jbanded._geom(L, W, S)
    emb_in = rng.normal(0, 0.5, size=(V, D)).astype(np.float32)
    emb_out = rng.normal(0, 0.5, size=(V, D)).astype(np.float32)
    tokens = rng.integers(0, V, size=(B, L)).astype(np.int32)
    tokens[2, 30:] = -1
    tokens[4, 13:] = -1
    nb = B if scope == "row" else 1
    negs = rng.integers(0, V, size=(nb, KP)).astype(np.int32)
    negs[0, :3] = tokens[0, 5:8]  # collisions exercise the masks
    tok = np.where(tokens >= 0, tokens, 0)
    keep = (rng.random((B, L)) < 0.8) & (tokens >= 0)
    w_eff = rng.integers(1, W + 1, size=(B, L))
    ctr, ctx = (emb_out, emb_in) if model == "cbow" else (emb_in, emb_out)
    jt = JDT[table_dtype]
    pad = C * S - L
    tok_j = jnp.asarray(tokens)
    return dict(
        a=jnp.pad(jnp.asarray(ctr).astype(jt)[tok], ((0, 0), (0, pad), (0, 0)))
        .reshape(B, C, S, D),
        bk=jbanded._slabs(jbanded._pad_ctx(jnp.asarray(ctx).astype(jt)[tok], W, P),
                          C, S, 2 * W),
        en=jnp.asarray(emb_out).astype(jt)[negs],
        tok_c=jnp.pad(tok_j, ((0, 0), (0, pad)), constant_values=-1).reshape(B, C, S),
        tok_k=jbanded.slab_token_ids(tok_j, W, S),
        keep_c=jnp.asarray(np.pad(keep.astype(np.float32), ((0, 0), (0, pad)))
                           .reshape(B, C, S)),
        w_c=jnp.asarray(np.pad(w_eff.astype(np.float32), ((0, 0), (0, pad)))
                        .reshape(B, C, S)),
        negs=jnp.asarray(negs),
    )


ORDER = ("a", "bk", "en", "tok_c", "tok_k", "keep_c", "w_c", "negs")


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("scope", ["row", "batch"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_band_core_plain_matches_jax_kernel(model, scope, cdt, table_dtype):
    inp = _inputs(table_dtype, scope, model)
    args = [inp[k] for k in ORDER]
    ref = j_band_core(*args, jnp.float32(0.03), W=W, K=K, cdt=JDT[cdt],
                      is_cbow=model == "cbow", cbow_mean=True, interpret=True)
    got = bc.band_core(*(_to_torch(a) for a in args), 0.03, W=W, K=K,
                       cdt=TDT[cdt], is_cbow=model == "cbow", cbow_mean=True)
    assert LAUNCHES["band_core"] == 0  # the CPU never launches
    for name, r, g in zip(NAMES, ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert g.shape == r.shape, name
        if name in ("n_ctx", "ctx_w"):
            np.testing.assert_array_equal(g, r, err_msg=name)
        elif name == "losses":
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=name)
        elif name == "w_neg_sum":
            np.testing.assert_allclose(g, r, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=2e-5, atol=1e-6, err_msg=name)
    # slab zeros: no gradient reaches a slot outside the row or a pad token
    invalid = np.asarray(inp["tok_k"]) < 0
    assert np.all(got[1].numpy()[invalid] == 0.0)
    # the regime is real: gradients and collisions are non-trivial
    assert np.abs(np.asarray(ref[0])).max() > 1e-3
    assert np.abs(np.asarray(ref[2])).max() > 1e-3


def test_band_core_cbow_sum_projection_matches_jax_kernel():
    """cbow_mean=False (sum projection, no double divide) is its own
    branch of both kernels."""
    inp = _inputs("float32", "row", "cbow")
    args = [inp[k] for k in ORDER]
    ref = j_band_core(*args, jnp.float32(0.03), W=W, K=K, cdt=jnp.float32,
                      is_cbow=True, cbow_mean=False, interpret=True)
    got = bc.band_core(*(_to_torch(a) for a in args), 0.03, W=W, K=K,
                       cdt=torch.float32, is_cbow=True, cbow_mean=False)
    for name, r, g in zip(NAMES, ref, got):
        if name != "losses":
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=2e-5,
                                       atol=1e-6, err_msg=name)


# ------------------------------------------------------ the pallas route
# one and three steps of band_backend='pallas' against the JAX package's
# step_pallas (its band kernel in interpret mode), same params and draws
# (tests/torch_parity.py); tolerances as there: f32 tables atol 1e-6, bf16
# tables exact for sg (cbow: assert_bf16_tables_close)
STEP_CASES = {
    "f32": dict(),
    "f32-batch-mean-clip": dict(negative_scope="batch", scatter_mean=True,
                                clip_row_update=0.0002),
    "bf16compute": dict(compute_dtype="bfloat16", scatter_mean=True),
    "bf16-sr": dict(dtype="bfloat16", stochastic_rounding=True, scatter_mean=True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_pallas_step_matches_jax(model, case, monkeypatch):
    monkeypatch.setattr(band_step, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.kw(model=model, band_backend="pallas", **STEP_CASES[case])
    jp, jm, tp, tm = tp_.run(kw, 1)
    tp_.assert_params_close(tp, jp, kw)
    tp_.assert_metrics_close(tm, jm)
    if "clip_row_update" in STEP_CASES[case]:
        assert float(jm["clip_engaged"]) > 0  # the trust region engaged


@pytest.mark.parametrize("model,case", [("sg", "f32-batch-mean-clip"),
                                        ("cbow", "bf16-sr")])
def test_pallas_three_steps_match_jax(model, case, monkeypatch):
    monkeypatch.setattr(band_step, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.kw(model=model, band_backend="pallas", **STEP_CASES[case])
    jp, _, tp, _ = tp_.run(kw, 3)
    tp_.assert_params_close(tp, jp, kw)


def test_pallas_refuses_dense_rows():
    _, tt = tp_.tables()
    step = BandStep(Word2VecConfig(**tp_.kw(band_backend="pallas",
                                            band_chunk=0)), tt)
    params = {"emb_in": torch.zeros(tp_.V, tp_.D),
              "emb_out_ns": torch.zeros(tp_.V, tp_.D)}
    with pytest.raises(ValueError, match="chunked band"):
        step(params, torch.zeros(2, 12, dtype=torch.int32),
             torch.Generator().manual_seed(0), 0.03)
