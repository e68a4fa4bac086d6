"""The port's fused-step kernels, plain versions against the JAX package.

On the CPU each wrapper of word2vec_tpu_torch/ops/fused_step.py takes its
plain PyTorch version (the CUDA kernels are held against those versions on
the card: tests/test_torch_cuda.py and chip_smoke.py). Here the plain
versions meet the JAX package's Pallas kernels, run through the Pallas
interpreter as tests/test_pallas_step.py runs them, on the same
numpy-seeded inputs at small shapes (V=60, d=16, B=6, L=40, W=3, S=10,
KP=8):

  * fused_grad_core: masks, n_ctx and ctx_w EXACT (0/1 sums); gradients
    within rtol 2e-5 / atol 1e-6 — the f32 reduction order differs between
    XLA's dot and torch's matmul (and the kernel's sequential sums), while
    the operand rounding to the compute dtype is the same; losses within
    rtol 1e-5 (a different grouping of the same f32 sum).
  * fused_slab_scatter: BITWISE in f32 and bf16, with heavy duplication
    and -1 padding — both apply duplicates one by one in sorted order,
    rounding to the table dtype after each add.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.ops import banded as jbanded  # noqa: E402
from word2vec_tpu.ops.pallas_step import (  # noqa: E402
    fused_grad_core as j_grad_core,
    fused_slab_scatter as j_slab_scatter,
)

from word2vec_tpu_torch.ops import banded as tbanded  # noqa: E402
from word2vec_tpu_torch.ops import fused_step as fs  # noqa: E402
from word2vec_tpu_torch.ops.launch import LAUNCHES  # noqa: E402

torch.set_num_threads(1)

V, D, B, L, W, S, KP, K = 60, 16, 6, 40, 3, 10, 8, 3
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _to_torch(x):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _grad_inputs(table_dtype):
    rng = np.random.default_rng(11)
    C, _ = jbanded._geom(L, W, S)
    emb = rng.normal(0, 0.5, size=(V, 2, D)).astype(np.float32)
    tokens = rng.integers(0, V, size=(B, L)).astype(np.int32)
    tokens[2, 30:] = -1
    tokens[4, 13:] = -1
    # a negative that collides with row 0's tokens exercises the masks
    negs = rng.integers(0, V, size=(B, KP)).astype(np.int32)
    negs[0, :3] = tokens[0, 5:8]
    tok = np.where(tokens >= 0, tokens, 0)
    pad = C * S - L
    keep = (rng.random((B, L)) < 0.8) & (tokens >= 0)
    w_eff = rng.integers(1, W + 1, size=(B, L))
    return dict(
        emb=jnp.asarray(emb).astype(JDT[table_dtype]),
        tok_c=jnp.asarray(np.pad(tok, ((0, 0), (0, pad))).reshape(B, C, S)),
        tok_k=jbanded.slab_token_ids(jnp.asarray(tokens), W, S),
        keep_c=jnp.asarray(np.pad(keep.astype(np.float32), ((0, 0), (0, pad)))
                           .reshape(B, C, S)),
        w_c=jnp.asarray(np.pad(w_eff.astype(np.float32), ((0, 0), (0, pad)))
                        .reshape(B, C, S)),
        negs=jnp.asarray(negs),
    )


NAMES = ("d_ctr", "d_ctx", "n_ctx", "ctx_w", "d_neg", "w_neg_sum", "losses")


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_grad_core_plain_matches_jax_kernel(model, cdt, table_dtype):
    inp = _grad_inputs(table_dtype)
    args = (inp["emb"], inp["tok_c"], inp["tok_k"], inp["keep_c"],
            inp["w_c"], inp["negs"])
    ref = j_grad_core(*args, jnp.float32(0.03), W=W, K=K, L=L,
                      cdt=JDT[cdt], is_cbow=model == "cbow", cbow_mean=True,
                      interpret=True)
    got = fs.fused_grad_core(*(_to_torch(a) for a in args), 0.03, W=W, K=K,
                             L=L, cdt=TDT[cdt], is_cbow=model == "cbow",
                             cbow_mean=True)
    assert all(v == 0 for v in LAUNCHES.values())  # the CPU never launches
    for name, r, g in zip(NAMES, ref, got):
        r = np.asarray(r)
        g = g.numpy()
        assert g.shape == r.shape, name
        if name in ("n_ctx", "ctx_w"):
            np.testing.assert_array_equal(g, r, err_msg=name)
        elif name == "losses":
            np.testing.assert_allclose(g, r, rtol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=2e-5, atol=1e-6, err_msg=name)
    # the regime is real: gradients and collisions are non-trivial
    assert np.abs(np.asarray(ref[0])).max() > 1e-3
    assert np.abs(np.asarray(ref[4])).max() > 1e-3


def test_grad_core_mask_matches_band_mask():
    """n_ctx is the row sum of banded.band_mask (the XLA chain's mask)."""
    inp = _grad_inputs("float32")
    keep = np.asarray(inp["keep_c"]).reshape(B, -1)[:, :L] > 0
    w = np.asarray(inp["w_c"]).reshape(B, -1)[:, :L].astype(np.int32)
    tok_k = np.asarray(inp["tok_k"])
    valid = np.zeros((B, L), bool)
    C = tok_k.shape[1]
    for c in range(C):
        for k in range(S + 2 * W):
            j = c * S + k - W
            if 0 <= j < L:
                valid[:, j] = tok_k[:, c, k] >= 0
    mask = tbanded.band_mask(torch.from_numpy(keep), torch.from_numpy(valid),
                             torch.from_numpy(w), W, S)
    got = fs.fused_grad_core(*(_to_torch(inp[k]) for k in (
        "emb", "tok_c", "tok_k", "keep_c", "w_c", "negs")), 0.03, W=W, K=K, L=L)
    np.testing.assert_array_equal(got[2].numpy(), mask.sum(-1).float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_scatter_plain_bitwise_matches_jax_kernel(dtype):
    rng = np.random.default_rng(0)
    n = 700  # heavy duplication over a 40-row slab
    idx = np.sort(rng.integers(0, 40, size=n)).astype(np.int32)
    idx[-9:] = -1  # padding rows are skipped
    emb = jnp.asarray(rng.normal(size=(40, 2, 8)).astype(np.float32)).astype(JDT[dtype])
    vals = jnp.asarray(rng.normal(size=(n, 2, 8)).astype(np.float32)).astype(JDT[dtype])
    ref = j_slab_scatter(emb, jnp.asarray(idx), vals, interpret=True)
    t_emb = _to_torch(emb)
    out = fs.fused_slab_scatter(t_emb, torch.from_numpy(idx), _to_torch(vals))
    assert out is t_emb  # in place
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plane_scatter_after_stable_sort_matches_unsorted_xla_scatter(dtype):
    """The negative-row tail: JAX's unsorted `.at[ids, 1].add` equals the
    plane scatter over the stably sorted ids, bitwise."""
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 12, size=90).astype(np.int32)
    emb = jnp.asarray(rng.normal(size=(12, 2, 8)).astype(np.float32)).astype(JDT[dtype])
    vals = jnp.asarray(rng.normal(size=(90, 8)).astype(np.float32)).astype(JDT[dtype])
    ref = emb.at[jnp.asarray(ids), 1].add(vals)
    t_ids = torch.from_numpy(ids)
    order = torch.argsort(t_ids, stable=True)
    got = fs.fused_slab_scatter(_to_torch(emb), t_ids[order].contiguous(),
                                _to_torch(vals)[order].contiguous(), plane=1)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_slab_scatter_rejects_unsorted_and_bad_shapes():
    emb = torch.zeros(5, 2, 4)
    with pytest.raises(ValueError, match="sorted"):
        fs.fused_slab_scatter(emb, torch.tensor([3, 1], dtype=torch.int32),
                              torch.ones(2, 2, 4))
    with pytest.raises(ValueError, match="plane"):
        fs.fused_slab_scatter(emb, torch.tensor([1], dtype=torch.int32),
                              torch.ones(1, 2, 4), plane=1)
