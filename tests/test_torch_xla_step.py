"""The port's band step on its default route (band_backend='xla') against
the JAX package's XLA chain (CPU), the ordered row sum, the layouts and
the default-config Trainer.

Harness and draws: tests/torch_parity.py. Tolerances: f32 tables within
atol 1e-6 after one and three steps (the f32 reduction order of the
contractions differs between XLA and torch); bf16 tables, ± stochastic
rounding, exact for sg, and for cbow equal but for at most 0.5% of the
cells one bf16 ulp apart (torch_parity.assert_bf16_tables_close says why);
metrics within rtol 1e-5, the clip count exact. The
ordered row sum is BITWISE the JAX helpers' `.at[idx].add` chains, and
the port's split and unified layouts give BITWISE the same trajectory.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.ops import train_step as jts  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import (  # noqa: E402
    PackedCorpus, Trainer, Vocab, Word2VecConfig, export_matrix,
)
from word2vec_tpu_torch.models.params import (  # noqa: E402
    FUSED_KEY, init_params, params_from_numpy, params_to_numpy, unfuse_tables,
)
from word2vec_tpu_torch.ops import band_step  # noqa: E402
from word2vec_tpu_torch.ops import train_step as tts  # noqa: E402
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.launch import LAUNCHES  # noqa: E402

torch.set_num_threads(1)

CASES = {
    "f32": dict(),
    "f32-mean-clip": dict(scatter_mean=True, clip_row_update=0.0002),
    "f32-batch-mean": dict(negative_scope="batch", scatter_mean=True),
    "bf16compute": dict(compute_dtype="bfloat16", scatter_mean=True),
    "bf16": dict(dtype="bfloat16", scatter_mean=True),
    "bf16-sr": dict(dtype="bfloat16", scatter_mean=True, stochastic_rounding=True),
    "dense": dict(band_chunk=0, scatter_mean=True, clip_row_update=0.0002),
    "slab": dict(slab_scatter=True, scatter_mean=True, clip_row_update=0.0002),
    "slab-bf16-sr-batch": dict(slab_scatter=True, dtype="bfloat16",
                               stochastic_rounding=True, negative_scope="batch"),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_one_step_matches_jax_xla_step(model, case, monkeypatch):
    monkeypatch.setattr(band_step, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.kw(model=model, **CASES[case])
    jp, jm, tp, tm = tp_.run(kw, 1)
    tp_.assert_params_close(tp, jp, kw)
    tp_.assert_metrics_close(tm, jm)
    if "clip_row_update" in CASES[case]:
        assert float(jm["clip_engaged"]) > 0  # the trust region engaged
    assert all(v == 0 for v in LAUNCHES.values())  # the CPU never launches


@pytest.mark.parametrize(
    "model,case",
    [("sg", "f32-mean-clip"), ("cbow", "bf16-sr"), ("sg", "slab")],
)
def test_three_steps_match_jax_xla_step(model, case, monkeypatch):
    monkeypatch.setattr(band_step, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.kw(model=model, **CASES[case])
    jp, _, tp, _ = tp_.run(kw, 3)
    tp_.assert_params_close(tp, jp, kw)


@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_unified_layout_matches_jax_fused_branch(model, monkeypatch):
    """table_layout='unified' on the xla route is the JAX step's
    fused=True branch (band_step.py:305-309, 519-554)."""
    monkeypatch.setattr(band_step, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.kw(model=model, table_layout="unified", dtype="bfloat16",
                stochastic_rounding=True, scatter_mean=True)
    jp, jm, tp, tm = tp_.run(kw, 1)
    tp_.assert_params_close(tp, jp, kw)
    tp_.assert_metrics_close(tm, jm)


@pytest.mark.parametrize(
    "case",
    [dict(negative_scope="batch", scatter_mean=True, clip_row_update=0.0002),
     dict(dtype="bfloat16", stochastic_rounding=True, scatter_mean=True),
     dict(compute_dtype="bfloat16", clip_row_update=0.0002)],
    ids=["f32-batch-mean-clip", "bf16-sr", "bf16compute-clip"],
)
@pytest.mark.parametrize("backend", ["xla", "pallas_oa"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_split_and_unified_layouts_bitwise(model, backend, case):
    """Two steps of the port on split tables and on the unified slab, same
    draws: bitwise equal (one gather, one doubled-width scatter; the same
    per-element arithmetic)."""
    _, tt = tp_.tables()
    toks = torch.from_numpy(tp_.tokens())
    out = {}
    for layout in ("split", "unified"):
        cfg = Word2VecConfig(**tp_.kw(model=model, band_backend=backend,
                                      table_layout=layout, **case))
        params = init_params(cfg, tp_.V, torch.Generator().manual_seed(3))
        step = BandStep(cfg, tt)
        gen = torch.Generator().manual_seed(5)
        metrics = [step(params, toks, gen, 0.03 - 0.01 * i) for i in range(2)]
        out[layout] = (params, metrics)
    split, unified = out["split"][0], unfuse_tables(out["unified"][0])
    for k in ("emb_in", "emb_out_ns"):
        assert torch.equal(split[k], unified[k]), k
    for ms, mu in zip(out["split"][1], out["unified"][1]):
        for k in ms:
            assert torch.equal(ms[k], mu[k]), k


# ------------------------------------------------------------ ordered sums
def test_ordered_row_sum_plain_bitwise_matches_xla_scatter_chain():
    """zeros(V).at[i1].add(v1).at[i2].add(v2): a sorted and an unsorted
    contribution of values spanning eight decades, so the order of each
    row's adds shows in the last bits."""
    rng = np.random.default_rng(0)
    n1, n2, nv = 3000, 700, 40
    i1 = np.sort(rng.integers(0, nv, size=n1)).astype(np.int32)
    i2 = rng.integers(0, nv, size=n2).astype(np.int32)
    v1 = (rng.normal(size=n1) * 10.0 ** rng.uniform(-4, 4, size=n1)).astype(np.float32)
    v2 = (rng.normal(size=n2) * 10.0 ** rng.uniform(-4, 4, size=n2)).astype(np.float32)
    ref = np.asarray(jnp.zeros(nv, jnp.float32).at[jnp.asarray(i1)].add(jnp.asarray(v1))
                     .at[jnp.asarray(i2)].add(jnp.asarray(v2)))
    got = tts.ordered_row_sum(nv, torch.from_numpy(i1), torch.from_numpy(v1),
                              presorted=True)
    got = tts.ordered_row_sum(nv, torch.from_numpy(i2), torch.from_numpy(v2), got)
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    # the plain version is the rank-pass form of the same sequential sum
    o = np.argsort(i2, kind="stable")
    again = tts.ordered_row_sum_plain(
        nv, torch.from_numpy(i2[o]), torch.from_numpy(v2[o]),
        tts.ordered_row_sum_plain(nv, torch.from_numpy(i1), torch.from_numpy(v1)))
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    with pytest.raises(ValueError, match="sorted"):
        tts.ordered_row_sum_plain(nv, torch.from_numpy(i2), torch.from_numpy(v2))


def test_row_helpers_bitwise_match_jax_helpers():
    """_dup_mean_scale and _row_clip_scale through ordered_row_sum: the
    same per-contribution values give bitwise the JAX helpers' results."""
    rng = np.random.default_rng(1)
    nv = 30
    idx = rng.integers(0, nv, size=400).astype(np.int32)
    w = rng.uniform(0, 3, size=400).astype(np.float32)
    np.testing.assert_array_equal(
        tts._dup_mean_scale(nv, torch.from_numpy(idx), torch.from_numpy(w)).numpy(),
        np.asarray(jts._dup_mean_scale(nv, jnp.asarray(idx), jnp.asarray(w))),
    )
    # one-column values: the norm is |v| in both packages, exactly
    v1 = rng.normal(size=(400, 1)).astype(np.float32)
    i2 = np.sort(rng.integers(0, nv, size=90)).astype(np.int32)
    v2 = rng.normal(size=(90, 1)).astype(np.float32)
    got = tts._row_clip_scale(nv, 2.0, (torch.from_numpy(idx), torch.from_numpy(v1)),
                              (torch.from_numpy(i2), torch.from_numpy(v2)))
    ref = jts._row_clip_scale(nv, 2.0, (jnp.asarray(idx), jnp.asarray(v1)),
                              (jnp.asarray(i2), jnp.asarray(v2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(got.min()) < 1.0  # some rows clipped


# ------------------------------------------------------------------ layout
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_split_params_round_trip_bit_for_bit(dtype):
    from word2vec_tpu.config import Word2VecConfig as JConfig
    from word2vec_tpu.models.params import init_params as j_init

    jcfg = JConfig(**tp_.kw(dtype=dtype))
    jp = j_init(jcfg, tp_.V, jax.random.key(2))
    jp = {k: v + jnp.asarray(0.37, v.dtype) for k, v in jp.items()}  # no zeros
    t = params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                          Word2VecConfig(**tp_.kw(dtype=dtype)), "cpu")
    assert sorted(t) == ["emb_in", "emb_out_ns"]
    back = params_to_numpy(t)
    for k, v in jp.items():
        ref = np.asarray(v.astype(jnp.float32))
        assert t[k].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(back[k].view(np.int32), ref.view(np.int32))


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize(
    "over,lever",
    [
        (dict(kernel="pair"), "kernel='pair'"),
        (dict(train_method="hs", negative=0, kernel="band"), "hierarchical softmax"),
        (dict(fused_tables=True), "fused_tables"),
    ],
)
def test_unported_routes_raise(over, lever):
    _, tt = tp_.tables()
    with pytest.raises(NotImplementedError) as e:
        BandStep(Word2VecConfig(**tp_.kw(**over)), tt)
    assert lever in str(e.value)


def test_default_config_is_the_xla_route_on_split_tables():
    cfg = Word2VecConfig()
    assert (cfg.band_backend, cfg.table_layout) == ("xla", "split")
    _, tt = tp_.tables()
    step = BandStep(Word2VecConfig(**tp_.kw()), tt)
    assert (step.route, step.unified) == ("xla", False)


def test_planted_corpus_trainer_recovers_structure_on_default_route():
    """The verify recipe's planted corpus ({a,b} share contexts {x,y};
    {c,d} share {p,q}) through the port's Trainer on the CPU with the
    DEFAULT band_backend and table_layout: the loss falls and the
    structure is recovered as in the JAX run."""
    rng = np.random.default_rng(0)
    sents = []
    for _ in range(1000):
        w1 = rng.choice(["a", "b"])
        w2 = rng.choice(["c", "d"])
        sents.append(["x", w1, "y", "x", w1, "y"])
        sents.append(["p", w2, "q", "p", w2, "q"])
    cfg = Word2VecConfig(
        model="sg", train_method="ns", negative=5, word_dim=32, window=2,
        min_count=1, subsample_threshold=0, iters=3, batch_rows=32,
        max_sentence_len=16, init_alpha=0.05, scatter_mean=True,
        kernel="band", shared_negatives=8,
    )
    assert (cfg.band_backend, cfg.table_layout) == ("xla", "split")
    vocab = Vocab.build(sents, min_count=1)
    corpus = PackedCorpus.pack(vocab.encode_corpus(sents), cfg.max_sentence_len)
    state, report = Trainer(cfg, vocab, corpus, device="cpu").train(log_every=20)
    assert report.total_words == 3 * corpus.num_tokens
    hist = report.loss_history
    assert np.all(np.isfinite(hist)) and hist[-1] < hist[0] - 0.2
    W = export_matrix(state.params, cfg).float()

    def cos(u, v):
        x, y = W[vocab[u]], W[vocab[v]]
        return float(x @ y / (x.norm() * y.norm()))

    assert cos("a", "b") > 0.9
    assert cos("a", "c") < 0.3
    assert FUSED_KEY not in state.params
