"""Shared harness of the step parity tests (tests/test_torch_*.py): one
config through the JAX package's band step and the port's BandStep on the
same params, tokens and draws.

The JAX side is `make_band_train_step(cfg, tables, fused=unified)`, its
Pallas kernels run through the interpreter on the CPU. Its draws are
reproduced with the same jax.random calls it makes (ops/band_step.py:
257-268 and 612-619, the alias draw of ops/train_step.py:41-49, the SR
streams of _sr_streams) and handed to the port's `BandStep.apply` as
`Draws`, so both packages see the same randomness.

`jax_grid_cast` removes one reference artefact for the bf16+SR cases: XLA's
CPU exp2 is not exact at integer arguments (ROADMAP Queue C1), so the JAX
step's SR grid sits slightly off a power of two while torch.exp2 is exact;
the tests hand the port the reference's grid.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from word2vec_tpu.config import Word2VecConfig as JConfig
from word2vec_tpu.data.negative import build_alias_table
from word2vec_tpu.models.params import init_params as j_init
from word2vec_tpu.ops.band_step import make_band_train_step as j_step
from word2vec_tpu.ops.tables import DeviceTables as JTables
from word2vec_tpu.ops.train_step import _sr_streams

from word2vec_tpu_torch import Word2VecConfig
from word2vec_tpu_torch.models.params import params_from_numpy
from word2vec_tpu_torch.ops.band_step import BandStep
from word2vec_tpu_torch.ops.train_step import Draws
from word2vec_tpu_torch.ops.tables import DeviceTables as TTables

V, D, B, L = 60, 16, 6, 40


def kw(**over):
    """Step config kwargs at the small test shape (split tables, 'xla')."""
    base = dict(
        model="sg", train_method="ns", negative=3, word_dim=D, window=3,
        min_count=1, compute_dtype="float32", shared_negatives=8,
        max_sentence_len=L, band_chunk=10,
    )
    base.update(over)
    return base


def tables():
    rng = np.random.default_rng(2)
    counts = np.arange(2 * V, V, -1).astype(np.float64)
    at = build_alias_table(counts ** 0.75 / np.sum(counts ** 0.75))
    keep = rng.uniform(0.4, 1.0, size=V).astype(np.float32)  # subsampling on
    j = JTables(jnp.asarray(keep), jnp.asarray(at.accept),
                jnp.asarray(at.alias), None, None, None)
    t = TTables(torch.from_numpy(keep), torch.from_numpy(at.accept),
                torch.from_numpy(at.alias))
    return j, t


def tokens():
    rng = np.random.default_rng(4)
    toks = rng.integers(0, V, size=(B, L)).astype(np.int32)
    toks[2, 30:] = -1
    return toks


def jax_draws(step: BandStep, key, jt) -> Draws:
    """The JAX step's draws for `key`, as the port's Draws."""
    cfg = step.config
    W, KP = cfg.window, cfg.shared_negatives
    k_sub, k_win, k_neg = jax.random.split(key, 3)
    u_sub = jax.random.uniform(k_sub, (B, L))
    w_eff = W - jax.random.randint(k_win, (B, L), 0, W, dtype=jnp.int32)
    shape = (B, KP) if cfg.negative_scope == "row" else (KP,)
    k_bucket, k_coin = jax.random.split(k_neg)
    j = jax.random.randint(k_bucket, shape, 0, V, dtype=jnp.int32)
    u = jax.random.uniform(k_coin, shape)
    negs = jnp.where(u < jt.alias_accept[j], j, jt.alias_idx[j])
    sr = None
    if cfg.stochastic_rounding:
        k_sr = _sr_streams(key, True)
        sr = tuple(
            torch.from_numpy(np.array(jax.random.uniform(k_sr(i), (n, D))))
            for i, n in enumerate(step.sr_rows(B, L))
        )
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Draws(t(u_sub), t(w_eff), t(negs).to(torch.int32), sr)


def jax_grid_cast(vals, dtype, u=None, dest=None):
    """The port's _cast_update with the SR grid ulp(dest) taken from
    jnp.exp2, as the JAX step computes it on the CPU."""
    if u is None or dtype != torch.bfloat16:
        return vals.to(dtype)
    w = jnp.asarray(np.abs(dest.float().numpy()))
    ulp = torch.from_numpy(np.array(
        jnp.exp2(jnp.floor(jnp.log2(jnp.maximum(w, 1e-7))) - 7.0)
    ))
    q = vals.float() / ulp
    qf = torch.floor(q)
    return ((qf + (u < q - qf).float()) * ulp).to(torch.bfloat16)


# compiled JAX steps by config: the three-step cases reuse the one-step
# cases' compilations when the file runs on one worker
_JAX_STEPS = {}


def jax_step(cfg_kw):
    key = tuple(sorted(cfg_kw.items()))
    if key not in _JAX_STEPS:
        jcfg = JConfig(**cfg_kw)
        jt, tt = tables()
        fused = jcfg.table_layout == "unified"
        _JAX_STEPS[key] = (jcfg, jt, tt, jax.jit(j_step(jcfg, jt, fused=fused)))
    return _JAX_STEPS[key]


def torch_params(jp, cfg):
    return params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, cfg, "cpu")


def run(cfg_kw, steps):
    """`steps` steps of both packages from the same JAX-initialized params.
    Returns (jax params, jax metrics, port params, port metrics)."""
    jcfg, jt, tt, jfn = jax_step(cfg_kw)
    tcfg = Word2VecConfig(**cfg_kw)
    jp = j_init(jcfg, V, jax.random.key(1))
    tp = torch_params(jp, tcfg)
    start = {k: v.clone() for k, v in tp.items()}
    toks = tokens()
    tfn = BandStep(tcfg, tt)
    for i in range(steps):
        key = jax.random.fold_in(jax.random.key(7), i)
        alpha = 0.03 - 0.002 * i
        jp, jm = jfn(jp, jnp.asarray(toks), key, jnp.float32(alpha))
        tm = tfn.apply(tp, torch.from_numpy(toks), jax_draws(tfn, key, jt), alpha)
    assert any(not torch.equal(tp[k], start[k]) for k in tp)  # tables moved
    return jp, jm, tp, tm


def assert_bf16_tables_close(got, ref, name=""):
    """cbow's bf16 tables: every cell equal, except at most 0.5% of the
    cells (and at least 2 allowed) that may sit one bf16 ulp apart. The
    port's band_sv contraction sums its terms in another order than XLA's
    dot (the last f32 bit of some cbow projections differs), and such a bit
    can flip the bf16 rounding of an update that lands near a rounding
    boundary; with a zero-initialized table the SR grid is 2^-31 and a flip
    is likelier (ROADMAP Queue C3)."""
    diff = got != ref
    n = int(diff.sum())
    assert n <= max(2, int(0.005 * got.size)), (name, n, got.size)
    if n:
        mag = np.maximum(np.abs(got[diff]), np.abs(ref[diff]))
        ulp = np.exp2(np.floor(np.log2(mag)) - 7.0)
        assert np.all(np.abs(got[diff] - ref[diff]) <= ulp), name


def assert_params_close(tp, jp, cfg_kw):
    """f32 tables within atol 1e-6; bf16 tables exact for sg and per
    assert_bf16_tables_close for cbow."""
    assert sorted(tp) == sorted(jp)
    for k in tp:
        got = tp[k].float().numpy()
        ref = np.asarray(jp[k], np.float32)
        if cfg_kw.get("dtype", "float32") == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=k)
        elif cfg_kw.get("model", "sg") == "sg":
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            assert_bf16_tables_close(got, ref, k)


def assert_metrics_close(tm, jm):
    np.testing.assert_allclose(float(tm["pairs"]), float(jm["pairs"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-5)
    assert float(tm["clip_engaged"]) == float(jm["clip_engaged"])


# ------------------------------------------------- trainer-level harness
# (tests/test_torch_{chunk,resident,resume}.py): every single-device route
# of the port, by (band_backend, table_layout)
ROUTES = [("xla", "split"), ("xla", "unified"), ("pallas_oa", "split"),
          ("pallas", "split"), ("pallas_fused", "unified")]
ROUTE_IDS = ["-".join(r) for r in ROUTES]


def small_corpus(n_tokens=1500):
    """A Zipf corpus of 37-token sentences, packed at L=24 (two rows a
    sentence, the second one ragged)."""
    from word2vec_tpu_torch import PackedCorpus
    from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab

    vocab = zipf_vocab(50, 5000)
    ids = zipf_corpus_ids(vocab, n_tokens, seed=3, sentence_len=37)
    return vocab, PackedCorpus.pack(ids, 24)


#: the other step routes (ops/steps.make_step) as trainer_cfg
#: overrides: the positional hs step (one tier, two tiers with a tail
#: bound that overflows) and the pair step on ns and on hs
STEP_ROUTES = {
    "hs-sg": dict(train_method="hs", negative=0),
    "hs-cbow-2tier-overflow": dict(train_method="hs", negative=0, model="cbow",
                                   hs_dense_top=8, hs_tail_slots=3),
    "pair-ns": dict(kernel="pair"),
    "pair-hs-micro2": dict(kernel="pair", train_method="hs", negative=0,
                           micro_steps=2),
}


def trainer_cfg(route=("xla", "split"), **over):
    """A Trainer config at the small shape (B=4 x L=24, band_chunk 8) on
    one route."""
    backend, layout = route
    base = dict(
        model="sg", train_method="ns", negative=3, word_dim=16, window=3,
        min_count=1, subsample_threshold=1e-3, iters=1, batch_rows=4,
        max_sentence_len=24, band_chunk=8, shared_negatives=8, seed=11,
        band_backend=backend, table_layout=layout,
    )
    base.update(over)
    return Word2VecConfig(**base)


def assert_params_bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        w = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(x.view(w), y.view(w)), k


# ------------------------------------------- hs and pair step harness
# (tests/test_torch_{hs_step,pair_step,huffman}.py): a Zipf vocabulary of
# HV words whose Huffman tree both packages build from the same counts,
# tokens [HB, HL] drawn from it, and the JAX step's draws for any step of
# the router (ops/steps.make_step)
HV, HD, HB, HL = 60, 16, 4, 24


def hs_counts():
    return np.maximum(1, np.round(3000.0 / np.arange(1, HV + 1))).astype(np.int64)


def hs_vocabs():
    """(JAX Vocab, port Vocab) over the same words and counts."""
    from word2vec_tpu.data.vocab import Vocab as JVocab
    from word2vec_tpu_torch.data.vocab import Vocab as TVocab

    words = [f"w{i}" for i in range(HV)]
    return JVocab(words, hs_counts()), TVocab(words, hs_counts())


def hs_kw(**over):
    """Step config kwargs of the hs / pair cases (one-tier sg hs)."""
    base = dict(
        model="sg", train_method="hs", negative=0, word_dim=HD, window=3,
        min_count=1, compute_dtype="float32", max_sentence_len=HL,
        subsample_threshold=1e-2,
    )
    base.update(over)
    return base


def hs_tokens(seed=4):
    counts = hs_counts()
    rng = np.random.default_rng(seed)
    toks = rng.choice(HV, size=(HB, HL), p=counts / counts.sum()).astype(np.int32)
    toks[2, 18:] = -1
    return toks


def any_draws(step, key, jt, B, L) -> Draws:
    """The JAX step's draws for `key` and [B, L] tokens, for a BandStep,
    HsStep or PairStep (or one instrumented with the health counters):
    the subsample uniforms and w_eff of split(key, 3) (every JAX step),
    the band step's shared negatives and the pair step's per-pair
    negatives from the third key (their _draw_negatives), and the SR
    uniforms of each site (jax.random.uniform(k_sr(i), [n, d]), None for a
    site of 0 rows; d the step's width, d/tp for a tensor-parallel
    shard's step). [B, L] may be a sequence shard's haloed tokens."""
    from word2vec_tpu.ops.train_step import _draw_negatives as j_negs
    from word2vec_tpu_torch.ops.pair_step import PairStep

    cfg = step.config
    step = getattr(step, "base", step)  # an instrumented step's route
    W = cfg.window
    k_sub, k_win, k_neg = jax.random.split(key, 3)
    u_sub = jax.random.uniform(k_sub, (B, L))
    w_eff = W - jax.random.randint(k_win, (B, L), 0, W, dtype=jnp.int32)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    negs = None
    if isinstance(step, BandStep):
        KP = cfg.shared_negatives
        shape = (B, KP) if cfg.negative_scope == "row" else (KP,)
        negs = t(j_negs(k_neg, shape, jt.alias_accept, jt.alias_idx)).to(torch.int32)
    elif isinstance(step, PairStep) and cfg.use_ns:
        negs = t(j_negs(k_neg, (step.pairs(B, L), cfg.negative),
                        jt.alias_accept, jt.alias_idx)).to(torch.int32)
    sr = None
    if cfg.stochastic_rounding:
        k_sr = _sr_streams(key, True)
        sr = tuple(
            t(jax.random.uniform(k_sr(i), (n, step.dim))) if n else None
            for i, n in enumerate(step.sr_rows(B, L))
        )
    return Draws(t(u_sub), t(w_eff), negs, sr)


_HS_STEPS = {}


def hs_run(cfg_kw, steps=2, toks=None):
    """`steps` steps of the JAX step the config routes to
    (make_hs_train_step / make_pair_train_step) and of the port's
    make_step, from the same JAX-initialized params (emb_out_hs drawn
    nonzero, so the first step moves every table), tokens and draws.
    Returns (jax params, jax metrics, port params, port metrics)."""
    from word2vec_tpu.ops.hs_step import make_hs_train_step
    from word2vec_tpu.ops.train_step import make_pair_train_step
    from word2vec_tpu_torch.ops.steps import make_step

    key_ = tuple(sorted(cfg_kw.items()))
    if key_ not in _HS_STEPS:
        jcfg, tcfg = JConfig(**cfg_kw), Word2VecConfig(**cfg_kw)
        jv, tv = hs_vocabs()
        jt = JTables.build(jv, jcfg)
        tt = TTables.build(tv, tcfg, torch.device("cpu"))
        make = (make_pair_train_step if jcfg.resolved_kernel == "pair"
                else make_hs_train_step)
        _HS_STEPS[key_] = (jcfg, tcfg, jt, tt, jax.jit(make(jcfg, jt)))
    jcfg, tcfg, jt, tt, jfn = _HS_STEPS[key_]
    jp = j_init(jcfg, HV, jax.random.key(1))
    if "emb_out_hs" in jp:
        jp["emb_out_hs"] = (0.1 * jax.random.normal(
            jax.random.key(3), jp["emb_out_hs"].shape)).astype(jp["emb_out_hs"].dtype)
    tp = torch_params(jp, tcfg)
    toks = hs_tokens() if toks is None else toks
    step = make_step(tcfg, tt)
    for i in range(steps):
        key = jax.random.fold_in(jax.random.key(7), i)
        alpha = 0.05 - 0.01 * i
        jp, jm = jfn(jp, jnp.asarray(toks), key, jnp.float32(alpha))
        tm = step.apply(tp, torch.from_numpy(toks),
                        any_draws(step, key, jt, *toks.shape), alpha)
    return jp, jm, tp, tm
