"""The port's fused band step against the JAX package's (CPU).

The JAX side is `make_band_train_step(cfg(band_backend="pallas_fused"),
tables, fused=True)`, whose Pallas kernels run through the interpreter on
the CPU. Its draws are reproduced with the same jax.random calls it makes
(ops/band_step.py:826-833, the alias draw of ops/train_step.py:41-49 and
the SR streams of _sr_streams) and handed to the port's
`BandStep.apply` as `Draws`, so both packages see the same randomness.

Tolerances: f32 tables within atol 1e-6 — the only difference is the f32
reduction order of the gradient contractions (ops/fused_step.py); bf16
tables, ± stochastic rounding, EXACT. One reference artefact is removed
for that: XLA's CPU exp2 is not exact at integer arguments (exp2(-31)
comes out 4.656615e-10, 4e-7 above 2^-31), so the JAX step's SR grid is
slightly off a power of two, while the port's torch.exp2 is exact. The SR
tests hand the port the reference's grid (`_jax_grid_cast`); with it the
trajectories are bitwise equal. Without it about 2% of the bf16 cells
that a zero-initialized row receives differ by a bf16 ulp of some
partial sum of that row.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.negative import build_alias_table  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.ops.band_step import make_band_train_step as j_step  # noqa: E402
from word2vec_tpu.ops.tables import DeviceTables as JTables  # noqa: E402
from word2vec_tpu.ops.train_step import _sr_streams  # noqa: E402

from word2vec_tpu_torch import (  # noqa: E402
    PackedCorpus, Trainer, Vocab, Word2VecConfig, export_matrix,
)
from word2vec_tpu_torch.models.params import (  # noqa: E402
    FUSED_KEY, params_from_numpy,
)
from word2vec_tpu_torch.ops import band_step  # noqa: E402
from word2vec_tpu_torch.ops.launch import LAUNCHES  # noqa: E402
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.tables import DeviceTables as TTables  # noqa: E402
from word2vec_tpu_torch.ops.steps import make_step  # noqa: E402
from word2vec_tpu_torch.ops.train_step import Draws  # noqa: E402

torch.set_num_threads(1)

V, D, B, L = 60, 16, 6, 40


def _kw(**over):
    base = dict(
        model="sg", train_method="ns", negative=3, word_dim=D, window=3,
        min_count=1, compute_dtype="float32", shared_negatives=8,
        max_sentence_len=L, band_chunk=10, table_layout="unified",
        band_backend="pallas_fused",
    )
    base.update(over)
    return base


def _host_tables():
    rng = np.random.default_rng(2)
    counts = np.arange(2 * V, V, -1).astype(np.float64)
    at = build_alias_table(counts ** 0.75 / np.sum(counts ** 0.75))
    keep = rng.uniform(0.4, 1.0, size=V).astype(np.float32)  # subsampling on
    return keep, at


def _tables():
    keep, at = _host_tables()
    j = JTables(jnp.asarray(keep), jnp.asarray(at.accept),
                jnp.asarray(at.alias), None, None, None)
    t = TTables(torch.from_numpy(keep), torch.from_numpy(at.accept),
                torch.from_numpy(at.alias))
    return j, t


def _tokens():
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, V, size=(B, L)).astype(np.int32)
    tokens[2, 30:] = -1
    return tokens


def _jax_draws(cfg, key, tables, tokens):
    """The JAX fused step's draws, as the port's Draws."""
    W, KP = cfg.window, cfg.shared_negatives
    k_sub, k_win, k_neg = jax.random.split(key, 3)
    u_sub = jax.random.uniform(k_sub, (B, L))
    w_eff = W - jax.random.randint(k_win, (B, L), 0, W, dtype=jnp.int32)
    k_bucket, k_coin = jax.random.split(k_neg)
    j = jax.random.randint(k_bucket, (B, KP), 0, V, dtype=jnp.int32)
    u = jax.random.uniform(k_coin, (B, KP))
    negs = jnp.where(u < tables.alias_accept[j], j, tables.alias_idx[j])
    sr = None
    if cfg.stochastic_rounding:
        k_sr = _sr_streams(key, True)
        sr = tuple(
            torch.from_numpy(np.array(jax.random.uniform(k_sr(i), shape)))
            for i, shape in enumerate(
                [(B * L, D), (B * L, D), (B * KP, D)]
            )
        )
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return Draws(t(u_sub), t(w_eff), t(negs).to(torch.int32), sr)


def _assert_params_close(t_params, j_params, dtype):
    got = t_params[FUSED_KEY].float().numpy()
    ref = np.asarray(j_params[FUSED_KEY], np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def _jax_grid_cast(vals, dtype, u=None, dest=None):
    """The port's _cast_update with the SR grid ulp(dest) taken from
    jnp.exp2, as the JAX step computes it on the CPU (module docstring)."""
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
# cases' compilations (the file runs on one worker), which keeps the CPU
# load of this file down
_JAX_STEPS = {}


def _jax_step(kw):
    key = tuple(sorted(kw.items()))
    if key not in _JAX_STEPS:
        jcfg = JConfig(**kw)
        jt, tt = _tables()
        _JAX_STEPS[key] = (jcfg, jt, tt, jax.jit(j_step(jcfg, jt, fused=True)))
    return _JAX_STEPS[key]


def _run(kw, steps):
    jcfg, jt, tt, jfn = _jax_step(kw)
    tcfg = Word2VecConfig(**kw)
    jp = j_init(jcfg, V, jax.random.key(1))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, tcfg, "cpu")
    start = tp[FUSED_KEY].clone()
    tokens = _tokens()
    tfn = BandStep(tcfg, tt)
    for i in range(steps):
        key = jax.random.fold_in(jax.random.key(7), i)
        alpha = 0.03 - 0.002 * i
        jp, jm = jfn(jp, jnp.asarray(tokens), key, jnp.float32(alpha))
        tm = tfn.apply(tp, torch.from_numpy(tokens),
                       _jax_draws(jcfg, key, jt, tokens), alpha)
    assert not torch.equal(tp[FUSED_KEY], start)  # the step moved the slab
    _run.step = tfn  # the step of the last run (its update tail)
    return jp, jm, tp, tm


@pytest.mark.parametrize(
    "case",
    [
        dict(),
        dict(scatter_mean=True, clip_row_update=0.0002),
        dict(compute_dtype="bfloat16", scatter_mean=True),
        dict(dtype="bfloat16", scatter_mean=True),
        dict(dtype="bfloat16", scatter_mean=True, stochastic_rounding=True),
    ],
    ids=["f32", "f32-mean-clip", "f32-bf16compute", "bf16", "bf16-sr"],
)
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_one_step_matches_jax_fused_step(model, case, monkeypatch):
    monkeypatch.setattr(band_step, "_cast_update", _jax_grid_cast)
    kw = _kw(model=model, **case)
    jp, jm, tp, tm = _run(kw, 1)
    _assert_params_close(tp, jp, kw.get("dtype", "float32"))
    np.testing.assert_allclose(float(tm["pairs"]), float(jm["pairs"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-5)
    assert float(tm["clip_engaged"]) == float(jm["clip_engaged"])
    if "clip_row_update" in case:
        assert float(jm["clip_engaged"]) > 0  # the trust region engaged


_CARD_RULE = band_step.gathered_tail


def _route_tail(monkeypatch, tail):
    """Route the band step's update tail (ops/band_step.gathered_tail):
    "card" applies the card's rule on the CPU too (the gathered tail
    through the plain versions of its kernels), "sorted" keeps the sorted
    tail everywhere."""
    if tail == "card":
        def rule(config, sr, device):
            return _CARD_RULE(config, sr, torch.device("cuda"))
    else:
        def rule(config, sr, device):
            return False
    monkeypatch.setattr(band_step, "gathered_tail", rule)


def _on_the_gathered_tail(monkeypatch):
    """The gathered update tail (the card's rule) on the CPU too."""
    _route_tail(monkeypatch, "card")


@pytest.mark.parametrize(
    "case,gathered",
    [
        (dict(), True),
        (dict(clip_row_update=0.0002), True),
        (dict(dtype="bfloat16", clip_row_update=0.0002), True),
        (dict(scatter_mean=True, clip_row_update=0.0002), False),
        (dict(dtype="bfloat16", scatter_mean=True, stochastic_rounding=True), False),
    ],
    ids=["f32", "f32-clip", "bf16-clip", "f32-mean-clip", "bf16-sr"],
)
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_band_tail_routing_matches_jax_fused_step(model, case, gathered, monkeypatch):
    """With the gathered tail allowed on the CPU, the step takes the tail
    the routing rule says (the gathered one, but the sorted one under
    scatter_mean or SR), as its engagement flag (what the trainer's
    band_tail counter reads) shows, and still matches the JAX step at its
    tolerance, the clip engaged."""
    monkeypatch.setattr(band_step, "_cast_update", _jax_grid_cast)
    _on_the_gathered_tail(monkeypatch)
    kw = _kw(model=model, **case)
    jp, jm, tp, tm = _run(kw, 1)
    assert _run.step.gathered_tail is gathered
    _assert_params_close(tp, jp, kw.get("dtype", "float32"))
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-5)
    assert float(tm["clip_engaged"]) == float(jm["clip_engaged"])
    if "clip_row_update" in case:
        assert float(jm["clip_engaged"]) > 0


def test_the_cpu_keeps_the_sorted_tail():
    """On the CPU the rule gives the sorted tail (the plain path as it was)."""
    _run(_kw(), 1)
    assert _run.step.gathered_tail is False


_TAIL_ROUTES = {
    "fused": dict(),
    "fused-cbow-bf16": dict(model="cbow", dtype="bfloat16"),
    "xla-split": dict(band_backend="xla", table_layout="split"),
    "xla-unified-batch": dict(band_backend="xla", negative_scope="batch"),
    "xla-slab-cbow": dict(band_backend="xla", table_layout="split",
                          slab_scatter=True, model="cbow"),
    "pallas-oa": dict(band_backend="pallas_oa", table_layout="split"),
    "pallas": dict(band_backend="pallas", table_layout="split"),
    "pallas-cbow-noclip": dict(band_backend="pallas", table_layout="split",
                               model="cbow", clip_row_update=0.0),
}


@pytest.mark.parametrize("route", list(_TAIL_ROUTES))
def test_gathered_tail_bitwise_the_sorted_tail(route, monkeypatch):
    """Three steps of every band route, the gathered tail against the
    sorted one on the CPU (their kernels' plain versions): bitwise-equal
    tables and metrics, the row clip engaged (its squared norms read in
    place, then gathered, sum each row in the same order on the CPU)."""
    kw = _kw(**dict(dict(clip_row_update=0.0002), **_TAIL_ROUTES[route]))
    cfg = Word2VecConfig(**kw)
    _, tt = _tables()
    tokens = torch.from_numpy(_tokens())
    emb = torch.randn(V, 2, D, generator=torch.Generator().manual_seed(3)) * 0.3
    out = {}
    for name, tail in (("sorted", "sorted"), ("gathered", "card")):
        _route_tail(monkeypatch, tail)
        tdt = torch.bfloat16 if kw.get("dtype") == "bfloat16" else torch.float32
        params = ({FUSED_KEY: emb.to(tdt, copy=True)} if cfg.table_layout == "unified"
                  else {"emb_in": emb[:, 0].to(tdt, copy=True),
                        "emb_out_ns": emb[:, 1].to(tdt, copy=True)})
        step = BandStep(cfg, tt)
        ms = [step(params, tokens, torch.Generator().manual_seed(10 + i), 0.05)
              for i in range(3)]
        assert step.gathered_tail is (name == "gathered")
        out[name] = (params, ms)
    (ps, ms), (pg, mg) = out["sorted"], out["gathered"]
    for k in ps:
        assert torch.equal(ps[k], pg[k]), k
    for a, b in zip(ms, mg):
        assert {k: float(v) for k, v in a.items()} == {k: float(v) for k, v in b.items()}
    if cfg.clip_row_update > 0:
        assert all(float(m["clip_engaged"]) > 0 for m in mg)


def _planted(**over):
    rng = np.random.default_rng(0)
    sents = []
    for _ in range(300):
        w1 = rng.choice(["a", "b"])
        w2 = rng.choice(["c", "d"])
        sents.append(["x", w1, "y", "x", w1, "y"])
        sents.append(["p", w2, "q", "p", w2, "q"])
    kw = dict(
        model="sg", train_method="ns", negative=5, word_dim=32, window=2,
        min_count=1, subsample_threshold=0, iters=2, batch_rows=32,
        max_sentence_len=16, init_alpha=0.05, scatter_mean=False,
        kernel="band", band_chunk=8, shared_negatives=8,
        table_layout="unified", band_backend="pallas_fused", clip_row_update=0.01,
    )
    kw.update(over)
    cfg = Word2VecConfig(**kw)
    vocab = Vocab.build(sents, min_count=1)
    corpus = PackedCorpus.pack(vocab.encode_corpus(sents), cfg.max_sentence_len)
    return cfg, vocab, corpus


def _band_tail_rows(tr):
    return [e["args"] for e in tr.flight.ring.events() if e["name"] == "band_tail"]


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_trainer_records_the_band_tail_a_dispatch(chunk_steps, monkeypatch):
    """The trainer's engagement counter: one band_tail counter a dispatch
    on the flight recorder's ring, its steps summing to the run's, reading
    0 on the CPU's sorted tail and 1 on the gathered one (allowed on the
    CPU here), whose run is bitwise the sorted run's; the hs step records
    none."""
    cfg, vocab, corpus = _planted(chunk_steps=chunk_steps)
    runs = {}
    for name, tail in (("sorted", "sorted"), ("gathered", "card")):
        _route_tail(monkeypatch, tail)
        tr = Trainer(cfg, vocab, corpus, device="cpu")
        state, rep = tr.train(log_every=0)
        rows = _band_tail_rows(tr)
        assert sum(r["steps"] for r in rows) == rep.steps
        assert len(rows) == -(-rep.steps // chunk_steps)
        assert {r["gathered"] for r in rows} == {float(name == "gathered")}
        runs[name] = state.params
    assert all(torch.equal(runs["sorted"][k], runs["gathered"][k]) for k in runs["sorted"])
    hs_cfg, vocab, corpus = _planted(train_method="hs", negative=0, band_backend="xla",
                                     table_layout="split", chunk_steps=chunk_steps)
    tr = Trainer(hs_cfg, vocab, corpus, device="cpu")
    tr.train(log_every=0)
    assert _band_tail_rows(tr) == []


@pytest.mark.parametrize(
    "model,case",
    [
        ("sg", dict(scatter_mean=True, clip_row_update=0.0002)),
        ("cbow", dict(dtype="bfloat16", scatter_mean=True,
                      stochastic_rounding=True)),
    ],
    ids=["sg-f32-mean-clip", "cbow-bf16-sr"],
)
def test_three_steps_match_jax_fused_step(model, case, monkeypatch):
    monkeypatch.setattr(band_step, "_cast_update", _jax_grid_cast)
    kw = _kw(model=model, **case)
    jp, _, tp, _ = _run(kw, 3)
    _assert_params_close(tp, jp, kw.get("dtype", "float32"))


@pytest.mark.parametrize(
    "over,lever",
    [
        (dict(train_method="hs", negative=0, band_backend="xla",
              table_layout="split"), "negative sampling only"),
        (dict(kernel="pair", band_backend="xla", table_layout="split"),
         "fused_tables applies to the ns band kernel only"),
    ],
)
def test_refusals_match_jax(over, lever):
    """What the JAX package refuses, the port refuses: the band step on
    hs (hs routes to ops/hs_step.HsStep) and the pair step on the fused
    [V, 2, d] slab."""
    _, tt = _tables()
    cfg = Word2VecConfig(**_kw(**over))
    with pytest.raises(ValueError) as e:
        if cfg.use_hs:
            BandStep(cfg, tt)
        else:
            make_step(cfg, tt, fused=True)
    assert lever in str(e.value)


def test_dense_rows_are_refused():
    _, tt = _tables()
    cfg = Word2VecConfig(**_kw(max_sentence_len=12, band_chunk=0))
    step = BandStep(cfg, tt)
    params = {FUSED_KEY: torch.zeros(V, 2, D)}
    tokens = torch.zeros(2, 12, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunked band"):
        step(params, tokens, torch.Generator().manual_seed(0), 0.03)


def test_planted_corpus_trainer_recovers_structure():
    """The verify recipe's planted corpus ({a,b} share contexts {x,y};
    {c,d} share {p,q}) through the port's Trainer on the CPU: the loss
    falls and the structure is recovered as in the JAX run."""
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
        kernel="band", band_chunk=8, shared_negatives=8,
        table_layout="unified", band_backend="pallas_fused",
    )
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
    assert all(v == 0 for v in LAUNCHES.values())  # the CPU never launches
