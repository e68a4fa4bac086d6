"""The port's pair step (ops/pair_step.PairStep), its update tail and the
kernel auto-selection, against the JAX package (CPU).

Pins:
  * two steps of PairStep equal make_pair_train_step's on the same params,
    tokens and draws (the per-pair negatives [P, K] and the SR uniforms
    made by the JAX step's own jax.random calls), on ns and on hs, sg and
    cbow, scatter_mean and the row clip, bf16 tables +- SR. Tolerances as
    in tests/test_torch_hs_step.py: f32 params within atol 1e-6 (the
    contractions sum in another order), bf16 sg bitwise and bf16 cbow per
    assert_bf16_tables_close; pairs and clip_engaged exact, loss within
    rtol 1e-5;
  * BITWISE: the pair step's unsorted `.at[idx].add` (XLA applies
    duplicates in update order) equals the port's stable argsort and
    ordered scatter (sorted_scatter), with and without the scatter_mean
    counts, f32 and bf16 tables, SR uniforms in update order (the clip's
    per-row norms sum over d in another order: the step tests hold them);
  * the chunk runner with micro_steps=2 matches JAX make_chunk_runner on
    pair, ns and hs;
  * kernel='auto' on a degeneracy-domain corpus: the port's Trainer
    selects 'pair' with the JAX trainer's decision record, logs it, runs
    PairStep and warns as the JAX trainer does (no "FORCES" warning).
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.ops.tables import DeviceTables as JTables  # noqa: E402
from word2vec_tpu.ops.train_step import (  # noqa: E402
    _cast_update as j_cast, _dup_mean_scale as j_mean, make_chunk_runner as j_chunk,
)
from word2vec_tpu.train import Trainer as JTrainer  # noqa: E402
from word2vec_tpu.utils.synthetic import zipf_vocab as j_zipf_vocab  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import PackedCorpus, Trainer, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.ops import train_step as tts  # noqa: E402
from word2vec_tpu_torch.ops.graphs import METRICS  # noqa: E402
from word2vec_tpu_torch.ops.tables import DeviceTables as TTables  # noqa: E402
from word2vec_tpu_torch.ops.pair_step import PairStep  # noqa: E402
from word2vec_tpu_torch.ops.train_step import make_chunk_runner, sorted_scatter  # noqa: E402
from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab  # noqa: E402

torch.set_num_threads(1)

NS = dict(kernel="pair", train_method="ns", negative=3)
HS = dict(kernel="pair")
CASES = {
    "ns-sg": dict(NS),
    "ns-cbow": dict(NS, model="cbow"),
    "hs-sg": dict(HS),
    "hs-cbow-sum": dict(HS, model="cbow", cbow_mean=False),
    "ns-sg-mean-clip": dict(NS, scatter_mean=True, clip_row_update=0.05),
    "hs-cbow-mean-clip": dict(HS, model="cbow", scatter_mean=True,
                              clip_row_update=0.05),
    "ns-sg-bf16-sr": dict(NS, dtype="bfloat16", stochastic_rounding=True,
                          compute_dtype="bfloat16"),
    "hs-sg-bf16-sr": dict(HS, dtype="bfloat16", stochastic_rounding=True),
    "ns-cbow-bf16": dict(NS, model="cbow", dtype="bfloat16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pair_step_matches_jax(case, monkeypatch):
    monkeypatch.setattr(tts, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.hs_kw(**CASES[case])
    jp, jm, tp, tm = tp_.hs_run(kw)
    tp_.assert_params_close(tp, jp, kw)
    tp_.assert_metrics_close(tm, jm)
    assert float(tm["hs_tail_dropped"]) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mean", [False, True])
def test_unsorted_scatter_order_is_bitwise_jax(dtype, mean, monkeypatch):
    """_score_and_update's table tail: the JAX order of an unsorted
    `.at[idx].add` with its scatter_mean counts, against the port's
    stable argsort + ordered scatter, bitwise."""
    monkeypatch.setattr(tts, "_cast_update", tp_.jax_grid_cast)
    rng = np.random.default_rng(5)
    rows, n, d = 9, 400, 6
    idx = rng.integers(0, rows, size=n).astype(np.int32)
    vals = (rng.normal(size=(n, d)) * 10.0 ** rng.uniform(-6, -1, size=(n, 1))
            ).astype(np.float32)
    vals[::7] = 0.0
    w = (rng.random(n) < 0.8).astype(np.float32)
    table = rng.normal(0, 0.1, size=(rows, d)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jt = jnp.asarray(table).astype(jdt)
    jv = jnp.asarray(vals)
    if mean:
        jv = jv * j_mean(rows, jnp.asarray(idx), jnp.asarray(w))[:, None]
    key = jax.random.key(3)
    ju = jax.random.uniform(key, jv.shape)
    if dtype == "bfloat16":
        cast = tp_.jax_grid_cast(torch.from_numpy(np.array(jv)), torch.bfloat16,
                                 torch.from_numpy(np.array(ju)),
                                 torch.from_numpy(np.array(jt.astype(jnp.float32)))[idx])
        upd = jnp.asarray(cast.float().numpy()).astype(jnp.bfloat16)
    else:
        upd = j_cast(jv, jnp.float32)
    want = np.asarray(jt.at[jnp.asarray(idx)].add(upd).astype(jnp.float32))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    got = torch.from_numpy(table).to(tdt)
    clip = sorted_scatter(
        got, torch.from_numpy(idx), torch.from_numpy(vals), torch.from_numpy(w),
        scatter_mean=mean, clip_tau=0.0,
        u=torch.from_numpy(np.array(ju)), u_sorted=False)
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert float(clip) == 0.0


@pytest.mark.parametrize("case", ["ns", "hs"])
def test_micro_chunk_runner_matches_jax(case):
    """make_chunk_runner with micro_steps=2 against JAX's: step i, sub-step
    j draws from fold_in(fold_in(base_key, step0 + i), j) over B/2 rows."""
    kw = tp_.hs_kw(**(NS if case == "ns" else HS), micro_steps=2)
    jcfg, tcfg = JConfig(**kw), Word2VecConfig(**kw)
    jv, tv = tp_.hs_vocabs()
    jt = JTables.build(jv, jcfg)
    tt = TTables.build(tv, tcfg, torch.device("cpu"))
    jp = j_init(jcfg, tp_.HV, jax.random.key(1))
    tp = tp_.torch_params(jp, tcfg)
    base = tp_.hs_tokens()
    toks = np.stack([base, np.roll(base, 1, axis=0)])
    alphas = np.float32([0.05, 0.04])
    base_key = jax.random.key(9)
    jp, jm = jax.jit(j_chunk(jcfg, jt))(jp, jnp.asarray(toks), base_key, 3,
                                         jnp.asarray(alphas))
    runner = make_chunk_runner(tcfg, tt)
    assert isinstance(runner.step, PairStep)
    runner.draws_hook = lambda step, sub: tp_.any_draws(
        runner.step, jax.random.fold_in(jax.random.fold_in(base_key, step), sub),
        jt, tp_.HB // 2, tp_.HL)
    tm = runner(tp, torch.from_numpy(toks), 0, 3, alphas)
    tp_.assert_params_close(tp, jp, kw)
    for i in range(2):
        tp_.assert_metrics_close({k: tm[k][i] for k in jm}, {k: jm[k][i] for k in jm})
    assert set(jm) | {"hs_tail_dropped"} == set(METRICS)


def _messages(make):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        obj = make()
    return obj, [str(w.message) for w in rec if issubclass(w.category, UserWarning)]


def test_auto_selects_pair_in_the_degeneracy_domain():
    kw = dict(model="sg", train_method="ns", negative=3, word_dim=8, window=2,
              min_count=1, max_sentence_len=16, batch_rows=4, iters=30)
    tv, jv = zipf_vocab(40, 20000), j_zipf_vocab(40, 20000)
    ids = zipf_corpus_ids(tv, 2000, seed=2, sentence_len=16)
    logs = []
    tr, got = _messages(lambda: Trainer(Word2VecConfig(**kw), tv,
                                        PackedCorpus.pack(ids, 16),
                                        log_fn=logs.append, device="cpu"))
    jtr, want = _messages(lambda: JTrainer(JConfig(**kw), jv, JCorpus.pack(ids, 16)))
    assert tr.kernel_decision == jtr.kernel_decision
    assert tr.kernel_decision["selected"] == "pair"
    assert logs[0] == tr.kernel_decision
    assert tr.config.kernel == jtr.config.kernel == "pair"
    assert got == want and not any("FORCES" in m for m in got)
    state, rep = tr.train(log_every=0, max_steps=3)
    assert rep.steps == 3 and np.isfinite(rep.final_loss)
    runner = next(iter(tr._runners.values()))
    assert isinstance(runner.step, PairStep)
    # outside the domain (or with band forced) nothing is selected
    far = Trainer(Word2VecConfig(**dict(kw, iters=1)), tv,
                  PackedCorpus.pack(ids, 16), device="cpu")
    assert far.kernel_decision is None and far.config.kernel == "auto"
