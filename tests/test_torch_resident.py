"""The port's device-resident corpus path (ops/resident.py) against the
JAX package's, and the resident Trainer against the streaming one (CPU).

Pins, BITWISE: assemble_batch equals the JAX assemble_batch on the same
row order (every batch of an epoch, the partial final batch, the all-PAD
batches past the epoch, column windows col0) and the port's own host
batcher; epoch_step_words and Word2VecConfig.chunk_geometry equal the
JAX ones; a resident Trainer run equals the streaming run on every route.
The resident runner matches JAX make_resident_chunk_runner with the JAX
step's draws fed in (torch_parity.assert_params_close). The error paths
are the JAX trainer's: resident='on' over the budget or on the per-step
path raises; fused_tables on the per-step path warns; TrainReport.resident
records the resolution.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.ops import resident as jres  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import PackedCorpus, Trainer, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.data.batcher import PAD, BatchIterator  # noqa: E402
from word2vec_tpu_torch.ops import resident as res  # noqa: E402
from word2vec_tpu_torch.ops.graphs import METRICS  # noqa: E402

torch.set_num_threads(1)


def _corpus(L=16, n=3000):
    from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab

    vocab = zipf_vocab(50, n * 10)
    sents = zipf_corpus_ids(vocab, n, seed=3, sentence_len=37)
    return PackedCorpus.pack(sents, L), JCorpus.pack(sents, L)


@pytest.mark.parametrize("B,L,col0,width", [(4, 16, 0, 16), (5, 16, 0, 16),
                                            (4, 16, 6, 7), (3, 12, 11, 5)])
def test_assemble_batch_matches_jax_bitwise(B, L, col0, width):
    tc, jc = _corpus(L)
    seed, epoch = 11, 2
    order = res.epoch_order(seed, epoch, tc.num_rows)
    assert np.array_equal(order, jres.epoch_order(seed, epoch, jc.num_rows))
    t_dev = res.device_corpus(tc, "cpu")
    j_dev = jres.device_corpus(jc)
    t_order = torch.from_numpy(order.astype(np.int32))
    j_order = jnp.asarray(order.astype(np.int32))
    spe = -(-tc.num_rows // B)
    for t in list(range(spe)) + [spe, spe + 3]:
        got = res.assemble_batch(t_dev, t_order, torch.tensor([t]), B, width, col0)
        want = np.asarray(jres.assemble_batch(j_dev, j_order, jnp.int32(t), B,
                                              width, col0))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        if t >= spe:
            assert bool((got == PAD).all())


def test_assemble_batch_matches_host_batcher():
    tc, _ = _corpus()
    B, L = 4, 16
    order = res.epoch_order(5, 1, tc.num_rows)
    dev = res.device_corpus(tc, "cpu")
    o = torch.from_numpy(order.astype(np.int32))
    host = list(BatchIterator(tc, B, L, seed=5).epoch(1))
    for t, (tokens, words) in enumerate(host):
        got = res.assemble_batch(dev, o, t, B, L)
        np.testing.assert_array_equal(got.numpy(), tokens)
        assert int((got >= 0).sum()) == words


def test_epoch_step_words_matches_jax_and_host():
    tc, jc = _corpus()
    for B in (3, 4, 7):
        order = res.epoch_order(5, 0, tc.num_rows)
        got = res.epoch_step_words(tc, order, B)
        np.testing.assert_array_equal(got, jres.epoch_step_words(jc, order, B))
        host = [w for _, w in BatchIterator(tc, B, 16, seed=5).epoch(0)]
        assert got.tolist() == host


def test_chunk_geometry_matches_jax():
    for steps in list(range(0, 140)) + [999, 1000, 1001, 4096]:
        for cap in (1, 2, 7, 16, 32, 33):
            assert (Word2VecConfig.chunk_geometry(steps, cap=cap)
                    == JConfig.chunk_geometry(steps, cap=cap)), (steps, cap)


def test_corpus_arrays_and_budget():
    tc, jc = _corpus()
    for k, v in res.corpus_arrays(tc).items():
        np.testing.assert_array_equal(v, jres.corpus_arrays(jc)[k])
        assert v.dtype == np.int32
    assert res.resident_budget_bytes() == res.RESIDENT_MAX_BYTES
    assert res.resident_budget_bytes(torch.device("cpu")) == res.RESIDENT_MAX_BYTES
    assert res.corpus_fits(tc) and not res.corpus_fits(tc, max_bytes=16)


@pytest.mark.parametrize("case", ["xla-split", "pallas_fused-unified"])
def test_resident_runner_matches_jax(case):
    """make_resident_chunk_runner against JAX's on the same corpus, order,
    epoch_t0 and alphas, the JAX step's draws fed in; the chunk runs past
    the epoch's end, so its last slot is an all-PAD (skipped) step."""
    backend, layout = case.split("-")
    kw = tp_.kw(band_backend=backend, table_layout=layout, batch_rows=tp_.B)
    jcfg, tcfg = JConfig(**kw), Word2VecConfig(**kw)
    jt, tt = tp_.tables()
    rng = np.random.default_rng(6)
    sents = [rng.integers(0, tp_.V, size=int(n)).astype(np.int32)
             for n in rng.integers(5, 60, size=14)]
    tc, jc = PackedCorpus.pack(sents, tp_.L), JCorpus.pack(sents, tp_.L)
    order = res.epoch_order(3, 0, tc.num_rows)
    spe = -(-tc.num_rows // tp_.B)
    t0, S = spe - 2, 3
    alphas = np.float32([0.03, 0.028, 0.026])
    base_key = jax.random.key(9)
    jp = j_init(jcfg, tp_.V, jax.random.key(1))
    tp = tp_.torch_params(jp, tcfg)
    jrun = jax.jit(jres.make_resident_chunk_runner(jcfg, jt))
    jp, jm = jrun(jp, jres.device_corpus(jc), jnp.asarray(order.astype(np.int32)),
                  base_key, 4, t0, jnp.asarray(alphas))
    runner = res.make_resident_chunk_runner(tcfg, tt)
    runner.draws_hook = lambda step, sub: tp_.jax_draws(
        runner.step, jax.random.fold_in(base_key, step), jt)
    tm = runner(tp, res.device_corpus(tc, "cpu"), order.astype(np.int32), 0, 4,
                t0, alphas, steps=2)
    tp_.assert_params_close(tp, jp, kw)
    for i in range(S):
        tp_.assert_metrics_close({k: tm[k][i] for k in jm},
                                 {k: jm[k][i] for k in jm})
        assert float(tm["hs_tail_dropped"][i]) == 0.0  # no hs tail here


def _train(cfg, **kw):
    vocab, corpus = tp_.small_corpus()
    tr = Trainer(cfg, vocab, corpus, device="cpu")
    state, report = tr.train(log_every=0, **kw)
    return state, report


@pytest.mark.parametrize("route", tp_.ROUTES, ids=tp_.ROUTE_IDS)
def test_resident_trainer_matches_streaming_bitwise(route):
    on, r_on = _train(tp_.trainer_cfg(route, chunk_steps=4, resident="on", iters=2))
    off, r_off = _train(tp_.trainer_cfg(route, chunk_steps=4, resident="off", iters=2))
    assert on.step == off.step and on.words_done == off.words_done
    tp_.assert_params_bitwise(on.params, off.params)
    assert r_on.resident["resolved"] == "resident" and r_off.resident is None
    assert r_on.final_loss == r_off.final_loss


@pytest.mark.parametrize("name", list(tp_.STEP_ROUTES))
def test_step_routes_resident_match_streaming_bitwise(name):
    """The hs and pair steps on the resident corpus equal streaming."""
    over = tp_.STEP_ROUTES[name]
    on, r_on = _train(tp_.trainer_cfg(chunk_steps=4, resident="on", **over))
    off, r_off = _train(tp_.trainer_cfg(chunk_steps=4, resident="off", **over))
    assert on.step == off.step and on.words_done == off.words_done
    tp_.assert_params_bitwise(on.params, off.params)
    assert r_on.resident["resolved"] == "resident"
    assert r_on.final_loss == r_off.final_loss and len(METRICS) == 5


def test_resident_report_and_auto_resolution(monkeypatch):
    logs = []
    vocab, corpus = tp_.small_corpus()
    cfg = tp_.trainer_cfg(chunk_steps=0)
    _, rep = Trainer(cfg, vocab, corpus, log_fn=logs.append,
                     device="cpu").train(log_every=0)
    assert rep.resident == {
        "event": "resident_path", "mode": "auto", "resolved": "resident",
        "budget_bytes": res.RESIDENT_MAX_BYTES,
        "corpus_bytes": corpus.flat.nbytes + 8 * corpus.num_rows,
    }
    assert logs == [rep.resident]
    monkeypatch.setattr(res, "RESIDENT_MAX_BYTES", 16)
    streamed, rep = _train(cfg)
    assert rep.resident["resolved"] == "streaming"
    assert rep.resident["budget_bytes"] == 16
    ref, _ = _train(tp_.trainer_cfg())
    tp_.assert_params_bitwise(streamed.params, ref.params)


def test_resident_on_over_budget_raises(monkeypatch):
    monkeypatch.setattr(res, "RESIDENT_MAX_BYTES", 16)
    with pytest.raises(ValueError, match="exceeds the device-memory budget"):
        _train(tp_.trainer_cfg(chunk_steps=4, resident="on"))


def test_resident_on_per_step_path_raises():
    with pytest.raises(ValueError, match="chunked dispatch"):
        _train(tp_.trainer_cfg(chunk_steps=1, resident="on"))


def test_fused_tables_on_per_step_path_warns_and_matches():
    with pytest.warns(UserWarning, match="chunked dispatch only"):
        fused, _ = _train(tp_.trainer_cfg(fused_tables=True))
    plain, _ = _train(tp_.trainer_cfg())
    tp_.assert_params_bitwise(fused.params, plain.params)


def test_fused_tables_refused_on_the_pallas_route():
    with pytest.raises(ValueError, match="fused_tables"):
        _train(tp_.trainer_cfg(("pallas", "split"), chunk_steps=4,
                               fused_tables=True))


@pytest.mark.parametrize("over", [dict(chunk_steps=0), dict(chunk_steps=3),
                                  dict(chunk_steps=3, resident="off"),
                                  dict(chunk_steps=0, resident="on"),
                                  dict(chunk_steps=3, fused_tables=True)],
                         ids=["auto", "3", "3-off", "auto-on", "3-fused"])
def test_trainer_accepts_chunked_configs(over):
    state, rep = _train(tp_.trainer_cfg(**over))
    assert state.step == rep.steps > 0 and np.isfinite(rep.final_loss)
