"""ShardedTrainer under the model and seq axes (word2vec_tpu_torch/
parallel/trainer.py) against the JAX package's ShardedTrainer on the same
mesh, corpus, initial tables and draws (the port's draws_hook(step, sub,
replica) fed fold_in(fold_in(fold_in(key(run_seed ^ 0x5EED), step), d), s),
folding only the axes wider than 1, as the JAX step does), and against
itself.

Pins:
  * dp 2 x tp 2 (mean and delta sync), dp 2 x sp 2 x tp 2 and the pair
    step under sp 2 (tests/test_parallel.py:126, :265, :319, :390):
    tables within atol 1e-6, equal total_words, the loss history within
    rtol 1e-5;
  * BITWISE in the port: chunked and resident == per-step at dp 2 x tp 2,
    sp 2 and dp 2 x sp 2 x tp 2 (tests/test_parallel.py:417), the
    resident path's haloed window == the streaming batch's; export /
    import round trips; a tp-2 checkpoint resumed by a fresh tp-2 trainer
    == the uninterrupted run, and it loads in a tp-1 Trainer and in the
    JAX Trainer; a nan fault fills every shard;
  * every route of the mesh (xla split and unified, hs, pair) trains at
    tp 2, tp 4, sp 2 and dp 2 x sp 2 x tp 2; a stream of segments trains
    at tp 2.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus  # noqa: E402
from word2vec_tpu.data.vocab import Vocab as JVocab  # noqa: E402
from word2vec_tpu.parallel import ShardedTrainer as JSharded  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Trainer, TrainState, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.data.batcher import BatchIterator  # noqa: E402
from word2vec_tpu_torch.models.params import params_from_numpy  # noqa: E402
from word2vec_tpu_torch.ops import resident as res  # noqa: E402
from word2vec_tpu_torch.ops.shards import halo_exchange  # noqa: E402
from word2vec_tpu_torch.ops.steps import make_step  # noqa: E402
from word2vec_tpu_torch.parallel import ShardedTrainer  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

SHARD_KW = dict(model="sg", train_method="ns", negative=3, word_dim=16,
                window=3, min_count=1, subsample_threshold=1e-3, iters=2,
                batch_rows=4, max_sentence_len=24, band_chunk=8,
                shared_negatives=8, seed=11, dp_sync_every=4,
                init_alpha=0.05)


def _both_trainers(dp, sp, tp, **over):
    """(port ShardedTrainer, its state, JAX ShardedTrainer, its state) on
    torch_parity.small_corpus, the port fed the JAX trainer's draws, both
    from the JAX trainer's initial tables."""
    kw = dict(SHARD_KW, **over)
    vocab, corpus = tp_.small_corpus()
    jv = JVocab(list(vocab.words), vocab.counts.copy())
    jc = JCorpus(corpus.flat.copy(), corpus.row_starts.copy(), corpus.row_lens.copy())
    jtr = JSharded(JConfig(**kw), jv, jc, dp=dp, tp=tp, sp=sp)
    ttr = ShardedTrainer(Word2VecConfig(**kw), vocab, corpus, dp=dp, tp=tp, sp=sp,
                         device="cpu")
    jstate = jtr.init_state()
    tstate = TrainState(params=None)
    host = {k: np.asarray(v[0]) for k, v in jstate.params.items()}
    ttr.import_params(params_from_numpy(host, ttr.config, "cpu"), tstate)
    step = make_step(ttr.config, ttr.tables, tp=tp, sp=sp)
    base = jax.random.key(ttr.run_seed ^ 0x5EED)
    B = kw["batch_rows"]
    Lh = kw["max_sentence_len"] // sp + (2 * kw["window"] if sp > 1 else 0)

    def hook(s, sub, r):
        d, q = divmod(r, sp)
        key = jax.random.fold_in(base, s)
        if dp > 1:
            key = jax.random.fold_in(key, d)
        if sp > 1:
            key = jax.random.fold_in(key, q)
        return tp_.any_draws(step, key, jtr.tables, B, Lh)

    ttr.draws_hook = hook
    return ttr, tstate, jtr, jstate


@pytest.mark.parametrize("mesh,over", [
    ((2, 1, 2), dict(sync_mode="mean")),
    ((2, 1, 2), dict(sync_mode="delta", table_layout="unified")),
    ((2, 2, 2), dict(sync_mode="mean", health_metrics=True)),
    ((1, 2, 1), dict(kernel="pair", train_method="hs", negative=0, iters=1)),
], ids=["dp2-tp2-mean", "dp2-tp2-delta-unified", "dp2-sp2-tp2", "sp2-pair-hs"])
def test_sharded_trainer_matches_jax(monkeypatch, mesh, over):
    """tests/test_parallel.py:126, :390, :265 and :319: the trainer at
    each mesh against JAX's over the same corpus, tables and draws."""
    dp, sp, tp = mesh
    ttr, ts, jtr, js = _both_trainers(dp, sp, tp, **over)
    ts, trep = ttr.train(state=ts, log_every=3)
    js, jrep = jtr.train(state=js, log_every=3)
    assert ts.step == js.step == trep.steps and trep.total_words == jrep.total_words
    assert len(trep.loss_history) == len(jrep.loss_history) > 2
    np.testing.assert_allclose(trep.loss_history, jrep.loss_history, rtol=1e-5)
    want = jtr.export_params(js)
    got = ttr.export_params(ts)
    tp_.assert_params_close(got, want, dict(SHARD_KW, **over))
    for k, v in got.items():
        assert v.shape == want[k].shape, k
    # the run ends on a sync: every replica's shards hold the export
    for rep in ttr._replicas:
        shards = rep if isinstance(rep, list) else [rep]
        assert len(shards) == tp
        for k in got:
            full = torch.cat([s[k] for s in shards], dim=-1)
            assert torch.equal(full, got[k])


def _sharded(mesh, route=None, **over):
    """A trainer on a corpus of 32 batches: 16 global steps an epoch at
    dp 2 (32 at dp 1), a whole number of chunks of 2 and 4."""
    dp, sp, tp = mesh
    vocab, corpus = tp_.small_corpus(2350)
    over.setdefault("dp_sync_every", 4)
    over.setdefault("iters", 2)
    over.update(tp_.STEP_ROUTES.get(route, {}))
    layout = "unified" if route == "unified" else "split"
    return ShardedTrainer(tp_.trainer_cfg(("xla", layout), **over),
                          vocab, corpus, dp=dp, tp=tp, sp=sp, device="cpu")


MESHES = [(2, 1, 2), (1, 2, 1), (2, 2, 2)]


@pytest.mark.parametrize("mesh", MESHES, ids=["dp2-tp2", "sp2", "dp2-sp2-tp2"])
def test_chunked_and_resident_match_per_step(mesh):
    """tests/test_parallel.py:416-440, bitwise in the port: chunk 0
    (auto, capped to divide the sync interval), chunk 4 streaming and the
    resident corpus equal the per-step run; the resident path's haloed
    window is the streaming batch's."""
    ref_tr = _sharded(mesh, chunk_steps=1)
    ref, _ = ref_tr.train(log_every=0)
    losses = {}
    for over in (dict(chunk_steps=0), dict(chunk_steps=4, resident="off"),
                 dict(chunk_steps=4, resident="on")):
        tr = _sharded(mesh, **over)
        st, rep = tr.train(log_every=0)
        assert (st.step, st.words_done) == (ref.step, ref.words_done), over
        tp_.assert_params_bitwise(st.params, ref.params)
        losses[over.get("resident")] = rep.final_loss
        if over.get("resident") == "on":
            assert rep.resident["resolved"] == "resident"
    assert losses["on"] == losses["off"]
    dp, sp, tp = mesh
    cfg = ref_tr.config
    B, L, W = cfg.batch_rows, cfg.max_sentence_len, cfg.window
    batcher = BatchIterator(ref_tr.corpus, B, L, seed=ref_tr.run_seed)
    order = res.epoch_order(ref_tr.run_seed, 1, ref_tr.corpus.num_rows)
    dev = res.device_corpus(ref_tr.corpus, "cpu")
    batches = [t for t, _ in batcher.epoch(1)]
    for t in (0, 3):
        chunk = np.concatenate(batches[t * dp:(t + 1) * dp])[None]
        for r in range(dp * sp):
            d, s = divmod(r, sp)
            want = ref_tr._replica_tokens(chunk, r)[0]
            rows = res.assemble_batch(dev, torch.from_numpy(order.astype(np.int32)),
                                      t * dp + d, B, L)
            got = rows if sp == 1 else halo_exchange(rows, s, sp, W)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_export_import_checkpoint_across_widths(tmp_path):
    """The checkpoint format stays unreplicated [V, d]: a tp-2 run's
    export round-trips bitwise through import_params, a checkpoint of it
    taken mid-run and resumed by a fresh tp-2 trainer lands bitwise on
    the uninterrupted run, and it loads in a tp-1 Trainer and in the JAX
    Trainer."""
    from word2vec_tpu.io.checkpoint import load_checkpoint as j_load
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    mesh = (1, 1, 2)
    full = _sharded(mesh, chunk_steps=2)
    fs, _ = full.train(log_every=0)
    ck = str(tmp_path / "ck")
    a = _sharded(mesh, chunk_steps=2)
    saved = {}

    def cb(s):
        if not saved and s.step >= 20:
            save_checkpoint(ck, TrainState(a.export_params(s), s.step, s.words_done,
                                           s.epoch), a.config, a.vocab)
            saved["step"] = s.step

    a.train(log_every=0, checkpoint_cb=cb, checkpoint_every=4)
    st, _, _ = load_checkpoint(ck)
    assert st.params["emb_in"].shape == (len(a.vocab), 16)
    b = _sharded(mesh, chunk_steps=2)
    b.import_params(st.params, st)
    assert all(v.shape[-1] == 8 for s in b._replicas[0] for v in s.values())
    rs, _ = b.train(state=st, log_every=0)
    assert (rs.step, rs.words_done) == (fs.step, fs.words_done)
    tp_.assert_params_bitwise(rs.params, fs.params)
    # export / import round trip, and the same tables in a tp-1 Trainer
    st2 = TrainState(params=None, step=rs.step)
    b.import_params(rs.params, st2)
    tp_.assert_params_bitwise(b.export_params(st2), rs.params)
    st1, _, _ = load_checkpoint(ck)
    jst, jcfg, _ = j_load(ck)
    for k, v in st1.params.items():
        np.testing.assert_array_equal(np.asarray(jst.params[k]), v.numpy())
    one = Trainer(b.config, b.vocab, b.corpus, device="cpu")
    _, rep1 = one.train(state=st1, log_every=0, max_steps=st1.step + 1)
    assert rep1.steps == saved["step"] + 1


@pytest.mark.parametrize("route", ["xla", "unified", "hs-sg", "pair-ns"])
@pytest.mark.parametrize("mesh", [(1, 1, 2), (1, 1, 4), (1, 2, 1), (2, 2, 2)],
                         ids=["tp2", "tp4", "sp2", "dp2-sp2-tp2"])
def test_every_mesh_route_trains(mesh, route):
    """Each route of the model and seq axes trains at each mesh: finite
    tables of the full width, the replicas equal after the final sync,
    every shard its own contiguous [V, d/tp] tensor."""
    tr = _sharded(mesh, route if route != "xla" else None, iters=1, chunk_steps=2)
    st, rep = tr.train(log_every=0)
    assert rep.total_words == tr.corpus.num_tokens and np.isfinite(rep.final_loss)
    dp, sp, tp = mesh
    for k, v in st.params.items():
        assert v.shape[-1] == 16 and bool(torch.isfinite(v).all()), k
    for rep_ in tr._replicas:
        shards = rep_ if isinstance(rep_, list) else [rep_]
        for s in shards:
            for v in s.values():
                assert v.shape[-1] == 16 // tp and v.is_contiguous()
        full = {k: torch.cat([s[k] for s in shards], dim=-1) for k in shards[0]}
        tp_.assert_params_bitwise(full, st.params)


def test_nan_fault_fills_every_shard_and_stream_trains():
    """A nan fault reaches every replica's every shard; a stream of
    segments trains under tp 2 (stream/driver.py with a ShardedTrainer)."""
    from word2vec_tpu_torch import PackedCorpus
    from word2vec_tpu_torch.resilience.faults import FaultPlan
    from word2vec_tpu_torch.stream import StreamRun
    from word2vec_tpu_torch.stream.source import ArraySource

    tr = _sharded((2, 1, 2), chunk_steps=1)
    tr.fault_plan = FaultPlan.parse("nan@3")
    with pytest.warns(UserWarning, match="non-finite"):
        tr.train(log_every=0, max_steps=4)
    for rep in tr._replicas:
        for s in rep:
            assert all(bool(torch.isnan(v).all()) for v in s.values())

    vocab, corpus = tp_.small_corpus(3000)
    ids = np.asarray(corpus.flat)
    cfg = tp_.trainer_cfg(chunk_steps=2, dp_sync_every=4, corpus_mode="streaming",
                          segment_tokens=1000)
    tr = ShardedTrainer(cfg, vocab, PackedCorpus.from_flat(ids[:1000], 24), tp=2,
                        device="cpu")
    st, rep = StreamRun(tr, ArraySource(ids, segment_tokens=1000)).train(log_every=0)
    assert rep.stream["segments"] == 3 and rep.total_words == len(ids)
    for k, v in st.params.items():
        assert v.shape[-1] == 16 and bool(torch.isfinite(v).all()), k
