"""The port's one-process data parallelism (word2vec_tpu_torch/parallel/)
against the JAX package's ShardedTrainer at tp = sp = 1, and against
itself (CPU, the JAX side on the 8 virtual CPU devices of conftest.py).

Pins:
  * the dp = 2 step (one runner a replica, replica r on rows
    [r*B, (r+1)*B) with its own draws) is BITWISE two single-device port
    steps on the row halves with the replica draws, and matches JAX's
    make_sharded_step fed the same draws (fold_in(key, r)) within
    torch_parity.assert_params_close (f32 within atol 1e-6); its metrics,
    health counters included, are the replica sums and match JAX's psum'd
    ones (rtol 1e-5, counts exact);
  * make_sync equals JAX's make_sync BITWISE at dp = 2 and 4, and
    make_delta_sync equals JAX's make_delta_sync BITWISE at dp = 2 and 4
    (XLA's CPU all-reduce sums a bf16 operand in float32 and rounds once;
    the port does the same); the replicas are bitwise equal afterwards and
    the sync writes into the replicas' own tensors;
  * ShardedTrainer(dp=2), mean and delta sync, against JAX's
    ShardedTrainer(dp=2) over the same corpus, initial tables and draws
    (the port's draws_hook(step, sub, replica) fed
    fold_in(fold_in(base, step), r)): tables within atol 1e-6, equal
    total_words and loss history within rtol 1e-5;
  * BITWISE inside the port: ShardedTrainer(dp=1) == Trainer, chunked ==
    per-step and resident == streaming at dp = 2 (mean and delta),
    resumed mid-epoch == uninterrupted, each kernel route at dp = 2 ==
    its per-replica single-device steps (ROADMAP C10: every route trains
    under the mesh; JAX refuses the Pallas routes there), a preempted run
    stopped on a sync boundary resumes onto the uninterrupted one;
  * the model and seq axes build, and refuse the kernel routes; the mesh
    refuses more replicas than devices with the JAX message;
  * the quality probe scores the synced export (a due probe forces the
    pending sync) and records what a single-device probe of the same
    tables records; the planner's constraints and shapes; a nan fault
    fills every replica; the supervisor's rollback lands in every
    replica's buffers; a stream of segments trains under dp = 2.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus  # noqa: E402
from word2vec_tpu.data.vocab import Vocab as JVocab  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.parallel import ShardedTrainer as JSharded  # noqa: E402
from word2vec_tpu.parallel import make_mesh as j_mesh  # noqa: E402
from word2vec_tpu.parallel import make_sharded_step as j_sharded_step  # noqa: E402
from word2vec_tpu.parallel import make_sync as j_sync  # noqa: E402
from word2vec_tpu.parallel import replicate_params as j_replicate  # noqa: E402
from word2vec_tpu.parallel.trainer import make_delta_sync as j_delta  # noqa: E402

import torch_parity as tp_  # noqa: E402
from word2vec_tpu_torch import Trainer, TrainState, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.device import seed_step  # noqa: E402
from word2vec_tpu_torch.models.params import params_from_numpy  # noqa: E402
from word2vec_tpu_torch.ops.band_step import BandStep  # noqa: E402
from word2vec_tpu_torch.ops.train_step import make_chunk_runner  # noqa: E402
from word2vec_tpu_torch.parallel import (  # noqa: E402
    ShardedTrainer, make_delta_sync, make_mesh, make_sync, replicate_params,
    unreplicate_params,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4, reason="needs 4 (virtual) devices"
)

CPU = torch.device("cpu")


def _mesh(dp):
    return make_mesh(dp, device="cpu")


# ------------------------------------------------------------ the step
def _dp_step(cfg, tt, params, tokens, alpha, hook=None, seed=3, step=5):
    """One dp step of the port: one runner a replica on its row block of
    tokens [dp*B, L] (the runners ShardedTrainer builds). Returns the
    replicas and the metrics {name: [dp]}."""
    dp = len(params)
    B = tokens.shape[0] // dp
    ms = []
    for r in range(dp):
        runner = make_chunk_runner(cfg, tt)
        runner.replica, runner.stride = r, dp
        runner.draws_hook = hook
        m = runner(params[r], torch.from_numpy(tokens[None, r * B:(r + 1) * B]),
                   seed, step, np.float32([alpha]))
        ms.append({k: float(v[0]) for k, v in m.items()})
    return params, {k: np.float32([m[k] for m in ms]) for k in ms[0]}


def _replica_sum(vals):
    acc = np.float32(vals[0])
    for v in vals[1:]:
        acc = np.float32(acc + np.float32(v))
    return acc


@pytest.mark.parametrize("backend", ["xla", "pallas_fused"])
def test_data_parallel_step_is_two_single_device_steps(backend):
    """Bitwise: replica r of the dp = 2 step is the single-device step on
    rows [r*B, (r+1)*B) with replica r's generator draws."""
    layout = "unified" if backend == "pallas_fused" else "split"
    cfg = Word2VecConfig(**tp_.kw(band_backend=backend, table_layout=layout))
    jcfg = JConfig(**tp_.kw(table_layout=layout))
    _, tt = tp_.tables()
    host = tp_.torch_params(j_init(jcfg, tp_.V, jax.random.key(1)), cfg)
    toks = np.concatenate([tp_.tokens(), np.roll(tp_.tokens(), 1, axis=0)])
    reps, _ = _dp_step(cfg, tt, replicate_params(host, _mesh(2)), toks, 0.03)
    for r in range(2):
        p = {k: v.clone() for k, v in host.items()}
        step = BandStep(cfg, tt)
        gen = torch.Generator()
        seed_step(gen, 3, 5, r)
        sub = torch.from_numpy(toks[r * tp_.B:(r + 1) * tp_.B])
        step.apply(p, sub, step.draw(gen, sub), 0.03)
        tp_.assert_params_bitwise(reps[r], p)
    assert any(not torch.equal(reps[0][k], reps[1][k]) for k in reps[0])


def test_data_parallel_matches_manual_shards_and_jax():
    """tests/test_parallel.py:75-109 on the port: the dp = 2 step against
    JAX's sharded step fed the same draws, its metrics (health counters
    included) the replica sums of JAX's psum, then the mean sync against
    JAX's: bitwise, every replica equal."""
    kw = tp_.kw(health_metrics=True)
    jcfg, cfg = JConfig(**kw), Word2VecConfig(**kw)
    jt, tt = tp_.tables()
    jp = j_init(jcfg, tp_.V, jax.random.key(1))
    toks = np.concatenate([tp_.tokens(), np.roll(tp_.tokens(), 2, axis=1)])
    key = jax.random.key(42)
    mesh = j_mesh(dp=2, tp=1)
    jout, jm = jax.jit(j_sharded_step(jcfg, jt, mesh))(
        j_replicate(jp, mesh), jnp.asarray(toks), key, jnp.float32(0.02))
    step = BandStep(cfg, tt)
    reps, tm = _dp_step(
        cfg, tt, replicate_params(tp_.torch_params(jp, cfg), _mesh(2)), toks,
        0.02, hook=lambda s, sub, r: tp_.jax_draws(step, jax.random.fold_in(key, r), jt))
    for r in range(2):
        tp_.assert_params_close(reps[r], {k: v[r] for k, v in jout.items()}, kw)
    assert set(jm) <= set(tm)
    for k in jm:
        got, want = _replica_sum(tm[k]), float(jm[k])
        if k in ("pairs", "clip_engaged", "nonfinite_loss", "nonfinite_params"):
            assert got == want, k
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=k)
    # the sync of the JAX replicas: bitwise JAX's, every replica equal
    host = [{k: torch.from_numpy(np.array(v[r])) for k, v in jout.items()}
            for r in range(2)]
    ptrs = [{k: v.data_ptr() for k, v in p.items()} for p in host]
    out = make_sync(_mesh(2))(host)
    want = j_sync(mesh)(jout)
    for r in range(2):
        assert {k: v.data_ptr() for k, v in out[r].items()} == ptrs[r]  # in place
        for k in want:
            np.testing.assert_array_equal(out[r][k].numpy().view(np.uint32),
                                          np.asarray(want[k][r]).view(np.uint32))


def _drifted(dp, dtype=np.float32, seed=0):
    """Replicas of one base table with per-replica SGD-scale drift (the
    JAX test's data, tests/test_parallel.py:360-387)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(40, 8)).astype(np.float32)
    drift = rng.normal(scale=1e-2, size=(dp, 40, 8)).astype(np.float32)
    drift[:, :3] *= 1e3  # a few rows far from the base: rounding matters
    return base, base[None] + drift


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("mode", ["mean", "delta"])
def test_sync_matches_jax_bitwise(dp, mode):
    base, reps = _drifted(dp)
    jmesh = j_mesh(dp=dp, tp=1)
    jparams = {"emb_in": jnp.asarray(reps)}
    tparams = [{"emb_in": torch.from_numpy(reps[r].copy())} for r in range(dp)]
    if mode == "mean":
        want = j_sync(jmesh)(jparams)
        got = make_sync(_mesh(dp))(tparams)
    else:
        jbase = j_replicate({"emb_in": base}, jmesh)
        want = j_delta(jmesh)(jparams, jbase)
        tbase = {"emb_in": torch.from_numpy(base.copy())}
        got = make_delta_sync(_mesh(dp))(tparams, tbase)
        # the next base is the synced tables, in its own buffer
        np.testing.assert_array_equal(tbase["emb_in"].numpy(), got[0]["emb_in"].numpy())
        assert tbase["emb_in"].data_ptr() != got[0]["emb_in"].data_ptr()
    w = np.asarray(want["emb_in"])
    for r in range(dp):
        np.testing.assert_array_equal(got[r]["emb_in"].numpy().view(np.uint32),
                                      w[r].view(np.uint32))
        np.testing.assert_array_equal(got[r]["emb_in"].numpy(), got[0]["emb_in"].numpy())


def test_delta_sync_tracks_mean_sync_and_bf16_tables():
    """tests/test_parallel.py:360-387: delta tracks the mean to bf16 of
    the delta; bf16 tables sync to JAX's bits too."""
    base, reps = _drifted(4, seed=1)
    tbase = {"emb_in": torch.from_numpy(base.copy())}
    d = make_delta_sync(_mesh(4))(
        [{"emb_in": torch.from_numpy(reps[r].copy())} for r in range(4)], tbase)
    m = make_sync(_mesh(4))([{"emb_in": torch.from_numpy(reps[r].copy())} for r in range(4)])
    ok = np.abs(reps - base[None]).max(axis=(0, 2)) < 1  # the undrifted rows
    np.testing.assert_allclose(d[0]["emb_in"].numpy()[ok], m[0]["emb_in"].numpy()[ok],
                               atol=1e-4)
    jmesh = j_mesh(dp=2, tp=1)
    b16 = jnp.asarray(reps[:2]).astype(jnp.bfloat16)
    want = np.asarray(j_sync(jmesh)({"t": b16})["t"].astype(jnp.float32))
    got = make_sync(_mesh(2))([
        {"t": torch.from_numpy(np.asarray(b16[r].astype(jnp.float32))).to(torch.bfloat16)}
        for r in range(2)])
    for r in range(2):
        np.testing.assert_array_equal(got[r]["t"].float().numpy(), want[r])


# ----------------------------------------------------- the trainer vs JAX
SHARD_KW = dict(model="sg", train_method="ns", negative=3, word_dim=16,
                window=3, min_count=1, subsample_threshold=1e-3, iters=2,
                batch_rows=4, max_sentence_len=24, band_chunk=8,
                shared_negatives=8, seed=11, dp_sync_every=4,
                init_alpha=0.05)


def _both_trainers(**over):
    """(port ShardedTrainer, JAX ShardedTrainer, JAX vocab size) at dp = 2
    on torch_parity.small_corpus, the port fed the JAX trainer's draws,
    both starting from the JAX trainer's initial tables."""
    kw = dict(SHARD_KW, **over)
    vocab, corpus = tp_.small_corpus()
    jv = JVocab(list(vocab.words), vocab.counts.copy())
    jc = JCorpus(corpus.flat.copy(), corpus.row_starts.copy(), corpus.row_lens.copy())
    jtr = JSharded(JConfig(**kw), jv, jc, dp=2)
    ttr = ShardedTrainer(Word2VecConfig(**kw), vocab, corpus, dp=2, device="cpu")
    jstate = jtr.init_state()
    tstate = TrainState(params=None)
    host = {k: np.asarray(v[0]) for k, v in jstate.params.items()}
    ttr.import_params(params_from_numpy(host, ttr.config, "cpu"), tstate)
    step = BandStep(ttr.config, ttr.tables)
    base = jax.random.key(ttr.run_seed ^ 0x5EED)
    ttr.draws_hook = lambda s, sub, r: tp_.jax_draws(
        step, jax.random.fold_in(jax.random.fold_in(base, s), r), jtr.tables)
    return ttr, tstate, jtr, jstate, len(vocab)


@pytest.mark.parametrize("mode,chunk", [("mean", 1), ("delta", 1), ("mean", 0)])
def test_sharded_trainer_matches_jax(monkeypatch, mode, chunk):
    """tests/test_parallel.py:126-145 and :390-413 at dp = 2, tp = 1."""
    ttr, ts, jtr, js, nv = _both_trainers(sync_mode=mode, chunk_steps=chunk)
    monkeypatch.setattr(tp_, "V", nv)
    monkeypatch.setattr(tp_, "B", SHARD_KW["batch_rows"])
    monkeypatch.setattr(tp_, "L", SHARD_KW["max_sentence_len"])
    ts, trep = ttr.train(state=ts, log_every=3)
    js, jrep = jtr.train(state=js, log_every=3)
    assert ts.step == js.step == trep.steps and trep.total_words == jrep.total_words
    assert len(trep.loss_history) == len(jrep.loss_history) > 2
    np.testing.assert_allclose(trep.loss_history, jrep.loss_history, rtol=1e-5)
    want = jtr.export_params(js)
    tp_.assert_params_close(ttr.export_params(ts), want, SHARD_KW)
    live = ttr._replicas
    for k in ts.params:  # the run ends on a sync: replicas equal, returned
        assert torch.equal(live[0][k], live[1][k])
        assert torch.equal(ts.params[k], live[0][k])


# --------------------------------------------------- bitwise in the port
def _sharded(route=("xla", "split"), dp=2, **over):
    """A dp trainer on a corpus of 32 batches: 16 global steps an epoch, a
    whole number of chunks of 2 and 4 (a partial chunk at an epoch's end
    moves the next sync to that chunk's boundary, as in the JAX trainer)."""
    vocab, corpus = tp_.small_corpus(2350)
    over.setdefault("dp_sync_every", 4)
    return ShardedTrainer(tp_.trainer_cfg(route, iters=2, **over), vocab, corpus,
                          dp=dp, device="cpu")


@pytest.mark.parametrize("route", tp_.ROUTES + list(tp_.STEP_ROUTES),
                         ids=tp_.ROUTE_IDS + list(tp_.STEP_ROUTES))
def test_dp1_is_trainer_bitwise(route):
    over = tp_.STEP_ROUTES.get(route, {}) if isinstance(route, str) else {}
    r = ("xla", "split") if isinstance(route, str) else route
    vocab, corpus = tp_.small_corpus(2000)
    cfg = tp_.trainer_cfg(r, chunk_steps=3, **over)
    a, ra = Trainer(cfg, vocab, corpus, device="cpu").train(log_every=2)
    s = ShardedTrainer(cfg, vocab, corpus, dp=1, device="cpu")
    b, rb = s.train(log_every=2)
    tp_.assert_params_bitwise(a.params, b.params)
    tp_.assert_params_bitwise(a.params, unreplicate_params(s._replicas))
    assert (ra.steps, ra.total_words, ra.loss_history) == (rb.steps, rb.total_words,
                                                          rb.loss_history)
    tp_.assert_params_bitwise(a.params, s.export_params(b))


@pytest.mark.parametrize("route", tp_.ROUTES, ids=tp_.ROUTE_IDS)
def test_kernel_routes_train_under_dp_bitwise_per_replica(route):
    """ROADMAP C10: every kernel route trains at dp = 2; one global step
    equals the route's single-device step per replica, with the replica
    draws, bitwise; the trainer's state after the step is those replicas."""
    tr = _sharded(route, dp_sync_every=0)
    tr._finalize = lambda s: None  # the replicas before the run's final sync
    state0 = tr.init_state()
    start = [{k: v.clone() for k, v in state0.params.items()} for _ in range(2)]
    _, rep = tr.train(state=state0, log_every=0, max_steps=1)
    assert rep.steps == 1 and rep.total_words > 0
    cfg, B = tr.config, tr.config.batch_rows
    from word2vec_tpu_torch.data.batcher import BatchIterator

    batcher = BatchIterator(tr.corpus, B, cfg.max_sentence_len, seed=tr.run_seed)
    toks = np.concatenate([t for t, _ in list(batcher.epoch(0))[:2]])
    alpha = np.float32(tr.alpha_at(0))
    for r in range(2):
        runner = make_chunk_runner(cfg, tr.tables)  # single-device runner
        gen = torch.Generator()

        def hook(step, sub, r=r):
            seed_step(gen, tr.run_seed, step, r)
            return runner.step.draw(gen, torch.from_numpy(toks[r * B:(r + 1) * B]))

        runner.draws_hook = hook
        runner(start[r], torch.from_numpy(toks[None, r * B:(r + 1) * B]),
               tr.run_seed, 0, np.float32([alpha]))
        tp_.assert_params_bitwise(tr._replicas[r], start[r])


def test_mesh_axes_and_refusals():
    """The model and seq axes build (ROADMAP A8b, tests/test_torch_tp_sp.py
    holds them against JAX); the kernel routes are refused under them."""
    assert make_mesh(1, tp=2, device="cpu").shape == {"data": 1, "seq": 1, "model": 2}
    assert make_mesh(2, sp=2, device="cpu").shape == {"data": 2, "seq": 2, "model": 1}
    vocab, corpus = tp_.small_corpus()
    assert ShardedTrainer(tp_.trainer_cfg(), vocab, corpus, dp=2, tp=2,
                          device="cpu").reps == 2
    with pytest.raises(ValueError, match="single-chip only"):
        ShardedTrainer(tp_.trainer_cfg(("pallas", "split")), vocab, corpus, dp=2,
                       tp=2, device="cpu")
    with pytest.raises(ValueError, match=r"mesh \(3x1x1\) needs 3 devices, have 2"):
        make_mesh(3, devices=["cpu", "cpu"])
    m = make_mesh(2, device="cpu")
    assert m.shape == {"data": 2, "seq": 1, "model": 1} and m.cards == [CPU]


@pytest.mark.parametrize("mode", ["mean", "delta"])
def test_sharded_chunked_and_resident_match_per_step(mode):
    """tests/test_parallel.py:416-440, bitwise in the port: chunk 0 (auto,
    capped to divide the sync interval), chunk 3 (capped to 2) and the
    resident corpus equal the per-step run."""
    ref, _ = _sharded(chunk_steps=1, sync_mode=mode).train(log_every=0)
    losses = {}
    for over in (dict(chunk_steps=0), dict(chunk_steps=3),
                 dict(chunk_steps=4, resident="off"),
                 dict(chunk_steps=4, resident="on")):
        tr = _sharded(sync_mode=mode, **over)
        st, rep = tr.train(log_every=0)
        assert (st.step, st.words_done) == (ref.step, ref.words_done), over
        tp_.assert_params_bitwise(st.params, ref.params)
        for r in range(2):
            tp_.assert_params_bitwise(tr._replicas[r], ref.params)
        losses[over.get("resident")] = rep.final_loss
        if over.get("resident") == "on":
            assert rep.resident["resolved"] == "resident"
    assert losses["on"] == losses["off"]
    assert _sharded(chunk_steps=3, sync_mode=mode)._resolve_chunk_len(
        _batcher(tr)) == 2


def _batcher(tr):
    from word2vec_tpu_torch.data.batcher import BatchIterator

    return BatchIterator(tr.corpus, tr.config.batch_rows, tr.config.max_sentence_len,
                         seed=tr.run_seed)


@pytest.mark.parametrize("mode,chunk", [("mean", 2), ("delta", 1)])
def test_mid_epoch_resume_matches_uninterrupted(tmp_path, mode, chunk):
    """After tests/test_resume.py:144-190 at tp = 1: a checkpoint of the
    synced, unreplicated tables at a mid-epoch global step, resumed by a
    fresh trainer, lands bitwise on the uninterrupted run (checkpoints
    land on sync boundaries, so they force no extra sync)."""
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint

    full = _sharded(chunk_steps=chunk, sync_mode=mode)
    fs, _ = full.train(log_every=0)
    ck = str(tmp_path / "ck")
    a = _sharded(chunk_steps=chunk, sync_mode=mode)
    spe = a._agreed_steps_per_epoch(_batcher(a))
    saved = {}

    def cb(s):
        if not saved and s.epoch == 1 and s.step > spe:
            save_checkpoint(ck, TrainState(a.export_params(s), s.step, s.words_done,
                                           s.epoch), a.config, a.vocab)
            saved["step"] = s.step

    a.train(log_every=0, checkpoint_cb=cb, checkpoint_every=4)
    assert saved and saved["step"] % 4 == 0
    st, ck_cfg, _ = load_checkpoint(ck)
    assert st.params["emb_in"].dim() == 2
    b = _sharded(chunk_steps=chunk, sync_mode=mode)
    b.import_params(st.params, st)
    rs, _ = b.train(state=st, log_every=0)
    assert rs.step == fs.step and rs.words_done == fs.words_done
    tp_.assert_params_bitwise(rs.params, fs.params)
    for r in range(2):
        tp_.assert_params_bitwise(b._replicas[r], full._replicas[r])


def test_preempted_on_a_sync_boundary_resumes_bitwise():
    """tests/test_resilience.py:387-415: a stop on a sync boundary, the
    exported tables handed to a fresh trainer, lands on the uninterrupted
    run."""
    whole = _sharded(chunk_steps=1)
    full, _ = whole.train(log_every=0)
    t = _sharded(chunk_steps=1)
    t.stop_check = lambda step: step >= 8 and step % 4 == 0
    st, rep = t.train(log_every=0)
    assert rep.interrupted == "preempted" and st.step == 8
    host = TrainState(t.export_params(st), st.step, st.words_done, st.epoch)
    t2 = _sharded(chunk_steps=1)
    t2.import_params(host.params, host)
    st2, _ = t2.train(state=host, log_every=0)
    tp_.assert_params_bitwise(st2.params, full.params)
    for r in range(2):
        tp_.assert_params_bitwise(t2._replicas[r], whole._replicas[r])


def test_sync_cadence_and_in_place_buffers():
    """Syncs every dp_sync_every // micro_steps dispatch steps, in the
    replica_sync span, into the buffers the graphs were captured on; a
    single-device checkpoint's tables land in both replicas."""
    tr = _sharded(chunk_steps=1, dp_sync_every=4, micro_steps=2)
    syncs = []
    inner = tr._run_sync
    tr._run_sync = lambda p: (syncs.append(tr.last_state.step), inner(p))[1]
    st, rep = tr.train(log_every=0, max_steps=7)
    assert syncs == [2, 4, 6, 7]  # every 2 dispatch steps, then the final one
    assert rep.phases["phases"]["replica_sync"]["count"] == 4
    # the caller's copy of the synced tables, not the replicas' buffers
    assert isinstance(st.params, dict)
    assert all(st.params[k].data_ptr() != v.data_ptr() for k, v in tr._replicas[0].items())
    live = tr._replicas
    single, _ = Trainer(tr.config, tr.vocab, tr.corpus, device="cpu").train(
        log_every=0, max_steps=2)
    s2 = TrainState(params=None, step=2)
    tr.import_params(single.params, s2)
    assert s2.params is live  # the captured buffers, filled in place
    for r in range(2):
        tp_.assert_params_bitwise(live[r], single.params)


def test_quality_probe_forces_the_pending_sync():
    """tests/test_quality.py:218-240: the probe scores the synced export,
    recording what a single-device probe of the same tables records."""
    from word2vec_tpu_torch.obs.quality import ProbeSet, QualityProbe

    tr = _sharded(chunk_steps=1, dp_sync_every=64)
    pset = ProbeSet.synthesize(tr.vocab)
    tr.quality_probe = QualityProbe(tr.vocab, pset, every=3)
    syncs = []
    inner = tr._run_sync
    tr._run_sync = lambda p: (syncs.append(tr.last_state.step), inner(p))[1]
    tr.train(log_every=0, max_steps=7)
    assert syncs == [3, 6, 7] and tr.quality_probe.probes == 2
    tr._replicas[1]["emb_in"].add_(0.25)  # replicas apart: a sync is pending
    tr._last_sync_step = 1
    reps = [{k: v.clone() for k, v in p.items()} for p in tr._replicas]
    got = QualityProbe(tr.vocab, pset, every=1).probe(
        tr.export_params(TrainState(tr._replicas, step=3)), step=3)
    assert tr._last_sync_step == 3
    for k in reps[0]:
        assert torch.equal(tr._replicas[0][k], tr._replicas[1][k])
        assert torch.equal(tr._replicas[0][k], (reps[0][k] + reps[1][k]) * 0.5)
    want = QualityProbe(tr.vocab, pset, every=1).probe(
        {k: v.clone() for k, v in tr._replicas[0].items()}, step=3)
    got.pop("quality_probe_ms"), want.pop("quality_probe_ms")
    assert got == want


def test_planner_constraints_and_shapes():
    """tests/test_tune.py:658 at tp = 1, with ROADMAP C10's departure:
    the kernel routes are allowed under the mesh."""
    tr = _sharded(chunk_steps=8, dp_sync_every=6)
    sh = tr.plan_shapes()
    assert sh["dp"] == 2 and sh["rows_per_dispatch"] == 2 * tr.config.batch_rows
    assert sh["chunk_len"] == 6 and sh["tp"] == sh["sp"] == 1
    c = tr.plan_constraints()
    assert c["allow_pallas"] is True and c["dp"] == 2
    from word2vec_tpu_torch.tune.planner import candidate_grid

    backends = {p.band_backend for p in candidate_grid(
        tr.config, len(tr.vocab), dict(c, platform="gpu"))}
    assert {"pallas", "pallas_oa", "pallas_fused"} <= backends


def test_nan_fault_and_supervisor_rollback_reach_every_replica(tmp_path):
    from word2vec_tpu_torch.io.checkpoint import save_checkpoint
    from word2vec_tpu_torch.resilience.faults import FaultPlan
    from word2vec_tpu_torch.resilience.supervisor import Supervisor

    tr = _sharded(chunk_steps=1, divergence_budget=2)
    ck = str(tmp_path / "ck")
    tr.fault_plan = FaultPlan.parse("nan@6")

    def cb(s):
        save_checkpoint(ck, TrainState(tr.export_params(s), s.step, s.words_done,
                                       s.epoch), tr.config, tr.vocab)

    sup = Supervisor(tr, checkpoint_dir=ck, max_retries=1)
    st, rep = sup.run(log_every=0, checkpoint_cb=cb, checkpoint_every=4)
    assert len(rep.recoveries) == 1 and rep.recoveries[0]["rolled_back_to"] == "step 4"
    assert tr.fault_plan.log and tr.fault_plan.log[0]["at_step"] == 6
    live = tr._replicas
    for p in live:
        assert all(bool(torch.isfinite(v).all()) for v in p.values())
    for k in st.params:
        assert torch.equal(live[0][k], live[1][k])
        assert torch.equal(st.params[k], live[0][k])


def test_stream_run_trains_under_dp():
    from word2vec_tpu_torch.stream import StreamRun
    from word2vec_tpu_torch.stream.source import ArraySource

    vocab, corpus = tp_.small_corpus(3000)
    ids = np.asarray(corpus.flat)
    cfg = tp_.trainer_cfg(chunk_steps=2, dp_sync_every=4, corpus_mode="streaming",
                          segment_tokens=1000)
    tr = ShardedTrainer(cfg, vocab, PackedCorpus_of(ids[:1000]), dp=2, device="cpu")
    run = StreamRun(tr, ArraySource(ids, segment_tokens=1000))
    st, rep = run.train(log_every=0)
    assert rep.stream["segments"] == 3 and rep.total_words == len(ids)
    live = tr._replicas
    for k in st.params:
        assert torch.equal(live[0][k], live[1][k])
        assert torch.equal(st.params[k], live[0][k])
        assert bool(torch.isfinite(st.params[k]).all())


def PackedCorpus_of(ids):
    from word2vec_tpu_torch import PackedCorpus

    return PackedCorpus.from_flat(ids, 24)
