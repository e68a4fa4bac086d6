"""The port's continuous-training plane (word2vec_tpu_torch/stream/ and the
trainer's streaming hooks) against the JAX package's on the same inputs,
on the CPU, plus the port's own contracts.

Against the JAX package (JAX on the CPU, as its own tests run it):
  * sources: the same files, lines and pipe bytes give equal RawSegment
    fields (sentences or flat ids, counts, shard / offset pairs,
    exhausted) and equal cursors, through the whole stream;
  * vocabulary: admission_order, Vocab.admit and encode_segment;
  * tables: after a growth the port's DeviceTables (keep probabilities,
    alias accept / idx) are bitwise the JAX package's DeviceTables.build;
  * the swap gate: the same decision, the score within 1e-6;
  * the driver: JAX's StreamRun and the port's over one source emit the
    same record sequence with the same keys and values (no timing or loss
    field is among them), the same report.stream and cursor document.
    Draws differ by construction (the threefry streams cannot be made in
    torch), so params are not compared across packages.

The port alone: the mid-stream SIGTERM resume is bitwise (chunk_steps 1
and 4, stopped in segment 0 and after a growth), and so is a
boundary-checkpoint resume; reserved rows keep their init bits until
admitted; segment s draws what a fresh trainer seeded seed + s draws; a
growth drops the cached runners and the next dispatch rebuilds the step
on the new tables (an admitted id is drawn as a negative after the growth,
never before it), while segments between growths reuse their runner; the
producer-death contracts; stream faults fire at segments, not at steps;
the hot swap loses no query under concurrent clients.
"""

import dataclasses
import os
import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from word2vec_tpu.config import Word2VecConfig as JConfig
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus
from word2vec_tpu.data.vocab import Vocab as JVocab
from word2vec_tpu.obs.quality import ProbeSet as JProbeSet
from word2vec_tpu.ops.tables import DeviceTables as JTables
from word2vec_tpu.resilience.faults import FaultPlan as JFaultPlan
from word2vec_tpu.stream import driver as jdriver
from word2vec_tpu.stream import source as jsource
from word2vec_tpu.train import Trainer as JTrainer

from word2vec_tpu_torch import train as train_mod
from word2vec_tpu_torch.config import Word2VecConfig
from word2vec_tpu_torch.data.batcher import PackedCorpus
from word2vec_tpu_torch.data.vocab import Vocab
from word2vec_tpu_torch.io.checkpoint import (
    load_checkpoint_with_path, read_stream_cursor, save_checkpoint,
)
from word2vec_tpu_torch.models.params import logical_table
from word2vec_tpu_torch.obs.quality import ProbeSet
from word2vec_tpu_torch.resilience.faults import FaultPlan
from word2vec_tpu_torch.serve.query import QueryEngine
from word2vec_tpu_torch.stream import (
    ArraySource, FileSource, PipeSource, StreamCursor, StreamRun,
    admission_order, make_source, resolve_shards,
)
from word2vec_tpu_torch.stream.driver import encode_segment, gate_table, prefetch
from word2vec_tpu_torch.train import TrainState, Trainer
from word2vec_tpu_torch.utils.synthetic import graded_pair_corpus

SEG = 400  # segment_tokens of the trainer-level tests


# --------------------------------------------------------------- fixtures
def _write_shards(tmp_path, n_shards=2, tokens_per_shard=900, vocab_words=18,
                  new_words_from=None, seed=0):
    """Deterministic token files (tests/test_stream.py's fixture). With
    `new_words_from=k`, shard k and later mix in novel z-words frequent
    enough to be admission candidates."""
    rng = np.random.default_rng(seed)
    base = [f"w{i:02d}" for i in range(vocab_words)]
    novel = [f"z{i}" for i in range(5)]
    paths = []
    for s in range(n_shards):
        toks = []
        for t in range(tokens_per_shard):
            if new_words_from is not None and s >= new_words_from and t % 7 == 0:
                toks.append(novel[rng.integers(len(novel))])
            else:
                toks.append(base[rng.integers(len(base))])
        p = tmp_path / f"shard_{s:02d}.txt"
        p.write_text(" ".join(toks) + "\n")
        paths.append(str(p))
    return paths


def _cfg_kw(**kw):
    base = dict(
        model="sg", train_method="ns", negative=3, word_dim=16, window=2,
        batch_rows=4, max_sentence_len=16, min_count=1, iters=1, seed=9,
        corpus_mode="streaming", chunk_steps=1,
    )
    base.update(kw)
    return base


def _stream_cfg(**kw):
    return Word2VecConfig(**_cfg_kw(**kw))


def _bootstrap(shards, cfg, segment_tokens=SEG, vocab=None):
    """The CLI's streaming bootstrap, compact: vocab from segment 0, the
    trainer built on the segment-0 corpus, on the CPU."""
    src = FileSource(shards, fmt="text8", segment_tokens=segment_tokens)
    boot = src.read_segment(0, 0, 0, vocab=None)
    if vocab is None:
        vocab = Vocab.from_counter(boot.counts, min_count=cfg.min_count)
    flat = encode_segment(boot, vocab, "text8")
    corpus = PackedCorpus.from_flat(flat, cfg.max_sentence_len)
    with pytest.warns(UserWarning):  # the tiny corpus's geometry warning
        trainer = Trainer(cfg, vocab, corpus, device="cpu")
    return trainer, src, vocab


def _host(params):
    return {k: v.detach().clone() for k, v in params.items()}


def _bitwise(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _boundary_stopper(n):
    """A cooperative stop that fires at the n-th observed boundary."""
    calls = {"n": 0}

    def stop(step):
        calls["n"] += 1
        return calls["n"] >= n

    return stop


def _seg_fields(raw):
    d = dataclasses.asdict(raw)
    d["flat"] = None if raw.flat is None else raw.flat.tolist()
    d["counts"] = None if raw.counts is None else dict(raw.counts)
    return d


def _read_all(src, first=(0, 0, 0)):
    """Every segment of a source from `first` on, as the driver reads them."""
    out = []
    cur = first
    while True:
        raw = src.read_segment(*cur)
        out.append(_seg_fields(raw))
        if raw.raw_tokens == 0 or raw.exhausted:
            return out
        cur = (raw.index + 1, raw.shard1, raw.offset1)


def _feed_pipe(payload: bytes):
    r, w = os.pipe()

    def feed():
        os.write(w, payload)
        os.close(w)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    return r, t


# ------------------------------------------------- sources, JAX vs port
@pytest.mark.parametrize("fmt,segment_tokens", [
    ("text8", 500), ("text8", 700), ("lines", 40), ("lines", 230),
])
def test_file_sources_equal_jax(tmp_path, fmt, segment_tokens):
    if fmt == "text8":
        shards = _write_shards(tmp_path, n_shards=3, tokens_per_shard=700,
                               new_words_from=1)
    else:
        shards = []
        for s in range(2):
            p = tmp_path / f"l{s}.txt"
            p.write_text("\n".join(
                f"s{s}_{i} a b c" + " d" * (i % 3) for i in range(50)) + "\n\n")
            shards.append(str(p))
    spec = ",".join(shards)
    t = FileSource(resolve_shards(spec), fmt=fmt, segment_tokens=segment_tokens,
                   chunk_words=64)
    j = jsource.FileSource(jsource.resolve_shards(spec), fmt=fmt,
                           segment_tokens=segment_tokens, chunk_words=64)
    assert t.describe() == j.describe()
    segs = _read_all(t)
    assert segs == _read_all(j)
    assert len(segs) > 1
    # a re-read from a middle cursor, counted against a vocabulary
    mid = segs[len(segs) // 2]
    words = sorted({w for s in segs[:1] for w in s["counts"]})
    tv, jv = Vocab(words, np.ones(len(words))), JVocab(words, np.ones(len(words)))
    at = (mid["index"], mid["shard0"], mid["offset0"])
    assert _seg_fields(t.read_segment(*at, vocab=tv)) == \
        _seg_fields(j.read_segment(*at, vocab=jv))


def test_resolve_shards_equal_jax(tmp_path):
    for name in ("b.txt", "a.txt", "c.dat"):
        (tmp_path / name).write_text("x y")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "d.txt").write_text("z")
    for spec in (str(tmp_path / "*.txt"), str(sub),
                 f"{tmp_path / 'c.dat'},{tmp_path / 'a.txt'}"):
        assert resolve_shards(spec) == jsource.resolve_shards(spec)
    for bad in (str(tmp_path / "missing.txt"), str(tmp_path / "no*.match")):
        with pytest.raises(FileNotFoundError):
            resolve_shards(bad)
        with pytest.raises(FileNotFoundError):
            jsource.resolve_shards(bad)


@pytest.mark.parametrize("fmt", ["text8", "lines"])
def test_pipe_sources_equal_jax_and_replay(tmp_path, fmt):
    if fmt == "text8":
        payload = " ".join(f"t{i % 37}" for i in range(1000)).encode()
    else:
        payload = "\n".join(
            " ".join(f"t{(i * 7 + k) % 29}" for k in range(3 + i % 5))
            for i in range(150)).encode() + b"\n"
    segs = {}
    for name, mod in (("port", None), ("jax", jsource)):
        r, t = _feed_pipe(payload)
        spool = str(tmp_path / f"spool_{name}")
        cls = PipeSource if mod is None else mod.PipeSource
        src = cls(fd=r, spool_dir=spool, fmt=fmt, segment_tokens=300)
        segs[name] = _read_all(src)
        t.join(timeout=5)
        os.close(r)
        segs[name + "_files"] = sorted(os.listdir(spool))
        # the spool replays a segment the pipe can no longer give (lines
        # cut at the last newline of the buffered block: one segment here)
        again = cls(fd=r, spool_dir=spool, fmt=fmt, segment_tokens=300)
        i = min(1, sum(sg["raw_tokens"] > 0 for sg in segs[name]) - 1)
        assert _seg_fields(again.read_segment(i, i, 0)) == segs[name][i]
    assert segs["port"] == segs["jax"]
    assert segs["port_files"] == segs["jax_files"]
    assert segs["port"][-1]["exhausted"]


def test_array_source_and_make_source_equal_jax(tmp_path):
    flat = np.arange(10, dtype=np.int32)
    assert _read_all(ArraySource(flat, segment_tokens=4)) == \
        _read_all(jsource.ArraySource(flat, segment_tokens=4))
    p = tmp_path / "c.txt"
    p.write_text("a b c")
    assert isinstance(make_source(str(p)), FileSource)
    r, w = os.pipe()
    try:
        assert isinstance(make_source("-", spool_dir=str(tmp_path / "sp"), fd=r),
                          PipeSource)
        with pytest.raises(ValueError):
            make_source("-", fd=r)  # no spool dir: not resumable
    finally:
        os.close(r)
        os.close(w)
    c = StreamCursor(segment=3, shard=1, offset=7, vocab_generation=2,
                     tokens_total=9, global_steps=4, global_words=5)
    jc = jsource.StreamCursor(**c.to_json())
    assert c.to_json() == jc.to_json()
    assert StreamCursor.from_json({**c.to_json(), "schema": 1}) == c


# ----------------------------------------------- vocabulary, JAX vs port
def test_admission_admit_encode_equal_jax(tmp_path):
    counts = {"d": 3, "b": 5, "c": 5, "a": 99, "rare": 1, "e": 5, "zz": 2}
    for cap in (0, 2, 10):
        tv, jv = Vocab(["a"], np.array([10])), JVocab(["a"], np.array([10]))
        items = admission_order(counts, tv, min_count=2, cap=cap)
        assert items == jdriver.admission_order(counts, jv, min_count=2, cap=cap)
        assert tv.admit(items) == jv.admit(items)
        assert tv.words == jv.words
        np.testing.assert_array_equal(tv.counts, jv.counts)
        assert tv.content_hash() == jv.content_hash()
        assert tv.content_hash(limit=1) == jv.content_hash(limit=1)
    with pytest.raises(ValueError):
        tv.admit([("a", 1)])
    shards = _write_shards(tmp_path, n_shards=2, tokens_per_shard=SEG,
                           new_words_from=1)
    for fmt in ("text8", "lines"):
        t = FileSource(shards, fmt=fmt, segment_tokens=SEG, chunk_words=50)
        j = jsource.FileSource(shards, fmt=fmt, segment_tokens=SEG,
                               chunk_words=50)
        raw_t, raw_j = t.read_segment(1, 1, 0), j.read_segment(1, 1, 0)
        words = [w for w, _ in sorted(raw_t.counts.items(),
                                      key=lambda wc: (-wc[1], wc[0]))][:12]
        tv = Vocab(words, np.arange(len(words), 0, -1))
        jv = JVocab(words, np.arange(len(words), 0, -1))
        np.testing.assert_array_equal(
            encode_segment(raw_t, tv, fmt), jdriver.encode_segment(raw_j, jv, fmt))


# --------------------------------------------------- tables, JAX vs port
def test_grown_tables_bitwise_jax(tmp_path):
    shards = _write_shards(tmp_path, n_shards=2, tokens_per_shard=SEG,
                           new_words_from=1)
    cfg = _stream_cfg(vocab_reserve=8, subsample_threshold=1e-2)
    trainer, src, vocab = _bootstrap(shards, cfg)
    jvocab = JVocab(list(vocab.words), vocab.counts.copy())
    raw = src.read_segment(1, 1, 0, vocab=vocab)
    items = admission_order(raw.counts, vocab, 1, 8)
    assert items
    vocab.admit(items)
    jvocab.admit(items)
    trainer.refresh_vocab_tables()
    jt = JTables.build(jvocab, JConfig(**_cfg_kw(vocab_reserve=8,
                                                 subsample_threshold=1e-2)))
    for name in ("keep_probs", "alias_accept", "alias_idx"):
        got = getattr(trainer.tables, name).numpy()
        want = np.asarray(getattr(jt, name))
        assert got.dtype == want.dtype and got.shape == (len(vocab),), name
        np.testing.assert_array_equal(got, want, err_msg=name)


# ----------------------------------------------------- gate, JAX vs port
def test_gate_decisions_equal_jax():
    tokens, _ = graded_pair_corpus(n_pairs=32, pool_words=8, n_tokens=20_000,
                                   seed=3)
    vocab = Vocab.build([tokens], min_count=1)
    jvocab = JVocab(list(vocab.words), vocab.counts.copy())
    probe, jprobe = ProbeSet.synthesize(vocab), JProbeSet.synthesize(jvocab)
    assert probe.pairs == jprobe.pairs and len(probe.pairs) >= 32
    rng = np.random.default_rng(5)
    W = rng.normal(0, 0.1, (len(vocab), 12)).astype(np.float32)
    ok, rec = gate_table(W, vocab, probe, floor=-1.0, device="cpu")
    score = rec["score"]
    for floor in (score - 1e-3, score + 1e-3):
        ok, rec = gate_table(W, vocab, probe, floor=floor, device="cpu")
        jok, jrec = jdriver.gate_table(W, jvocab, jprobe, floor=floor)
        assert ok == jok == (floor < score)
        assert rec["gate"] == jrec["gate"] == "spearman"
        assert abs(rec["score"] - jrec["score"]) <= 1e-6
    flat = np.ones_like(W) * 0.1  # a collapsed table: refused by both
    ok, rec = gate_table(flat, vocab, probe, floor=0.35, device="cpu")
    jok, jrec = jdriver.gate_table(flat, jvocab, jprobe, floor=0.35)
    assert not ok and not jok
    # no golds at all: ungated in both
    plain = Vocab([f"w{i}" for i in range(20)], np.arange(20, 0, -1))
    ok, rec = gate_table(W[:20], plain, ProbeSet.synthesize(plain), 0.9,
                         device="cpu")
    assert ok and rec["gate"] == "none" and rec["score"] is None


# --------------------------------------------------- driver, JAX vs port
def _jax_bootstrap(shards, kw, segment_tokens=SEG):
    src = jsource.FileSource(shards, fmt="text8", segment_tokens=segment_tokens)
    boot = src.read_segment(0, 0, 0, vocab=None)
    vocab = JVocab.from_counter(boot.counts, min_count=kw["min_count"])
    corpus = JCorpus.from_flat(jdriver.encode_segment(boot, vocab, "text8"),
                               kw["max_sentence_len"])
    with pytest.warns(UserWarning):
        trainer = JTrainer(JConfig(**kw), vocab, corpus)
    return trainer, src, vocab


@pytest.mark.parametrize("kind", ["files", "array"])
def test_driver_records_equal_jax(tmp_path, kind):
    """One stream through both drivers: the same records in the same
    order (vocab_growth from the corpus on files, from the fault plan's
    vocab_growth@1 on the array source), the same report.stream and the
    same cursor document."""
    shards = _write_shards(tmp_path, n_shards=3, tokens_per_shard=SEG,
                           new_words_from=1)
    kw = _cfg_kw(vocab_reserve=8, chunk_steps=4)
    logs = {}
    for pkg in ("port", "jax"):
        if pkg == "port":
            tr, src, vocab = _bootstrap(shards, Word2VecConfig(**kw))
            run_cls, plan_cls = StreamRun, FaultPlan
        else:
            tr, src, vocab = _jax_bootstrap(shards, kw)
            run_cls, plan_cls = jdriver.StreamRun, JFaultPlan
        plan = None
        if kind == "array":
            ids = np.concatenate([
                np.asarray(vocab.encode(s))
                for s in FileSource(shards, segment_tokens=10**6)
                .read_segment(0, 0, 0).sentences])
            mod = jsource if pkg == "jax" else None
            src = (mod.ArraySource if mod else ArraySource)(ids, segment_tokens=SEG)
            plan = plan_cls.parse("vocab_growth@1:n=3,stream_stall@2:secs=0")
        recs = []
        run = run_cls(tr, src, fault_plan=plan, log_fn=recs.append)
        state, rep = run.train(log_every=0)
        logs[pkg] = dict(recs=recs, stream=rep.stream, meta=run.cursor_meta(),
                         words=list(vocab.words), steps=rep.steps,
                         total_words=rep.total_words,
                         fired=None if plan is None else plan.log)
    t, j = logs["port"], logs["jax"]
    assert [r.get("event") for r in t["recs"]] == [r.get("event") for r in j["recs"]]
    assert t["recs"] == j["recs"]
    kinds = {r.get("event") for r in t["recs"]}
    assert {"stream", "stream_segment", "vocab_growth"} <= kinds
    assert t["stream"] == j["stream"] and t["meta"] == j["meta"]
    assert t["meta"]["schema"] == 1
    assert t["words"] == j["words"]
    assert (t["steps"], t["total_words"]) == (j["steps"], j["total_words"])
    assert t["fired"] == j["fired"]


# ---------------------------------------- the port: resume and growth
def _run_full(shards, cfg):
    trainer, src, vocab = _bootstrap(shards, cfg)
    run = StreamRun(trainer, src)
    state, report = run.train(log_every=0)
    return _host(state.params), report, vocab


def _interrupt_and_resume(tmp_path, shards, cfg, stop_at):
    """Stop at the stop_at-th boundary, checkpoint with the cursor, then
    resume in a fresh trainer: (resumed params, report, vocab, run_a)."""
    trainer_a, src_a, vocab_a = _bootstrap(shards, cfg)
    run_a = StreamRun(trainer_a, src_a)
    trainer_a.stop_check = _boundary_stopper(stop_at)
    state_a, rep_a = run_a.train(log_every=0)
    assert rep_a.interrupted == "preempted"
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, state_a, trainer_a.config, vocab_a,
                    stream=run_a.cursor_meta())
    state_b, ck_cfg, ck_vocab, ck_dir = load_checkpoint_with_path(ck)
    doc = read_stream_cursor(ck_dir)
    assert doc is not None and doc["source"]["kind"] == "files"
    trainer_b, src_b, _ = _bootstrap(shards, ck_cfg, vocab=ck_vocab)
    run_b = StreamRun(trainer_b, src_b, cursor=StreamCursor.from_json(doc))
    state_b2, rep_b = run_b.train(state=state_b, log_every=0)
    return _host(state_b2.params), rep_b, trainer_b.vocab, run_a, rep_a


@pytest.mark.parametrize("chunk_steps,where", [
    (1, "segment0"), (4, "segment0"), (1, "after_growth"), (4, "after_growth"),
])
def test_mid_stream_sigterm_resume_bitwise(tmp_path, chunk_steps, where):
    growth = where == "after_growth"
    shards = _write_shards(tmp_path, n_shards=3, tokens_per_shard=SEG,
                           new_words_from=1 if growth else None)
    cfg = _stream_cfg(chunk_steps=chunk_steps, vocab_reserve=8 if growth else 0)
    full, full_rep, full_vocab = _run_full(shards, cfg)
    per_seg = -(-full_rep.steps // 3 // chunk_steps)  # boundaries a segment
    # segment 0: its 2nd boundary; after the growth: segment 2's first
    stop_at = 2 if not growth else 2 * per_seg + 1
    resumed, rep_b, vocab_b, run_a, rep_a = _interrupt_and_resume(
        tmp_path, shards, cfg, stop_at)
    cur = rep_a.stream["cursor"]
    if growth:
        assert full_rep.stream["growths"] >= 1 and run_a.growths >= 1
        assert cur["segment"] == 2 and cur["vocab_generation"] >= 1
    else:
        assert cur["segment"] == 0
    _bitwise(full, resumed)
    assert rep_b.stream["cursor"] == full_rep.stream["cursor"]
    assert vocab_b.words == full_vocab.words


def test_boundary_checkpoint_resume_bitwise(tmp_path):
    """Resume from a checkpoint taken exactly AT a segment boundary (step 0
    of the next segment), through the driver's boundary checkpoint."""
    shards = _write_shards(tmp_path, n_shards=2, tokens_per_shard=SEG)
    cfg = _stream_cfg(chunk_steps=4)
    full, _, _ = _run_full(shards, cfg)
    trainer_a, src_a, vocab_a = _bootstrap(shards, cfg)
    run_a = StreamRun(trainer_a, src_a, max_segments=1)
    ck = str(tmp_path / "ck")
    saved = []

    def save(s):
        saved.append(s.step)
        save_checkpoint(ck, s, trainer_a.config, vocab_a,
                        stream=run_a.cursor_meta())

    run_a.train(log_every=0, checkpoint_cb=save, checkpoint_every=1000)
    assert saved == [0]  # the boundary checkpoint alone
    state_b, ck_cfg, ck_vocab, ck_dir = load_checkpoint_with_path(ck)
    assert state_b.step == 0
    doc = read_stream_cursor(ck_dir)
    assert doc["segment"] == 1
    trainer_b, src_b, _ = _bootstrap(shards, ck_cfg, vocab=ck_vocab)
    run_b = StreamRun(trainer_b, src_b, cursor=StreamCursor.from_json(doc))
    state_b2, _ = run_b.train(state=state_b, log_every=0)
    _bitwise(full, _host(state_b2.params))


def test_reserved_rows_untouched_until_admitted(tmp_path):
    shards = _write_shards(tmp_path, n_shards=3, tokens_per_shard=SEG,
                           new_words_from=1)
    cfg = _stream_cfg(vocab_reserve=8, table_layout="unified",
                      band_backend="pallas_fused", band_chunk=8)
    trainer, src, vocab = _bootstrap(shards, cfg)
    v0 = len(vocab)
    state = trainer.init_state()
    init = _host(state.params)
    assert logical_table(state.params, "emb_in").shape[0] == v0 + 8
    seen = []

    class Watch(StreamRun):
        def _maybe_grow(self, raw):
            # before the boundary's admission: rows past the live vocab
            # hold their init bits, rows below it have trained
            n = len(self.trainer.vocab)
            live = self.trainer.last_state.params
            for k in live:
                assert torch.equal(live[k][n:], init[k][n:]), k
            seen.append(n)
            return super()._maybe_grow(raw)

    run = Watch(trainer, src)
    state, rep = run.train(state=state, log_every=0)
    assert rep.stream["growths"] >= 1 and len(vocab) > v0
    assert seen[0] == v0 and seen[-1] > v0
    assert vocab.words[v0:] == sorted(
        vocab.words[v0:], key=lambda w: (-vocab.counts[vocab[w]], w))
    final = _host(state.params)
    n = len(vocab)
    for k in final:
        assert torch.equal(final[k][n:], init[k][n:]), k
        # every live row trained away from its init (none copied back)
        moved = (final[k][:v0] != init[k][:v0]).reshape(v0, -1).any(dim=1)
        assert bool(moved.all()), k


def test_segment_draws_equal_a_fresh_trainer_seeded_seed_plus_s(tmp_path):
    """Segment s trains exactly what a fresh trainer at seed + s trains
    on that segment's corpus from the same params: every seed site reads
    run_seed; and the new seed_offset builds no new runner."""
    shards = _write_shards(tmp_path, n_shards=2, tokens_per_shard=SEG)
    cfg = _stream_cfg(chunk_steps=4)
    trainer, src, vocab = _bootstrap(shards, cfg)
    run = StreamRun(trainer, src, max_segments=1)
    state0, _ = run.train(log_every=0)
    after0 = _host(state0.params)
    runners = dict(trainer._runners)
    run2 = StreamRun(trainer, src, cursor=run.cursor, max_segments=1)
    state1, _ = run2.train(state=TrainState(params=state0.params), log_every=0)
    assert trainer.seed_offset == 1 and trainer.run_seed == cfg.seed + 1
    assert trainer._runners == runners  # the same runner object, reused
    raw1 = src.read_segment(1, 1, 0)
    corpus1 = PackedCorpus.from_flat(encode_segment(raw1, vocab),
                                     cfg.max_sentence_len)
    fresh_cfg = dataclasses.replace(cfg, seed=cfg.seed + 1)
    with pytest.warns(UserWarning):
        fresh = Trainer(fresh_cfg, vocab, corpus1, device="cpu")
    ref, _ = fresh.train(state=TrainState(params=after0), log_every=0)
    _bitwise(_host(ref.params), _host(state1.params))
    # and seed + 1 is not seed: segment 1 at seed 9 trains other numbers
    with pytest.warns(UserWarning):
        other = Trainer(cfg, vocab, corpus1, device="cpu")
    oth, _ = other.train(state=TrainState(params=after0), log_every=0)
    assert not torch.equal(oth.params["emb_in"], state1.params["emb_in"])


def test_growth_drops_the_runners_and_rebuilds_the_step(tmp_path, monkeypatch):
    """refresh_vocab_tables empties the runner cache; the next runner's step
    reads the grown tables. An admitted word of enormous count owns the
    alias table after the growth: its id is drawn as a negative then, and
    never before (it lies past the old vocabulary size)."""
    builds = []
    make = train_mod.make_chunk_runner

    def counting(config, tables, **kw):
        builds.append(tables.alias_accept.shape[0])
        return make(config, tables, **kw)

    monkeypatch.setattr(train_mod, "make_chunk_runner", counting)
    shards = _write_shards(tmp_path, n_shards=1, tokens_per_shard=SEG)
    cfg = _stream_cfg(vocab_reserve=4, chunk_steps=4)
    trainer, src, vocab = _bootstrap(shards, cfg)
    v0 = len(vocab)
    trainer.train(log_every=0)
    assert builds == [v0] and len(trainer._runners) == 1
    runner = trainer._runner(4)
    tokens = torch.from_numpy(
        np.asarray(vocab.encode(src.read_segment(0, 0, 0).sentences[0]))
        [: cfg.max_sentence_len].reshape(1, -1).repeat(cfg.batch_rows, 0)
        .astype(np.int32))
    gen = torch.Generator().manual_seed(0)
    before = torch.cat([runner.step.draw(gen, tokens).negs.reshape(-1)
                        for _ in range(50)])
    assert int(before.max()) < v0
    new_id = vocab.admit([("zz_hot", 10**12)])[0]
    assert new_id == v0
    trainer.refresh_vocab_tables()
    assert trainer._runners == {}
    trainer.train(log_every=0)
    assert builds == [v0, v0 + 1] and len(trainer._runners) == 1
    runner2 = trainer._runner(4)
    assert runner2 is not runner
    assert runner2.step.tables is trainer.tables
    assert runner2.step.tables.alias_accept.shape[0] == v0 + 1
    after = torch.cat([runner2.step.draw(gen, tokens).negs.reshape(-1)
                       for _ in range(5)])
    assert float((after == new_id).float().mean()) > 0.9
    assert not bool((before == new_id).any())


def test_stream_captures_one_runner_per_growth(tmp_path, monkeypatch):
    """Over a whole stream: one runner for the first segment, one more per
    growth; segments between growths reuse theirs."""
    builds = []
    make = train_mod.make_chunk_runner
    monkeypatch.setattr(train_mod, "make_chunk_runner",
                        lambda c, t, **kw: builds.append(1) or make(c, t, **kw))
    shards = _write_shards(tmp_path, n_shards=4, tokens_per_shard=SEG,
                           new_words_from=1)
    cfg = _stream_cfg(vocab_reserve=8, chunk_steps=4)
    trainer, src, vocab = _bootstrap(shards, cfg)
    recs = []
    run = StreamRun(trainer, src, log_fn=recs.append)
    _, rep = run.train(log_every=0)
    growths = [r for r in recs if r.get("event") == "vocab_growth"]
    # growths after segments 1 (the z-words) only: 4 segments, 1 growth;
    # the last boundary's growth trains nothing more
    trained_after = [g for g in growths if g["segment"] < rep.stream["segments"] - 1]
    assert rep.stream["segments"] == 4 and growths
    assert len(builds) == 1 + len(trained_after)


# ------------------------------------------- producer-death contracts
def test_producer_exception_reraises_in_stream_path(tmp_path):
    shards = _write_shards(tmp_path, n_shards=2, tokens_per_shard=SEG)
    trainer, src, vocab = _bootstrap(shards, _stream_cfg())
    real = src.read_segment

    def poisoned(index, shard, offset, vocab=None):
        if index >= 1:
            raise OSError("shard storage vanished")
        return real(index, shard, offset, vocab=vocab)

    src.read_segment = poisoned
    run = StreamRun(trainer, src)
    with pytest.raises(OSError, match="shard storage vanished"):
        run.train(log_every=0)
    assert run.segments_done == 1  # the segment read before it trained


def test_dead_producer_without_sentinel_raises():
    ev = threading.Event()

    def blocking_gen():
        yield "seg0"
        ev.wait(30)  # the consumer declares the producer dead first

    gen = prefetch(blocking_gen(), depth=1)
    assert next(gen) == "seg0"
    t = gen.gi_frame.f_locals["t"]
    real_is_alive = t.is_alive
    try:
        t.is_alive = lambda: False  # the daemon-kill scenario
        with pytest.raises(RuntimeError, match="died without a sentinel"):
            next(gen)
    finally:
        t.is_alive = real_is_alive
        ev.set()
        gen.close()


def test_sigterm_mid_segment_drains_producer(tmp_path):
    shards = _write_shards(tmp_path, n_shards=3, tokens_per_shard=SEG)
    trainer, src, vocab = _bootstrap(shards, _stream_cfg())
    before = threading.active_count()
    run = StreamRun(trainer, src)
    trainer.stop_check = _boundary_stopper(3)
    state, rep = run.train(log_every=0)
    assert rep.interrupted == "preempted" and state.step > 0
    for _ in range(50):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.1)
    assert threading.active_count() <= before


# ------------------------------------------------------- stream faults
def test_stream_faults_fire_at_segments_not_steps(tmp_path):
    plan = FaultPlan.parse("stream_stall@1:secs=0.01,vocab_growth@0:n=3")
    shards = _write_shards(tmp_path, n_shards=2, tokens_per_shard=SEG)
    cfg = _stream_cfg(vocab_reserve=8)
    trainer, src, vocab = _bootstrap(shards, cfg)
    trainer.fault_plan = plan  # the step channel sees them and skips them
    v0 = len(vocab)
    _, rep = StreamRun(trainer, src, fault_plan=plan).train(log_every=0)
    assert [(r["kind"], r["at_step"]) for r in plan.log] == [
        ("vocab_growth", 0), ("stream_stall", 1)]
    chaos = [w for w in vocab.words[v0:] if w.startswith("__chaos_")]
    assert chaos == ["__chaos_g0_0", "__chaos_g0_1", "__chaos_g0_2"]
    assert rep.stream["growths"] == 1
    step_only = FaultPlan.parse("stream_stall@0:secs=0.01")
    state = TrainState(params={})
    state.step = 5
    step_only.on_step(state)
    assert step_only.log == []
    step_only.on_segment(0)
    assert step_only.log[0]["kind"] == "stream_stall"


# ------------------------------------------------------------ hot swap
def test_swap_under_concurrent_queries_loses_nothing(tmp_path):
    shards = _write_shards(tmp_path, n_shards=3, tokens_per_shard=SEG,
                           new_words_from=1)
    cfg = _stream_cfg(vocab_reserve=8)
    trainer, src, vocab = _bootstrap(shards, cfg)
    W0 = logical_table(trainer.init_state().params, "emb_in")[: len(vocab)]
    engine = QueryEngine(W0.numpy(), Vocab(list(vocab.words), vocab.counts.copy()),
                         device="cpu")
    errors, served = [], {"n": 0}
    stop = threading.Event()
    words = vocab.words[:8]

    def client():
        while not stop.is_set():
            try:
                out = engine.neighbors_batch(words[:4], k=3)
                assert len(out) == 4 and all(len(o) == 3 for o in out)
                served["n"] += 1
            except Exception as e:  # noqa: BLE001 — the assertion target
                errors.append(e)
                return

    threads = [threading.Thread(target=client, daemon=True) for _ in range(3)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the clients and the swaps finely
    try:
        for t in threads:
            t.start()
        recs = []
        run = StreamRun(trainer, src, swap_engine=engine, swap_floor=0.0,
                        log_fn=recs.append)
        state, rep = run.train(log_every=0)
    finally:
        stop.set()
        sys.setswitchinterval(switch)
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:1]
    assert served["n"] > 0
    assert rep.stream["swaps"] == rep.stream["segments"] == engine.generation == 3
    assert engine.V == len(vocab) > len(vocab.words[:18])
    swaps = [r for r in recs if r.get("event") == "table_swap"]
    assert [r["segment"] for r in swaps] == [0, 1, 2]
    assert swaps[-1]["vocab_size"] == len(vocab)
    want = logical_table(state.params, "emb_in")[: len(vocab)].numpy()
    ref = QueryEngine(want, vocab, device="cpu")
    assert engine.neighbors_batch(words, k=5) == ref.neighbors_batch(words, k=5)
    # a floor no table meets: refused, the engine keeps its generation
    run.swap_floor = 1.01
    run.probe_set = ProbeSet(pairs=[("w00", "w01", 1.0), ("w02", "w03", 2.0),
                                    ("w04", "w05", 3.0)],
                             analogies=[], tracked=[], source="file")
    run._maybe_swap(state, segment=3)
    assert run.swaps_refused == 1 and engine.generation == 3
    assert recs[-1]["event"] == "table_swap_refused"


def test_stream_counters_reach_the_prom_file(tmp_path):
    from word2vec_tpu_torch.obs.export import prometheus_textfile

    shards = _write_shards(tmp_path, n_shards=2, tokens_per_shard=SEG,
                           new_words_from=1)
    trainer, src, vocab = _bootstrap(shards, _stream_cfg(vocab_reserve=8))
    prom_path = str(tmp_path / "m.prom")
    prom = prometheus_textfile(prom_path)
    _, rep = StreamRun(trainer, src, log_fn=prom).train(log_every=0)
    prom.close()
    text = open(prom_path).read()
    for name in ("w2v_vocab_size", "w2v_stream_tokens_total",
                 "w2v_vocab_generation", "w2v_vocab_growth_total 1.0",
                 "w2v_table_swaps_total 0.0", "w2v_table_swap_refused_total 0.0"):
        assert name in text, name
    assert rep.stream["tokens_total"] == 2 * SEG
    assert rep.stream["cursor"]["segment"] == rep.stream["segments"] == 2


def test_streaming_refuses_resident_and_resolves_it_off(tmp_path):
    with pytest.raises(ValueError, match="resident"):
        Word2VecConfig(**_cfg_kw(resident="on"))
    shards = _write_shards(tmp_path, n_shards=1, tokens_per_shard=SEG)
    trainer, src, vocab = _bootstrap(shards, _stream_cfg(chunk_steps=4))
    assert trainer.config.resident == "auto"
    _, rep = trainer.train(log_every=0)
    assert trainer._resident is None and rep.resident is None
    assert Counter(k[1] for k in trainer._runners) == Counter({False: 1})
