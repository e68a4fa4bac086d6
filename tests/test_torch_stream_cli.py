"""The port's CLI on --corpus-mode streaming (--backend cpu), carrying
over tests/test_stream.py's CLI cases: a streaming run and a
sigterm-fault preemption whose --resume equals it bitwise; pipe ingestion
(-train -) with a spool; the pipe refused without streaming (rc 1); the
compatible-superset resume guard for a grown vocabulary. And one
cross-package check: the JAX CLI and the port CLI on the same shards
admit the same words in the same generations (the vocab_growth records,
the stream records, the checkpoint's vocabulary and its cursor)."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from word2vec_tpu_torch.cli import main
from word2vec_tpu_torch.io.checkpoint import (
    load_checkpoint, read_stream_cursor, save_checkpoint,
)
from word2vec_tpu_torch.io.embeddings import load_word2vec


def _write_shards(tmp_path, n_shards=2, tokens_per_shard=700, vocab_words=18,
                  new_words_from=None, seed=1):
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


@pytest.fixture
def cli_shards(tmp_path):
    return _write_shards(tmp_path)


SMALL = ["-size", "8", "-window", "2", "-negative", "2", "-min-count", "1",
         "--backend", "cpu", "--batch-rows", "4", "--max-sentence-len", "16",
         "--quiet", "--log-every", "0"]
STREAM = ["--corpus-mode", "streaming", "--segment-tokens", "400"]


def test_cli_streaming_smoke_and_resume_parity(tmp_path, cli_shards):
    base = ["-train", ",".join(cli_shards)] + SMALL + STREAM
    out_full = str(tmp_path / "full.txt")
    metrics = str(tmp_path / "m")
    assert main(base + ["-output", out_full, "--metrics-dir", metrics]) == 0
    words_full, W_full = load_word2vec(out_full)
    with open(os.path.join(metrics, "manifest.json")) as f:
        man = json.load(f)
    # the start block's stream shape is replaced at the end by the run's
    # stream report (as in the JAX CLI)
    assert man["corpus_mode"] == "streaming" and man["shutdown"] == "clean"
    assert man["stream"]["source"] == {
        "kind": "files", "shards": cli_shards, "fmt": "text8",
        "segment_tokens": 400}
    assert man["stream"]["segments"] == 4
    assert man["stream"]["cursor"]["tokens_total"] == 1400

    # interrupted leg: a sigterm fault mid-stream -> rc 75 with a cursor
    ck = str(tmp_path / "ck")
    out_ab = str(tmp_path / "ab.txt")
    rc = main(base + ["-output", out_ab, "--checkpoint-dir", ck,
                      "--checkpoint-every", "5", "--faults", "sigterm@7"])
    assert rc == 75
    doc = read_stream_cursor(ck)
    assert doc is not None and doc["schema"] == 1 and doc["segment"] == 0
    assert not os.path.exists(out_ab)
    rc = main(base + ["-output", out_ab, "--checkpoint-dir", ck,
                      "--resume", ck, "--checkpoint-every", "5"])
    assert rc == 0
    words_ab, W_ab = load_word2vec(out_ab)
    assert words_ab == words_full
    np.testing.assert_array_equal(W_full, W_ab)
    assert read_stream_cursor(ck)["segment"] == 4


def _pipe_into_stdin(payload: bytes, fn):
    r, w = os.pipe()

    def feed():
        os.write(w, payload)
        os.close(w)

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    real_stdin = os.dup(0)
    try:
        os.dup2(r, 0)
        return fn()
    finally:
        os.dup2(real_stdin, 0)
        os.close(real_stdin)
        os.close(r)
        t.join(timeout=5)


def test_cli_pipe_ingestion_equals_the_files(tmp_path, cli_shards):
    """-train - through a spool: the same segments as the files (one stream
    of the shards' bytes), so the same vectors bitwise."""
    payload = " ".join(open(p).read() for p in cli_shards).encode()
    out = str(tmp_path / "pipe.txt")
    spool = str(tmp_path / "spool")
    rc = _pipe_into_stdin(payload, lambda: main(
        ["-train", "-", "-output", out] + SMALL + STREAM
        + ["--stream-spool", spool]))
    assert rc == 0
    assert sorted(os.listdir(spool)) == [f"seg_{i:06d}.txt" for i in range(4)]
    joined = tmp_path / "joined.txt"
    joined.write_bytes(payload)
    out_f = str(tmp_path / "file.txt")
    assert main(["-train", str(joined), "-output", out_f] + SMALL + STREAM) == 0
    wp, Wp = load_word2vec(out)
    wf, Wf = load_word2vec(out_f)
    assert wp == wf
    np.testing.assert_array_equal(Wp, Wf)


def test_cli_rejects_pipe_without_streaming(capsys):
    assert main(["-train", "-", "-negative", "2", "--backend", "cpu"]) == 1
    assert "requires --corpus-mode streaming" in capsys.readouterr().err


def test_cli_superset_resume_guard(tmp_path, cli_shards):
    """A checkpoint whose vocabulary GREW online resumes against the
    original corpus through the compatible-superset guard (resident
    path), and a vocabulary that is no superset is refused."""
    ck = str(tmp_path / "ck")
    flags = ["-train", cli_shards[0]] + SMALL
    assert main(flags + ["-output", str(tmp_path / "v.txt"),
                         "--checkpoint-dir", ck]) == 0
    state, cfg_ck, vocab_ck = load_checkpoint(ck)
    vocab_ck.admit([("zzz_new", 9)])
    state.params = {
        k: torch.cat([v, torch.zeros((1,) + tuple(v.shape[1:]), dtype=v.dtype)])
        for k, v in state.params.items()
    }
    save_checkpoint(ck, state, cfg_ck, vocab_ck)
    out2 = str(tmp_path / "v2.txt")
    assert main(flags + ["-output", out2, "--resume", ck]) == 0
    words, W = load_word2vec(out2)
    assert words[-1] == "zzz_new" and len(words) == len(vocab_ck)
    # another corpus's vocabulary (other counts) is no superset: refused
    odir = tmp_path / "other"
    odir.mkdir()
    other = _write_shards(odir, n_shards=1, seed=7)[0]
    assert main(["-train", other] + SMALL + [
        "-output", str(tmp_path / "v3.txt"), "--resume", ck]) == 1


def _growth_flags(shards):
    return (["-train", ",".join(shards), "-output", ""] + SMALL + STREAM
            + ["--vocab-reserve", "8", "--chunk-steps", "4"])


def test_cli_admissions_equal_jax(tmp_path):
    """The JAX CLI and the port CLI over the same shards admit the same
    words into the same rows at the same boundaries."""
    from word2vec_tpu.cli import main as jmain
    from word2vec_tpu.io.checkpoint import load_checkpoint as jload
    from word2vec_tpu.io.checkpoint import read_stream_cursor as jread

    shards = _write_shards(tmp_path, n_shards=3, tokens_per_shard=400,
                           new_words_from=1)
    got = {}
    for pkg, fn in (("port", main), ("jax", jmain)):
        ck = str(tmp_path / f"ck_{pkg}")
        log = str(tmp_path / f"{pkg}.jsonl")
        assert fn(_growth_flags(shards) + [
            "--checkpoint-dir", ck, "--log-jsonl", log]) == 0
        with open(log) as f:
            recs = [json.loads(line) for line in f]
        load, read = (load_checkpoint, read_stream_cursor) if pkg == "port" \
            else (jload, jread)
        _, _, vocab = load(ck)
        got[pkg] = dict(
            growth=[r for r in recs if r.get("event") == "vocab_growth"],
            stream=[r for r in recs if r.get("event") in ("stream",
                                                          "stream_segment")],
            words=list(vocab.words), counts=np.asarray(vocab.counts).tolist(),
            cursor=read(ck),
        )
    t, j = got["port"], got["jax"]
    assert t["growth"] and t["growth"] == j["growth"]
    assert t["growth"][0]["segment"] == 1
    assert t["stream"] == j["stream"]
    assert t["words"] == j["words"] and t["counts"] == j["counts"]
    assert t["cursor"] == j["cursor"]
