"""The port's CLI (word2vec_tpu_torch/cli.py) on --backend cpu, mirroring
tests/test_cli.py's cases: help on no args, the validation errors, train
-> save text and binary, -read-vocab / -save-vocab, checkpoint and resume
(with the ignored-flag notice), --export-side and its guard, the 20-pair
fixture through --eval-ws353, int8 export; the JAX CLI and the port CLI on
one corpus and one set of flags writing the same vocab.txt and an equal
config.json (auto geometry included); a flag of an unported layer exiting
2; --backend gpu raising without a card."""

import json
import os

import numpy as np
import pytest
import torch

from word2vec_tpu_torch.cli import main as run
from word2vec_tpu_torch.data.vocab import Vocab
from word2vec_tpu_torch.io.embeddings import (
    load_embeddings_int8, load_embeddings_text, load_word2vec,
)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def corpus_file(tmp_path):
    rng = np.random.default_rng(0)
    toks = []
    for _ in range(400):
        w1 = rng.choice(["a", "b"])
        w2 = rng.choice(["c", "d"])
        toks += ["x", w1, "y", "p", w2, "q"]
    p = tmp_path / "corpus.txt"
    p.write_text(" ".join(toks))
    return str(p)


CPU = ["--backend", "cpu", "--batch-rows", "4", "--max-sentence-len", "32",
       "--quiet"]


def test_no_args_prints_help(capsys):
    assert run([]) == 0
    out = capsys.readouterr().out
    assert "-train" in out and "-output" in out and "--backend" in out


def test_validation_errors_mirror_reference(capsys):
    # ns with negative<=0 rejected (main.cpp:164-167)
    assert run(["-train", "x", "-train_method", "ns", "-negative", "0"]) == 1
    assert "negative" in capsys.readouterr().err
    # hs with negative>0 rejected (main.cpp:169-172)
    assert run(["-train", "x", "-train_method", "hs", "-negative", "5"]) == 1
    # missing -train
    assert run(["-negative", "5"]) == 1
    assert "-train <file> is required" in capsys.readouterr().err
    assert run(["-train", "x", "-negative", "5", "--checkpoint-keep", "-1"]) == 1
    assert "--checkpoint-keep must be >= 0" in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--multihost"], ["--compile-cache", "d"],
                                  ["--sync-deadline", "5"], ["--prng", "rbg"]])
def test_flags_of_unported_layers_exit_2(flag, capsys):
    with pytest.raises(SystemExit) as e:
        run(["-train", "x", "-negative", "5"] + flag)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device exists")
def test_backend_gpu_raises_without_a_card(corpus_file):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(["-train", corpus_file, "-negative", "3", "-output", ""])


def test_end_to_end_train_save(tmp_path, corpus_file):
    out = str(tmp_path / "vec.txt")
    vocab_out = str(tmp_path / "vocab.txt")
    rc = run([
        "-train", corpus_file, "-output", out, "-size", "16", "-window", "2",
        "-negative", "3", "-model", "sg", "-train_method", "ns", "-iter", "2",
        "-min-count", "1", "-subsample", "0", "-save-vocab", vocab_out,
        "--batch-rows", "8", "--backend", "cpu", "--max-sentence-len", "32",
        "--quiet",
    ])
    assert rc == 0
    words, M = load_word2vec(out)
    assert M.shape == (8, 16)
    assert set("abxypcdq") == set("".join(words))
    assert np.all(np.isfinite(M))
    assert Vocab.load(vocab_out).words == words


def test_binary_output_read_vocab_and_int8(tmp_path, corpus_file):
    vocab_out = str(tmp_path / "vocab.txt")
    out1 = str(tmp_path / "v1.bin")
    q8 = str(tmp_path / "v1.q8")
    common = ["-train", corpus_file, "-size", "8", "-negative", "2",
              "-min-count", "1", "-iter", "1"] + CPU
    assert run(common + ["-output", out1, "-binary", "1", "-save-vocab",
                         vocab_out, "--export-int8", q8]) == 0
    words, M = load_word2vec(out1, binary=True)
    assert M.shape[1] == 8
    qwords, Q = load_embeddings_int8(q8)
    assert qwords == words
    np.testing.assert_allclose(Q, M, atol=np.abs(M).max() / 100)
    # -read-vocab path (Word2Vec.cpp:179-196)
    out2 = str(tmp_path / "v2.txt")
    assert run(common + ["-output", out2, "-read-vocab", vocab_out]) == 0
    words2, _ = load_word2vec(out2)
    assert words2 == words


def test_checkpoint_resume_and_ignored_flags(tmp_path, corpus_file, capsys):
    ck = str(tmp_path / "ck")
    common = ["-train", corpus_file, "-size", "8", "-negative", "2",
              "-min-count", "1"] + CPU
    assert run(common + ["-output", str(tmp_path / "v.txt"), "-iter", "1",
                         "--checkpoint-dir", ck]) == 0
    assert os.path.exists(os.path.join(ck, "state.npz"))
    capsys.readouterr()
    # resume continues and rewrites output; typed lever flags the
    # checkpoint overrides are called out, even under --quiet
    assert run(common + ["-output", str(tmp_path / "v2.txt"), "-iter", "2",
                         "--resume", ck, "--table-dtype", "bfloat16",
                         "--negative-scope", "batch"]) == 0
    err = capsys.readouterr().err
    assert "ignoring differing flags" in err
    assert "dtype" in err and "negative_scope" in err and "batch_rows" not in err
    # no differing flags: no notice, and no package-change line
    assert run(common + ["-output", "", "--resume", ck]) == 0
    err = capsys.readouterr().err
    assert "ignoring differing flags" not in err and "written by" not in err
    # a different corpus is refused by the vocabulary guard
    other = tmp_path / "other.txt"
    other.write_text("a b x y m n " * 50)
    assert run(["-train", str(other), "-output", "", "--resume", ck] + CPU) == 1
    assert "rebuilds to a different vocabulary" in capsys.readouterr().err
    assert run(["-train", str(other), "-output", "", "--resume", ck,
                "--allow-vocab-mismatch"] + CPU) == 0
    # nothing to resume from
    assert run(common + ["-output", "", "--resume", str(tmp_path / "nope")]) == 1
    assert "no loadable checkpoint" in capsys.readouterr().err


def test_export_side_override_and_guard(tmp_path, corpus_file, capsys):
    common = ["-train", corpus_file, "-size", "8", "-negative", "2",
              "-min-count", "1", "-iter", "1", "-model", "cbow"] + CPU
    out_auto, out_in = tmp_path / "auto.txt", tmp_path / "input.txt"
    assert run(common + ["-output", str(out_auto)]) == 0
    assert run(common + ["-output", str(out_in), "--export-side", "input"]) == 0
    _, W_auto = load_embeddings_text(str(out_auto))
    _, W_in = load_embeddings_text(str(out_in))
    # cbow+ns auto saves the OUTPUT matrix (main.cpp:201)
    assert not np.allclose(W_auto, W_in)
    # hs + output side is rejected BEFORE training
    assert run(["-train", corpus_file, "-size", "8", "-negative", "0",
                "-train_method", "hs", "-min-count", "1", "--backend", "cpu",
                "--quiet", "-output", str(tmp_path / "x.txt"),
                "--export-side", "output"]) == 1
    assert "internal nodes" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["-train_method", "hs", "-negative", "0"],
                                   ["-negative", "3", "--kernel", "pair"]])
def test_hs_and_pair_routes_train(corpus_file, tmp_path, flags):
    """hs and the pair step train through the CLI and export every
    word's vector."""
    out = tmp_path / "v.txt"
    assert run(["-train", corpus_file, "-min-count", "1", "-size", "8",
                "-output", str(out)] + flags + CPU) == 0
    words, W = load_embeddings_text(str(out))
    assert sorted(words) == sorted("abcdpqxy") and np.isfinite(W).all()


def test_eval_fixture_end_to_end(tmp_path, capsys):
    """The committed 20-pair graded fixture through --eval-ws353 on the
    topical toy corpus of tests/test_cli.py, and --eval-analogy."""
    fixture = os.path.join(HERE, "fixtures", "wordsim_fixture_20.csv")
    topics = [
        ["cat", "kitten", "dog", "puppy", "horse"],
        ["king", "queen", "prince", "princess"],
        ["paris", "france", "berlin", "germany", "city", "country"],
        ["apple", "banana", "fruit"],
    ]
    rng = np.random.default_rng(11)
    toks = []
    for _ in range(300):
        t = topics[rng.integers(len(topics))]
        toks += list(rng.choice(t, size=6))
    corpus = tmp_path / "toy.txt"
    corpus.write_text(" ".join(toks))
    qa = tmp_path / "q.txt"
    qa.write_text(": sec\nking queen paris france\ncat dog apple zebra\n")
    rc = run([
        "-train", str(corpus), "-output", "", "-size", "16", "-negative", "3",
        "-min-count", "1", "-iter", "2", "--backend", "cpu",
        "--batch-rows", "4", "--max-sentence-len", "32",
        "--eval-ws353", fixture, "--eval-analogy", str(qa), "--quiet",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "WS-353 spearman:" in out and "(20/20 pairs)" in out
    assert "analogy accuracy:" in out and "1 oov-skipped" in out


def test_log_jsonl_and_vocab_line(tmp_path, corpus_file, capsys):
    log = str(tmp_path / "log.jsonl")
    assert run(["-train", corpus_file, "-output", "", "-size", "8",
                "-negative", "2", "-min-count", "1", "-iter", "2",
                "--backend", "cpu", "--batch-rows", "4",
                "--max-sentence-len", "32", "--log-every", "5",
                "--log-jsonl", log, "--checkpoint-dir", str(tmp_path / "ck"),
                "--checkpoint-every", "5"]) == 0
    out = capsys.readouterr().out
    assert "native data layer" in out or "python data layer" in out
    recs = [json.loads(line) for line in open(log)]
    assert any("loss" in r and "step" in r for r in recs)
    assert any(r.get("event") == "checkpoint" for r in recs)
    rep = [r for r in recs if r.get("event") == "train_report"]
    assert len(rep) == 1 and rep[0]["nonfinite_loss_steps"] == 0


def test_same_vocab_and_config_as_the_jax_cli(tmp_path):
    """One corpus and one set of flags through both CLIs (auto batch
    geometry): the checkpoints hold the same vocab.txt, byte for byte, and
    config.json files equal as dicts."""
    from word2vec_tpu.cli import main as jax_run

    rng = np.random.default_rng(3)
    p = 1.0 / np.arange(1, 301)
    p /= p.sum()
    corpus = tmp_path / "zipf.txt"
    corpus.write_text(" ".join(rng.choice([f"t{i}" for i in range(300)],
                                          20000, p=p)))
    flags = ["-train", str(corpus), "-output", "", "-size", "8",
             "-negative", "3", "-min-count", "2", "-iter", "1",
             "--backend", "cpu", "--max-sentence-len", "64",
             "--table-layout", "unified", "--quiet"]
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    assert jax_run(flags + ["--checkpoint-dir", jck]) == 0
    assert run(flags + ["--checkpoint-dir", tck]) == 0
    with open(os.path.join(jck, "vocab.txt"), "rb") as a, \
            open(os.path.join(tck, "vocab.txt"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(jck, "config.json")) as a, \
            open(os.path.join(tck, "config.json")) as b:
        jcfg, tcfg = json.load(a), json.load(b)
    assert jcfg == tcfg
    assert tcfg["batch_rows"] != 32  # auto geometry, not the placeholder


def test_hs_two_tier_cli_run_matches_the_jax_cli(tmp_path, corpus_file, capsys):
    """-train_method hs --hs-dense-top / --hs-tail-slots through both CLIs
    on one corpus: equal config.json and vocab.txt; the port's progress
    line shows hs_tail_dropped; cbow+hs exports C (the input table,
    main.cpp:198-199) and both exports hold every word."""
    from word2vec_tpu.cli import main as jax_run

    flags = ["-train", corpus_file, "-size", "8", "-negative", "0",
             "-train_method", "hs", "-model", "cbow", "-min-count", "1",
             "-iter", "1", "--hs-dense-top", "3", "--hs-tail-slots", "4",
             "--max-sentence-len", "32", "--batch-rows", "4",
             "--log-every", "5"]
    jck, tck = str(tmp_path / "jck"), str(tmp_path / "tck")
    jout, tout = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    assert jax_run(flags + ["--checkpoint-dir", jck, "-output", jout, "--quiet"]) == 0
    capsys.readouterr()
    assert run(flags + ["--checkpoint-dir", tck, "-output", tout,
                        "--backend", "cpu"]) == 0
    assert "hs_tail_dropped:" in capsys.readouterr().err
    with open(os.path.join(jck, "config.json")) as a, \
            open(os.path.join(tck, "config.json")) as b:
        assert json.load(a) == json.load(b)
    with open(os.path.join(jck, "vocab.txt"), "rb") as a, \
            open(os.path.join(tck, "vocab.txt"), "rb") as b:
        assert a.read() == b.read()
    (jw, jW), (tw, tW) = load_embeddings_text(jout), load_embeddings_text(tout)
    assert jw == tw and tW.shape == jW.shape == (8, 8) and np.isfinite(tW).all()
