"""Checkpoint files across the two packages, and the port's own checkpoint
faults and resume.

  * a checkpoint written by either package loads into the other with the
    params bitwise equal (f32 and bf16 tables, split and unified layouts),
    step / words_done / epoch equal, config.json equal as dicts, the same
    vocabulary (content hash), and a sha256 manifest the other package
    verifies;
  * a truncated state.npz is quarantined and the `.old` backup loads;
  * a run cut at a checkpoint (a cooperative stop through the CLI, exit
    75) and resumed from it with --resume ends bitwise equal to the
    uninterrupted run, per-step and with chunk_steps=4, on the xla and the
    pallas_fused routes;
  * the CLI resumes a JAX checkpoint and says which package wrote it.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2vec_tpu.config import Word2VecConfig as JConfig
from word2vec_tpu.data.vocab import Vocab as JVocab
from word2vec_tpu.io import checkpoint as jck
from word2vec_tpu.models.params import convert_params_layout as j_convert
from word2vec_tpu.train import TrainState as JState

from word2vec_tpu_torch import Word2VecConfig
from word2vec_tpu_torch.cli import main as cli
from word2vec_tpu_torch.data.vocab import Vocab
from word2vec_tpu_torch.io import checkpoint as ck
from word2vec_tpu_torch.models.params import convert_params_layout
from word2vec_tpu_torch.resilience import shutdown
from word2vec_tpu_torch.train import TrainState

V, D = 23, 8
CASES = [(dt, lay) for dt in ("float32", "bfloat16") for lay in ("split", "unified")]
CASE_IDS = ["-".join(c) for c in CASES]


def _cfg_kw(dtype, layout):
    return dict(model="sg", train_method="ns", negative=3, word_dim=D,
                window=2, min_count=1, iters=2, batch_rows=4,
                max_sentence_len=16, dtype=dtype, table_layout=layout,
                divergence_budget=8, seed=4)


def _tables(dtype):
    """Split numpy tables, made from a seed, rounded to `dtype`."""
    rng = np.random.default_rng(11)
    out = {}
    for k in ("emb_in", "emb_out_ns"):
        a = rng.normal(size=(V, D)).astype(np.float32)
        if dtype == "bfloat16":
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        out[k] = a
    return out


def _bits_np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a.view(np.uint32)


def _bits_t(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


def _vocab_pair():
    counts = {f"v{i}": 100 - 3 * i for i in range(V)}
    return Vocab.from_counter(counts, min_count=1), JVocab.from_counter(counts, min_count=1)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype,layout", CASES, ids=CASE_IDS)
def test_jax_checkpoint_loads_into_the_port(tmp_path, dtype, layout):
    tabs = _tables(dtype)
    jparams = {k: jnp.asarray(v, jnp.dtype(dtype)) for k, v in tabs.items()}
    jparams = j_convert(jparams, layout)
    _, jvocab = _vocab_pair()
    path = str(tmp_path / "ck")
    jck.save_checkpoint(path, JState(jparams, step=7, words_done=123, epoch=1),
                        JConfig(**_cfg_kw(dtype, layout)), jvocab)

    ck.verify_checkpoint(path)  # the JAX manifest verifies here
    state, cfg, vocab = ck.load_checkpoint(path)
    assert (state.step, state.words_done, state.epoch) == (7, 123, 1)
    assert sorted(state.params) == sorted(jparams)
    for k, v in jparams.items():
        t = state.params[k]
        assert t.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
        np.testing.assert_array_equal(_bits_t(t), _bits_np(v), err_msg=k)
    assert vocab.content_hash() == jvocab.content_hash()
    assert cfg == Word2VecConfig(**_cfg_kw(dtype, layout))
    assert ck.checkpoint_writer(path) == "word2vec_tpu"


@pytest.mark.parametrize("dtype,layout", CASES, ids=CASE_IDS)
def test_port_checkpoint_loads_into_jax(tmp_path, dtype, layout):
    tabs = _tables(dtype)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    params = convert_params_layout(
        {k: torch.from_numpy(v).to(tdt) for k, v in tabs.items()}, layout)
    vocab, jvocab = _vocab_pair()
    path = str(tmp_path / "ck")
    cfg = Word2VecConfig(**_cfg_kw(dtype, layout))
    ck.save_checkpoint(path, TrainState(params, step=9, words_done=456, epoch=1),
                       cfg, vocab)

    jck.verify_checkpoint(path)  # the port's manifest verifies in JAX
    meta = jck.read_integrity_meta(path)
    assert meta["table_layout"] == layout and meta["vocab_size"] == V
    assert meta["vocab_hash"] == jvocab.content_hash()
    assert meta["writer"] == ck.WRITER
    jstate, jcfg, jv = jck.load_checkpoint(path)
    assert (jstate.step, jstate.words_done, jstate.epoch) == (9, 456, 1)
    assert sorted(jstate.params) == sorted(params)
    for k, t in params.items():
        np.testing.assert_array_equal(_bits_np(jstate.params[k]), _bits_t(t),
                                      err_msg=k)
    assert jv.content_hash() == vocab.content_hash()
    assert jcfg == JConfig(**_cfg_kw(dtype, layout))

    # the same state and config written by the JAX package: config.json
    # equal as dicts, vocab.txt equal byte for byte
    jpath = str(tmp_path / "jck")
    jck.save_checkpoint(jpath, jstate, jcfg, jv)
    assert _read_json(os.path.join(path, "config.json")) == _read_json(
        os.path.join(jpath, "config.json"))
    with open(os.path.join(path, "vocab.txt"), "rb") as a, \
            open(os.path.join(jpath, "vocab.txt"), "rb") as b:
        assert a.read() == b.read()
    # a round trip through the port loads back bitwise
    back, _, _ = ck.load_checkpoint(jpath)
    for k, t in params.items():
        np.testing.assert_array_equal(_bits_t(back.params[k]), _bits_t(t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hs_checkpoint_round_trips_across_packages(tmp_path, dtype):
    """hs params ({emb_in [V, d], emb_out_hs [V-1, d]}): the port's
    checkpoint loads into JAX, JAX writes it back, the port loads it;
    params bitwise at both ends, the configs equal."""
    rng = np.random.default_rng(12)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    params = {"emb_in": torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)),
              "emb_out_hs": torch.from_numpy(
                  rng.normal(size=(V - 1, D)).astype(np.float32))}
    params = {k: v.to(tdt) for k, v in params.items()}
    kw = dict(_cfg_kw(dtype, "split"), train_method="hs", negative=0,
              hs_dense_top=4, model="cbow")
    vocab, jvocab = _vocab_pair()
    path, jpath = str(tmp_path / "ck"), str(tmp_path / "jck")
    ck.save_checkpoint(path, TrainState(params, step=5, words_done=77, epoch=0),
                       Word2VecConfig(**kw), vocab)
    jstate, jcfg, _ = jck.load_checkpoint(path)
    assert jcfg == JConfig(**kw) and sorted(jstate.params) == sorted(params)
    for k, t in params.items():
        np.testing.assert_array_equal(_bits_np(jstate.params[k]), _bits_t(t), err_msg=k)
    jck.save_checkpoint(jpath, jstate, jcfg, jvocab)
    back, cfg, _ = ck.load_checkpoint(jpath)
    assert cfg == Word2VecConfig(**kw) and back.step == 5
    for k, t in params.items():
        assert back.params[k].shape == t.shape and back.params[k].dtype == tdt
        np.testing.assert_array_equal(_bits_t(back.params[k]), _bits_t(t), err_msg=k)


def test_truncated_state_is_quarantined_and_old_loads(tmp_path):
    vocab, _ = _vocab_pair()
    cfg = Word2VecConfig(**_cfg_kw("float32", "split"))
    path = str(tmp_path / "ck")
    for step in (3, 6):
        p = {k: torch.full((V, D), float(step)) for k in ("emb_in", "emb_out_ns")}
        ck.save_checkpoint(path, TrainState(p, step=step), cfg, vocab, keep=1)
    npz = os.path.join(path, "state.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.warns(UserWarning, match="corrupt checkpoint"):
        state, _, _, loaded = ck.load_checkpoint_with_path(path)
    assert loaded == path + ".old" and state.step == 3
    assert float(state.params["emb_in"][0, 0]) == 3.0
    assert os.path.isdir(path + ".corrupt") and not os.path.exists(path)
    # nothing left to load: a named error
    shutil.rmtree(path + ".old")
    with pytest.raises(ck.CheckpointError, match="no loadable checkpoint"):
        ck.load_checkpoint(path)


def test_stream_cursor_rides_in_the_checkpoint(tmp_path):
    """A stream-cursor document written by either package is covered by
    the manifest and read back by both (read_stream_cursor)."""
    vocab, jvocab = _vocab_pair()
    doc = {"segment": 3, "shard": 1, "offset": 4096, "vocab_generation": 2}
    p = {k: torch.zeros(V, D) for k in ("emb_in", "emb_out_ns")}
    path = str(tmp_path / "ck")
    ck.save_checkpoint(path, TrainState(p, step=5), Word2VecConfig(
        **_cfg_kw("float32", "split")), vocab, stream=doc)
    jck.verify_checkpoint(path)
    assert jck.read_stream_cursor(path) == ck.read_stream_cursor(path) == doc
    jpath = str(tmp_path / "jck")
    jck.save_checkpoint(jpath, JState({k: jnp.zeros((V, D)) for k in p}, step=5),
                        JConfig(**_cfg_kw("float32", "split")), jvocab, stream=doc)
    assert ck.read_stream_cursor(ck.load_checkpoint_with_path(jpath)[3]) == doc
    assert ck.read_stream_cursor(str(tmp_path)) is None


def test_backup_chain_rotates_and_prunes(tmp_path):
    vocab, _ = _vocab_pair()
    cfg = Word2VecConfig(**_cfg_kw("float32", "split"))
    path = str(tmp_path / "ck")
    for step in range(1, 5):
        p = {k: torch.zeros(V, D) for k in ("emb_in", "emb_out_ns")}
        ck.save_checkpoint(path, TrainState(p, step=step), cfg, vocab, keep=2)
    steps = [ck.load_checkpoint(c, fallback=False)[0].step
             for c in ck.checkpoint_candidates(path)]
    assert steps == [4, 3, 2]
    assert not os.path.exists(ck.backup_name(path, 3))


# ----------------------------------------------------- cut and resumed runs
@pytest.fixture(scope="module")
def zipf_file(tmp_path_factory):
    rng = np.random.default_rng(1)
    p = 1.0 / np.arange(1, 121)
    p /= p.sum()
    toks = rng.choice([f"w{i}" for i in range(120)], 12000, p=p)
    path = tmp_path_factory.mktemp("corpus") / "zipf.txt"
    path.write_text(" ".join(toks))
    return str(path)


def _common(zipf_file, route, chunk):
    backend, layout = route
    return ["-train", zipf_file, "-output", "", "-size", "16", "-window", "2",
            "-negative", "3", "-iter", "2", "-min-count", "1",
            "-subsample", "0", "--backend", "cpu", "--batch-rows", "4",
            "--max-sentence-len", "192", "--chunk-steps", str(chunk),
            "--band-backend", backend, "--table-layout", layout, "--quiet"]


def _final_params(path):
    state, _, _ = ck.load_checkpoint(path, fallback=False)
    return state


@pytest.mark.parametrize("chunk", [1, 4], ids=["per-step", "chunk4"])
@pytest.mark.parametrize("route", [("xla", "split"), ("pallas_fused", "unified")],
                         ids=["xla", "pallas_fused"])
def test_cut_run_resumes_bitwise(tmp_path, zipf_file, monkeypatch, route, chunk):
    common = _common(zipf_file, route, chunk)
    full = str(tmp_path / "full")
    assert cli(common + ["--checkpoint-dir", full]) == 0

    cut_at = 8  # a chunk boundary of both dispatches, mid-epoch
    monkeypatch.setattr(shutdown.ShutdownHandler, "make_stop_check",
                        lambda self: lambda step: step >= cut_at)
    cut = str(tmp_path / "cut")
    assert cli(common + ["--checkpoint-dir", cut]) == shutdown.EXIT_PREEMPTED
    mid = _final_params(cut)
    assert mid.step == cut_at and mid.epoch == 0
    monkeypatch.undo()

    assert cli(common + ["--checkpoint-dir", cut, "--resume", cut]) == 0
    a, b = _final_params(full), _final_params(cut)
    assert (a.step, a.words_done, a.epoch) == (b.step, b.words_done, b.epoch)
    assert a.step > cut_at
    for k in a.params:
        np.testing.assert_array_equal(_bits_t(a.params[k]), _bits_t(b.params[k]),
                                      err_msg=k)


def test_periodic_checkpoint_resume_matches(tmp_path, zipf_file):
    """--checkpoint-every leaves the last periodic checkpoint as `.old`
    beside the final one; resuming from it ends on the final params."""
    common = _common(zipf_file, ("xla", "split"), 1)
    full = str(tmp_path / "full")
    assert cli(common + ["--checkpoint-dir", full, "--checkpoint-every", "5"]) == 0
    end = _final_params(full)
    mid = _final_params(full + ".old")
    assert mid.step == 5 * (end.step // 5) and mid.step < end.step
    shutil.copytree(full + ".old", str(tmp_path / "mid"))
    assert cli(common + ["--checkpoint-dir", str(tmp_path / "again"),
                         "--resume", str(tmp_path / "mid")]) == 0
    b = _final_params(str(tmp_path / "again"))
    for k in end.params:
        np.testing.assert_array_equal(_bits_t(end.params[k]), _bits_t(b.params[k]))


def test_cli_resumes_a_jax_checkpoint(tmp_path, zipf_file, capsys):
    """A checkpoint written by the JAX package (with the JAX CLI's runtime
    wiring in its config) resumes through the port's CLI: the writer line,
    the reset of unported wiring, and a run that continues from its step."""
    from word2vec_tpu.data.corpus import load_corpus as j_load

    jvocab, _ = j_load(zipf_file, min_count=1)
    kw = dict(_cfg_kw("float32", "split"), max_sentence_len=192,
              word_dim=16, subsample_threshold=0.0, chunk_steps=1,
              health_metrics=True, quality_probe_every=100)
    jcfg = JConfig(**kw)
    rng = np.random.default_rng(2)
    n = len(jvocab)
    jparams = {"emb_in": jnp.asarray(rng.normal(size=(n, 16)) / 16, jnp.float32),
               "emb_out_ns": jnp.zeros((n, 16), jnp.float32)}
    path = str(tmp_path / "jck")
    jck.save_checkpoint(path, JState(jparams, step=3, words_done=3 * 4 * 192,
                                     epoch=0), jcfg, jvocab)
    out = str(tmp_path / "port")
    rc = cli(["-train", zipf_file, "-output", "", "--backend", "cpu",
              "--resume", path, "--checkpoint-dir", out, "--quiet"])
    assert rc == 0
    err = capsys.readouterr().err
    assert "checkpoint written by word2vec_tpu;" in err
    assert "['health_metrics', 'quality_probe_every']" in err
    state, cfg, _ = ck.load_checkpoint(out)
    assert state.step > 3 and cfg.word_dim == 16
    assert not cfg.health_metrics and cfg.quality_probe_every == 0
    assert ck.checkpoint_writer(out) == ck.WRITER
