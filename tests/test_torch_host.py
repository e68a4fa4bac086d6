"""The PyTorch port's host layer against the JAX package (CPU).

Pins: the copied host modules give identical outputs on the same inputs
(vocab, alias tables, packing, batches, synthetic corpora, vector files);
config validation is the same; weights carry across exactly in both table
layouts; the banded helpers and the step's update helpers agree with the
JAX package's on the same (numpy-seeded) inputs; the port imports no jax;
entry points refuse to run without a device unless asked for the CPU.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data import batcher as jbatcher  # noqa: E402
from word2vec_tpu.data.negative import build_alias_table as j_alias  # noqa: E402
from word2vec_tpu.data.vocab import Vocab as JVocab  # noqa: E402
from word2vec_tpu.io import embeddings as jemb  # noqa: E402
from word2vec_tpu.models.params import init_params as j_init  # noqa: E402
from word2vec_tpu.ops import banded as jbanded  # noqa: E402
from word2vec_tpu.ops import train_step as jts  # noqa: E402
from word2vec_tpu.utils import synthetic as jsyn  # noqa: E402

from word2vec_tpu_torch import Trainer, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.data import batcher as tbatcher  # noqa: E402
from word2vec_tpu_torch.data.negative import build_alias_table as t_alias  # noqa: E402
from word2vec_tpu_torch.data.vocab import Vocab as TVocab  # noqa: E402
from word2vec_tpu_torch.io import embeddings as temb  # noqa: E402
from word2vec_tpu_torch.models import params as tparams  # noqa: E402
from word2vec_tpu_torch.ops import banded as tbanded  # noqa: E402
from word2vec_tpu_torch.ops import train_step as tts  # noqa: E402
from word2vec_tpu_torch.utils import synthetic as tsyn  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sentences():
    toks, _ = jsyn.topic_corpus(n_topics=3, words_per_topic=8,
                                shared_words=4, n_tokens=3000, seed=2)
    return [toks[i:i + 17] for i in range(0, len(toks), 17)]


# ------------------------------------------------------------ host copies
def test_vocab_and_alias_tables_are_identical():
    sents = _sentences()
    jv, tv = JVocab.build(sents, min_count=2), TVocab.build(sents, min_count=2)
    assert jv.words == tv.words
    np.testing.assert_array_equal(jv.counts, tv.counts)
    assert jv.content_hash() == tv.content_hash()
    np.testing.assert_array_equal(jv.keep_probs(1e-3), tv.keep_probs(1e-3))
    ja, ta = j_alias(jv.unigram_probs(0.75)), t_alias(tv.unigram_probs(0.75))
    np.testing.assert_array_equal(ja.accept, ta.accept)
    np.testing.assert_array_equal(ja.alias, ta.alias)


def test_packed_corpus_and_batches_are_identical():
    sents = _sentences()
    vocab = JVocab.build(sents, min_count=1)
    enc = list(vocab.encode_corpus(sents))
    jc = jbatcher.PackedCorpus.pack(enc, 12)
    tc = tbatcher.PackedCorpus.pack(enc, 12)
    for f in ("flat", "row_starts", "row_lens"):
        np.testing.assert_array_equal(getattr(jc, f), getattr(tc, f))
    flat = np.concatenate([np.append(e, -1) for e in enc]).astype(np.int32)
    jf, tf = (m.PackedCorpus.from_flat(flat, 12) for m in (jbatcher, tbatcher))
    np.testing.assert_array_equal(jf.row_starts, tf.row_starts)
    np.testing.assert_array_equal(jf.row_lens, tf.row_lens)
    ji = jbatcher.BatchIterator(jc, 7, 12, seed=3)
    ti = tbatcher.BatchIterator(tc, 7, 12, seed=3)
    for epoch in (0, 1):
        jb = list(ji.epoch(epoch))
        tb = list(ti.epoch(epoch, skip=0))
        assert len(jb) == len(tb) == ti.steps_per_epoch()
        for (a, wa), (b, wb) in zip(jb, tb):
            np.testing.assert_array_equal(a, b)
            assert wa == wb


def test_synthetic_corpora_are_identical():
    jv, tv = jsyn.zipf_vocab(500, 100_000), tsyn.zipf_vocab(500, 100_000)
    assert jv.content_hash() == tv.content_hash()
    for a, b in zip(jsyn.zipf_corpus_ids(jv, 3000, seed=1),
                    tsyn.zipf_corpus_ids(tv, 3000, seed=1)):
        np.testing.assert_array_equal(a, b)
    assert jsyn.topic_corpus(n_tokens=2000) == tsyn.topic_corpus(n_tokens=2000)


@pytest.mark.parametrize("fmt", ["text", "binary"])
def test_vector_files_cross_load(tmp_path, fmt):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(9)]
    mat = rng.normal(size=(9, 5)).astype(np.float32)
    path = str(tmp_path / "v")
    getattr(temb, f"save_embeddings_{fmt}")(path, words, mat)
    w2, m2 = getattr(jemb, f"load_embeddings_{fmt}")(path)
    assert w2 == words
    np.testing.assert_allclose(m2, mat, rtol=1e-6)


@pytest.mark.parametrize(
    "kw",
    [
        dict(band_backend="pallas_fused", table_layout="split"),
        dict(band_backend="pallas_fused", table_layout="unified",
             negative_scope="batch"),
        dict(stochastic_rounding=True),
        dict(band_chunk=4, window=5),
        dict(model="skipgram"),
    ],
)
def test_config_validation_matches(kw):
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        Word2VecConfig(**kw)
    assert str(je.value) == str(te.value)


def test_config_defaults_match():
    import dataclasses

    j, t = JConfig(), Word2VecConfig()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (JConfig.auto_geometry(10**6, vocab_size=5000)
            == Word2VecConfig.auto_geometry(10**6, vocab_size=5000))


# ------------------------------------------------------------ weights
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src_layout", ["split", "unified"])
@pytest.mark.parametrize("dst_layout", ["split", "unified"])
def test_params_cross_package_round_trip(dtype, src_layout, dst_layout):
    """JAX params as numpy -> port params -> numpy: exact in both layouts
    and both dtypes (bf16 passes through float32, which holds it)."""
    jcfg = JConfig(word_dim=8, min_count=1, dtype=dtype,
                   table_layout=src_layout)
    jp = {k: np.asarray(v) for k, v in
          j_init(jcfg, 30, jax.random.key(0)).items()}
    tcfg = Word2VecConfig(word_dim=8, min_count=1, dtype=dtype,
                          table_layout=dst_layout)
    tp = tparams.params_from_numpy(jp, tcfg, "cpu")
    assert tparams.params_layout(tp) == dst_layout
    for v in tp.values():
        assert v.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    back = tparams.params_to_numpy(tp)
    for name in ("emb_in", "emb_out_ns"):
        np.testing.assert_array_equal(
            tparams.logical_table(back, name),
            np.asarray(tparams.logical_table(jp, name), np.float32),
        )
    np.testing.assert_array_equal(
        tparams.export_matrix(back, tcfg),
        np.asarray(tparams.export_matrix(jp, jcfg), np.float32),
    )


@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_init_params_shape_dtype_range(model):
    cfg = Word2VecConfig(model=model, word_dim=16, min_count=1,
                         table_layout="unified", dtype="bfloat16")
    g = torch.Generator().manual_seed(0)
    p = tparams.init_params(cfg, 50, g)
    slab = p[tparams.FUSED_KEY]
    assert slab.shape == (50, 2, 16) and slab.dtype == torch.bfloat16
    live, zero = (0, 1) if model == "sg" else (1, 0)
    assert torch.all(slab[:, zero] == 0)
    w = slab[:, live].float()
    assert float(w.abs().max()) <= 0.5 / 16 and float(w.std()) > 0.01


# ------------------------------------------------------------ helpers
@pytest.mark.parametrize("L,W,req", [(40, 3, 10), (192, 5, 0), (12, 2, 0),
                                     (100, 7, 20)])
def test_banded_geometry_matches(L, W, req):
    S = tbanded.resolve_chunk(L, W, req)
    assert S == jbanded.resolve_chunk(L, W, req)
    if S == 0:
        return
    assert tbanded._geom(L, W, S) == jbanded._geom(L, W, S)
    rng = np.random.default_rng(L)
    tok = rng.integers(0, 50, size=(3, L)).astype(np.int32)
    tok[1, L // 2:] = -1
    np.testing.assert_array_equal(
        tbanded.slab_token_ids(torch.from_numpy(tok), W, S).numpy(),
        np.asarray(jbanded.slab_token_ids(jnp.asarray(tok), W, S)),
    )
    keep = rng.random((3, L)) < 0.7
    w_eff = rng.integers(1, W + 1, size=(3, L)).astype(np.int32)
    valid = tok >= 0
    np.testing.assert_array_equal(
        tbanded.band_mask(torch.from_numpy(keep), torch.from_numpy(valid),
                          torch.from_numpy(w_eff), W, S).numpy(),
        np.asarray(jbanded.band_mask(jnp.asarray(keep), jnp.asarray(valid),
                                     jnp.asarray(w_eff), W, S)),
    )
    C, _ = tbanded._geom(L, W, S)
    y = rng.normal(size=(3, C, S + 2 * W, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tbanded._overlap_add(torch.from_numpy(y), S, 2 * W).numpy(),
        np.asarray(jbanded._overlap_add(jnp.asarray(y), S, 2 * W)),
    )


def test_update_helpers_match_jax():
    """Alias draw, duplicate-mean scale, clip scale (same bucket/coin
    inputs, same index sets): exact for the draws and counts; the clip
    norms are f32 sums of squares, rtol 1e-6 for the reduction order."""
    rng = np.random.default_rng(7)
    V = 40
    at = j_alias(rng.random(V) + 0.1)
    key = jax.random.key(3)
    kb, kc = jax.random.split(key)
    bucket = jax.random.randint(kb, (5, 8), 0, V, dtype=jnp.int32)
    coin = jax.random.uniform(kc, (5, 8))
    j_negs = jts._draw_negatives(key, (5, 8), jnp.asarray(at.accept),
                                 jnp.asarray(at.alias))
    t_negs = tts._draw_negatives(
        torch.from_numpy(np.array(bucket)), torch.from_numpy(np.array(coin)),
        torch.from_numpy(at.accept), torch.from_numpy(at.alias),
    )
    np.testing.assert_array_equal(t_negs.numpy(), np.asarray(j_negs))
    idx = np.sort(rng.integers(0, V, size=60)).astype(np.int32)
    w = rng.integers(0, 3, size=60).astype(np.float32)
    np.testing.assert_array_equal(
        tts._dup_mean_scale(V, torch.from_numpy(idx), torch.from_numpy(w)).numpy(),
        np.asarray(jts._dup_mean_scale(V, jnp.asarray(idx), jnp.asarray(w))),
    )
    vals = rng.normal(size=(60, 6)).astype(np.float32)
    idx2 = rng.integers(0, V, size=10).astype(np.int32)
    vals2 = rng.normal(size=(10, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tts._row_clip_scale(V, 2.0, (torch.from_numpy(idx), torch.from_numpy(vals)),
                            (torch.from_numpy(idx2), torch.from_numpy(vals2))).numpy(),
        np.asarray(jts._row_clip_scale(V, 2.0, (jnp.asarray(idx), jnp.asarray(vals)),
                                       (jnp.asarray(idx2), jnp.asarray(vals2)))),
        rtol=1e-6,
    )


def test_stochastic_rounding_cast_matches_jax():
    """SR given the same uniforms is exact: ulp(dest) is a power of two
    taken from a bf16 value (floor(log2) is unambiguous there), so the
    quantization is exact arithmetic in both packages."""
    rng = np.random.default_rng(1)
    dest = jnp.asarray(rng.normal(0, 0.3, size=(50, 8)).astype(np.float32)
                       ).astype(jnp.bfloat16)
    dest = dest.at[0].set(0.0)  # the 1e-7 floor
    vals = rng.normal(0, 1e-3, size=(50, 8)).astype(np.float32)
    key = jax.random.key(5)
    u = jax.random.uniform(key, (50, 8))
    ref = jts._cast_update(jnp.asarray(vals), jnp.bfloat16, key, dest)
    got = tts._cast_update(
        torch.from_numpy(vals), torch.bfloat16,
        torch.from_numpy(np.array(u)),
        torch.from_numpy(np.asarray(dest, np.float32)).to(torch.bfloat16),
    )
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))
    plain = tts._cast_update(torch.from_numpy(vals), torch.bfloat16)
    np.testing.assert_array_equal(
        plain.float().numpy(),
        np.asarray(jts._cast_update(jnp.asarray(vals), jnp.bfloat16), np.float32),
    )


# ------------------------------------------------------------ isolation
#: the serving tier's modules, which the walk below must reach
SERVE_TIER = (
    "serve.server", "serve.metrics", "serve.__main__", "obs.trace",
    "obs.flight", "obs.export", "obs.signals", "obs.quality",
    "resilience.faults", "resilience.watchdog", "resilience.shutdown",
)


def test_port_imports_without_jax():
    """Every module of the port (the serving tier's among them) imports
    with jax and the JAX package blocked, and no module of either is
    loaded."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['word2vec_tpu'] = None\n"
        "import word2vec_tpu_torch as p\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, 'word2vec_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        f"missing = [m for m in {SERVE_TIER!r}\n"
        "           if 'word2vec_tpu_torch.' + m not in names]\n"
        "assert not missing, missing\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None and\n"
        "       (m in ('jax', 'word2vec_tpu') or m.startswith('jax.')\n"
        "        or m.startswith('word2vec_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_sources_name_no_jax():
    import re

    pat = re.compile(r"^\s*(import jax|from jax|import word2vec_tpu\b(?!_torch)"
                     r"|from word2vec_tpu[ .](?!_torch))", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "word2vec_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for m in SERVE_TIER:
        assert os.path.join(REPO, "word2vec_tpu_torch",
                            *m.split(".")) + ".py" in files, m
    for f in files:
        with open(f) as fh:
            assert not pat.search(fh.read()), f


def test_trainer_without_device_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Word2VecConfig(word_dim=8, min_count=1, window=2, batch_rows=2,
                         max_sentence_len=12, band_chunk=4,
                         table_layout="unified", band_backend="pallas_fused")
    sents = [["a", "b", "c", "a", "b"]] * 4
    vocab = TVocab.build(sents, min_count=1)
    corpus = tbatcher.PackedCorpus.pack(vocab.encode_corpus(sents), 12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, vocab, corpus)
    Trainer(cfg, vocab, corpus, device="cpu")  # explicit CPU is allowed
