"""The port's native host data layer (word2vec_tpu_torch/native) against the
JAX package's native layer, the pure-Python fallbacks and the numpy fill:
count_file, encode_file and fill_batch give the same results bitwise, on a
temporary corpus in both the text8 and the lines format; the library is
built into build/native/ under a source-hash name, never beside the
source."""

import shutil

import numpy as np
import pytest

from word2vec_tpu import native as jnative
from word2vec_tpu.data.corpus import load_corpus as j_load_corpus
from word2vec_tpu_torch import native
from word2vec_tpu_torch.data.batcher import (
    BatchIterator, PackedCorpus, epoch_order, fill_batch,
)
from word2vec_tpu_torch.data.corpus import load_corpus
from word2vec_tpu_torch.data.vocab import Vocab

HAVE_CXX = shutil.which("g++") is not None
needs_cxx = pytest.mark.skipif(
    not HAVE_CXX,
    reason="no g++ on this host: the native layer falls back to the "
    "Python path, which the other tests of this file still hold",
)

FORMATS = {"text8": native.MODE_STREAM, "lines": native.MODE_LINES}


@pytest.fixture
def corpus_file(tmp_path):
    """A Zipf-ish corpus of 300 lines of 1-40 words over 200 words, made
    from a seed."""
    rng = np.random.default_rng(5)
    p = 1.0 / np.arange(1, 201)
    p /= p.sum()
    lines = []
    for _ in range(300):
        n = int(rng.integers(0, 41))
        lines.append(" ".join(f"t{int(i)}" for i in rng.choice(200, n, p=p)))
    path = tmp_path / "corpus.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@needs_cxx
def test_native_builds_into_build_dir():
    assert native.available(), native.build_error
    assert native.implementation() == "native"
    lib = native._target()
    assert lib.exists() and lib.parent.name == "native"
    assert lib.parent.parent.name == "build"
    assert not list(native._SRC.parent.glob("*.so"))


def test_count_matches_jax_and_python(corpus_file):
    c, t = native.count_file(corpus_file)
    jc, jt = jnative.count_file(corpus_file)
    pc, pt = native._count_file_py(corpus_file)
    assert c == jc == pc and t == jt == pt


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_encode_matches_jax_and_python(corpus_file, fmt):
    vocab = Vocab.from_counter(native.count_file(corpus_file)[0], min_count=3)
    ids = native.encode_file(corpus_file, vocab, FORMATS[fmt])
    jids = jnative.encode_file(corpus_file, vocab, FORMATS[fmt])
    pids = native._encode_file_py(corpus_file, vocab, FORMATS[fmt])
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(ids, pids)
    assert (ids == -1).any() == (fmt == "lines")


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_load_corpus_matches_jax(corpus_file, fmt):
    vocab, flat = load_corpus(corpus_file, fmt=fmt, min_count=2, max_vocab=150)
    jvocab, jflat = j_load_corpus(corpus_file, fmt=fmt, min_count=2,
                                  max_vocab=150)
    assert vocab.words == jvocab.words
    assert vocab.content_hash() == jvocab.content_hash()
    np.testing.assert_array_equal(flat, jflat)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_fill_batch_matches_jax_and_numpy(corpus_file, fmt):
    vocab, flat = load_corpus(corpus_file, fmt=fmt, min_count=1)
    corpus = PackedCorpus.from_flat(flat, 16)
    order = epoch_order(3, 1, corpus.num_rows)
    for pos in (0, 37, corpus.num_rows - 5):  # the last batch runs off the end
        out = np.empty((12, 16), np.int32)
        jout = np.empty_like(out)
        pout = np.empty_like(out)
        args = (corpus.flat, corpus.row_starts, corpus.row_lens, order, pos)
        w = native.fill_batch(*args, out)
        jw = jnative.fill_batch(*args, jout)
        pw = fill_batch(*args, pout)
        assert w == jw == pw
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(out, pout)


def test_batch_iterator_goes_through_the_native_fill(corpus_file, monkeypatch):
    vocab, flat = load_corpus(corpus_file, fmt="lines", min_count=1)
    corpus = PackedCorpus.from_flat(flat, 16)
    calls = []
    real = native.fill_batch

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(native, "fill_batch", spy)
    batches = list(BatchIterator(corpus, 8, 16, seed=2).epoch(0))
    assert len(calls) == len(batches) == -(-corpus.num_rows // 8)
    order = epoch_order(2, 0, corpus.num_rows)
    for i, (b, w) in enumerate(batches):
        ref = np.empty((8, 16), np.int32)
        assert w == fill_batch(corpus.flat, corpus.row_starts, corpus.row_lens,
                               order, i * 8, ref)
        np.testing.assert_array_equal(b, ref)


def test_fill_batch_rejects_a_wrong_out_buffer(corpus_file):
    if not native.available():
        pytest.skip("no native layer: the numpy fill takes any buffer")
    vocab, flat = load_corpus(corpus_file, min_count=1)
    corpus = PackedCorpus.from_flat(flat, 16)
    order = epoch_order(0, 0, corpus.num_rows)
    with pytest.raises(ValueError, match="C-contiguous int32"):
        native.fill_batch(corpus.flat, corpus.row_starts, corpus.row_lens,
                          order, 0, np.empty((4, 16), np.int64))
