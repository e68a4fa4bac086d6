"""Corpus readers.

Reference equivalents:
  - text8_corpus: whitespace token stream chunked into 1000-word
    pseudo-sentences (reference: main.cpp:63-92). Here the path is a real
    parameter — the reference hardcodes "text8" (main.cpp:68) and ignores its
    own -train flag; that bug is not replicated.
  - line_docs: one sentence per line (reference: Word2Vec.cpp:19-30).

Readers are generators: the corpus streams through vocab counting and encoding
without materializing a vector<vector<string>> like the reference does, which
matters at enwik9 scale (~124M tokens).

A copy of word2vec_tpu/data/corpus.py for the PyTorch port. When the
native C++ host library is available (word2vec_tpu_torch.native), the
tokenize/encode hot path of `load_corpus` is done there; these pure-Python
readers are the always-available fallback and the reference semantics
definition.
"""

from __future__ import annotations

from typing import Iterator, List

DEFAULT_CHUNK_WORDS = 1000  # reference: main.cpp:66 max_sentence_len


def text8_corpus(path: str, chunk_words: int = DEFAULT_CHUNK_WORDS) -> Iterator[List[str]]:
    """Whitespace tokens chunked into fixed-size pseudo-sentences.

    Reference: main.cpp:63-92 (chunk boundary at :80-85, trailing partial
    sentence kept at :88-89).
    """
    sentence: List[str] = []
    remainder = ""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            block = remainder + block
            parts = block.split()
            # A token can straddle the block boundary: hold back the tail
            # unless the block ends in whitespace.
            if parts and not block[-1].isspace():
                remainder = parts.pop()
            else:
                remainder = ""
            for tok in parts:
                sentence.append(tok)
                if len(sentence) == chunk_words:
                    yield sentence
                    sentence = []
    if remainder:
        sentence.append(remainder)
    if sentence:
        yield sentence


def line_docs(path: str) -> Iterator[List[str]]:
    """One whitespace-tokenized sentence per line (reference: Word2Vec.cpp:19-30)."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            toks = line.split()
            if toks:
                yield toks


def load_corpus(
    path: str, fmt: str = "text8", min_count: int = 5, max_vocab: int = 0
):
    """One-shot corpus load: (Vocab, flat int32 id stream).

    Uses the native C++ layer (word2vec_tpu_torch.native) for the two
    host-side O(corpus) passes — word counting and id encoding — falling
    back to Python transparently. `fmt` selects the reference reader
    semantics: "text8" is a whitespace stream (main.cpp:63-92), "lines"
    treats each line as a sentence (Word2Vec.cpp:19-30; sentence breaks
    become -1 separators in the stream). max_vocab > 0 caps the vocabulary
    to the top-N by count (the working replacement for the reference's
    declared-but-undefined reduce_vocab, Word2Vec.h:69); capped-out words
    encode as OOV and are dropped.

    Pack the result with PackedCorpus.from_flat(flat, max_sentence_len).
    """
    from .. import native
    from .vocab import Vocab

    mode = native.MODE_STREAM if fmt == "text8" else native.MODE_LINES
    counts, total = native.count_file(path)
    vocab = Vocab.from_counter(counts, min_count=min_count, max_vocab=max_vocab)
    flat = native.encode_file(path, vocab, mode, max_tokens=total)
    return vocab, flat
