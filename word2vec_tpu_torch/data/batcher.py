"""Fixed-shape batch pipeline: encoded corpus -> [B, L] token-id matrices.

A copy of word2vec_tpu/data/batcher.py for the PyTorch port. Batch assembly
goes through the native C++ fill (native.fill_batch) when the host layer
builds; `fill_batch` below is its plain numpy version (the JAX package's
`native._fill_batch_py`), and both produce identical batches. The
background-thread prefetch of the JAX module is not copied: the port's
trainer fills the next chunk on its own thread while the card runs the
current one, which measured faster on the H100 host than a producer thread
competing with it for the GIL (PERF.md).

Device-first design (SURVEY §7 step 2): the host does *no* pair generation.
Sentences are packed into fixed-shape int32 rows (pad = -1); subsampling,
window shrink, pair enumeration and negative sampling all happen inside the
device step (ops/). This keeps the host loop at O(tokens) memcpy
— essential on a 1-core host — and makes device cost shape-static.

The per-epoch sentence shuffle (reference: Word2Vec.cpp:373 std::shuffle)
becomes a per-epoch row permutation. Sentences longer than max_len are wrapped
into multiple rows; context windows do not cross row boundaries, which differs
from the reference only for the ~2*window/max_len fraction of positions at
wrap points.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

PAD = -1


class PackedCorpus:
    """Flat token-id array + row table; the in-memory corpus representation."""

    def __init__(self, flat: np.ndarray, row_starts: np.ndarray, row_lens: np.ndarray):
        self.flat = flat
        self.row_starts = row_starts
        self.row_lens = row_lens

    @property
    def num_rows(self) -> int:
        return len(self.row_starts)

    @property
    def num_tokens(self) -> int:
        return int(self.row_lens.sum())

    @classmethod
    def from_flat(cls, flat: np.ndarray, max_len: int) -> "PackedCorpus":
        """Pack a flat id stream (from native.encode_file).

        Runs of ids between -1 separators are sentences (MODE_LINES); a stream
        with no separators (MODE_STREAM / text8) is one giant sentence whose
        rows are cut every max_len tokens — the same boundaries the reference's
        1000-word chunking would produce after re-wrapping.
        """
        flat = np.asarray(flat, dtype=np.int32)
        if len(flat) == 0:
            raise ValueError("empty corpus")
        if not (flat == PAD).any():
            n = len(flat)
            starts = np.arange(0, n, max_len, dtype=np.int64)
            lens = np.minimum(n - starts, max_len).astype(np.int32)
            return cls(flat, starts, lens)
        # split at separators, then wrap each sentence
        sep = np.flatnonzero(flat == PAD)
        bounds = np.concatenate([[-1], sep, [len(flat)]])
        starts: List[int] = []
        lens: List[int] = []
        for s, e in zip(bounds[:-1] + 1, bounds[1:]):
            n = e - s
            for ofs in range(0, n, max_len):
                starts.append(s + ofs)
                lens.append(min(max_len, n - ofs))
        return cls(
            flat,
            np.asarray(starts, dtype=np.int64),
            np.asarray(lens, dtype=np.int32),
        )

    @classmethod
    def pack(cls, sentences: Iterable[np.ndarray], max_len: int) -> "PackedCorpus":
        """Pack encoded sentences, wrapping rows longer than max_len."""
        chunks: List[np.ndarray] = []
        starts: List[int] = []
        lens: List[int] = []
        pos = 0
        for ids in sentences:
            n = len(ids)
            if n == 0:
                continue
            chunks.append(np.asarray(ids, dtype=np.int32))
            for ofs in range(0, n, max_len):
                ln = min(max_len, n - ofs)
                starts.append(pos + ofs)
                lens.append(ln)
            pos += n
        if not chunks:
            raise ValueError("empty corpus")
        flat = np.concatenate(chunks)
        return cls(flat, np.asarray(starts, dtype=np.int64), np.asarray(lens, dtype=np.int32))


def epoch_order(seed: int, epoch_index: int, num_rows: int) -> np.ndarray:
    """The per-epoch row permutation — a pure function of (seed, epoch), the
    property mid-epoch resume and the device-resident path both rely on
    (reference shuffle: Word2Vec.cpp:373). Single source of truth for
    BatchIterator and ops/resident.py."""
    order = np.arange(num_rows, dtype=np.int64)
    np.random.default_rng((seed, epoch_index)).shuffle(order)
    return order


class BatchIterator:
    """Yields [B, L] int32 batches (pad = -1) in per-epoch shuffled row order.

    The final partial batch of an epoch is padded with empty rows so every
    device step has the same shape (no recompilation).

    Each epoch's permutation is a pure function of (seed, epoch index) —
    epoch k can be regenerated in isolation, which is what makes mid-epoch
    checkpoint resume possible (epoch(k, skip=n) re-enters epoch k at batch
    n without replaying batches 0..n-1). Calling epoch() with no index keeps
    an internal counter, so sequential use shuffles every pass as before
    (Word2Vec.cpp:373).
    """

    def __init__(
        self,
        corpus: PackedCorpus,
        batch_rows: int,
        max_len: int,
        seed: int = 0,
        shuffle: bool = True,
    ):
        self.corpus = corpus
        self.B = batch_rows
        self.L = max_len
        self.seed = seed
        self.shuffle = shuffle
        self._epoch_counter = 0

    def steps_per_epoch(self) -> int:
        return -(-self.corpus.num_rows // self.B)

    def epoch(
        self, epoch_index: Optional[int] = None, skip: int = 0
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """Yield (tokens [B, L], words_in_batch) for one pass over the corpus,
        starting `skip` batches in.

        The epoch starts here (its shuffle), when this is called; the
        returned iterator only fills batches, so a caller can time the two
        apart (the trainer's epoch_prep and batcher_wait spans).

        Batch assembly goes through the native fill (native.fill_batch)
        when the C++ layer is available; the numpy fill below is identical.
        """
        if epoch_index is None:
            epoch_index = self._epoch_counter
            self._epoch_counter += 1
        if self.shuffle:
            order = epoch_order(self.seed, epoch_index, self.corpus.num_rows)
        else:
            order = np.arange(self.corpus.num_rows, dtype=np.int64)
        return self._fill(order, skip)

    def _fill(
        self, order: np.ndarray, skip: int
    ) -> Iterator[Tuple[np.ndarray, int]]:
        from .. import native

        flat = self.corpus.flat
        starts = self.corpus.row_starts
        lens = self.corpus.row_lens
        B, L = self.B, self.L
        for i in range(skip * B, len(order), B):
            batch = np.empty((B, L), dtype=np.int32)
            words = native.fill_batch(flat, starts, lens, order, i, batch)
            yield batch, words


def fill_batch(
    flat: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    order: np.ndarray,
    pos: int,
    out: np.ndarray,
) -> int:
    """Fill out[B, L] (pad -1) from packed-corpus rows order[pos:pos+B];
    returns the real-token count. The plain version of native.fill_batch."""
    B, L = out.shape
    out[:] = PAD
    words = 0
    for r in range(B):
        oi = pos + r
        if oi >= len(order):
            continue
        row = int(order[oi])
        s, n = int(starts[row]), min(int(lens[row]), L)
        out[r, :n] = flat[s : s + n]
        words += n
    return words


def chunk_batches(
    epoch_iter: Iterator[Tuple[np.ndarray, int]], s: int
) -> Iterator[Tuple[np.ndarray, List[int]]]:
    """Group an epoch's [B, L] batches into [S, B, L] chunks for the chunked
    dispatch runner (ops/train_step.make_chunk_runner). The trailing partial
    chunk is padded with all-(-1) batches — provable no-op steps — so one
    captured shape covers every chunk. Yields (tokens, per-batch word
    counts: len(words) < S exactly when the chunk is padded)."""
    buf: List[np.ndarray] = []
    words: List[int] = []
    for tokens, w in epoch_iter:
        buf.append(tokens)
        words.append(w)
        if len(buf) == s:
            yield np.stack(buf), words
            buf, words = [], []
    if buf:
        dead = np.full_like(buf[0], PAD)
        yield np.stack(buf + [dead] * (s - len(buf))), words
