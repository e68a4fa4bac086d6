"""Streaming corpus sources: shard sets, directory globs, and pipes.

A copy of word2vec_tpu/stream/source.py for the PyTorch port (host code:
the same segments, cursors, spool files and admission counts).

The continuous-training data plane consumes the corpus in
bounded SEGMENTS of raw tokens instead of one resident pack. A source turns
a corpus spec into an ordered shard list and answers one question:

    read_segment(index, shard, offset, vocab=None) -> RawSegment

deterministically — the same (shard, offset) start always yields the same
raw tokens, which is what makes the mid-stream checkpoint cursor a replay
coordinate: SIGTERM at step k of segment s resumes by re-reading segment s
from its recorded start and re-entering it at batch k (train._resume_skip),
byte-for-byte on the uninterrupted trajectory.

Three sources:
  * FileSource  — an explicit file list, comma list, directory, or glob
    (resolve_shards). Offsets count raw TOKENS within a shard ("text8"
    whitespace-stream semantics, main.cpp:63-92) or LINES ("lines",
    Word2Vec.cpp:19-30). Sentences never cross shard boundaries.
  * PipeSource  — an unbounded fd/stdin stream (`-train -`). Bytes are
    SPOOLED to one file per segment before use, so a segment that has been
    read once can be re-read on resume — a pipe cannot seek, the spool can.
  * ArraySource — a pre-encoded id stream (bench/test harnesses; the 100M
    synthetic A/B shape) with zero tokenization cost.

Counting rides the read: a segment reports the words it saw that are NOT in
the current vocabulary (the online-growth admission candidates,
stream/driver.py) — or every word when `vocab` is None (the cold-start
vocabulary bootstrap).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
from collections import Counter
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

#: the pipe spec: `-train -` reads stdin through a PipeSource
PIPE_SPEC = "-"

#: reference pseudo-sentence length for the text8 whitespace stream
#: (main.cpp:66 max_sentence_len)
DEFAULT_CHUNK_WORDS = 1000


@dataclasses.dataclass
class StreamCursor:
    """The mid-stream replay coordinate a streaming checkpoint carries
    (io/checkpoint.save_checkpoint(stream=...) -> stream.json).

    Positional fields name where the IN-PROGRESS segment starts (segment
    index, shard index, consumed units within the shard); bookkeeping
    fields carry what the positional ones cannot re-derive: the vocab
    generation (how many online-growth admissions happened before this
    segment) and the run-global step/word counters (per-segment TrainState
    counters reset at every boundary, so the global totals live here).
    """

    segment: int = 0
    shard: int = 0
    offset: int = 0            # consumed units in shard: tokens (text8) | lines
    vocab_generation: int = 0
    tokens_total: int = 0      # raw tokens consumed before this segment
    global_steps: int = 0      # optimizer steps completed before this segment
    global_words: int = 0      # trained words completed before this segment

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict) -> "StreamCursor":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: int(v) for k, v in d.items() if k in known})


@dataclasses.dataclass
class RawSegment:
    """One read segment: raw material plus its positional extent."""

    index: int
    shard0: int
    offset0: int
    shard1: int                # position AFTER the segment (next start)
    offset1: int
    raw_tokens: int
    #: tokenized sentences (FileSource/PipeSource); None for ArraySource
    sentences: Optional[List[List[str]]]
    #: pre-encoded ids (ArraySource); None for token sources
    flat: Optional[np.ndarray]
    #: admission candidates: words seen that are not in `vocab` (all words
    #: when read with vocab=None); None when the source cannot count
    counts: Optional[Counter]
    #: nothing exists after (shard1, offset1) — the stream is drained
    exhausted: bool


def resolve_shards(spec: str) -> List[str]:
    """A corpus spec -> the ordered shard list.

    Comma-separated parts; each part is a glob pattern (expanded, sorted),
    a directory (its regular files, sorted), or a plain file. The order is
    deterministic — it IS the stream order the cursor indexes into."""
    shards: List[str] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if any(ch in part for ch in "*?["):
            hits = sorted(p for p in _glob.glob(part) if os.path.isfile(p))
            if not hits:
                raise FileNotFoundError(
                    f"corpus glob {part!r} matched no files"
                )
            shards.extend(hits)
        elif os.path.isdir(part):
            hits = sorted(
                e.path for e in os.scandir(part) if e.is_file()
            )
            if not hits:
                raise FileNotFoundError(
                    f"corpus directory {part!r} holds no files"
                )
            shards.extend(hits)
        elif os.path.isfile(part):
            shards.append(part)
        else:
            raise FileNotFoundError(f"corpus shard {part!r} does not exist")
    if not shards:
        raise FileNotFoundError(f"corpus spec {spec!r} resolved to no shards")
    return shards


def _iter_shard_units(path: str, fmt: str, skip: int) -> Iterator[List[str]]:
    """Yield the shard's units past `skip`: single tokens (text8) or whole
    tokenized lines (lines). Block-buffered like data/corpus.text8_corpus,
    with the same straddling-token hold-back."""
    if fmt == "lines":
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for n, line in enumerate(f):
                if n < skip:
                    continue
                yield line.split()
        return
    seen = 0
    remainder = ""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        while True:
            block = f.read(1 << 20)
            if not block:
                break
            block = remainder + block
            parts = block.split()
            if parts and not block[-1].isspace():
                remainder = parts.pop()
            else:
                remainder = ""
            for tok in parts:
                seen += 1
                if seen > skip:
                    yield [tok]
    if remainder:
        seen += 1
        if seen > skip:
            yield [remainder]


class FileSource:
    """Sharded file-set source (see module docstring)."""

    kind = "files"

    def __init__(
        self,
        shards: Sequence[str],
        fmt: str = "text8",
        segment_tokens: int = 1_000_000,
        chunk_words: int = DEFAULT_CHUNK_WORDS,
    ):
        if fmt not in ("text8", "lines"):
            raise ValueError(f"fmt must be 'text8' or 'lines', got {fmt!r}")
        if segment_tokens < 1:
            raise ValueError("segment_tokens must be >= 1")
        self.shards = list(shards)
        self.fmt = fmt
        self.segment_tokens = int(segment_tokens)
        self.chunk_words = int(chunk_words)
        if not self.shards:
            raise ValueError("FileSource needs at least one shard")

    def describe(self) -> Dict:
        return {
            "kind": self.kind,
            "shards": list(self.shards),
            "fmt": self.fmt,
            "segment_tokens": self.segment_tokens,
        }

    def read_segment(
        self, index: int, shard: int, offset: int, vocab=None
    ) -> RawSegment:
        """Read the next <= segment_tokens raw tokens starting at
        (shard, offset). Deterministic: sentence chunking restarts at the
        segment start, sentences never cross shard boundaries, and the
        segment ends exactly at segment_tokens tokens (text8) or at the
        first line boundary at/after it (lines)."""
        sentences: List[List[str]] = []
        counts: Counter = Counter()
        cur: List[str] = []
        raw = 0
        s, ofs = int(shard), int(offset)
        exhausted = False
        # membership check against a LIVE vocab dict is safe under
        # concurrent admits (CPython: no iteration, only lookups) — the
        # driver's prefetch producer counts while the consumer may grow
        contains = (lambda w: False) if vocab is None else vocab.__contains__
        while s < len(self.shards) and raw < self.segment_tokens:
            for unit in _iter_shard_units(self.shards[s], self.fmt, ofs):
                if self.fmt == "lines":
                    ofs += 1
                    raw += len(unit)
                    for tok in unit:
                        if not contains(tok):
                            counts[tok] += 1
                    if unit:
                        sentences.append(unit)
                else:
                    tok = unit[0]
                    ofs += 1
                    raw += 1
                    if not contains(tok):
                        counts[tok] += 1
                    cur.append(tok)
                    if len(cur) == self.chunk_words:
                        sentences.append(cur)
                        cur = []
                if raw >= self.segment_tokens:
                    break
            else:
                # shard drained: sentence break at the shard boundary
                if cur:
                    sentences.append(cur)
                    cur = []
                s += 1
                ofs = 0
                continue
            break  # segment full mid-shard
        if cur:
            sentences.append(cur)
        if s >= len(self.shards):
            exhausted = True
        elif raw < self.segment_tokens:
            exhausted = True  # ended early: nothing left to read
        return RawSegment(
            index=int(index), shard0=int(shard), offset0=int(offset),
            shard1=s, offset1=ofs, raw_tokens=raw,
            sentences=sentences, flat=None, counts=counts,
            exhausted=exhausted,
        )


class PipeSource:
    """An unbounded fd stream, spooled one file per segment (module doc).

    `spool_dir` must persist as long as resumability is wanted — the spool
    IS the replayable corpus the pipe itself cannot be. Cursor shape:
    shard == segment index (each segment is its own spool file),
    offset == 0 (segments are whole files)."""

    kind = "pipe"

    def __init__(
        self,
        fd: int = 0,
        spool_dir: str = "",
        fmt: str = "text8",
        segment_tokens: int = 1_000_000,
        chunk_words: int = DEFAULT_CHUNK_WORDS,
    ):
        if not spool_dir:
            raise ValueError(
                "PipeSource needs a spool_dir: the pipe cannot be re-read, "
                "so resumability requires spooling segments to disk"
            )
        os.makedirs(spool_dir, exist_ok=True)
        self.fd = int(fd)
        self.spool_dir = spool_dir
        self.fmt = fmt
        self.segment_tokens = int(segment_tokens)
        self.chunk_words = int(chunk_words)
        self._carry = b""
        self._eof = False
        self._spooled = -1  # highest segment index already on disk
        for name in os.listdir(spool_dir):
            if name.startswith("seg_") and name.endswith(".txt"):
                try:
                    self._spooled = max(self._spooled, int(name[4:-4]))
                except ValueError:
                    pass

    def describe(self) -> Dict:
        return {
            "kind": self.kind,
            "spool_dir": self.spool_dir,
            "fmt": self.fmt,
            "segment_tokens": self.segment_tokens,
        }

    def _spool_path(self, index: int) -> str:
        return os.path.join(self.spool_dir, f"seg_{index:06d}.txt")

    def _spool_next(self) -> bool:
        """Spool one more segment file from the fd; False at EOF with
        nothing left to write."""
        if self._eof and not self._carry:
            return False
        chunks = [self._carry]
        total = len(self._carry.split())
        while total < self.segment_tokens and not self._eof:
            block = os.read(self.fd, 1 << 20)
            if not block:
                self._eof = True
                break
            chunks.append(block)
            total += len(block.split())
        data = b"".join(chunks)
        if not data.strip():
            self._carry = b""
            return False
        # cut at a unit boundary: whitespace for text8, newline for lines
        toks = data.split()
        if len(toks) > self.segment_tokens and not self._eof:
            if self.fmt == "lines":
                cut = data.rfind(b"\n")
                if cut < 0:
                    cut = len(data)
                else:
                    cut += 1
            else:
                kept = b" ".join(toks[: self.segment_tokens]) + b" "
                cut = len(kept)
                data = kept + b" ".join(toks[self.segment_tokens:])
            head, self._carry = data[:cut], data[cut:]
        else:
            head, self._carry = data, b""
        self._spooled += 1
        path = self._spool_path(self._spooled)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(head)
        os.replace(tmp, path)  # a torn spool file must never be replayed
        return True

    def read_segment(
        self, index: int, shard: int, offset: int, vocab=None
    ) -> RawSegment:
        del shard, offset  # pipe cursor: shard == index, offset == 0
        while self._spooled < index:
            if not self._spool_next():
                return RawSegment(
                    index=index, shard0=index, offset0=0,
                    shard1=index, offset1=0, raw_tokens=0,
                    sentences=[], flat=None, counts=Counter(),
                    exhausted=True,
                )
        inner = FileSource(
            [self._spool_path(index)], fmt=self.fmt,
            segment_tokens=self.segment_tokens,
            chunk_words=self.chunk_words,
        )
        raw = inner.read_segment(index, 0, 0, vocab=vocab)
        more = (self._spooled > index) or not self._eof or bool(self._carry)
        return RawSegment(
            index=index, shard0=index, offset0=0,
            shard1=index + 1, offset1=0, raw_tokens=raw.raw_tokens,
            sentences=raw.sentences, flat=None, counts=raw.counts,
            exhausted=not more,
        )


class ArraySource:
    """A pre-encoded int32 id stream (bench/test harness; no growth)."""

    kind = "array"

    def __init__(self, flat: np.ndarray, segment_tokens: int = 1_000_000):
        self.flat = np.asarray(flat, dtype=np.int32)
        self.segment_tokens = int(segment_tokens)
        if self.segment_tokens < 1:
            raise ValueError("segment_tokens must be >= 1")

    def describe(self) -> Dict:
        return {
            "kind": self.kind,
            "tokens": int(len(self.flat)),
            "segment_tokens": self.segment_tokens,
        }

    def read_segment(
        self, index: int, shard: int, offset: int, vocab=None
    ) -> RawSegment:
        del vocab
        start = int(offset)
        end = min(len(self.flat), start + self.segment_tokens)
        piece = self.flat[start:end]
        return RawSegment(
            index=int(index), shard0=0, offset0=start,
            shard1=0, offset1=end, raw_tokens=int(end - start),
            sentences=None, flat=piece, counts=None,
            exhausted=end >= len(self.flat),
        )


def make_source(
    spec: str,
    fmt: str = "text8",
    segment_tokens: int = 1_000_000,
    spool_dir: str = "",
    chunk_words: int = DEFAULT_CHUNK_WORDS,
    fd: Optional[int] = None,
):
    """The CLI's source factory: `-` (or an explicit fd) is a pipe, spooled
    under `spool_dir`; anything else resolves through resolve_shards."""
    if spec == PIPE_SPEC or fd is not None:
        return PipeSource(
            fd=0 if fd is None else fd, spool_dir=spool_dir, fmt=fmt,
            segment_tokens=segment_tokens, chunk_words=chunk_words,
        )
    return FileSource(
        resolve_shards(spec), fmt=fmt, segment_tokens=segment_tokens,
        chunk_words=chunk_words,
    )
