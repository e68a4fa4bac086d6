"""ctypes bindings for the native host data layer (host_data.cpp).

A copy of word2vec_tpu/native/__init__.py for the PyTorch port, with one
change of build: the shared library is compiled with g++ at first use into
`build/native/` beside the package (ignored by git), under a name keyed by
a hash of the source and the flags, written to a temporary name and
renamed into place, so several processes may build at once and a changed
source never loads a stale library. Nothing is built next to the source.

Every entry point has a pure-Python fallback — the semantics definition —
so the package works identically without a toolchain, just slower on the
host-side corpus pass. `implementation()` says which one runs.

Public API:
    available() -> bool
    implementation() -> "native" | "python"
    count_file(path) -> (counts dict, total_words)   [vocab counting]
    encode_file(path, vocab, mode) -> np.ndarray[int32]
    fill_batch(flat, starts, lens, order, pos, out) -> words  [batch assembly]
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "host_data.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
#: why the native layer is unavailable (the compiler's message), if it is
build_error: Optional[str] = None

MODE_STREAM = 0  # text8-style whitespace stream
MODE_LINES = 1   # newline = sentence boundary (-1 separators)


def _target() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libw2vhost-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    global build_error
    out = _target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        build_error = (e.stderr or b"").decode(errors="replace") or str(e)
        return None
    except (subprocess.TimeoutExpired, OSError) as e:
        build_error = str(e)
        return None
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed, build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _build()
        if path is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            build_error = str(e)
            _build_failed = True
            return None
        lib.w2v_count_file.restype = ctypes.c_void_p
        lib.w2v_count_file.argtypes = [ctypes.c_char_p]
        lib.w2v_counter_size.restype = ctypes.c_longlong
        lib.w2v_counter_size.argtypes = [ctypes.c_void_p]
        lib.w2v_counter_total.restype = ctypes.c_longlong
        lib.w2v_counter_total.argtypes = [ctypes.c_void_p]
        lib.w2v_counter_entry.restype = ctypes.c_longlong
        lib.w2v_counter_entry.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.w2v_counter_free.restype = None
        lib.w2v_counter_free.argtypes = [ctypes.c_void_p]
        lib.w2v_vocab_create.restype = ctypes.c_void_p
        lib.w2v_vocab_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_longlong,
        ]
        lib.w2v_vocab_free.restype = None
        lib.w2v_vocab_free.argtypes = [ctypes.c_void_p]
        lib.w2v_encode_file.restype = ctypes.c_longlong
        lib.w2v_encode_file.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ]
        lib.w2v_fill_batch.restype = ctypes.c_longlong
        lib.w2v_fill_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def implementation() -> str:
    """"native" when the C++ layer built and loaded, else "python"."""
    return "native" if available() else "python"


# ------------------------------------------------------------------ counting
def count_file(path: str) -> Tuple[Dict[str, int], int]:
    """Word counts + total tokens. Native if possible, else pure Python."""
    lib = _load()
    if lib is None:
        return _count_file_py(path)
    h = lib.w2v_count_file(path.encode())
    if not h:
        raise OSError(f"cannot read {path}")
    try:
        n = lib.w2v_counter_size(h)
        total = lib.w2v_counter_total(h)
        buf = ctypes.create_string_buffer(1 << 16)
        counts: Dict[str, int] = {}
        for i in range(n):
            c = lib.w2v_counter_entry(h, i, buf, len(buf))
            if c < 0:
                raise RuntimeError("counter entry overflow")
            w = buf.value.decode("utf-8", errors="replace")
            # distinct invalid-byte tokens can decode to the same U+FFFD
            # string: merge counts rather than overwrite (matches the Python
            # fallback, which decodes before counting). Such tokens still
            # fail to match raw corpus bytes in encode_file and are dropped
            # as OOV there — a native/Python divergence for non-UTF8
            # corpora only (text8/enwik9 are ASCII).
            counts[w] = counts.get(w, 0) + c
        return counts, int(total)
    finally:
        lib.w2v_counter_free(h)


def _count_file_py(path: str) -> Tuple[Dict[str, int], int]:
    from collections import Counter

    counter: Counter = Counter()
    total = 0
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            toks = line.split()
            counter.update(toks)
            total += len(toks)
    return dict(counter), total


# ------------------------------------------------------------------- encode
def encode_file(
    path: str, vocab, mode: int = MODE_STREAM, max_tokens: Optional[int] = None
) -> np.ndarray:
    """Corpus -> flat int32 id stream (OOV dropped, Word2Vec.cpp:223; mode
    LINES inserts -1 at sentence boundaries). `vocab` is a data.vocab.Vocab.

    max_tokens: total corpus token count if known (from count_file) — sizes
    the output buffer tightly (ids + separators <= 2*tokens). Without it the
    bound falls back to the file byte count.
    """
    lib = _load()
    if lib is None:
        return _encode_file_py(path, vocab, mode)
    if max_tokens is not None:
        cap = 2 * max_tokens + 2 if mode == MODE_LINES else max_tokens + 2
    else:
        # ids + separators <= whitespace tokens + sentences <= bytes + 2
        cap = os.path.getsize(path) + 2
    out = np.empty(cap, dtype=np.int32)
    words = [w.encode() for w in vocab.words]
    arr = (ctypes.c_char_p * len(words))(*words)
    vh = lib.w2v_vocab_create(arr, len(words))
    if not vh:
        raise MemoryError("vocab handle")
    try:
        n = lib.w2v_encode_file(
            path.encode(), vh, mode,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        if n < 0:
            raise OSError(f"cannot read {path}")
        return out[:n].copy()
    finally:
        lib.w2v_vocab_free(vh)


def _encode_file_py(path: str, vocab, mode: int) -> np.ndarray:
    w2i = vocab.word2id
    ids: list = []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            toks = [w2i[t] for t in line.split() if t in w2i]
            if mode == MODE_LINES:
                if toks and ids:
                    ids.append(-1)
                ids.extend(toks)
            else:
                ids.extend(toks)
    return np.asarray(ids, dtype=np.int32)


# --------------------------------------------------------------- batch fill
def fill_batch(
    flat: np.ndarray,
    starts: np.ndarray,
    lens: np.ndarray,
    order: np.ndarray,
    pos: int,
    out: np.ndarray,
) -> int:
    """Fill out[B, L] (pad -1) from packed-corpus rows order[pos:pos+B];
    returns the real-token count. Native if possible; the plain version is
    data/batcher.fill_batch."""
    lib = _load()
    if lib is None:
        from ..data.batcher import fill_batch as fill_plain

        return fill_plain(flat, starts, lens, order, pos, out)
    if out.dtype != np.int32 or not out.flags.c_contiguous or out.ndim != 2:
        raise ValueError("fill_batch: out must be a C-contiguous int32 [B, L]")
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    B, L = out.shape
    return int(
        lib.w2v_fill_batch(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(order), pos, B, L,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    )
