"""Checkpoint / resume, with integrity manifests and last-good retention.

The port's counterpart of word2vec_tpu/io/checkpoint.py, writing the same
format, so a checkpoint of either package loads into the other: a
checkpoint captures the full training state {params, step, words_done,
epoch, config} plus the vocabulary, and an interrupted run resumes exactly
on the alpha schedule (Word2Vec.cpp:379-380 depends only on words_done).

Format: one directory per checkpoint —
    state.npz       all embedding tables + integer counters (__step,
                    __words_done, __epoch; __dtypes names the tables stored
                    as their uint16 bit pattern, i.e. bfloat16)
    config.json     the Word2VecConfig
    vocab.txt       `index count word` lines (reference format, Word2Vec.cpp:171)
    stream.json     the stream cursor (streaming runs of the JAX package)
    integrity.json  sha256 of every other file, written last, and a `meta`
                    block: table_layout, vocab_hash, vocab_size and (this
                    package only) `writer`

Durability contract:
  * writes are atomic (tmp dir + rename) AND retried with bounded backoff
    on OSError;
  * the previous checkpoint is RETAINED as `<path>.old` (and `.old2`, ...,
    up to `keep`) instead of deleted after a successful write;
  * the loader verifies the sha256 manifest and the parse itself; a
    truncated/corrupt checkpoint is QUARANTINED (renamed `<dir>.corrupt`)
    and the loader falls back along the backup chain instead of crashing
    the resume. Checkpoints without an integrity manifest load with
    parse-level checking only.

Tables come back as CPU tensors; Trainer.train copies them into its own
device buffers (the ones its CUDA graphs replay against), never rebinding
them. Each save attempt is an injection point of the `ckpt_oserror` fault
(resilience/faults.py): the active plan makes it raise OSError, which the
retry loop absorbs up to its bound.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import tempfile
import time
import warnings
import zipfile
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Word2VecConfig
from ..data.vocab import Vocab
from ..models.params import params_layout
from ..resilience import faults as _faults
from ..train import TrainState

INTEGRITY_FILE = "integrity.json"
STREAM_FILE = "stream.json"
#: the integrity meta's `writer` of this package's checkpoints (the JAX
#: package writes none, and ignores the key when it loads)
WRITER = "word2vec_tpu_torch"


class CheckpointError(RuntimeError):
    """A checkpoint failed integrity/parse validation — or, out of
    load_checkpoint, every candidate did (the message lists what was
    tried)."""


#: everything a torn/corrupt checkpoint can raise out of the parse
#: (BadZipFile: truncated npz; ValueError: short buffers / bad json /
#: bad config fields; KeyError: missing arrays; OSError: unreadable files)
_CORRUPT_ERRORS = (
    CheckpointError,
    zipfile.BadZipFile,
    ValueError,
    KeyError,
    OSError,
)


# --------------------------------------------------------------- integrity
def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def write_integrity(dirpath: str, meta: Optional[dict] = None) -> dict:
    """Hash every regular file in `dirpath` into its integrity manifest.
    Called LAST during a save, so a manifest's presence certifies that every
    named file was completely written when the hash was taken. `meta`
    carries content-level fingerprints that tools can read without parsing
    the checkpoint itself; verification ignores it."""
    files = {
        e.name: _sha256(e.path)
        for e in sorted(os.scandir(dirpath), key=lambda e: e.name)
        if e.is_file() and e.name != INTEGRITY_FILE
    }
    man = {"schema": 1, "algo": "sha256", "files": files}
    if meta:
        man["meta"] = dict(meta)
    with open(os.path.join(dirpath, INTEGRITY_FILE), "w") as f:
        json.dump(man, f, indent=2)
        f.write("\n")
    return man


def read_integrity_meta(path: str) -> dict:
    """The `meta` block of a checkpoint's integrity manifest ({} when the
    manifest or the block is missing/unreadable — metadata reads must never
    fail a resume)."""
    try:
        with open(os.path.join(path, INTEGRITY_FILE)) as f:
            return dict(json.load(f).get("meta") or {})
    except (OSError, ValueError, TypeError, AttributeError):
        return {}


def checkpoint_writer(path: str) -> Optional[str]:
    """The package that wrote the checkpoint at `path`: the meta's
    `writer`; "word2vec_tpu" for a manifest meta without one (the JAX
    package writes none); None when there is no meta to tell."""
    meta = read_integrity_meta(path)
    if not meta:
        return None
    return str(meta.get("writer", "word2vec_tpu"))


def verify_checkpoint(path: str) -> None:
    """Validate `path` against its integrity manifest; raises CheckpointError
    on a missing or mismatched file. A checkpoint without a manifest (older
    writer) passes — the parse-level checks in the loader still apply."""
    man_path = os.path.join(path, INTEGRITY_FILE)
    if not os.path.exists(man_path):
        return
    try:
        with open(man_path) as f:
            man = json.load(f)
        files = dict(man["files"])
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointError(f"{path}: unreadable integrity manifest: {e}")
    for name, want in files.items():
        fp = os.path.join(path, name)
        if not os.path.exists(fp):
            raise CheckpointError(f"{path}: missing file {name!r} named by "
                                  "the integrity manifest")
        got = _sha256(fp)
        if got != want:
            raise CheckpointError(
                f"{path}: sha256 mismatch on {name!r} "
                f"(manifest {want[:12]}…, file {got[:12]}…)"
            )


# ------------------------------------------------------------ backup chain
def backup_name(path: str, k: int) -> str:
    """k-th retained backup: `.old` (most recent previous), `.old2`, ..."""
    return path + ".old" + ("" if k == 1 else str(k))


#: how far the candidate scan looks for backups (far above any sane
#: --checkpoint-keep; quarantine can leave gaps, so the scan doesn't stop
#: at the first missing index)
_SCAN_LIMIT = 16


def checkpoint_candidates(path: str) -> Iterator[str]:
    """The load order: the checkpoint itself, then its backups newest-first."""
    yield path
    for k in range(1, _SCAN_LIMIT + 1):
        b = backup_name(path, k)
        if os.path.isdir(b):
            yield b


def _quarantine(path: str) -> Optional[str]:
    """Rename a corrupt checkpoint dir aside (never clobbering an earlier
    quarantine); returns the new name, or None when the rename itself fails
    (the load fallback must proceed regardless)."""
    base = path + ".corrupt"
    dst = base
    n = 2
    while os.path.exists(dst):
        dst = base + str(n)
        n += 1
    try:
        os.replace(path, dst)
        return dst
    except OSError:
        return None


# ------------------------------------------------------------------- save
def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    """A table as the npz stores it: bfloat16 (which npz cannot represent)
    as its uint16 bit pattern, named in __dtypes — the JAX writer's
    convention (word2vec_tpu/io/checkpoint.py:242-253)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    return t.cpu().numpy(), None


def save_checkpoint(path: str, state: TrainState, config: Word2VecConfig,
                    vocab: Optional[Vocab] = None, keep: int = 1,
                    retries: int = 3, backoff: float = 0.05,
                    stream: Optional[dict] = None) -> None:
    """Atomic checkpoint write with integrity manifest and retention.

    `keep` previous checkpoints are retained (`.old` ... `.old{keep}`);
    keep=0 deletes the previous one after a successful write. OSError
    during the write is retried up to `retries` times with exponential
    backoff before surfacing. `stream` is a stream-cursor document written
    as `stream.json` inside the dir, under the same manifest (read it back
    with `read_stream_cursor`).
    """
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    last: Optional[OSError] = None
    for attempt in range(retries + 1):
        if attempt:
            warnings.warn(
                f"checkpoint write to {path!r} failed ({last}); "
                f"retry {attempt}/{retries}",
                stacklevel=2,
            )
            time.sleep(backoff * (2 ** (attempt - 1)))
        try:
            _save_once(path, state, config, vocab, keep, stream)
            return
        except OSError as e:
            last = e
    raise last  # type: ignore[misc]


def read_stream_cursor(path: str) -> Optional[dict]:
    """The stream-cursor document of the checkpoint dir `path` (None for
    non-streaming checkpoints). `path` must be the dir that actually
    LOADED — use load_checkpoint_with_path, not the nominal path, or a
    fallback to `.old` would pair new params with a stale cursor."""
    fp = os.path.join(path, STREAM_FILE)
    if not os.path.exists(fp):
        return None
    with open(fp) as f:
        return json.load(f)


def _save_once(path: str, state: TrainState, config: Word2VecConfig,
               vocab: Optional[Vocab], keep: int,
               stream: Optional[dict] = None) -> None:
    _faults.raise_if_active("ckpt_oserror", where=path)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        arrays = {}
        nonnative = {}
        for k, v in state.params.items():
            a, dt = _to_numpy(v)
            if dt is not None:
                nonnative[k] = dt
            arrays[k] = a
        np.savez(
            os.path.join(tmp, "state.npz"),
            __step=np.int64(state.step),
            __words_done=np.int64(state.words_done),
            __epoch=np.int64(state.epoch),
            __dtypes=np.str_(json.dumps(nonnative)),
            **arrays,
        )
        with open(os.path.join(tmp, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(config), f, indent=2)
        if vocab is not None:
            vocab.save(os.path.join(tmp, "vocab.txt"))
        if stream is not None:
            with open(os.path.join(tmp, STREAM_FILE), "w") as f:
                json.dump(dict(stream), f, indent=2)
                f.write("\n")
        # the realized table layout (split [V, d] pair vs unified [V, 2, d]
        # slab) rides in the meta so tools can tell what the state.npz rows
        # MEAN without parsing it
        meta = {"table_layout": params_layout(state.params)}
        if vocab is not None:
            meta["vocab_hash"] = vocab.content_hash()
            meta["vocab_size"] = len(vocab)
        meta["writer"] = WRITER
        # written last: its presence certifies a complete write
        write_integrity(tmp, meta=meta)
        # Atomic overwrite with retention: rotate the backup chain, move the
        # old checkpoint to `.old`, land the new one. A crash at any point
        # leaves either the old or the new checkpoint recoverable.
        if os.path.isdir(path):
            for k in range(max(keep, 1), 1, -1):
                src = backup_name(path, k - 1)
                if os.path.isdir(src):
                    dst = backup_name(path, k)
                    if os.path.isdir(dst):
                        shutil.rmtree(dst)
                    os.replace(src, dst)
            first = backup_name(path, 1)
            if os.path.isdir(first):
                shutil.rmtree(first)
            os.replace(path, first)
        os.replace(tmp, path)
        # prune beyond the retention window (keep=0: drop `.old` too)
        for k in range(keep + 1, _SCAN_LIMIT + 1):
            b = backup_name(path, k)
            if os.path.isdir(b):
                shutil.rmtree(b, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


# ------------------------------------------------------------------- load
def _load_dir(path: str) -> Tuple[TrainState, Word2VecConfig, Optional[Vocab]]:
    """Parse one specific checkpoint dir (no fallback, no quarantine)."""
    with np.load(os.path.join(path, "state.npz")) as z:
        nonnative = (
            json.loads(str(z["__dtypes"])) if "__dtypes" in z.files else {}
        )

        def restore(k: str) -> torch.Tensor:
            a = z[k]
            if nonnative.get(k) == "bfloat16":
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(a)

        params = {
            k: restore(k) for k in z.files if not k.startswith("__")
        }
        state = TrainState(
            params=params,
            step=int(z["__step"]),
            words_done=int(z["__words_done"]),
            epoch=int(z["__epoch"]),
        )
    with open(os.path.join(path, "config.json")) as f:
        raw = json.load(f)
    known = {f.name for f in dataclasses.fields(Word2VecConfig)}
    config = Word2VecConfig(**{k: v for k, v in raw.items() if k in known})
    vocab_path = os.path.join(path, "vocab.txt")
    vocab = Vocab.load(vocab_path) if os.path.exists(vocab_path) else None
    return state, config, vocab


#: validate(state, config, vocab) raises to reject a parsed checkpoint
Validator = Callable[[TrainState, Word2VecConfig, Optional[Vocab]], None]


def load_checkpoint(
    path: str,
    fallback: bool = True,
    quarantine: bool = True,
    validate: Optional[Validator] = None,
) -> Tuple[TrainState, Word2VecConfig, Optional[Vocab]]:
    """Load the newest GOOD checkpoint at `path`.

    Candidates are tried newest-first (`path`, `.old`, `.old2`, ...). A
    candidate fails on integrity mismatch (verify_checkpoint), any parse
    error of a truncated/torn dir, or a caller-supplied `validate(state,
    config, vocab)` raising (the supervisor validates that the tables are
    finite — a checkpoint saved after divergence is not a rollback
    target). Failed candidates are quarantined (renamed `.corrupt*`;
    `quarantine=False` leaves them in place) so the next save's rotation
    never resurrects them; `fallback=False` restricts the search to `path`
    itself. Raises CheckpointError when nothing loads.
    """
    state, config, vocab, _ = load_checkpoint_with_path(
        path, fallback=fallback, quarantine=quarantine, validate=validate
    )
    return state, config, vocab


def load_checkpoint_with_path(
    path: str,
    fallback: bool = True,
    quarantine: bool = True,
    validate: Optional[Validator] = None,
) -> Tuple[TrainState, Word2VecConfig, Optional[Vocab], str]:
    """load_checkpoint, additionally returning the DIRECTORY that loaded
    (`path` itself, or the `.old*` backup the fallback walked to)."""
    tried: List[str] = []
    for cand in checkpoint_candidates(path):
        if not os.path.exists(os.path.join(cand, "state.npz")):
            tried.append(f"{cand}: missing state.npz")
            if not fallback:
                break
            continue
        try:
            verify_checkpoint(cand)
            out = _load_dir(cand)
            if validate is not None:
                validate(*out)
            return out + (cand,)
        except _CORRUPT_ERRORS as e:
            tried.append(f"{cand}: {type(e).__name__}: {e}")
            moved = _quarantine(cand) if quarantine else None
            warnings.warn(
                f"corrupt checkpoint {cand!r} ({type(e).__name__}: {e})"
                + (f"; quarantined as {moved!r}" if moved else "")
                + ("; falling back" if fallback else ""),
                stacklevel=2,
            )
        if not fallback:
            break
    raise CheckpointError(
        f"no loadable checkpoint at {path!r}; tried: " + "; ".join(tried)
    )
