"""The shared batched query kernel: one top-k matmul for everything.

The port's counterpart of word2vec_tpu/serve/query.py (jitted XLA there,
plain torch ops here: a matmul and a selection, no hand-written kernel).

  * the table is row-normalized ONCE (`unit_norm`, on the host in f32) and
    placed on the engine's device (the card unless the caller asks for the
    CPU), resident for the engine's lifetime, in f32 or bf16;
  * every query kind reduces to one shape: a weighted combination of up to
    3 table rows (neighbors: +row_i; analogy a:b::c:? : -a +b +c),
    renormalized, scored against the whole table as a `[B, V]` f32 plane,
    query tokens masked to -inf, top-k. The query is combined and the
    plane accumulated in f64 (the f32/bf16 operands upcast exactly, one
    rounding to f32 at the end): the scores agree with the JAX engine's
    f32-accumulated ones (preferred_element_type=float32) within 1e-6, and
    they come out the same on the card and on the CPU, whose f32 matmuls
    sum in different orders — so a near-tie cannot reorder the top-k
    between the two;
  * batch and k are padded to power-of-two buckets, and a batch above
    MAX_BATCH_BUCKET is split, as in the JAX engine;
  * ties are returned in ascending-index order: the top-k SET is chosen
    with ties broken by the lower index (the order jax.lax.top_k keeps;
    torch.topk on the card promises none), then the host reorders the
    selection by (score desc, index asc).

`get_engine(W, vocab)` is the module-level cache the eval/ modules use:
same array object + same restriction + same device -> same engine, so
successive queries normalize the table once. The cache holds a weakref to
W, never W itself. Mutating W in place is NOT observed.
"""

from __future__ import annotations

import collections
import threading
import weakref
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.vocab import Vocab
from ..device import DeviceLike, resolve_device

#: serving dtypes for the resident table (int8 is a FILE format — it
#: dequantizes into one of these on load)
TABLE_DTYPES = ("float32", "bfloat16")
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def unit_norm(W: np.ndarray) -> np.ndarray:
    """Row-normalize once, host-side, in f32 — the normalization every
    query path shares."""
    W = np.asarray(W, dtype=np.float32)
    return W / np.maximum(np.linalg.norm(W, axis=1, keepdims=True), 1e-12)


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1)).bit_length()


# ---------------------------------------------------------------- kernels
def _scores(q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[B, d] x [V, d] -> [B, V] f32: q rounded to the table dtype (as the
    JAX dot takes it), exact products accumulated in f64, rounded once."""
    return torch.matmul(
        q.to(table.dtype).double(), table.double().T
    ).float()


def _combine_queries(table, ids, w):
    """[B, 3] row ids + weights -> [B, d] unit queries, f32 (combined and
    normalized in f64, rounded once).

    Neighbors: ids=(i,i,i), w=(1,0,0). Analogy a:b::c:? : ids=(a,b,c),
    w=(-1,1,1) — exactly `Wn[b] - Wn[a] + Wn[c]`, renormalized (3CosAdd).
    Padding rows (ids=-1 clamped to 0, w=0) come out as zero queries.
    """
    rows = table[ids.long().clamp(0, table.shape[0] - 1)].double()
    q = (w.double()[:, :, None] * rows).sum(dim=1)
    n = torch.clamp_min(torch.linalg.norm(q, dim=1, keepdim=True), 1e-12)
    return (q / n).float()


def _stable_topk(scores: torch.Tensor, k: int):
    """Top-k (values, ids) of each row, the k chosen with ties broken by the
    lower index and returned by (score desc, index asc)."""
    B = scores.shape[0]
    thr = torch.topk(scores, k, dim=1).values[:, -1:]
    gt = scores > thr
    eq = scores == thr
    need = k - gt.sum(dim=1, keepdim=True)
    sel = gt | (eq & (torch.cumsum(eq.int(), dim=1) <= need))
    if int(sel.sum()) != B * k:  # NaN scores: the exact stable order
        order = torch.sort(scores, dim=1, descending=True, stable=True).indices
        top = order[:, :k]
        return scores.gather(1, top), top
    idx = sel.nonzero()[:, 1].view(B, k)  # ascending index within a row
    vals = scores.gather(1, idx)
    o = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, o), idx.gather(1, o)


def _topk_kernel(table, q, mask, k):
    """[B, d] unit queries -> top-k (scores, ids) over the [V, d] table.

    The one kernel behind every neighbor/analogy query: the [B, V] cosine
    plane (_scores), -inf masking of the query tokens (mask
    is [B, M] row ids, -1 = no mask: a min against +inf, a no-op), then the
    index-stable top-k.
    """
    scores = _scores(q, table)
    valid = mask >= 0
    idx = torch.where(valid, mask, 0).long()
    fill = torch.where(
        valid,
        torch.tensor(-float("inf"), device=scores.device),
        torch.tensor(float("inf"), device=scores.device),
    )
    scores.scatter_reduce_(1, idx, fill, "amin", include_self=True)
    return _stable_topk(scores, k)


def _query_planes(table, ids, w):
    """Full [B, V] cosine planes of combined queries (the analogy
    evaluator's 3CosAdd path needs every candidate's score)."""
    return _scores(_combine_queries(table, ids, w), table)


def _row_planes(table, ids):
    """[B, V] cosine planes of raw table rows (3CosMul's ca/cb/cc)."""
    return _scores(table[ids.long()], table)


def _pair_cosines(table, i, j):
    """Per-pair cosine of rows i and j (rows are unit, so a plain dot)."""
    a = table[i.long()].float()
    b = table[j.long()].float()
    return (a * b).sum(dim=-1)


class QueryEngine:
    """A row-normalized table resident on a device + the batched kernels.

    `restrict` keeps only the most frequent `restrict` rows (the analogy
    evaluator's `restrict_vocab` protocol); words mapping past it are OOV
    to this engine. `device` defaults to "cuda" and raises without a card;
    "cpu" runs the same torch ops on the host.
    """

    #: batch rows are padded to the next power of two up to this cap; a
    #: bigger batch is split
    MAX_BATCH_BUCKET = 1024

    def __init__(
        self,
        W: np.ndarray,
        vocab: Vocab,
        table_dtype: str = "float32",
        restrict: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if table_dtype not in TABLE_DTYPES:
            raise ValueError(
                f"table_dtype must be one of {TABLE_DTYPES}, got "
                f"{table_dtype!r} (int8 is a file format: load it with "
                "io/embeddings.load_embeddings_int8, it dequantizes here)"
            )
        self.device = resolve_device(device)
        self.vocab = vocab
        V = W.shape[0] if restrict is None else min(W.shape[0], int(restrict))
        Wn = unit_norm(np.asarray(W)[:V])
        self.table_dtype = table_dtype
        self.table = self._place(Wn)
        self.V, self.d = int(V), int(Wn.shape[1])
        #: monotonically increasing swap generation (0 = the construction
        #: table)
        self.generation = 0
        self._swap_lock = threading.Lock()

    def _place(self, Wn: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(Wn).to(
            self.device, _TORCH_DTYPES[self.table_dtype]
        )

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------ hot swap
    def swap_table(self, W: np.ndarray, vocab: Optional[Vocab] = None,
                   allow_shrink: bool = False) -> int:
        """Atomically replace the resident table with fresh embeddings:
        normalize and place the NEW table first, then flip the references.
        In-flight queries snapshot the (table, V) pair once at entry
        (batch_topk), so every request is answered by one table generation.

        The new vocabulary may only EXTEND the old one (grow-only); a
        shrinking swap is refused unless `allow_shrink` (single-threaded
        callers). Returns the new generation."""
        Wn = unit_norm(np.asarray(W))
        if vocab is not None and len(vocab) < Wn.shape[0]:
            Wn = Wn[: len(vocab)]
        if Wn.shape[0] < self.V and not allow_shrink:
            raise ValueError(
                f"swap_table would SHRINK the table ({self.V} -> "
                f"{Wn.shape[0]} rows): ids resolved against the old "
                "vocabulary could index past the new one mid-flight; pass "
                "allow_shrink=True only from single-threaded callers"
            )
        if Wn.shape[1] != self.d:
            raise ValueError(
                f"swap_table dim mismatch: engine serves d={self.d}, new "
                f"table has d={Wn.shape[1]}"
            )
        new_table = self._place(Wn)
        # the swap's transient double residency (old table serving + new
        # table placed) is the serve tier's memory spike: attribute it on
        # the process-wide memory ledger when one is wired (obs/devmem.py;
        # no-op otherwise)
        from ..obs import devmem as _devmem

        _devmem.sample_active("serve_swap")
        with self._swap_lock:
            self.table = new_table
            self.V = int(Wn.shape[0])
            if vocab is not None:
                self.vocab = vocab
            self.generation += 1
            return self.generation

    # ------------------------------------------------------------- lookup
    def ids_of(self, words: Sequence[str]) -> np.ndarray:
        """Word strings -> row ids; KeyError NAMES the missing word (the
        eval CLI prints these verbatim)."""
        out = np.empty(len(words), dtype=np.int32)
        for n, w in enumerate(words):
            if w not in self.vocab or self.vocab[w] >= self.V:
                raise KeyError(f"{w!r} not in vocabulary")
            out[n] = self.vocab[w]
        return out

    # ------------------------------------------------------ batched top-k
    def batch_topk(
        self, ids: np.ndarray, weights: np.ndarray, k: int
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """The serving entry point: [B, 3] ids + weights -> per-row
        (indices, scores), already k-clamped, -inf-filtered, and
        tie-stable (score desc, index asc). Pads B and k to power-of-two
        buckets. The (table, V) pair is snapshotted ONCE here."""
        table, V = self.table, self.V
        B = int(ids.shape[0])
        if B == 0:
            return []
        if B > self.MAX_BATCH_BUCKET:
            return (
                self.batch_topk(ids[: self.MAX_BATCH_BUCKET],
                                weights[: self.MAX_BATCH_BUCKET], k)
                + self.batch_topk(ids[self.MAX_BATCH_BUCKET:],
                                  weights[self.MAX_BATCH_BUCKET:], k)
            )
        k = max(1, min(int(k), V))
        kb = min(V, _next_pow2(k))
        Bb = _next_pow2(B)
        ids_p = np.full((Bb, 3), -1, dtype=np.int32)
        w_p = np.zeros((Bb, 3), dtype=np.float32)
        ids_p[:B] = ids
        w_p[:B] = weights
        ids_t = self._tensor(ids_p, torch.int32)
        q = _combine_queries(table, ids_t, self._tensor(w_p, torch.float32))
        vals, top = _topk_kernel(table, q, ids_t, kb)
        vals = vals[:B].cpu().numpy()
        top = top[:B].to(torch.int32).cpu().numpy()
        out: List[Tuple[np.ndarray, np.ndarray]] = []
        for r in range(B):
            v, t = vals[r], top[r]
            keep = np.isfinite(v)
            v, t = v[keep], t[keep]
            # deterministic tie order: score desc, then index asc (lexsort's
            # last key is primary)
            order = np.lexsort((t, -v))[:k]
            out.append((t[order], v[order]))
        return out

    # -------------------------------------------------------- query kinds
    def neighbors_batch(
        self, words: Sequence[str], k: int = 10
    ) -> List[List[Tuple[str, float]]]:
        """Top-k cosine neighbors per word, the word itself masked."""
        wid = self.ids_of(words)
        ids = np.stack([wid, wid, wid], axis=1)
        w = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (len(wid), 1))
        return [self._decode(t, v) for t, v in self.batch_topk(ids, w, k)]

    def neighbor_id_sets(
        self, ids: np.ndarray, k: int = 10
    ) -> List[np.ndarray]:
        """Top-k neighbor ROW IDS per raw row id (self masked)."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        trip = np.stack([ids, ids, ids], axis=1)
        w = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (len(ids), 1))
        return [t for t, _ in self.batch_topk(trip, w, k)]

    def analogy_batch(
        self, triples: Sequence[Tuple[str, str, str]], k: int = 5
    ) -> List[List[Tuple[str, float]]]:
        """a:b :: c:? by 3CosAdd per triple; a, b, c masked."""
        flat = [w for t in triples for w in t]
        wid = self.ids_of(flat).reshape(-1, 3)
        w = np.tile(np.array([[-1.0, 1.0, 1.0]], np.float32), (len(wid), 1))
        return [self._decode(t, v) for t, v in self.batch_topk(wid, w, k)]

    def similarity_batch(
        self, pairs: Sequence[Tuple[str, str]]
    ) -> List[float]:
        """Cosine per (word, word) pair."""
        flat = [w for p in pairs for w in p]
        wid = self.ids_of(flat).reshape(-1, 2)
        return [float(x) for x in self.pair_cosines(wid[:, 0], wid[:, 1])]

    def _decode(
        self, idx: np.ndarray, scores: np.ndarray
    ) -> List[Tuple[str, float]]:
        words = self.vocab.words
        return [(words[int(i)], float(s)) for i, s in zip(idx, scores)]

    # ------------------------------------------------- eval-harness planes
    def pair_cosines(self, i: np.ndarray, j: np.ndarray) -> np.ndarray:
        """Cosines of row pairs by index (similarity.evaluate_pairs)."""
        return _pair_cosines(
            self.table, self._tensor(i, torch.int64), self._tensor(j, torch.int64)
        ).cpu().numpy()

    def analogy_planes(
        self, a: np.ndarray, b: np.ndarray, c: np.ndarray
    ) -> np.ndarray:
        """[B, V] 3CosAdd score planes, unmasked and WRITABLE (the analogy
        evaluator applies its own exclusion mask and rank math)."""
        ids = np.stack([a, b, c], axis=1).astype(np.int32)
        w = np.tile(np.array([[-1.0, 1.0, 1.0]], np.float32), (len(ids), 1))
        return _query_planes(
            self.table, self._tensor(ids, torch.int32),
            self._tensor(w, torch.float32),
        ).cpu().numpy()

    def cosine_planes(self, ids: np.ndarray) -> np.ndarray:
        """[B, V] cosine planes of table rows (3CosMul's three planes)."""
        return _row_planes(
            self.table, self._tensor(ids, torch.int64)
        ).cpu().numpy()


# -------------------------------------------------------------- engine cache
# The normalize-once contract for the eval/ modules: repeat queries against
# the SAME exported array reuse one engine. Keyed on id(W) with a weakref
# guard — a recycled id whose original array died is a miss, never a stale
# hit.
_CACHE_LOCK = threading.Lock()
_CACHE_CAP = 4
_ENGINE_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def get_engine(
    W: np.ndarray,
    vocab: Vocab,
    table_dtype: str = "float32",
    restrict: Optional[int] = None,
    device: DeviceLike = None,
) -> QueryEngine:
    """The cached-engine entry point eval/ uses (see module docstring)."""
    W = np.asarray(W)
    dev = resolve_device(device)
    key = (id(W), id(vocab), table_dtype, restrict, str(dev))
    with _CACHE_LOCK:
        hit = _ENGINE_CACHE.get(key)
        if hit is not None:
            ref, eng = hit
            if ref() is W:
                _ENGINE_CACHE.move_to_end(key)
                return eng
            del _ENGINE_CACHE[key]
    eng = QueryEngine(
        W, vocab, table_dtype=table_dtype, restrict=restrict, device=dev
    )
    with _CACHE_LOCK:
        try:
            _ENGINE_CACHE[key] = (weakref.ref(W), eng)
        except TypeError:
            # a non-weakref-able array subclass: serve it uncached
            return eng
        while len(_ENGINE_CACHE) > _CACHE_CAP:
            _ENGINE_CACHE.popitem(last=False)
    return eng


def clear_engine_cache() -> None:
    """Drop every cached engine (tests; also frees the device tables)."""
    with _CACHE_LOCK:
        _ENGINE_CACHE.clear()
