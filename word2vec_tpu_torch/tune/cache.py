"""Persistent JSON plan cache of the autotuned planner.

Port of word2vec_tpu/tune/cache.py: the same file format (one JSON object,
{schema, plans: {key: entry}}), the same SCHEMA, the same plan_key (with
the vocabulary bucketed to two significant figures), lookup, atomic
store and the W2V_PLAN_CACHE override, so a file either package wrote
reads in the other. One difference: the default file is
~/.cache/word2vec_tpu_torch/plan_cache.json. On a CPU host the two
packages' plans share keys (cpu|cpu|...), and a plan timed on the JAX
package's XLA programs says nothing about the port's kernels, so the two
do not mix unless a caller points both at one file.

Keys are the planner's identity tuple

    (device_kind, backend, kernel_route, vocab_size, word_dim,
     table_layout, shared_negatives, band_backend)

rendered as a string: the dimensions along which a tuned step shape
transfers. table_layout, shared_negatives and band_backend are the
CONFIGURED values (the search's starting point): a plan probed under the
split layout, a pinned negative-pool width or another band route is never
served to a run configured otherwise. Anything else that could invalidate
a plan (window, sentence length, model, objective, ...) goes into the
entry's FINGERPRINT (tune/planner.config_fingerprint): a lookup whose
fingerprint disagrees is a miss.

Entries carry provenance (probe throughput, predicted cost, creation
time). Writes are atomic (tmp + os.replace) and lock-free: last writer
wins, which is fine for entries that can be recomputed. A corrupt or
unreadable file reads as empty: the planner then probes again, it never
fails the run. The packaged seed file (tune/seed_plans.json) backs every
lookup; user-cache entries shadow seeds on a key collision.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Dict, Optional

# the JAX package's schema (word2vec_tpu/tune/cache.py): 2 added the
# configured table layout and KP to the key, 3 the configured band route
SCHEMA = 3

_SEED_PATH = os.path.join(os.path.dirname(__file__), "seed_plans.json")


def default_cache_path() -> str:
    env = os.environ.get("W2V_PLAN_CACHE")
    if env:
        return env
    return os.path.join(
        os.path.expanduser("~"), ".cache", "word2vec_tpu_torch",
        "plan_cache.json",
    )


def plan_key(
    device_kind: str, backend: str, kernel_route: str, vocab_size: int,
    dim: int, table_layout: str, shared_negatives: int, band_backend: str,
) -> str:
    """The cache key. vocab_size is bucketed to 2 significant figures:
    step shapes do not change between a 71,290- and a 71,000-word
    vocabulary, and an exact count would make every corpus probe again.
    table_layout, shared_negatives and band_backend are required
    arguments (the configured values): the plan stored under the key may
    still realize another layout, width or route, which is the planner's
    arbitration, recorded in the entry."""
    v = int(vocab_size)
    if v >= 100:
        mag = 10 ** (len(str(v)) - 2)
        v = (v // mag) * mag
    return (
        f"{device_kind or 'unknown'}|{backend}|{kernel_route}|V{v}|d{dim}"
        f"|{table_layout}|kp{int(shared_negatives)}|{band_backend}"
    )


def _read(path: str) -> Dict:
    try:
        with open(path) as f:
            doc = json.load(f)
        if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
            return {"schema": SCHEMA, "plans": {}}
        if not isinstance(doc.get("plans"), dict):
            return {"schema": SCHEMA, "plans": {}}
        return doc
    except (OSError, json.JSONDecodeError, ValueError):
        return {"schema": SCHEMA, "plans": {}}


def lookup(
    key: str, fingerprint: Dict, path: Optional[str] = None
) -> Optional[Dict]:
    """The cached entry for `key`, or None. A fingerprint mismatch is a
    miss (the key matched but the problem changed underneath it). User
    cache first, packaged seeds second."""
    for p in (path or default_cache_path(), _SEED_PATH):
        entry = _read(p)["plans"].get(key)
        if entry is None:
            continue
        if entry.get("fingerprint") != fingerprint:
            continue
        return entry
    return None


def store(key: str, entry: Dict, path: Optional[str] = None) -> str:
    """Atomically merge {key: entry} into the cache file; returns the path."""
    path = path or default_cache_path()
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    doc = _read(path)
    doc["plans"][key] = dict(
        entry,
        created_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        schema=SCHEMA,
    )
    fd, tmp = tempfile.mkstemp(dir=parent, prefix=".plan_cache_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path
