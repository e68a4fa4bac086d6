"""Warm-restart kernel cache: an elastic generation switch that revisits a
topology loads its kernels instead of building them.

Port of word2vec_tpu/tune/compile_cache.py. There the compiled artefacts
are XLA executables and the cache is jax's persistent compilation cache;
here they are the hand-written kernels' shared libraries, which _build.py
caches by source hash in `build/kernels/` (W2V_KERNEL_BUILD_DIR overrides
it). `enable_warm_cache` points that lookup at `<root>/<key>` for an
exec'd NEXT-GENERATION elastic process only, and on a miss copies the
current sources' libraries from the default build directory, when they
are there, before anything builds: a generation then runs no nvcc.

The fence is the JAX package's, enforced in one place:

  * only an exec'd next-generation elastic process (W2V_ELASTIC_GEN > 0)
    may turn the cache on; generation 0 (the launch process, every test
    process, every non-elastic run) never does: `enable_warm_cache`
    refuses (returns None) for gen <= 0;
  * an operator who set the cache variable (W2V_KERNEL_BUILD_DIR)
    themselves owns the decision: refused too.

The cache is keyed per (topology, plan) as in JAX (`topology_key`): a
generation reads only entries of the SAME world / mesh shape and realized
plan.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from typing import Optional

from .._build import ENV_BUILD_DIR


def topology_key(world: int, dp: int, tp: int, sp: int, config,
                 plan_key: Optional[str] = None,
                 version: Optional[str] = None) -> str:
    """One cache subdirectory per (topology, realized plan, library
    version): the human-readable prefix names the mesh, the hash pins
    every lever that changes the built program set. `version` defaults to
    torch's (the JAX package hashes jax's in the same place, so the two
    digests agree when handed the same string)."""
    if version is None:
        import torch

        version = torch.__version__
    parts = [
        f"w{int(world)}", f"dp{int(dp)}", f"tp{int(tp)}", f"sp{int(sp)}",
        config.band_backend, config.table_layout, config.resolved_kernel,
        config.dtype, config.compute_dtype,
        f"b{config.batch_rows}", f"m{config.micro_steps}",
        f"c{config.chunk_steps}", f"L{config.max_sentence_len}",
        f"d{config.word_dim}", f"n{config.negative}",
        f"sn{config.shared_negatives}", config.negative_scope,
        f"sr{int(config.stochastic_rounding)}",
        str(version),
        plan_key or "",
    ]
    digest = hashlib.sha256("|".join(map(str, parts)).encode()).hexdigest()
    return f"w{int(world)}dp{int(dp)}tp{int(tp)}sp{int(sp)}-{digest[:16]}"


def enable_warm_cache(root: Optional[str], key: str, gen: int,
                      env=os.environ) -> Optional[str]:
    """Point the kernel-library lookup at `<root>/<key>`, ONLY for an
    exec'd next-generation elastic process, seeding it on a miss with the
    current sources' libraries from the default build directory. Returns
    the enabled directory, or None when the fence refuses:

      * gen <= 0          — the launch process and every test process
                            build (or load) where they always do
      * no root           — the lever is opt-in (--compile-cache)
      * W2V_KERNEL_BUILD_DIR set — the operator owns the kernel cache
      * the dir cannot be created — degrade to the default lookup, never
        fail the recovery
    """
    if not root or int(gen) <= 0:
        return None
    if env.get(ENV_BUILD_DIR):
        return None
    path = os.path.join(root, key)
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        return None
    from .. import _build

    for name in _build.library_names():
        src = _build.DEFAULT_BUILD_DIR / name
        dst = os.path.join(path, name)
        if not os.path.exists(dst) and src.exists():
            try:
                tmp = f"{dst}.{os.getpid()}.tmp"
                shutil.copyfile(src, tmp)
                os.replace(tmp, dst)  # atomic: no half-copied library
            except OSError:
                pass  # a miss: the library builds into the cache dir
    _build.set_build_dir(path)
    return path


def disable_cache() -> None:
    """Best-effort reset (tests): the lookup back on the default dir."""
    from .. import _build

    _build.set_build_dir(os.environ.get(ENV_BUILD_DIR) or _build.DEFAULT_BUILD_DIR)
