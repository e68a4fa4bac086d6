"""The autotuned execution planner: cost-model pruning and timed probes.

Port of word2vec_tpu/tune/planner.py, copied so the port imports nothing
of the JAX package. It turns the search of the step-shape space into
code:

  1. GRID     — candidate TunePlans around the configured shape: batch rows,
                band chunk, scan megastep cap, negative-pool width/scope,
                table layout and dtype, band route. Candidates that would
                change training quality are excluded up front (the hot-row
                block guard; levers stay inside their measured quality
                envelopes). On the card (platform "gpu") the band-ns grid
                also offers the three hand-written kernel routes: pallas
                (csrc/band_core.cu), pallas_oa (csrc/overlap.cu) and
                pallas_fused (csrc/fused_step.cu).
  2. PRUNE    — rank the grid with the analytic cost model
                (tune/cost_model.py: bytes + FLOPs -> roofline ms, the
                card's own anchors) and keep the top few plus the
                configured plan.
  3. PROBE    — time the survivors with short probes on the device the run
                trains on: a ChunkRunner per candidate, whose first
                dispatch warms up and captures the step's CUDA graph
                (excluded from the timing), then a few timed dispatches of
                a short chunk of graph replays.
  4. PERSIST  — the winner goes into the JSON plan cache (tune/cache.py);
                the next run starts tuned with zero probe cost
                (mode="cached").

A probe trains a throwaway copy of the params; a probed run's training
state is never touched, and resolve_plan frees every probe's graphs,
tables and params before it returns. A candidate the config refuses, or
one that runs out of device memory, becomes an "error" record; a kernel
that fails to build or launch fails the search (no candidate hides a
kernel fault by losing to another route).

Also here, from the same JAX module: the degeneracy-domain fence and the
kernel auto-selection (`degeneracy_domain`, `select_kernel`).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import TunePlan, Word2VecConfig
from ..device import DeviceLike, generator, resolve_device
from . import cache as plan_cache
from . import cost_model

# fingerprint: everything that invalidates a cached plan but is neither a
# cache-key dimension nor a plan dimension (see cache.py). The telemetry
# fields (health_metrics, divergence_budget) are left out: they add a
# roughly uniform per-step cost that does not reorder candidates.
FINGERPRINT_FIELDS = (
    "model", "train_method", "negative", "window", "max_sentence_len",
    "compute_dtype", "slab_scatter",
    "fused_tables", "hs_dense_top", "hs_tail_slots", "clip_row_update",
    "scatter_mean", "cbow_mean",
)

#: the band routes that run a hand-written kernel of the port
KERNEL_ROUTES = ("pallas", "pallas_oa", "pallas_fused")


def config_fingerprint(config: Word2VecConfig) -> Dict:
    fp = {f: getattr(config, f) for f in FINGERPRINT_FIELDS}
    fp["schema"] = plan_cache.SCHEMA
    return fp


def kernel_route(config: Word2VecConfig) -> str:
    if config.resolved_kernel == "pair":
        return "pair"
    return "band-hs" if config.use_hs else "band-ns"


def device_identity(device: torch.device) -> Tuple[str, str]:
    """(device_kind, platform) of the device a plan is tuned for: the
    card's name and "gpu", or "cpu" and "cpu" — the strings the JAX
    package's key carries on the same hardware."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device), "gpu"
    return "cpu", "cpu"


# ---------------------------------------------------- degeneracy-domain fence
# The measured quality-collapse domain of the shared-negative band kernel
# (benchmarks/BAND_DEGENERACY_r5.md): a tiny closed vocabulary over-trained
# for thousands of occurrences per word. Full collapse at ~860 words /
# 4,600 occ (analogy 0.0 vs pair 0.74); measured degradation up to ~4.4k
# words; onset ~1,000+ occ/word. Realistic corpora (text8: 71k vocab,
# ~240 occ/word) sit 20x outside.
DEGENERACY_VOCAB_MAX = 5000
DEGENERACY_OCC_PER_WORD = 1000


def degeneracy_domain(
    config: Word2VecConfig, vocab_size: int, total_tokens: int
) -> bool:
    """True when (vocab, planned training tokens) sit inside the band
    kernel's measured degeneracy domain — the fence the trainer warning
    and the kernel auto-selection below share."""
    return (
        config.use_ns
        and 0 < vocab_size < DEGENERACY_VOCAB_MAX
        and total_tokens * config.iters
        > DEGENERACY_OCC_PER_WORD * vocab_size
    )


def select_kernel(
    config: Word2VecConfig, vocab_size: int, total_tokens: int
) -> Optional[Dict]:
    """For kernel='auto' runs whose corpus shape sits inside the measured
    degeneracy domain, choose kernel='pair' (per-pair negative draws hold
    near-reference accuracy on the identical stream) instead of warning
    and collapsing. Returns the decision record when a change is
    selected, else None. An explicit kernel='band' is the override: the
    trainer only consults this for kernel='auto', so a forced band config
    keeps the fast path (and gets the degeneracy warning instead)."""
    if config.kernel != "auto" or not config.use_ns:
        return None
    # band-only levers are an explicit opt-in to the band machinery (and a
    # pair config would reject them outright — config.__post_init__): the
    # static warning still fires for these, selection stands aside
    if (
        config.fused_tables or config.slab_scatter
        or config.table_layout != "split"
        or config.band_backend != "xla"
        or config.negative_scope != "row"
    ):
        return None
    if not degeneracy_domain(config, vocab_size, total_tokens):
        return None
    occ = total_tokens * config.iters // max(1, vocab_size)
    return {
        "event": "kernel_auto_selection",
        "selected": "pair",
        "instead_of": "band",
        "reason": (
            f"degeneracy domain: {vocab_size}-word vocabulary at ~{occ} "
            f"training occurrences/word (fence: vocab < "
            f"{DEGENERACY_VOCAB_MAX} and occ/word > "
            f"{DEGENERACY_OCC_PER_WORD}; benchmarks/BAND_DEGENERACY_r5.md)"
        ),
        "vocab_size": int(vocab_size),
        "occ_per_word": int(occ),
        "override": "--kernel band forces the band fast path",
    }


# ------------------------------------------------------------------ planner
@dataclasses.dataclass
class PlanResolution:
    plan: TunePlan
    source: str                 # "cache" | "probe"
    key: str
    predicted: Dict             # CostEstimate.to_json() of the chosen plan
    probes: List[Dict]          # per-candidate records ([] on a cache hit)
    cache_path: Optional[str]

    def to_json(self) -> Dict:
        return {
            "plan": self.plan.to_json(),
            "source": self.source,
            "key": self.key,
            "predicted": self.predicted,
            "probes": self.probes,
        }


def candidate_grid(
    config: Word2VecConfig,
    vocab_size: int,
    constraints: Optional[Dict] = None,
) -> List[TunePlan]:
    """Valid TunePlans around the configured shape (the JAX package's grid;
    the kernel routes are offered on the card, platform "gpu").

    Quality fences: the optimizer block may not carry more tokens per vocab
    word than max(8x vocab, the configured block) — tuning must never walk
    a run INTO the hot-row divergence domain the Trainer warns about; KP
    stays >= 16; 'batch' scope is the replicated quality-positive lever;
    the table-layout candidates are trajectory-identical and the bf16+SR
    candidate is margin-neutral. A candidate the config rules reject
    (pallas+hs, batch-scope+pair, unified+pallas, ...) is dropped by
    apply_plan's validation.
    """
    c = constraints or {}
    base = config.current_plan()
    L = config.max_sentence_len
    block = max(1, config.batch_rows // config.micro_steps) * L
    max_block = max(8 * max(1, vocab_size), block)
    on_card = c.get("platform") == "gpu"

    rows = sorted({
        base.batch_rows,
        max(config.micro_steps, base.batch_rows // 2),
        base.batch_rows * 2,
    })
    caps = sorted({base.chunk_cap, 32, 96})
    # Band chunk S: the auto rule (ops/banded.resolve_chunk) fills a
    # 128-column slab. Smaller explicit chunks shrink the [B, C, S, S+2W]
    # logit plane at the cost of more, narrower products; probes decide.
    W2 = 2 * config.window
    chunks = sorted({
        base.band_chunk,
        max(W2, config.max_sentence_len // 2),
        max(W2, config.max_sentence_len // 3),
    })
    is_band_ns = kernel_route(config) == "band-ns"
    # KP widths 64 -> 32 -> 16, each ~halving the negative-side products
    kps = sorted({base.shared_negatives, 16, 32, 64}) if is_band_ns else [
        base.shared_negatives
    ]
    scopes = ["row", "batch"] if is_band_ns else [base.negative_scope]
    # table layout: trajectory-identical, arbitrated by the cost model's
    # per-layout scatter term and the probes
    layouts = (
        sorted({base.table_layout, "split", "unified"})
        if is_band_ns else [base.table_layout]
    )
    # storage dtype ± SR: the bf16+SR candidate beside the configured one
    dtypes = [(base.table_dtype, base.stochastic_rounding)]
    if is_band_ns and ("bfloat16", True) not in dtypes:
        dtypes.append(("bfloat16", True))
    backends = [base.band_backend]
    if is_band_ns and c.get("allow_pallas", True) and on_card:
        # band_core gathers from split tables only (no fused [V, 2, d]
        # restack); the overlap-add composes with both layouts; the fused
        # step REQUIRES the unified slab. Invalid combos are dropped by
        # apply_plan's validation.
        if not config.fused_tables and "pallas" not in backends:
            backends.append("pallas")
        if "pallas_oa" not in backends:
            backends.append("pallas_oa")
        if "pallas_fused" not in backends:
            backends.append("pallas_fused")

    combos = [
        (b, cap, kp, scope, S, be, lay, dt)
        for b in rows
        for cap in caps
        for kp in kps
        for scope in scopes
        for S in chunks
        for be in backends
        for lay in layouts
        for dt in dtypes
    ]
    out: List[TunePlan] = []
    seen = set()
    for b, cap, kp, scope, S, be, lay, (dt, sr) in combos:
        # batch scope correlates the whole batch on one pool; keep it at
        # the promoted kp=256 width
        eff_kp = max(kp, 256) if scope == "batch" else kp
        plan = TunePlan(
            batch_rows=b,
            band_chunk=S,
            chunk_cap=cap,
            prefetch_depth=base.prefetch_depth,
            shared_negatives=eff_kp,
            negative_scope=scope,
            band_backend=be,
            table_layout=lay,
            table_dtype=dt,
            stochastic_rounding=sr,
        )
        if plan in seen:
            continue
        seen.add(plan)
        try:
            applied = config.apply_plan(plan)
        except ValueError:
            continue
        cand_block = (applied.batch_rows // applied.micro_steps) * L
        if cand_block > max_block:
            continue
        if be in KERNEL_ROUTES:
            # the three kernels require the chunked band representation; a
            # candidate whose rows resolve dense would only burn a probe
            # on a guaranteed ValueError
            from ..ops.banded import resolve_chunk

            if resolve_chunk(L, applied.window, applied.band_chunk) == 0:
                continue
        out.append(plan)
    return out


def _synthetic_probe_corpus(vocab, n_tokens: int, max_len: int):
    from ..data.batcher import PackedCorpus
    from ..utils.synthetic import zipf_corpus_ids

    ids = zipf_corpus_ids(vocab, n_tokens, seed=11)
    return PackedCorpus.pack(ids, max_len)


def _probe_chunks(corpus, cfg: Word2VecConfig, s_probe: int, n: int):
    """n [s_probe, B, L] token chunks from the corpus front (no shuffle —
    probes time compute, they don't train)."""
    from ..data.batcher import BatchIterator, chunk_batches

    batcher = BatchIterator(
        corpus, cfg.batch_rows, cfg.max_sentence_len, seed=1, shuffle=False
    )
    chunks: List[Tuple[np.ndarray, List[int]]] = []
    while len(chunks) < n:
        for tok, words in chunk_batches(batcher.epoch(0), s_probe):
            chunks.append((tok, words))
            if len(chunks) == n:
                break
        if not chunks:  # empty corpus cannot happen (PackedCorpus raises)
            break
    return chunks


#: the run seed of every probe's draws (device.step_seed(PROBE_SEED, step))
PROBE_SEED = 13


def probe_plan(
    config: Word2VecConfig,
    plan: TunePlan,
    vocab,
    corpus,
    probe_steps: int = 2,
    probe_dispatches: int = 2,
    device: DeviceLike = None,
) -> Dict:
    """Time one candidate: words/sec and ms per optimizer step, with the
    first dispatch (the graph's warm-up and capture) excluded.

    A ChunkRunner of `probe_steps` steps a dispatch over fresh tables and
    params (seed 0) runs one warm-up dispatch, then `probe_dispatches`
    timed ones on the host clock, closed by a device synchronize, each
    staging its tokens from page-locked memory pinned before the timing;
    the draws are those of run seed PROBE_SEED. The record carries the
    probe's kernel launches by wrapper (`launches`, warm-up included). A
    plan the config refuses, or a probe that runs out of device memory,
    returns a record with an "error" field and score 0; any other failure
    (a kernel that does not build or launch) raises."""
    from ..models.params import init_params
    from ..ops import launch
    from ..ops.tables import DeviceTables
    from ..ops.train_step import make_chunk_runner

    rec: Dict = {"plan": plan.to_json()}
    try:
        cfg = config.apply_plan(plan)
    except ValueError as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["score_words_per_sec"] = 0.0
        return rec
    dev = resolve_device(device)
    before = dict(launch.LAUNCHES)
    s = max(1, min(probe_steps, cfg.chunk_cap))

    def host(a: np.ndarray) -> torch.Tensor:
        # staged from page-locked memory made here: a dispatch that pins
        # its tokens itself allocates new page-locked blocks in a probe
        # this short (milliseconds each), which a long run's cache of
        # blocks amortizes away
        t = torch.from_numpy(a)
        return t.pin_memory() if dev.type == "cuda" else t

    chunks = [(host(tok), wl)
              for tok, wl in _probe_chunks(corpus, cfg, s, probe_dispatches + 1)]
    alphas = host(np.full(s, cfg.init_alpha, np.float32))
    try:
        tables = DeviceTables.build(vocab, cfg, dev)
        params = init_params(cfg, len(vocab), generator(dev, 0))
        runner = make_chunk_runner(
            cfg, tables, fused=cfg.fused_tables and s > 1,
            graphed=dev.type == "cuda",
        )
        runner(params, chunks[0][0], PROBE_SEED, 0, alphas)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        words = 0
        t0 = time.perf_counter()
        for i in range(probe_dispatches):
            tok, wl = chunks[(i + 1) % len(chunks)]
            runner(params, tok, PROBE_SEED, (i + 1) * s, alphas)
            words += sum(wl)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    except torch.cuda.OutOfMemoryError as e:
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["score_words_per_sec"] = 0.0
        return rec
    rec["launches"] = {
        k: launch.LAUNCHES[k] - before.get(k, 0) for k in launch.LAUNCHES
    }
    step_ms = 1e3 * dt / (probe_dispatches * s)
    rec["measured_step_ms"] = round(step_ms, 4)
    rec["probe_words_per_sec"] = round(words / max(dt, 1e-9), 1)
    # short chunks under-represent dispatch amortization; add the model's
    # per-dispatch overhead share at the candidate's REAL megastep cap
    _, _, overhead = cost_model.device_spec(*device_identity(dev))
    total_ms = step_ms + overhead / max(1, plan.chunk_cap)
    wps = 1e3 * words / max(probe_dispatches * s, 1) / max(total_ms, 1e-9)
    rec["score_words_per_sec"] = round(wps, 1)
    return rec


def free_probe_residue(device: torch.device) -> None:
    """Return the process to the allocator state it had before the probes:
    every probe's runner, graphs (and their private pool), tables and
    params are unreferenced by now; collect them, and on the card release
    the cached blocks and the cuBLAS workspaces the probes' capture
    streams made (the counterpart of jax.clear_caches after JAX probes)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    if device.type == "cuda":
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()
        torch.cuda.empty_cache()


def resolve_plan(
    config: Word2VecConfig,
    vocab,
    corpus=None,
    mode: Optional[str] = None,
    cache_path: Optional[str] = None,
    constraints: Optional[Dict] = None,
    max_probes: int = 4,
    probe_steps: int = 2,
    probe_dispatches: int = 2,
    log_fn: Optional[Callable[[Dict], None]] = None,
    device: DeviceLike = None,
) -> PlanResolution:
    """The planner entry point (Trainer and cli.py call this), for the
    device the run trains on (the card unless the caller asks for the CPU).

    mode "cached": cache hit -> zero probe cost; miss -> probe, then cache.
    mode "probe":  always search (and refresh the cache with the winner).
    """
    mode = mode or config.autotune
    if mode == "off":
        raise ValueError("resolve_plan called with autotune='off'")
    dev = resolve_device(device)
    device_kind, platform = device_identity(dev)
    constraints = dict(constraints or {})
    constraints.setdefault("platform", platform)
    key = plan_cache.plan_key(
        device_kind, platform, kernel_route(config), len(vocab),
        config.word_dim,
        table_layout=config.table_layout,
        shared_negatives=config.shared_negatives,
        band_backend=config.band_backend,
    )
    if config.corpus_mode == "streaming":
        # streaming runs get their own cached plans: the host also reads
        # and encodes segments, so chunk shapes trade differently.
        # Appended, so every resident key keeps its form.
        key += "+stream"
    fp = config_fingerprint(config)

    if mode == "cached":
        entry = plan_cache.lookup(key, fp, cache_path)
        if entry is not None:
            res = PlanResolution(
                plan=TunePlan.from_json(entry["plan"]),
                source="cache",
                key=key,
                predicted=entry.get("predicted", {}),
                probes=[],
                cache_path=cache_path or plan_cache.default_cache_path(),
            )
            if log_fn:
                log_fn({"event": "autotune", **res.to_json()})
            return res
        # miss: fall through to a probe (then persist, so the NEXT cached
        # run is free)

    grid = candidate_grid(config, len(vocab), constraints)
    base = config.current_plan()
    if base not in grid:
        grid.append(base)

    def predicted_wps(plan: TunePlan) -> float:
        cfg = config.apply_plan(plan)
        return cost_model.predicted_words_per_sec(
            cfg, len(vocab), device_kind, platform
        )

    ranked = sorted(grid, key=predicted_wps, reverse=True)
    survivors = ranked[: max(1, max_probes)]
    if base not in survivors:
        survivors[-1] = base  # the incumbent always gets probed

    if corpus is None:
        need = max(p.batch_rows for p in survivors) * probe_steps * (
            probe_dispatches + 1
        )
        corpus = _synthetic_probe_corpus(
            vocab, need * config.max_sentence_len, config.max_sentence_len
        )

    probes = []
    try:
        for plan in survivors:
            rec = probe_plan(
                config, plan, vocab, corpus,
                probe_steps=probe_steps, probe_dispatches=probe_dispatches,
                device=dev,
            )
            # each probe's residue goes before the next one is timed (a
            # graph a garbage collection destroys inside another probe's
            # timed dispatches stalls them), and none is left for the
            # process that is about to train
            free_probe_residue(dev)
            rec["predicted_total_ms"] = cost_model.predict(
                config.apply_plan(plan), len(vocab), device_kind, platform
            ).to_json()["total_ms"]
            probes.append(rec)
            if log_fn:
                log_fn({"event": "autotune_probe", **rec})
    finally:
        free_probe_residue(dev)

    best = max(probes, key=lambda r: r.get("score_words_per_sec", 0.0))
    if "error" in best:
        # every survivor failed: keep the configured shape, report why
        best_plan = base
    else:
        best_plan = TunePlan.from_json(best["plan"])
    predicted = cost_model.predict(
        config.apply_plan(best_plan), len(vocab), device_kind, platform
    ).to_json()

    stored_path = None
    try:
        stored_path = plan_cache.store(
            key,
            {
                "plan": best_plan.to_json(),
                "fingerprint": fp,
                "predicted": predicted,
                "measured_words_per_sec": best.get("probe_words_per_sec"),
                "device_kind": device_kind,
                "platform": platform,
            },
            cache_path,
        )
    except OSError:
        pass  # read-only filesystem: the plan still applies, it just won't persist

    res = PlanResolution(
        plan=best_plan,
        source="probe",
        key=key,
        predicted=predicted,
        probes=probes,
        cache_path=stored_path,
    )
    if log_fn:
        log_fn({"event": "autotune", **res.to_json()})
    return res
