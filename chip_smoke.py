#!/usr/bin/env python3
"""Chip smoke for the PyTorch / CUDA port (word2vec_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. device: the card's name and power limit (nvidia-smi), torch / CUDA
     versions; a CUDA device is required.
  2. build: every csrc/*.cu source compiled by nvcc (one process each, all
     started together), with the build seconds and ptxas's register /
     spill report.
  3. kernels vs plain versions on the card, at the flagship shapes:
     fused_grad_core and band_core (sg and cbow, f32 tables, bf16 and f32
     compute; band_core in row and batch negative scope) within the stated
     tolerance, n_ctx / ctx_w exact; the slab scatter (f32 and bf16
     tables, whole rows and the plane-1 negative tail), the overlap-add
     and the ordered row sum bitwise, the row sum also across two runs;
     then the run list (exact), the scatter and the row sum on adversarial
     id sets at flagship width (one run, all distinct, a -1 prefix, runs
     around every threshold and stage size, a batch padded to row 0),
     bitwise and across two runs.
  4. the slice: one step on a small input per route (pallas_fused,
     xla, pallas_oa and pallas on split tables, xla on the unified slab),
     kernels on the card vs the plain versions on the CPU with the same
     draws; then the flagship Trainer (sg, ns, K=5, d=300, window 5,
     B=256 x L=192, KP=64, f32 tables, bf16 compute) for 30 steps on one
     synthetic 71k-word Zipf corpus on each of band_backend 'xla' (the JAX
     default, split tables), 'pallas_oa' and 'pallas' (split) and
     'pallas_fused' (unified slab): finite, falling loss; exact launch
     counts per step (expected_launches), each route's run with every
     count set to 0 just before it; export and a save/load round trip of
     the default route's vectors; two runs of one flagship step on the
     default route, bitwise equal.
  5. times: device-time medians (CUDA events queued behind a spin kernel,
     cuda_ms) per kernel and for its plain version, the
     library call that computes the same function where there is one
     (index_add_ for the scatter and the row sum, F.fold for the
     overlap-add, unique_consecutive for the run list), each kernel's
     bound, and the trainer's words/sec per route. The scatter and the row
     sum are also timed at every call shape the step makes (unified,
     split in/out and neg, a real batch's ids, grad_inputs' ragged rows,
     the pallas slab side), each
     beside index_add_, its bytes bound, its chain bound (longest run x
     dependent-add cycles / SM clock) and its longest run.
The line before the card line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# flagship geometry
V, D, B, L, W, K, KP = 71000, 300, 256, 192, 5, 5, 64
STEPS = 30
# the flagship trainer runs: (band_backend, table_layout); the first is the
# JAX package's default and the one whose vectors are exported
ROUTES = [("xla", "split"), ("pallas_oa", "split"), ("pallas", "split"),
          ("pallas_fused", "unified")]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device ms of fn() over reps runs, each timed with CUDA events.
    Before each run a spin kernel (torch.cuda._sleep, ~0.5 ms) keeps the
    device busy while the host enqueues the events and fn's launches, so
    a call whose host side is slower than its kernels is timed by its
    kernels, not by the Python that launches them (a call that enqueues
    more than the spin covers, like the plain versions' loops, still
    counts its host time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, peak: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def expected_launches(backend: str, layout: str, steps: int) -> dict:
    """Kernel launches of `steps` flagship trainer steps on one route. The
    flagship config keeps the defaults clip_row_update=1.0 (the row trust
    region: one ordered row sum for the in table, two for the out table's
    positive and negative contributions) and scatter_mean=False (which
    would add three more); the tables take one ordered scatter each on
    split tables plus the negative tail, or one doubled-width scatter plus
    the tail on the unified slab; each sorted id array gets its run list
    once."""
    from word2vec_tpu_torch.ops.launch import LAUNCHES

    per = {k: 0 for k in LAUNCHES}
    per["ordered_row_sum"] = 3
    per["fused_slab_scatter"] = 2 if layout == "unified" else 3
    # one run list per distinct sorted id array: the token ids (both
    # token-order sides) and the negative ids; pallas scatters its context
    # side from slab space, a third array
    per["find_runs"] = 3 if backend == "pallas" else 2
    kernel = {"pallas_fused": "fused_grad_core", "pallas_oa": "overlap_add_slabs",
              "pallas": "band_core"}.get(backend)
    if kernel:
        per[kernel] = 1
    return {k: v * steps for k, v in per.items()}


# ------------------------------------------------------------ inputs
def zipf_p():
    ranks = np.arange(1, V + 1, dtype=np.float64)
    return (1.0 / ranks) / np.sum(1.0 / ranks)


def grad_inputs(dev, table_dtype, seed=0):
    from word2vec_tpu_torch.ops import banded

    rng = np.random.default_rng(seed)
    p = zipf_p()
    toks = rng.choice(V, size=(B, L), p=p).astype(np.int32)
    lens = rng.integers(L // 2, L + 1, size=B)
    for r in range(B):  # ragged rows: -1 padding past each row's end
        toks[r, lens[r]:] = -1
    emb = np.stack(
        [
            rng.uniform(-0.5, 0.5, size=(V, D)) / D,
            rng.normal(0.0, 0.05, size=(V, D)),
        ],
        axis=1,
    ).astype(np.float32)
    tokens = torch.from_numpy(toks).to(dev)
    S = banded.resolve_chunk(L, W, 0)
    C, _ = banded._geom(L, W, S)
    valid = tokens >= 0
    tok = torch.where(valid, tokens, 0)
    keep = valid & torch.from_numpy(rng.random((B, L)) < 0.8).to(dev)
    w_eff = torch.from_numpy(
        W - rng.integers(0, W, size=(B, L)).astype(np.int32)
    ).to(dev)
    pad = C * S - L
    pad2 = torch.nn.functional.pad
    return dict(
        tokens=tokens,
        emb=torch.from_numpy(emb).to(dev).to(table_dtype).contiguous(),
        tok_c=pad2(tok, (0, pad)).reshape(B, C, S).contiguous(),
        tok_k=banded.slab_token_ids(tokens, W, S).contiguous(),
        keep_c=pad2(keep.float(), (0, pad)).reshape(B, C, S).contiguous(),
        w_c=pad2(w_eff.float(), (0, pad)).reshape(B, C, S).contiguous(),
        negs=torch.from_numpy(
            rng.choice(V, size=(B, KP), p=p).astype(np.int32)
        ).to(dev),
        alpha=0.025,
    )


def core_inputs(inp, model, scope):
    """band_core's inputs as the pallas route builds them
    (ops/band_step.py _apply_pallas) from grad_inputs' slab: center rows
    and context slabs gathered from the two planes, raw -1-padded ids."""
    from word2vec_tpu_torch.ops import banded

    emb, tokens = inp["emb"], inp["tokens"]
    S = banded.resolve_chunk(L, W, 0)
    C, P = banded._geom(L, W, S)
    tok = torch.where(tokens >= 0, tokens, 0).long()
    ctr, ctx = (1, 0) if model == "cbow" else (0, 1)
    negs = inp["negs"] if scope == "row" else inp["negs"][:1]
    return (
        banded._pad_rows(emb[tok, ctr], C * S).reshape(B, C, S, D).contiguous(),
        banded._slabs(banded._pad_ctx(emb[tok, ctx], W, P), C, S, 2 * W).contiguous(),
        emb[negs.long(), 1].contiguous(),
        torch.nn.functional.pad(tokens, (0, C * S - L), value=-1)
        .reshape(B, C, S).contiguous(),
        inp["tok_k"], inp["keep_c"], inp["w_c"], negs.contiguous(),
        inp["alpha"],
    )


def band_flops(tok_k, keep_c, w_c, centers, is_cbow, dneg_rows):
    """The contractions this data needs: the negative logits and d_hid at
    KP columns per center, d_neg over `dneg_rows` positions, and the band
    logits, the center-side and the context-side band products over the
    masked pairs only (2 operations a multiply-add)."""
    from word2vec_tpu_torch.ops import banded

    S = keep_c.shape[2]
    dist = torch.as_tensor(banded.band_dist(L, W, S), device=tok_k.device)
    mask = (
        (keep_c > 0)[..., None] & (tok_k >= 0)[:, :, None, :]
        & (dist <= w_c[..., None]) & (dist > 0)
    )
    pairs = int(mask.sum())
    return 2 * D * (
        2 * centers * KP + dneg_rows * KP + 3 * pairs
        + (centers if is_cbow else 0)
    )


def grad_bound(inp, cdt, is_cbow):
    """(bound ms, bound_by) of one fused_grad_core call on these inputs:
    each distinct table row the data needs read once, the index and weight
    inputs read once, every output written once; the contractions this
    data needs at the compute type's peak."""
    emb, tok_c, tok_k, negs = inp["emb"], inp["tok_c"], inp["tok_k"], inp["negs"]
    es = emb.element_size()
    Bc, C, S = tok_c.shape
    n_ctr = torch.unique(tok_c).numel()
    n_ctx = torch.unique(tok_k[tok_k >= 0]).numel()
    n_neg = torch.unique(negs).numel()
    nbytes = (
        (n_ctr * 2 * D + n_ctx * D + n_neg * D) * es
        + 4 * (tok_c.numel() * 3 + tok_k.numel() + negs.numel())
        + 4 * (2 * Bc * C * S * D + 2 * Bc * C * S + Bc * KP * D + Bc * KP + 2)
    )
    flops = band_flops(tok_k, inp["keep_c"], inp["w_c"], Bc * C * S, is_cbow, Bc * L)
    return bound_ms(nbytes, flops, PEAK_FLOPS[cdt])


def core_bound(args, cdt, is_cbow):
    """(bound ms, bound_by) of one band_core call: its gathered inputs
    (a, bk, en in the table dtype, the ids and weights) read once, every
    output written once; the contractions as band_flops counts them."""
    a, bk, en, tok_c, tok_k, keep_c, w_c, negs, _ = args
    Bc, C, S, d = a.shape
    SK = bk.shape[2]
    NB = negs.shape[0]
    in_bytes = sum(t.numel() * t.element_size()
                   for t in (a, bk, en, tok_c, tok_k, keep_c, w_c, negs))
    out_bytes = 4 * (Bc * C * S * d + Bc * C * SK * d + NB * KP * d
                     + Bc * C * S + Bc * C * SK + NB * KP + 2)
    flops = band_flops(tok_k, keep_c, w_c, Bc * C * S, is_cbow, Bc * C * S)
    return bound_ms(in_bytes + out_bytes, flops, PEAK_FLOPS[cdt])


def scatter_inputs(dev, table_dtype, seed=1):
    rng = np.random.default_rng(seed)
    p = zipf_p()
    n = B * L
    idx = np.sort(rng.choice(V, size=n, p=p)).astype(np.int32)
    idx[:7] = -1  # padding ids are skipped
    emb = rng.normal(0.0, 0.1, size=(V, 2, D)).astype(np.float32)
    vals = rng.normal(0.0, 1e-3, size=(n, 2, D)).astype(np.float32)
    negs = np.sort(rng.choice(V, size=B * KP, p=p)).astype(np.int32)
    vneg = rng.normal(0.0, 1e-3, size=(B * KP, D)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(
        emb=t(emb).to(table_dtype).contiguous(),
        idx=t(idx),
        vals=t(vals).to(table_dtype).contiguous(),
        negs=t(negs),
        vneg=t(vneg).to(table_dtype).contiguous(),
    )


def scatter_bound(idx, vals):
    es = vals.element_size()
    width = vals[0].numel()
    live = idx[idx >= 0]
    rows = torch.unique(live).numel()
    nbytes = vals.numel() * es + idx.numel() * 4 + 2 * rows * width * es
    return bound_ms(nbytes, live.numel() * width, PEAK_FLOPS[torch.float32])


def row_sum_inputs(dev, seed=3):
    """A flagship batch's sorted token ids (the clip budget's in-table
    call) with per-update norms spanning eight decades, and an unsorted
    negative-draw contribution."""
    rng = np.random.default_rng(seed)
    idx = np.sort(rng.choice(V, size=B * L, p=zipf_p())).astype(np.int32)
    vals = (rng.random(B * L) * 10.0 ** rng.uniform(-4, 4, size=B * L)).astype(np.float32)
    i2 = rng.choice(V, size=B * KP, p=zipf_p()).astype(np.int32)
    v2 = rng.random(B * KP).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(idx), t(vals), t(i2), t(v2)


def trainer_ids(tokens):
    """The sorted token ids a step's tail scatters: -1 padding mapped to
    row 0 as the step's gate does, stably sorted."""
    flat = torch.where(tokens >= 0, tokens, 0).reshape(-1)
    return torch.sort(flat, stable=True).values.to(torch.int32).contiguous()


def slab_ids(tokens):
    """The pallas route's slab-space ids: invalid slots mapped to row 0."""
    from word2vec_tpu_torch.ops import banded

    S = banded.resolve_chunk(L, W, 0)
    k = banded.slab_token_ids(tokens, W, S).reshape(-1)
    return torch.sort(torch.where(k >= 0, k, 0), stable=True).values.to(
        torch.int32).contiguous()


def adversarial_ids(dev, seed=8):
    """Named sorted id sets over the flagship vocabulary, one per edge of
    the ordered sums' work split: one run, all distinct, a -1 prefix,
    runs one below, at and one above the long-run threshold and each
    stage size (read from the built kernels), and a flagship batch's ids
    with ragged rows padded to row 0 (grad_inputs' tokens)."""
    from word2vec_tpu_torch import _build

    rng = np.random.default_rng(seed)
    lr = _build.library("runs").w2v_long_run()
    st = _build.library("fused_step").w2v_scatter_stage_terms()
    rs = _build.library("row_sum").w2v_row_sum_stage()
    edges, row = [], 1
    for n in (lr - 1, lr, lr + 1, st - 1, st, st + 1, 2 * st + 1,
              rs - 1, rs, rs + 1, 2 * rs + 1):
        edges += [row] * n + [row + 1]
        row += 2 + int(rng.integers(0, 3))
    sets = {
        "one_run": np.full(8192, 11),
        "distinct": rng.choice(V, size=20000, replace=False),
        "neg_prefix": np.concatenate(
            [np.full(64, -1), rng.choice(V, size=20000, p=zipf_p())]),
        "edges": np.asarray(edges),
    }
    out = {k: torch.from_numpy(np.sort(v).astype(np.int32)).to(dev)
           for k, v in sets.items()}
    out["trainer"] = trainer_ids(grad_inputs(dev, torch.float32)["tokens"])
    return out


def longest_run(idx) -> int:
    live = idx[idx >= 0]
    if live.numel() == 0:
        return 0
    return int(torch.unique_consecutive(live, return_counts=True)[1].max())


# dependent-add latency of one ordered term, in cycles: the FADD (4); in
# bf16 also the widening shift and the round back (counted as 4 more, a
# floor: the round alone is not faster)
CHAIN_CYCLES = {torch.float32: 4, torch.bfloat16: 8}


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi clocks failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0]) * 1e6


# ------------------------------------------------------------ phases
def rel_err(k, p):
    k, p = k.double(), p.double()
    return float((k - p).abs().max()), float(
        (k - p).abs().max() / p.abs().max().clamp_min(1e-30)
    )


# tolerance on max|kernel - plain| / max|plain| per gradient output: f32
# compute differs only in summation order and FMA contraction; with bf16
# compute an intermediate (a gradient weight) that lands on a bf16
# rounding boundary in one version can round one bf16 ulp (2^-8) away in
# the other, so the bound is bf16-ulp class; losses 1e-4; masks exact
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def check_outputs(what, names, got, ref, cdt):
    """Log and hold each output; return the worst abs error over the
    gradient outputs."""
    worst = 0.0
    for name, g, r in zip(names, got, ref):
        if g.shape != r.shape or not torch.isfinite(g).all():
            fail(f"{what}: {name} shape {tuple(g.shape)} or non-finite values")
        ab, rel = rel_err(g, r)
        exact = name in ("n_ctx", "ctx_w")
        limit = 0.0 if exact else (1e-4 if name == "losses" else TOL[cdt])
        log(f"  {what} {name}: max_abs_err={ab:.3e} max_rel_err={rel:.3e} "
            f"(limit {limit:g})")
        if rel > limit:
            fail(f"{what} {name}: rel err {rel:.3e} > {limit:g}")
        if not exact and name != "losses":
            worst = max(worst, ab)
    return worst


def phase_kernels(dev):
    from word2vec_tpu_torch.ops import band_core as bc
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import overlap as ov
    from word2vec_tpu_torch.ops import train_step as ts

    errs = {}
    grad_names = ("d_ctr", "d_ctx", "n_ctx", "ctx_w", "d_neg", "w_neg_sum", "losses")
    for model in ("sg", "cbow"):
        for cdt in (torch.bfloat16, torch.float32):
            inp = grad_inputs(dev, torch.float32)
            kw = dict(W=W, K=K, L=L, cdt=cdt, is_cbow=model == "cbow",
                      cbow_mean=True)
            args = (inp["emb"], inp["tok_c"], inp["tok_k"], inp["keep_c"],
                    inp["w_c"], inp["negs"], inp["alpha"])
            got = fs.fused_grad_core(*args, **kw)
            ref = fs.fused_grad_core_plain(*args, **kw)
            torch.cuda.synchronize()
            errs[("fused_grad_core", model, cdt)] = check_outputs(
                f"fused_grad_core {model} cdt={str(cdt)[6:]}", grad_names,
                got, ref, cdt)
    core_names = ("d_h", "d_ctx", "d_neg", "n_ctx", "ctx_w", "w_neg_sum", "losses")
    inp = grad_inputs(dev, torch.float32)
    for model in ("sg", "cbow"):
        for scope in ("row", "batch"):
            args = core_inputs(inp, model, scope)
            for cdt in (torch.bfloat16, torch.float32):
                kw = dict(W=W, K=K, cdt=cdt, is_cbow=model == "cbow", cbow_mean=True)
                got = bc.band_core(*args, **kw)
                ref = bc.band_core_plain(*args, **kw)
                torch.cuda.synchronize()
                errs[("band_core", model, scope, cdt)] = check_outputs(
                    f"band_core {model} {scope} cdt={str(cdt)[6:]}", core_names,
                    got, ref, cdt)
                if bool((got[1][args[4] < 0] != 0).any()):
                    fail("band_core: context gradient at an invalid slab slot")
    for dt in (torch.float32, torch.bfloat16):
        sc = scatter_inputs(dev, dt)
        got = fs.fused_slab_scatter(sc["emb"].clone(), sc["idx"], sc["vals"])
        ref = fs.fused_slab_scatter_plain(sc["emb"].clone(), sc["idx"], sc["vals"])
        got = fs.fused_slab_scatter(got, sc["negs"], sc["vneg"], plane=1)
        ref = fs.fused_slab_scatter_plain(ref, sc["negs"], sc["vneg"], plane=1)
        torch.cuda.synchronize()
        same = torch.equal(bits(got), bits(ref))
        moved = not torch.equal(got, sc["emb"])
        log(f"  fused_slab_scatter {str(dt)[6:]}: bitwise_equal={same} "
            f"table_changed={moved}")
        if not (same and moved):
            fail(f"fused_slab_scatter {dt}: kernel != plain (bitwise)")
    # the overlap-add on a flagship slab-space gradient [256, 2, 128, 300]
    S = 118
    y = torch.randn((B, 2, S + 2 * W, D), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))
    got = ov.overlap_add_slabs(y, W, S)
    ref = ov.overlap_add_slabs_plain(y, W, S)
    torch.cuda.synchronize()
    same = got.shape == ref.shape and torch.equal(bits(got), bits(ref))
    log(f"  overlap_add_slabs [{B}, 2, {S + 2 * W}, {D}] f32: bitwise_equal={same}")
    if not same:
        fail("overlap_add_slabs: kernel != plain (bitwise)")
    # the ordered row sum: a sorted and an unsorted contribution, bitwise
    # against the plain version and across two runs
    idx, vals, i2, v2 = row_sum_inputs(dev)
    runs = []
    for _ in range(2):
        out = ts.ordered_row_sum(V, idx, vals, presorted=True)
        runs.append(ts.ordered_row_sum(V, i2, v2, out))
    o2 = torch.argsort(i2, stable=True)
    ref = ts.ordered_row_sum_plain(V, i2[o2], v2[o2],
                                   ts.ordered_row_sum_plain(V, idx, vals))
    torch.cuda.synchronize()
    same = torch.equal(bits(runs[0]), bits(ref))
    again = torch.equal(bits(runs[0]), bits(runs[1]))
    log(f"  ordered_row_sum [N={idx.numel()}+{i2.numel()}]: bitwise_equal={same} "
        f"repeatable={again}")
    if not (same and again):
        fail("ordered_row_sum: kernel != plain or not repeatable (bitwise)")
    phase_ordered_sets(dev)
    return errs


def phase_ordered_sets(dev):
    """The run list, the slab scatter (whole doubled-width rows and the
    plane-1 tail, f32 and bf16 tables) and the ordered row sum on every
    adversarial id set at flagship width: bitwise vs the plain versions
    and across two runs; zero terms and -0.0 cells included."""
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import runs as rl
    from word2vec_tpu_torch.ops import train_step as ts

    gen = torch.Generator(device=dev).manual_seed(10)
    emb32 = torch.randn((V, 2, D), device=dev, generator=gen) * 0.1
    emb32[::3] = -0.0
    for name, idx in adversarial_ids(dev).items():
        n = idx.numel()
        runs = rl.find_runs(idx)
        got = rl.unpack_runs(runs, n)
        want = rl.unpack_runs(rl.find_runs_plain(idx), n)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            fail(f"find_runs {name}: kernel != plain")
        v32 = torch.randn((n, 2, D), device=dev, generator=gen) * 1e-3
        v32[::5] = 0.0
        res = []
        for dt in (torch.float32, torch.bfloat16):
            emb, vals = emb32.to(dt), v32.to(dt)
            pv = vals[:, 1].contiguous()
            ref = fs.fused_slab_scatter_plain(emb.clone(), idx, vals)
            ref = fs.fused_slab_scatter_plain(ref, idx, pv, plane=1)
            outs = []
            for _ in range(2):
                g = fs.fused_slab_scatter(emb.clone(), idx, vals, runs=runs)
                outs.append(fs.fused_slab_scatter(g, idx, pv, plane=1))
            torch.cuda.synchronize()
            ok = all(torch.equal(bits(o), bits(ref)) for o in outs)
            res.append(f"{str(dt)[6:]}={ok}")
            if not ok or torch.equal(ref, emb):
                fail(f"fused_slab_scatter {name} {dt}: kernel != plain or "
                     "not repeatable (bitwise)")
        live = idx[idx >= 0].contiguous()
        rv = (torch.rand(live.numel(), device=dev, generator=gen)
              * 10.0 ** (8 * torch.rand(live.numel(), device=dev, generator=gen) - 4))
        rv[::7] = 0.0
        start = torch.randn(V, device=dev, generator=gen)
        start[::3] = -0.0
        ref = ts.ordered_row_sum_plain(V, live, rv, start.clone())
        outs = [ts.ordered_row_sum(V, live, rv, start.clone(), presorted=True)
                for _ in range(2)]
        torch.cuda.synchronize()
        ok = all(torch.equal(bits(o), bits(ref)) for o in outs)
        log(f"  ordered sums, {name} [N={n}, longest run {longest_run(idx)}]: "
            f"run list exact; scatter (2x{D} + plane 1) bitwise and repeatable "
            f"{' '.join(res)}; row sum bitwise and repeatable={ok}")
        if not ok:
            fail(f"ordered_row_sum {name}: kernel != plain or not repeatable")


def phase_small_step(dev):
    """One step per route, kernels on the card vs plain versions on the CPU,
    same params and draws (small shape, f32 compute)."""
    from word2vec_tpu_torch.config import Word2VecConfig
    from word2vec_tpu_torch.data.negative import build_alias_table
    from word2vec_tpu_torch.device import generator
    from word2vec_tpu_torch.models.params import FUSED_KEY
    from word2vec_tpu_torch.ops.band_step import BandStep, Draws
    from word2vec_tpu_torch.ops.tables import DeviceTables

    v, d = 500, 64
    rng = np.random.default_rng(5)
    cases = [
        ("pallas_fused", "unified", "sg", "row"),
        ("pallas_fused", "unified", "cbow", "row"),
        ("xla", "split", "sg", "row"),
        ("xla", "split", "cbow", "batch"),
        ("pallas_oa", "split", "sg", "batch"),
        ("pallas_oa", "split", "cbow", "row"),
        ("pallas", "split", "sg", "row"),
        ("pallas", "split", "cbow", "batch"),
        ("xla", "unified", "sg", "row"),
    ]
    for backend, layout, model, scope in cases:
        cfg = Word2VecConfig(
            model=model, negative=3, word_dim=d, window=3, min_count=1,
            compute_dtype="float32", shared_negatives=8, max_sentence_len=40,
            band_chunk=10, table_layout=layout, band_backend=backend,
            negative_scope=scope, scatter_mean=True,
        )
        counts = np.arange(2 * v, v, -1).astype(np.float64)
        at = build_alias_table(counts ** 0.75 / np.sum(counts ** 0.75))
        keep = rng.uniform(0.3, 1.0, size=v).astype(np.float32)

        def tables(dv):
            return DeviceTables(
                torch.as_tensor(keep, device=dv),
                torch.as_tensor(at.accept, device=dv),
                torch.as_tensor(at.alias, device=dv),
            )

        toks = rng.integers(0, v, size=(8, 40)).astype(np.int32)
        toks[3, 25:] = -1
        emb = np.stack([rng.uniform(-0.5, 0.5, (v, d)) / d,
                        rng.normal(0, 0.05, (v, d))], axis=1).astype(np.float32)

        def params(dv):
            t = torch.from_numpy(emb.copy()).to(dv)
            if layout == "unified":
                return {FUSED_KEY: t}
            return {"emb_in": t[:, 0].contiguous(),
                    "emb_out_ns": t[:, 1].contiguous()}

        cpu = torch.device("cpu")
        step_cpu = BandStep(cfg, tables(cpu))
        step_gpu = BandStep(cfg, tables(dev))
        tok_cpu = torch.from_numpy(toks)
        dr = step_cpu.draw(generator(cpu, 3), tok_cpu)
        p_cpu, p_gpu, start = params(cpu), params(dev), params(cpu)
        m_cpu = step_cpu.apply(p_cpu, tok_cpu, dr, 0.03)
        m_gpu = step_gpu.apply(
            p_gpu, tok_cpu.to(dev),
            Draws(dr.u_sub.to(dev), dr.w_eff.to(dev), dr.negs.to(dev)), 0.03,
        )
        torch.cuda.synchronize()
        err = max(float((p_gpu[k].cpu() - p_cpu[k]).abs().max()) for k in p_cpu)
        moved = max(float((p_cpu[k] - start[k]).abs().max()) for k in p_cpu)
        lerr = abs(float(m_gpu["loss_sum"]) - float(m_cpu["loss_sum"]))
        log(f"  small step {backend}/{layout} {model} {scope}: params "
            f"max_abs_err={err:.3e} (update max {moved:.3e}), loss_sum "
            f"err={lerr:.3e}")
        # f32 compute: the two versions differ only in summation order
        if not (err <= 1e-6 and moved > 1e-4):
            fail(f"small step {backend} {model}: GPU step disagrees with the CPU step")
        if lerr > 1e-4 * abs(float(m_cpu["loss_sum"])):
            fail(f"small step {backend} {model}: loss_sum disagrees")


def flagship_corpus():
    from word2vec_tpu_torch import PackedCorpus
    from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab

    t0 = time.perf_counter()
    vocab = zipf_vocab(V)
    n_tok = (STEPS + 1) * B * L
    corpus = PackedCorpus.pack(
        zipf_corpus_ids(vocab, n_tok, seed=0, sentence_len=1000), L
    )
    log(f"  corpus: V={len(vocab)} tokens={corpus.num_tokens} rows="
        f"{corpus.num_rows} ({time.perf_counter() - t0:.1f} s to make)")
    return vocab, corpus


def phase_trainer(dev, vocab, corpus, backend, layout, out_dir=None):
    from word2vec_tpu_torch import Trainer, Word2VecConfig, export_matrix
    from word2vec_tpu_torch.io.embeddings import (
        load_embeddings_binary, save_embeddings_binary,
    )
    from word2vec_tpu_torch.ops.launch import LAUNCHES, reset_launch_counts

    cfg = Word2VecConfig(
        model="sg", train_method="ns", negative=K, word_dim=D, window=W,
        batch_rows=B, max_sentence_len=L, shared_negatives=KP,
        negative_scope="row", table_layout=layout, band_backend=backend,
        min_count=5,
    )
    tr = Trainer(cfg, vocab, corpus)  # device defaults to cuda
    tr.train(log_every=0, max_steps=3)  # warm-up (allocator, libraries)
    reset_launch_counts()
    state, rep = tr.train(log_every=5, max_steps=STEPS)
    counts = dict(LAUNCHES)
    hist = rep.loss_history
    log(f"  trainer {backend}/{layout}: steps={rep.steps} words={rep.total_words} "
        f"wall={rep.wall_time:.3f} s words/sec={rep.words_per_sec:.1f} "
        f"loss_history={hist}")
    log(f"  launches {backend}/{layout}: {counts}")
    if rep.steps != STEPS:
        fail(f"trainer {backend} ran {rep.steps} steps, expected {STEPS}")
    if not (hist and all(np.isfinite(hist))):
        fail(f"trainer {backend}: non-finite loss history {hist}")
    if not hist[-1] < hist[0]:
        fail(f"trainer {backend}: loss did not fall: {hist}")
    want = expected_launches(backend, layout, STEPS)
    if counts != want:
        fail(f"trainer {backend}/{layout}: launch counts {counts} != {want}")
    if out_dir is not None:
        mat = export_matrix(state.params, cfg).float().cpu().numpy()
        if mat.shape != (len(vocab), D) or not np.isfinite(mat).all():
            fail(f"export: shape {mat.shape} or non-finite values")
        path = os.path.join(out_dir, "vectors.bin")
        save_embeddings_binary(path, vocab.words, mat)
        words, back = load_embeddings_binary(path)
        if words != vocab.words or not np.array_equal(back, mat):
            fail("saved vectors do not load back")
        log(f"  export: {mat.shape} saved and reloaded")
    return counts, rep


def corpus_batch(dev, corpus):
    """The flagship corpus's first batch [B, L] (int32, -1 padding)."""
    from word2vec_tpu_torch.data.batcher import BatchIterator

    batch, _ = next(iter(BatchIterator(corpus, B, L, seed=0).epoch(0)))
    return torch.from_numpy(batch).to(dev)


def phase_repeat(dev, vocab, corpus):
    """Two runs of one flagship step on the default route (xla, split
    tables) from the same params, tokens and draws: bitwise-equal tables
    and metrics (every per-row sum and table update adds in a fixed
    order)."""
    from word2vec_tpu_torch import Word2VecConfig
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.ops.tables import DeviceTables

    cfg = Word2VecConfig(
        model="sg", train_method="ns", negative=K, word_dim=D, window=W,
        batch_rows=B, max_sentence_len=L, shared_negatives=KP, min_count=5,
    )
    step = BandStep(cfg, DeviceTables.build(vocab, cfg, dev))
    tokens = corpus_batch(dev, corpus)
    draws = step.draw(torch.Generator(device=dev).manual_seed(9), tokens)
    emb = grad_inputs(dev, torch.float32)["emb"]
    outs = []
    for _ in range(2):
        params = {"emb_in": emb[:, 0].contiguous(),
                  "emb_out_ns": emb[:, 1].contiguous()}
        metrics = step.apply(params, tokens, draws, 0.025)
        torch.cuda.synchronize()
        outs.append((params, metrics))
    (p0, m0), (p1, m1) = outs
    same = all(torch.equal(bits(p0[k]), bits(p1[k])) for k in p0) and all(
        torch.equal(bits(m0[k]), bits(m1[k])) for k in m0)
    moved = not torch.equal(p0["emb_out_ns"], emb[:, 1])
    log(f"  repeat flagship xla/split step: bitwise_equal={same} "
        f"table_changed={moved} clip_engaged={float(m0['clip_engaged']):.0f}")
    if not (same and moved):
        fail("two runs of one flagship step differ (bitwise)")


def phase_times(dev, errs, counts, tokens):
    """Times at the flagship shapes; `tokens` is one batch of the flagship
    corpus (the real step's ids for the ordered sums)."""
    from word2vec_tpu_torch.ops import band_core as bc
    from word2vec_tpu_torch.ops import fused_step as fs
    from word2vec_tpu_torch.ops import overlap as ov
    from word2vec_tpu_torch.ops import runs as rl
    from word2vec_tpu_torch.ops import train_step as ts

    kernels = []

    def entry(name, source, replaces, route, err, ms, plain, bms, by, lib):
        n = counts[route][name]
        log(f"  {name}: {ms:.4f} ms, plain {plain:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bms:.4f} ms "
            f"({by}); {n} launches in the {route[0]}/{route[1]} trainer run")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"word2vec_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": n,
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
        })

    inp = grad_inputs(dev, torch.float32)
    kw = dict(W=W, K=K, L=L, cdt=torch.bfloat16, is_cbow=False, cbow_mean=True)
    args = (inp["emb"], inp["tok_c"], inp["tok_k"], inp["keep_c"],
            inp["w_c"], inp["negs"], inp["alpha"])
    ms = cuda_ms(lambda: fs.fused_grad_core(*args, **kw), reps=20)
    plain = cuda_ms(lambda: fs.fused_grad_core_plain(*args, **kw), reps=5)
    bms, by = grad_bound(inp, torch.bfloat16, False)
    log("  (fused_grad_core sg, f32 tables, bf16 compute)")
    entry("fused_grad_core", "fused_step.cu", "word2vec_tpu/ops/pallas_step.py:401",
          ("pallas_fused", "unified"),
          errs[("fused_grad_core", "sg", torch.bfloat16)], ms, plain, bms, by, None)

    # the slab scatter at every call shape the step makes, each beside
    # index_add_ and both bounds; the run lists are built before timing
    # (find_runs is timed on its own below)
    card, clock = card_line(), sm_clock_hz()
    sc = scatter_inputs(dev, torch.float32)
    emb, idx, vals = sc["emb"], sc["idx"], sc["vals"]
    emb_in = emb[:, 0].contiguous()
    ids_batch = trainer_ids(tokens)
    ids_slab = slab_ids(tokens)
    ids_ragged = trainer_ids(grad_inputs(dev, torch.float32)["tokens"])
    g = torch.Generator(device=dev).manual_seed(11)
    calls = [
        ("unified [N, 2x300] (xla/pallas_fused, unified slab)", emb, idx, vals, None),
        ("unified bf16 [N, 2x300]", emb.to(torch.bfloat16), idx,
         vals.to(torch.bfloat16), None),
        ("split in/out [N, 300] (xla, pallas_oa)", emb_in, idx,
         vals[:, 0].contiguous(), None),
        ("split neg [B*KP, 300] (every split route)", emb_in, sc["negs"], sc["vneg"], None),
        ("trainer batch in/out [N, 300] (real step ids, padding on row 0)",
         emb_in, ids_batch, torch.randn((ids_batch.numel(), D), device=dev,
                                        generator=g) * 1e-3, None),
        ("ragged batch in/out [N, 300] (grad_inputs' rows, padding on row 0)",
         emb_in, ids_ragged, torch.randn((ids_ragged.numel(), D), device=dev,
                                         generator=g) * 1e-3, None),
        ("pallas slab side [B*C*(S+2W), 300] (invalid slots on row 0)",
         emb_in, ids_slab, torch.randn((ids_slab.numel(), D), device=dev,
                                       generator=g) * 1e-3, None),
    ]
    call_rows = []
    for label, e, ix, vv, plane in calls:
        runs = rl.find_runs(ix)
        k_ms = cuda_ms(lambda: fs.fused_slab_scatter(e, ix, vv, plane, runs=runs),
                       reps=20)
        live = ix >= 0
        rows = e.view(e.shape[0], -1)
        li, lv = ix[live].long(), vv[live].reshape(int(live.sum()), -1)
        lib = cuda_ms(lambda: rows.index_add_(0, li, lv), reps=20)
        b_bytes, _ = scatter_bound(ix, vv)
        longest = longest_run(ix)
        b_chain = longest * CHAIN_CYCLES[e.dtype] / clock * 1e3
        call_rows.append({
            "call": label, "n": ix.numel(), "width": vv[0].numel(),
            "dtype": str(e.dtype)[6:], "ms": k_ms, "index_add_ms": lib,
            "bytes_bound_ms": b_bytes, "chain_bound_ms": b_chain,
            "longest_run": longest,
        })
        log(f"  fused_slab_scatter {label}: {k_ms:.4f} ms, index_add_ {lib:.4f} ms, "
            f"bytes bound {b_bytes:.4f} ms, chain bound {b_chain:.4f} ms "
            f"(longest run {longest}) ({card})")
    u = call_rows[0]
    plain = cuda_ms(
        lambda: fs.fused_slab_scatter_plain(emb, idx, vals), reps=3, warmup=1
    )
    bms, by = ((u["bytes_bound_ms"], "bytes") if u["bytes_bound_ms"] >= u["chain_bound_ms"]
               else (u["chain_bound_ms"], "operations"))
    log(f"  (fused_slab_scatter entry: the unified doubled-width f32 call; "
        f"bound_by {by} = {'bytes' if by == 'bytes' else 'the longest run chain'})")
    entry("fused_slab_scatter", "fused_step.cu", "word2vec_tpu/ops/pallas_step.py:490",
          ("xla", "split"), 0.0, u["ms"], plain, bms, by, u["index_add_ms"])

    # the run list of the unified call's ids; torch.unique_consecutive
    # computes the same runs (with a host sync)
    ms = cuda_ms(lambda: rl.find_runs(idx), reps=20)
    plain = cuda_ms(lambda: rl.find_runs_plain(idx), reps=5)
    lib = cuda_ms(lambda: torch.unique_consecutive(idx, return_counts=True), reps=20)
    n_runs = int(torch.unique_consecutive(idx[idx >= 0]).numel())
    bms, by = bound_ms(4 * idx.numel() + 8 * n_runs + 16, idx.numel(),
                       PEAK_FLOPS[torch.float32])
    for label, ix in (("trainer batch", ids_batch), ("pallas slab side", ids_slab),
                      ("neg", sc["negs"])):
        log(f"  find_runs {label} [N={ix.numel()}]: "
            f"{cuda_ms(lambda: rl.find_runs(ix), reps=20):.4f} ms")
    log(f"  (find_runs on the unified call's {idx.numel()} ids, {n_runs} runs)")
    entry("find_runs", "runs.cu", "word2vec_tpu/ops/pallas_step.py:490",
          ("xla", "split"), 0.0, ms, plain, bms, by, lib)

    # the overlap-add on a flagship slab-space gradient; F.fold computes the
    # same sums (col2im) from the pre-permuted input
    S = 118
    C, SK = 2, S + 2 * W
    y = torch.randn((B, C, SK, D), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    yp = y.permute(0, 3, 2, 1).reshape(B, D * SK, C).contiguous()

    def lib_fold():
        return torch.nn.functional.fold(
            yp, output_size=(C * S + 2 * W, 1), kernel_size=(SK, 1), stride=(S, 1))

    ms = cuda_ms(lambda: ov.overlap_add_slabs(y, W, S), reps=20)
    plain = cuda_ms(lambda: ov.overlap_add_slabs_plain(y, W, S), reps=20)
    lib = cuda_ms(lib_fold, reps=20)
    folded = lib_fold()[:, :, W:W + C * S, 0].permute(0, 2, 1)
    fold_err = float((folded - ov.overlap_add_slabs(y, W, S)).abs().max())
    log(f"  (overlap_add_slabs f32 [{B}, {C}, {SK}, {D}]; F.fold vs the kernel: "
        f"max_abs_err={fold_err:.3e})")
    out_elems = B * C * S * D
    bms, by = bound_ms(4 * (y.numel() + out_elems), out_elems,
                       PEAK_FLOPS[torch.float32])
    entry("overlap_add_slabs", "overlap.cu", "word2vec_tpu/ops/pallas_overlap.py:108",
          ("pallas_oa", "split"), 0.0, ms, plain, bms, by, lib)

    cargs = core_inputs(inp, "sg", "row")
    ckw = dict(W=W, K=K, cdt=torch.bfloat16, is_cbow=False, cbow_mean=True)
    ms = cuda_ms(lambda: bc.band_core(*cargs, **ckw), reps=20)
    plain = cuda_ms(lambda: bc.band_core_plain(*cargs, **ckw), reps=3, warmup=1)
    bms, by = core_bound(cargs, torch.bfloat16, False)
    log("  (band_core sg, row scope, f32 tables, bf16 compute)")
    entry("band_core", "band_core.cu", "word2vec_tpu/ops/pallas_band.py:292",
          ("pallas", "split"),
          errs[("band_core", "sg", "row", torch.bfloat16)], ms, plain, bms, by, None)

    # the ordered row sum: synthetic flagship ids and the real step's ids
    out = torch.zeros(V, device=dev)
    idx, vals, _, _ = row_sum_inputs(dev)
    for label, ix in (("synthetic Zipf ids", idx), ("trainer batch", ids_batch),
                      ("ragged batch", ids_ragged), ("pallas slab side", ids_slab)):
        rv = vals[: ix.numel()] if ix.numel() <= vals.numel() else torch.rand(
            ix.numel(), device=dev, generator=g)
        runs = rl.find_runs(ix)
        k_ms = cuda_ms(lambda: ts.ordered_row_sum(V, ix, rv, out, presorted=True,
                                                  runs=runs), reps=20)
        li = ix.long()
        lib = cuda_ms(lambda: torch.zeros(V, device=dev).index_add_(0, li, rv), reps=20)
        rows = torch.unique(ix).numel()
        b_bytes, _ = bound_ms(8 * ix.numel() + 8 * rows, ix.numel(),
                              PEAK_FLOPS[torch.float32])
        longest = longest_run(ix)
        b_chain = longest * CHAIN_CYCLES[torch.float32] / clock * 1e3
        call_rows.append({
            "call": f"ordered_row_sum {label}", "n": ix.numel(), "width": 1,
            "dtype": "float32", "ms": k_ms, "index_add_ms": lib,
            "bytes_bound_ms": b_bytes, "chain_bound_ms": b_chain,
            "longest_run": longest,
        })
        log(f"  ordered_row_sum {label} [N={ix.numel()}]: {k_ms:.4f} ms, "
            f"index_add_ {lib:.4f} ms, bytes bound {b_bytes:.4f} ms, chain bound "
            f"{b_chain:.4f} ms (longest run {longest}) ({card})")
    r = call_rows[-4]
    plain = cuda_ms(lambda: ts.ordered_row_sum_plain(V, idx, vals), reps=3, warmup=1)
    bms, by = ((r["bytes_bound_ms"], "bytes") if r["bytes_bound_ms"] >= r["chain_bound_ms"]
               else (r["chain_bound_ms"], "operations"))
    log(f"  (ordered_row_sum entry: a flagship batch's {idx.numel()} sorted Zipf "
        f"ids; bound_by {by} = {'bytes' if by == 'bytes' else 'the longest run chain'})")
    entry("ordered_row_sum", "row_sum.cu", "word2vec_tpu/ops/train_step.py:88",
          ("xla", "split"), 0.0, r["ms"], plain, bms, by, r["index_add_ms"])
    log(json.dumps({"ordered_sum_calls": call_rows, "card": card,
                    "sm_clock_mhz": clock / 1e6}))
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import word2vec_tpu_torch  # noqa: F401 — fails outside the repository
    from word2vec_tpu_torch import _build

    if any(m == "jax" or m.startswith(("jax.", "word2vec_tpu."))
           or m == "word2vec_tpu" for m in sys.modules):
        fail("the port imported jax or the JAX package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1 device] {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        _build.library(name)
    log(f"[2 build] {time.perf_counter() - t0:.1f} s")
    for name, rep in _build.PTXAS_REPORTS.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    log("[3 kernels vs plain, flagship shapes]")
    errs = phase_kernels(dev)

    log("[4 slice]")
    phase_small_step(dev)
    vocab, corpus = flagship_corpus()
    counts, reps = {}, {}
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(
        prefix="smoke_", dir=os.path.join(HERE, "build")
    ) as out_dir:
        for route in ROUTES:
            counts[route], reps[route] = phase_trainer(
                dev, vocab, corpus, *route,
                out_dir=out_dir if route == ROUTES[0] else None,
            )

    phase_repeat(dev, vocab, corpus)

    log(f"[5 times] card: {card}")
    kernels = phase_times(dev, errs, counts, corpus_batch(dev, corpus))
    for (backend, layout), rep in reps.items():
        log(f"  trainer words/sec {backend}/{layout}: {rep.words_per_sec:.1f} "
            f"({card})")

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
