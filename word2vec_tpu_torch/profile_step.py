"""Where the flagship step's time goes on the GPU.

    python -m word2vec_tpu_torch.profile_step [--backend xla] [--steps 10] [--out DIR]

Builds the flagship trainer (sg, ns, K=5, d=300, window 5, B=256 x L=192,
KP=64) on the route `--backend` names (xla, pallas_oa or pallas on split
tables, the JAX package's default layout; pallas_fused on the unified
slab) on a synthetic 71k-word Zipf corpus, warms up, then runs `--steps`
steps under torch.profiler and
prints: the card's name and power limit, the mean step time (host clock
around synchronized steps), the device time per kernel name summed over
the window, and the device's busy and idle shares of the window. The
Chrome trace goes to DIR/profile_step_<backend>_trace.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

from . import PackedCorpus, Trainer, Word2VecConfig
from .data.batcher import BatchIterator
from .utils.synthetic import zipf_corpus_ids, zipf_vocab


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def _busy_us(events) -> float:
    """Union length of the device intervals (overlapping kernels count once)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="xla",
                    choices=["xla", "pallas_oa", "pallas", "pallas_fused"])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Word2VecConfig(
        model="sg", train_method="ns", negative=5, word_dim=300, window=5,
        batch_rows=256, max_sentence_len=192, shared_negatives=64,
        negative_scope="row", band_backend=args.backend,
        table_layout="unified" if args.backend == "pallas_fused" else "split",
    )
    vocab = zipf_vocab(71000)
    n_tok = (args.steps + 6) * cfg.batch_rows * cfg.max_sentence_len
    corpus = PackedCorpus.pack(
        zipf_corpus_ids(vocab, n_tok, seed=0), cfg.max_sentence_len
    )
    tr = Trainer(cfg, vocab, corpus)
    state = tr.init_state()
    tr.train(state=state, log_every=0, max_steps=3)  # warm-up

    # host-clock step time, one synchronized step at a time
    gen = torch.Generator(device=tr.device).manual_seed(1)
    batch, _ = next(iter(
        BatchIterator(corpus, cfg.batch_rows, cfg.max_sentence_len).epoch(0)
    ))
    tokens = torch.from_numpy(batch).to(tr.device)
    step_ms = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step_fn(state.params, tokens, gen, 0.025)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tr.step_fn(state.params, tokens, gen, 0.025)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    dev_events = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start
        )
    busy = _busy_us(dev_events)
    card = _card()
    os.makedirs(args.out, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(args.out, f"profile_step_{args.backend}_trace.json"))
    total = sum(by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1])
    print(f"card: {card}")
    print(f"route: band_backend={cfg.band_backend!r} table_layout={cfg.table_layout!r}")
    print(f"step ms (host clock, synchronized, {args.steps} steps): "
          f"median {sorted(step_ms)[len(step_ms) // 2]:.4f}")
    print(f"profiled window: {window_us / 1e3:.4f} ms for {args.steps} steps; "
          f"device busy {busy / 1e3:.4f} ms ({100 * busy / window_us:.1f}%), "
          f"idle {100 * (1 - busy / window_us):.1f}%")
    print("device time by kernel (ms per step, share of device time):")
    for name, us in rows[:25]:
        print(f"  {us / args.steps / 1e3:9.4f}  {100 * us / max(total, 1e-9):5.1f}%  "
              f"{name[:110]}")
    print(json.dumps({
        "card": card,
        "band_backend": cfg.band_backend,
        "table_layout": cfg.table_layout,
        "step_ms_median": sorted(step_ms)[len(step_ms) // 2],
        "window_ms": window_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "kernels_ms_per_step": {
            k[:80]: v / args.steps / 1e3 for k, v in rows[:25]
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
