"""Serve CLI — load an exported table, stand up the query server.

A copy of word2vec_tpu/serve/__main__.py for the PyTorch port, plus
--backend: the table and the query engine live on the card (gpu, the
default; raises when there is no CUDA device, never serving on the CPU)
or, asked, on the CPU.

    python -m word2vec_tpu_torch.serve --vectors vec.txt
    python -m word2vec_tpu_torch.serve --vectors vec.bin --format binary
    python -m word2vec_tpu_torch.serve --vectors vec.i8 --format int8 \\
        --table-dtype bfloat16 --port 8080 --metrics-dir mdir --trace tdir

When ready it prints ONE JSON line to stdout —
`{"event": "serving", "host": ..., "port": ..., "vocab": V, "dim": d}` —
then serves until SIGTERM/SIGINT (graceful drain, exit 0; second signal or
a blown drain deadline exits 75 for scheduler requeue, matching training's
resilience contract). Exit 1 = startup/crash failure.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np

from ..data.vocab import Vocab
from ..device import resolve_device
from ..io.embeddings import (
    load_embeddings_binary,
    load_embeddings_int8,
    load_embeddings_text,
)
from .query import QueryEngine
from .server import ServeConfig, serve_forever


def load_table(path: str, fmt: str = "text", layout: str = "reference"):
    """(words, f32 matrix) from any export format: text / binary / the
    int8 symmetric-quantized container (dequantized here — the cross-dtype
    path: int8 file -> f32/bf16 resident engine table)."""
    if fmt == "text":
        return load_embeddings_text(path)
    if fmt == "binary":
        return load_embeddings_binary(path, layout=layout)
    if fmt == "int8":
        return load_embeddings_int8(path)
    raise ValueError(f"format must be text|binary|int8, got {fmt!r}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="word2vec_tpu_torch.serve")
    ap.add_argument("--vectors", required=True, metavar="FILE",
                    help="exported embedding table (io/embeddings formats)")
    ap.add_argument("--format", choices=["text", "binary", "int8"],
                    default="text")
    ap.add_argument("--binary-layout", choices=["reference", "google"],
                    default="reference")
    ap.add_argument("--table-dtype", choices=["float32", "bfloat16"],
                    default="float32",
                    help="resident device table dtype (int8 files "
                    "dequantize into this)")
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="where the table and the query engine live: the "
                    "card (default; raises without one) or the CPU")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000,
                    help="0 = ephemeral; the bound port is in the ready line")
    ap.add_argument("--coalesce-ms", type=float, default=2.0,
                    help="request-coalescing window: concurrent queries "
                    "arriving within it share one padded device batch "
                    "(0 = batch only what is already queued)")
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--max-pending", type=int, default=1024,
                    help="bounded queue: queries past this shed with 429")
    ap.add_argument("--cache-size", type=int, default=4096,
                    help="LRU result cache entries (0 disables)")
    ap.add_argument("--max-k", type=int, default=100)
    ap.add_argument("--request-timeout", type=float, default=30.0,
                    metavar="SECS")
    ap.add_argument("--drain-deadline", type=float, default=10.0,
                    metavar="SECS",
                    help="SIGTERM drain budget; past it exit 75 (requeue)")
    ap.add_argument("--stats-every", type=float, default=5.0, metavar="SECS")
    ap.add_argument("--metrics-dir", metavar="DIR",
                    help="serve.prom + serve_metrics.jsonl + flight.json")
    ap.add_argument("--prom-textfile", metavar="FILE")
    ap.add_argument("--trace", metavar="DIR", dest="trace_dir",
                    help="export the request/batch span timeline as a "
                    "Chrome-trace doc on shutdown (obs/trace.py)")
    ap.add_argument("--faults", metavar="SPEC", default="",
                    help="chaos plan (resilience/faults.py); serve kinds: "
                    "stall/hang/sigterm/oom, @k = batch number")
    ap.add_argument("--probe-pairs", metavar="FILE",
                    help="score the loaded table against word-pair golds "
                    "at startup (obs/quality.score_table) and publish the "
                    "w2v_quality_* gauges on /metrics — a table exported "
                    "mid-training serves its measured quality alongside "
                    "the serve gauges")
    ap.add_argument("--probe-analogies", metavar="FILE",
                    help="startup analogy-question probe "
                    "(questions-words.txt format; see --probe-pairs)")
    ap.add_argument("--quiet", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # the card unless the caller asks for the CPU: raises without a card,
    # before the table is read
    device = resolve_device("cuda" if args.backend == "gpu" else "cpu")
    try:
        words, W = load_table(args.vectors, args.format, args.binary_layout)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    vocab = Vocab(words, np.ones(len(words), dtype=np.int64))
    engine = QueryEngine(W, vocab, table_dtype=args.table_dtype,
                         device=device)

    plan = None
    if args.faults:
        from ..resilience.faults import FaultPlan

        try:
            plan = FaultPlan.parse(args.faults)
        except ValueError as e:
            print(f"error: bad --faults spec: {e}", file=sys.stderr)
            return 1

    startup_records = None
    if args.probe_pairs or args.probe_analogies:
        # one-shot quality probe of the loaded table: the same scoring core
        # the in-training probe uses (obs/quality.score_table), published
        # through the server's hub so /metrics carries w2v_quality_* gauges
        # plus the present-from-zero probe counter
        from ..obs.quality import ProbeSet, score_table

        try:
            pset = ProbeSet.from_files(
                vocab, args.probe_pairs, args.probe_analogies
            )
        except (OSError, ValueError) as e:
            print(f"error: bad probe file: {e}", file=sys.stderr)
            return 1
        rec, _ = score_table(W, vocab, pset, device=device)
        startup_records = [rec, {"event": "quality_probe", "step": 0}]
        if not args.quiet:
            shown = {k: v for k, v in rec.items()
                     if k.startswith("quality_")}
            print(f"startup quality probe: {json.dumps(shown)}",
                  file=sys.stderr)

    cfg = ServeConfig(
        host=args.host, port=args.port, coalesce_ms=args.coalesce_ms,
        max_batch=args.max_batch, max_pending=args.max_pending,
        cache_size=args.cache_size, max_k=args.max_k,
        request_timeout_s=args.request_timeout,
        drain_deadline_s=args.drain_deadline,
        stats_every_s=args.stats_every, metrics_dir=args.metrics_dir,
        prom_textfile=args.prom_textfile, trace_dir=args.trace_dir,
        faults=plan, install_signals=True,
        startup_records=startup_records,
    )

    def ready(server) -> None:
        print(json.dumps({
            "event": "serving", "host": cfg.host, "port": server.port,
            "vocab": engine.V, "dim": engine.d,
            "table_dtype": engine.table_dtype,
        }), flush=True)
        if not args.quiet:
            print(f"serving {engine.V} x {engine.d} embeddings on "
                  f"http://{cfg.host}:{server.port} "
                  f"(coalesce {cfg.coalesce_ms} ms, cache "
                  f"{cfg.cache_size}, max-pending {cfg.max_pending})",
                  file=sys.stderr, flush=True)

    try:
        rc = asyncio.run(serve_forever(engine, cfg, ready_cb=ready))
    except ValueError as e:       # bad config (e.g. unservable fault kind)
        print(f"error: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # noqa: BLE001 — crash path: leave evidence
        print(f"serve crashed: {e!r}", file=sys.stderr)
        return 1
    if rc == 0 and not args.quiet:
        print("drained clean (exit 0)", file=sys.stderr)
    elif rc != 0:
        print(f"serve exiting {rc} for requeue", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
