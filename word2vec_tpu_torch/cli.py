"""word2vec.c-compatible command line for the PyTorch / CUDA port.

The train -> checkpoint -> export -> eval subset of word2vec_tpu/cli.py,
with the same flag names, defaults, validation messages and exit codes:

    python -m word2vec_tpu_torch.cli -train text8 -output vec.bin -size 300 \\
        -window 5 -negative 5 -model sg -train_method ns -iter 3 -binary 1

Training runs on the GPU (--backend gpu, the default, raises when there is
no CUDA device; it never carries on on the CPU); --backend cpu runs the
kernels' plain PyTorch versions, for tests. The corpus is counted and
encoded by the native host layer (native/, built with g++ at first use;
the pure-Python layer otherwise, and the vocab line says which ran), every
optimizer step is a CUDA graph replay through the route's hand-written
kernels (train.py), checkpoints are the JAX package's format
(io/checkpoint.py, loadable by either package), and --eval-ws353 /
--eval-analogy score the exported vectors through a query engine resident
on the card (serve/query.py, eval/).

Reference divergences (deliberate, as in the JAX CLI):
  - `-train <file>` is honored (the reference hardcodes ./text8).
  - `-binary` works (the reference's parse line is commented out).
  - `-alpha` is honored for skip-gram; the 0.05 cbow-mean default applies
    only when model=cbow and -alpha was not given (word2vec.c behavior).
  - `-threads` is accepted for compatibility and ignored.

Flags of layers the port does not have yet (--dp/--tp/--sp, --multihost,
--elastic*, --faults, --slo, --trace, --metrics-dir, --quality-*,
--autotune, --corpus-mode, --prng, ...) are not defined: argparse rejects
them.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

#: config fields that are runtime wiring of layers the port does not have
#: (telemetry, planner, elasticity); a resumed checkpoint of the JAX
#: package may carry them on, and the resume resets them to these values
_UNPORTED_WIRING = {
    "health_metrics": False,
    "quality_probe_every": 0,
    "autotune": "off",
    "elastic": "off",
    "elastic_policy": "",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="word2vec_tpu_torch",
        description="word2vec on the GPU, PyTorch/CUDA port "
                    "(reference-compatible flags)",
        allow_abbrev=False,
    )
    # reference flags (main.cpp:123-151); single-dash long names as upstream
    p.add_argument("-train", dest="train", metavar="FILE", help="training corpus")
    p.add_argument("-output", dest="output", metavar="FILE",
                   default="text8-sgns.txt", help="output vectors (main.cpp:106)")
    p.add_argument("-size", dest="size", type=int, default=200,
                   help="embedding dim (default 200, main.cpp:112)")
    p.add_argument("-window", dest="window", type=int, default=5)
    p.add_argument("-subsample", dest="subsample", type=float, default=1e-4)
    p.add_argument("-train_method", dest="train_method", default="ns",
                   choices=["ns", "hs"])
    p.add_argument("-negative", dest="negative", type=int, default=0,
                   help="negative samples (reference default 0, main.cpp:118)")
    p.add_argument("-threads", dest="threads", type=int, default=1,
                   help="accepted for compatibility; ignored")
    p.add_argument("-iter", dest="iter", type=int, default=1)
    p.add_argument("-min-count", dest="min_count", type=int, default=5)
    p.add_argument("--max-vocab", type=int, default=0,
                   help="cap the vocabulary to the top-N words by count "
                        "(0 = unlimited); the working version of the "
                        "reference's declared-but-undefined reduce_vocab "
                        "(Word2Vec.h:69)")
    p.add_argument("-alpha", dest="alpha", type=float, default=None)
    p.add_argument("-model", dest="model", default="sg", choices=["sg", "cbow"])
    p.add_argument("-save-vocab", dest="save_vocab", metavar="FILE")
    p.add_argument("-read-vocab", dest="read_vocab", metavar="FILE")
    p.add_argument("-binary", dest="binary", type=int, default=0)
    p.add_argument("-cbow-mean", dest="cbow_mean", type=int, default=1,
                   help="cbow projection: 1=mean (reference default), 0=sum")
    # single-device levers
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                   help="gpu (default): the CUDA device, raising when there "
                        "is none; cpu: the kernels' plain PyTorch versions")
    p.add_argument("--micro-steps", type=int, default=0,
                   help="sequential optimizer sub-steps per dispatched batch "
                        "(0 = auto with --batch-rows 0, else 1)")
    p.add_argument("--chunk-steps", type=int, default=0,
                   help="optimizer steps per dispatch (0 = auto, 1 = "
                        "per-step); identical trajectory either way")
    p.add_argument("--batch-rows", type=int, default=0,
                   help="sentence rows per device step; 0 = auto-size so an "
                        "epoch has enough optimizer steps to learn")
    p.add_argument("--clip-row-update", type=float, default=1.0,
                   help="per-row trust region: max L2 norm of one row's "
                        "summed update per optimizer step (0 = off)")
    p.add_argument("--scatter-mean", type=int, default=0, choices=[0, 1],
                   help="normalize duplicate-row updates by count (hot-row "
                        "stabilizer; 0 = reference-faithful sum)")
    p.add_argument("--kernel", choices=["auto", "band", "pair"], default="auto",
                   help="device kernel: band (the objective's fast path: "
                        "banded ns or positional hs), pair (per-pair "
                        "enumeration, reference-faithful), auto (band; pair "
                        "in the band kernel's degeneracy domain)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"],
                   default="bfloat16",
                   help="dot-product dtype; float32 for reference-exact scores")
    p.add_argument("--table-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="storage dtype of the [V, d] embedding tables")
    p.add_argument("--stochastic-rounding", type=int, default=0, choices=[0, 1],
                   help="unbiased stochastic rounding of table updates "
                        "(bfloat16 tables)")
    p.add_argument("--table-layout", choices=["split", "unified"],
                   default="split",
                   help="split = two [V, d] tables; unified = one [V, 2, d] "
                        "slab")
    p.add_argument("--shared-negatives", type=int, default=64,
                   help="shared negative draws per batch row (band kernel)")
    p.add_argument("--negative-scope", choices=["row", "batch"], default="row",
                   help="share the negative pool per row, or one pool for "
                        "the whole batch")
    p.add_argument("--band-backend",
                   choices=["xla", "pallas", "pallas_oa", "pallas_fused"],
                   default="xla",
                   help="band step route: xla (torch ops + the scatter "
                        "kernels), pallas (the band core kernel), pallas_oa "
                        "(the overlap-add kernel), pallas_fused (the fused "
                        "step; --table-layout unified)")
    p.add_argument("--slab-scatter", type=int, default=0, choices=[0, 1],
                   help="band kernel: scatter context grads from slab space")
    p.add_argument("--hs-dense-top", type=int, default=0, metavar="P",
                   help="two-tier hs update: handle the top-P Huffman nodes "
                        "(a contiguous slice + per-path prefix) with dense "
                        "matmuls, gather/scatter only the short path tails "
                        "(config.hs_dense_top; 0 = single-tier)")
    p.add_argument("--hs-tail-slots", type=int, default=-1, metavar="T",
                   help="two-tier hs tail-scatter compaction bound per batch "
                        "row: -1 auto (+6 sigma), 0 off, >0 explicit "
                        "(config.hs_tail_slots)")
    p.add_argument("--resident", choices=["auto", "on", "off"], default="auto",
                   help="device-resident corpus (chunked dispatch)")
    p.add_argument("--max-sentence-len", type=int, default=192)
    p.add_argument("--corpus-format", choices=["text8", "lines"], default="text8",
                   help="text8: whitespace stream (main.cpp:63-92); "
                        "lines: one sentence per line (Word2Vec.cpp:19-30)")
    p.add_argument("--binary-layout", choices=["reference", "google"],
                   default="reference")
    p.add_argument("--export-int8", metavar="FILE",
                   help="also export the table as the int8 "
                        "symmetric-quantized container (per-row scale "
                        "header, io/embeddings.save_embeddings_int8)")
    p.add_argument("--export-side", choices=["auto", "input", "output"],
                   default="auto",
                   help="which table -output saves: auto = the reference's "
                   "choice (main.cpp:196-202); input = the gather-side "
                   "table; output = the ns prediction table")
    p.add_argument("--checkpoint-dir", metavar="DIR")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="STEPS")
    p.add_argument("--checkpoint-keep", type=int, default=1, metavar="N",
                   help="previous checkpoints retained as rollback targets "
                        "(<dir>.old ... .old{N})")
    p.add_argument("--resume", metavar="DIR", help="resume from checkpoint "
                   "dir (integrity-checked; a corrupt checkpoint is "
                   "quarantined as .corrupt and the .old backup loads "
                   "instead); a checkpoint of either package loads")
    p.add_argument("--allow-vocab-mismatch", action="store_true",
                   help="skip the --resume vocabulary-compatibility guard")
    p.add_argument("--divergence-budget", type=int, default=8,
                   help="consecutive non-finite-loss steps before the run "
                        "aborts with a DivergenceError (exit 2) instead of "
                        "training on NaN parameters (0 = count only)")
    p.add_argument("--eval-ws353", metavar="FILE",
                   help="WordSim-353 csv/tsv for post-train eval")
    p.add_argument("--eval-analogy", metavar="FILE",
                   help="google questions-words.txt for post-train eval")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--log-jsonl", metavar="FILE",
                   help="append machine-readable JSONL log records to FILE")
    p.add_argument("--quiet", action="store_true")
    return p


def _flag_diffs(parser, args, argv, flag_kwargs, ck_cfg) -> List[str]:
    """Config fields the user typed a flag for that the checkpoint's config
    overrides (the JAX CLI's resume notice, word2vec_tpu/cli.py:866-942)."""
    from .config import Word2VecConfig

    try:
        flag_cfg = Word2VecConfig(**flag_kwargs)
    except ValueError:
        return []
    opts_by_dest = {a.dest: a.option_strings for a in parser._actions}
    dest_overrides = {
        "iters": "iter", "word_dim": "size",
        "subsample_threshold": "subsample", "init_alpha": "alpha",
        "dtype": "table_dtype",
    }

    def user_set(field: str) -> bool:
        opts = opts_by_dest.get(dest_overrides.get(field, field))
        if opts is None:
            return field in flag_kwargs
        return any(
            t == o or t.startswith(o + "=") for t in argv for o in opts
        )

    def flag_value(field: str):
        if field == "micro_steps" and not args.batch_rows:
            return max(1, args.micro_steps)
        return getattr(flag_cfg, field)

    return sorted(
        f.name
        for f in dataclasses.fields(flag_cfg)
        if f.name not in _UNPORTED_WIRING
        and user_set(f.name)
        and flag_value(f.name) != getattr(ck_cfg, f.name)
    )


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    parser = build_parser()
    if not argv:
        parser.print_help()  # reference: help on no args (main.cpp:99-103)
        return 0
    args = parser.parse_args(argv)

    from . import native
    from .config import Word2VecConfig
    from .data.batcher import PackedCorpus
    from .data.corpus import load_corpus
    from .data.vocab import Vocab
    from .device import resolve_device
    from .io.checkpoint import (
        WRITER, CheckpointError, checkpoint_writer, load_checkpoint_with_path,
        save_checkpoint,
    )
    from .io.embeddings import save_word2vec
    from .models.params import export_matrix
    from .obs.health import DivergenceError
    from .resilience.shutdown import EXIT_PREEMPTED, ShutdownHandler
    from .train import Trainer
    from .utils.logging import jsonl_logger, progress_logger, tee

    if args.checkpoint_keep < 0:
        print("error: --checkpoint-keep must be >= 0", file=sys.stderr)
        return 1

    # Resume: the checkpoint's config and vocab are authoritative — resuming
    # against a rebuilt vocab would silently re-attribute embedding rows.
    state = None
    ck_cfg = None
    ck_vocab = None
    if args.resume:
        try:
            state, ck_cfg, ck_vocab, ck_dir = load_checkpoint_with_path(
                args.resume
            )
        except CheckpointError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        if not args.quiet:
            print(f"resumed from {args.resume} at step {state.step}")
        writer = checkpoint_writer(ck_dir)
        if writer is not None and writer != WRITER:
            # unconditional (even under --quiet): the run changes package
            print(
                f"resume: checkpoint written by {writer}; params, counters "
                "and the alpha schedule carry over, the draw stream "
                "continues on this package's generator (threefry cannot be "
                "reproduced in torch)",
                file=sys.stderr,
            )
        wiring = {
            k: v for k, v in _UNPORTED_WIRING.items()
            if getattr(ck_cfg, k) != v
        }
        if wiring:
            print(
                "resume: resetting config fields of layers this package "
                f"does not have: {sorted(wiring)}",
                file=sys.stderr,
            )
            ck_cfg = dataclasses.replace(ck_cfg, **wiring)

    # validation mirrors main.cpp:164-181 (raised by Word2VecConfig)
    alpha = args.alpha
    if alpha is None:
        # word2vec.c-style default: 0.05 for cbow(+mean), 0.025 for sg
        alpha = 0.05 if (args.model == "cbow" and args.cbow_mean) else 0.025
    flag_kwargs = dict(
        iters=args.iter,
        window=args.window,
        min_count=args.min_count,
        word_dim=args.size,
        negative=args.negative,
        subsample_threshold=args.subsample,
        init_alpha=alpha,
        cbow_mean=bool(args.cbow_mean),
        train_method=args.train_method,
        model=args.model,
        batch_rows=args.batch_rows or 32,  # placeholder; auto-sized below
        # with auto batch sizing the real (rows, micro) pair is set below
        micro_steps=max(1, args.micro_steps) if args.batch_rows else 1,
        chunk_steps=args.chunk_steps,
        max_sentence_len=args.max_sentence_len,
        seed=args.seed,
        kernel=args.kernel,
        compute_dtype=args.compute_dtype,
        shared_negatives=args.shared_negatives,
        negative_scope=args.negative_scope,
        scatter_mean=bool(args.scatter_mean),
        slab_scatter=bool(args.slab_scatter),
        hs_dense_top=args.hs_dense_top,
        hs_tail_slots=args.hs_tail_slots,
        band_backend=args.band_backend,
        table_layout=args.table_layout,
        resident=args.resident,
        clip_row_update=args.clip_row_update,
        dtype=args.table_dtype,
        stochastic_rounding=bool(args.stochastic_rounding),
        divergence_budget=args.divergence_budget,
    )
    try:
        cfg = ck_cfg if ck_cfg is not None else Word2VecConfig(**flag_kwargs)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    if args.export_side == "output" and cfg.use_hs:
        # fail BEFORE training, on the EFFECTIVE config
        print("error: --export-side output requires negative sampling "
              "(the hs output table holds internal nodes, not word rows)",
              file=sys.stderr)
        return 1

    if not args.train:
        print("error: -train <file> is required", file=sys.stderr)
        return 1

    # the card unless the caller asks for the CPU: raises without a card,
    # before the corpus scan
    device = resolve_device("cuda" if args.backend == "gpu" else "cpu")

    if ck_cfg is not None:
        # unconditional (even under --quiet): a lever flag silently ignored
        # at resume time is how an A/B run measures the wrong configuration
        diffs = _flag_diffs(parser, args, list(argv), flag_kwargs, ck_cfg)
        if diffs:
            print(
                "resume: using checkpoint config; ignoring differing "
                f"flags {diffs}", file=sys.stderr,
            )

    t0 = time.perf_counter()
    mode = native.MODE_STREAM if args.corpus_format == "text8" else native.MODE_LINES
    if args.max_vocab and (ck_vocab is not None or args.read_vocab):
        print(
            "warning: --max-vocab applies only when the vocabulary is built "
            "from the corpus; the loaded vocabulary (checkpoint/-read-vocab) "
            "is used as-is", file=sys.stderr,
        )
    if ck_vocab is not None:
        vocab = ck_vocab
        if args.read_vocab and Vocab.load(
            args.read_vocab
        ).content_hash() != vocab.content_hash() and not args.allow_vocab_mismatch:
            print(
                f"error: -read-vocab {args.read_vocab} holds a different "
                f"vocabulary than the checkpoint at {args.resume} "
                "(content-hash mismatch); resuming would re-attribute "
                "embedding rows. Drop -read-vocab (the checkpoint's vocab "
                "is authoritative) or pass --allow-vocab-mismatch.",
                file=sys.stderr,
            )
            return 1
        if not args.read_vocab and not args.allow_vocab_mismatch:
            # Resume-compatibility guard: rebuild the vocabulary this corpus
            # + the checkpoint's min_count produce and compare content
            # hashes. Hash-equal vocabularies encode identically, so the
            # rebuilt ids are reused.
            rb_vocab, rb_flat = load_corpus(
                args.train, fmt=args.corpus_format, min_count=cfg.min_count,
                max_vocab=args.max_vocab,
            )
            if rb_vocab.content_hash() == vocab.content_hash():
                flat = rb_flat
            elif vocab.is_compatible_superset(rb_vocab):
                # the checkpoint's vocabulary extends what this corpus
                # rebuilds to (an online-growth checkpoint of the JAX
                # package): it stays authoritative, re-encode with it
                print(
                    f"resume: checkpoint vocabulary ({len(vocab)} words) is "
                    f"a compatible superset of the corpus rebuild "
                    f"({len(rb_vocab)} words) — an online-growth "
                    "checkpoint; resuming with the grown vocabulary",
                    file=sys.stderr,
                )
                flat = native.encode_file(args.train, vocab, mode)
            else:
                print(
                    f"error: the corpus at {args.train} rebuilds to a "
                    f"different vocabulary ({len(rb_vocab)} words) than the "
                    f"checkpoint at {args.resume} pins ({len(vocab)} words, "
                    "content-hash mismatch, not a compatible superset): "
                    "this is not the corpus the "
                    "checkpoint was trained on (or -min-count/--max-vocab "
                    "differ from the original run). Resuming would silently "
                    "re-attribute embedding rows; pass "
                    "--allow-vocab-mismatch to train the checkpoint's "
                    "vocab against this corpus anyway.",
                    file=sys.stderr,
                )
                return 1
        else:
            flat = native.encode_file(args.train, vocab, mode)
    elif args.read_vocab:
        vocab = Vocab.load(args.read_vocab)  # Word2Vec.cpp:179-196
        flat = native.encode_file(args.train, vocab, mode)
    else:
        vocab, flat = load_corpus(
            args.train, fmt=args.corpus_format, min_count=cfg.min_count,
            max_vocab=args.max_vocab,
        )
    if not args.quiet:
        print(f"vocab: {len(vocab)} words, {vocab.total_words} total "
              f"({time.perf_counter() - t0:.1f}s, "
              f"{native.implementation()} data layer)")
    corpus = PackedCorpus.from_flat(flat, cfg.max_sentence_len)
    if args.save_vocab:
        vocab.save(args.save_vocab)  # Word2Vec.cpp:171-177

    if args.batch_rows == 0 and not args.resume:
        auto_rows, auto_micro = Word2VecConfig.auto_geometry(
            corpus.num_tokens, cfg.max_sentence_len, vocab_size=len(vocab),
        )
        if args.micro_steps:
            # explicit micro with auto rows: keep the auto-sized OPTIMIZER
            # block and scale the dispatch to block * micro
            block = max(1, auto_rows // auto_micro)
            auto_micro = args.micro_steps
            auto_rows = block * auto_micro
        cfg = dataclasses.replace(cfg, batch_rows=auto_rows, micro_steps=auto_micro)
        if not args.quiet:
            steps = max(
                1,
                corpus.num_tokens * auto_micro
                // (auto_rows * cfg.max_sentence_len),
            )
            print(
                f"batch geometry auto: {auto_rows} rows x {auto_micro} "
                f"micro-steps (~{steps} optimizer steps/epoch)"
            )

    sinks = []
    if not args.quiet:
        sinks.append(progress_logger())
    if args.log_jsonl:
        sinks.append(jsonl_logger(args.log_jsonl))
    hub = tee(*sinks)
    log_fn = hub if sinks else None

    trainer = Trainer(cfg, vocab, corpus, log_fn=log_fn, device=device)

    def save_ckpt(s) -> None:
        t = time.perf_counter()
        save_checkpoint(
            args.checkpoint_dir, s, trainer.config, vocab,
            keep=args.checkpoint_keep,
        )
        if log_fn is not None:
            log_fn({"event": "checkpoint", "step": s.step,
                    "seconds": time.perf_counter() - t})

    ckpt_cb = save_ckpt if args.checkpoint_dir and args.checkpoint_every else None

    # Preemption-safe shutdown: SIGTERM/SIGINT request a cooperative stop at
    # the next dispatch boundary; the run then checkpoints and exits
    # EXIT_PREEMPTED so a scheduler can requeue with --resume.
    handler = ShutdownHandler().install()
    trainer.install_shutdown(handler)
    try:
        state, report = trainer.train(
            state=state,
            log_every=args.log_every,
            checkpoint_cb=ckpt_cb,
            checkpoint_every=args.checkpoint_every,
        )
    except DivergenceError as e:
        print(f"error: DivergenceError: {e}", file=sys.stderr)
        hub.close()
        return 2
    finally:
        handler.uninstall()
    if log_fn is not None:
        summary = {
            "event": "train_report",
            "steps": report.steps,
            "words_per_sec": report.words_per_sec,
            "final_loss": report.final_loss,
            "nonfinite_loss_steps": report.health.get("nonfinite_loss_steps"),
            "health_observations": report.health.get("observations"),
        }
        if report.interrupted:
            summary["interrupted"] = report.interrupted
        log_fn(summary)

    if report.interrupted == "preempted":
        # checkpoint the stopped-at-boundary state, skip export/eval (the
        # run is not finished), exit with the distinct requeue rc
        if args.checkpoint_dir:
            save_ckpt(state)
        print(
            f"preempted (signal {handler.signum}): stopped at step "
            f"{state.step}; "
            + (
                f"checkpoint saved to {args.checkpoint_dir}; requeue with "
                f"--resume {args.checkpoint_dir}"
                if args.checkpoint_dir
                else "WARNING: no --checkpoint-dir, progress not persisted"
            ),
            file=sys.stderr,
        )
        hub.close()
        return EXIT_PREEMPTED

    if not args.quiet:
        print(f"\ntrained {report.total_words} words in {report.wall_time:.1f}s "
              f"({report.words_per_sec:,.0f} words/sec), final loss "
              f"{report.final_loss:.4f}")

    if args.checkpoint_dir:
        save_ckpt(state)

    # matrix choice per main.cpp:196-202; one host copy serves the files
    # and the eval engine (its cache is keyed on this array object)
    matrix = export_matrix(state.params, cfg, side=args.export_side)
    W = matrix.float().cpu().numpy()
    if args.output:
        save_word2vec(
            args.output, vocab, W,
            binary=bool(args.binary), layout=args.binary_layout,
        )
        if not args.quiet:
            print(f"saved {'binary' if args.binary else 'text'} vectors to "
                  f"{args.output}")
    if args.export_int8:
        from .io.embeddings import save_embeddings_int8

        save_embeddings_int8(args.export_int8, vocab.words, W)
        if not args.quiet:
            print(f"saved int8-quantized vectors to {args.export_int8}")

    if args.eval_ws353 or args.eval_analogy:
        from .eval.analogy import evaluate_analogies
        from .eval.similarity import evaluate_ws353

        if args.eval_ws353:
            r = evaluate_ws353(W, vocab, args.eval_ws353, device=device)
            print(f"WS-353 spearman: {r.spearman:.4f} ({r.pairs_used}/{r.pairs_total} pairs)")
        if args.eval_analogy:
            r = evaluate_analogies(W, vocab, args.eval_analogy, device=device)
            # skip counts are part of the verdict: a probe set full of
            # OOV/degenerate rows must not read as a clean 0-question pass
            print(
                f"analogy accuracy: {r.accuracy:.4f} ({r.correct}/{r.total}"
                f", {r.skipped_oov} oov-skipped, {r.skipped_degenerate} "
                f"degenerate-skipped)"
            )
    hub.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
