"""Eval CLI — the `distance` / `compute-accuracy` tools of the original
word2vec toolkit, absent from the reference (SURVEY §3.5). A copy of
word2vec_tpu/eval/__main__.py for the PyTorch port, plus --backend: the
query engine runs on the card (gpu, the default; raises without one) or,
asked, on the CPU.

    python -m word2vec_tpu_torch.eval neighbors vec.txt france [-k 10]
    python -m word2vec_tpu_torch.eval analogy   vec.txt king man woman
    python -m word2vec_tpu_torch.eval ws353     vec.txt wordsim353.csv
    python -m word2vec_tpu_torch.eval analogies vec.txt questions-words.txt
    python -m word2vec_tpu_torch.eval convert   SimLex-999.txt out.csv --cols 0,1,3

Vector files: the trainer's text or binary formats (io/embeddings —
text is auto-detected; pass --binary/--binary-layout otherwise).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..data.vocab import Vocab
from ..io.embeddings import load_embeddings_binary, load_embeddings_text
from .analogy import evaluate_analogies
from .neighbors import analogy_query, nearest_neighbors
from .similarity import evaluate_pairs, load_word_pairs


def _load(args) -> tuple:
    if args.int8:
        from ..io.embeddings import load_embeddings_int8

        words, W = load_embeddings_int8(args.vectors)
    elif args.binary:
        words, W = load_embeddings_binary(args.vectors, layout=args.binary_layout)
    else:
        words, W = load_embeddings_text(args.vectors)
    vocab = Vocab(words, np.ones(len(words), dtype=np.int64))
    return vocab, W


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="word2vec_tpu_torch.eval")
    ap.add_argument("--binary", action="store_true",
                    help="vectors file is binary (default: text)")
    ap.add_argument("--binary-layout", choices=["reference", "google"],
                    default="reference")
    ap.add_argument("--int8", action="store_true",
                    help="vectors file is the int8 symmetric-quantized "
                    "container (io/embeddings; dequantized on load)")
    ap.add_argument("--backend", choices=["gpu", "cpu"], default="gpu",
                    help="where the query engine runs: the card (default; "
                    "raises without one) or the CPU")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("neighbors", help="top-k cosine neighbors (distance.c)")
    p.add_argument("vectors")
    p.add_argument("word")
    p.add_argument("-k", type=int, default=10)

    p = sub.add_parser("analogy", help="a:b :: c:? by 3CosAdd")
    p.add_argument("vectors")
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument("c")
    p.add_argument("-k", type=int, default=5)

    p = sub.add_parser("ws353", help="Spearman vs a word-pair gold file")
    p.add_argument("vectors")
    p.add_argument("pairs_file")

    p = sub.add_parser("analogies",
                       help="google questions-words accuracy (compute-accuracy)")
    p.add_argument("vectors")
    p.add_argument("questions_file")
    p.add_argument("--method", choices=["3cosadd", "3cosmul"],
                   default="3cosadd",
                   help="scoring objective: compute-accuracy's additive "
                   "3CosAdd (default) or the multiplicative 3CosMul "
                   "(Levy & Goldberg 2014; gensim most_similar_cosmul)")

    p = sub.add_parser(
        "convert",
        help="normalize a similarity dataset (WordSim-353 / SimLex-999 / "
        "MEN / any delimited word-pair file) into the canonical "
        "word1,word2,score CSV the --eval-ws353 gate reads",
    )
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--cols", default="0,1,2",
                   help="0-based columns of word1,word2,score (SimLex-999: "
                   "0,1,3)")
    p.add_argument("--delimiter", default=None,
                   help="explicit field delimiter (default: sniff , tab "
                   "then whitespace); a whitespace delimiter treats runs "
                   "of it as one separator, like the sniff")
    p.add_argument("--keep-case", action="store_true",
                   help="do not lowercase words")

    args = ap.parse_args(argv)

    if args.cmd == "convert":
        from .similarity import convert_pairs_file

        try:
            cols = tuple(int(c) for c in args.cols.split(","))
        except ValueError:
            print(f"error: --cols must be three integers, got {args.cols!r}",
                  file=sys.stderr)
            return 1
        if len(cols) != 3 or any(c < 0 for c in cols):
            print("error: --cols needs exactly three non-negative indices",
                  file=sys.stderr)
            return 1
        try:
            n = convert_pairs_file(
                args.src, args.dst, cols=cols, delimiter=args.delimiter,
                lower=not args.keep_case,
            )
        except (ValueError, OSError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
        print(json.dumps({"pairs_written": n, "dst": args.dst}))
        return 0

    vocab, W = _load(args)
    device = "cuda" if args.backend == "gpu" else "cpu"

    if args.cmd == "neighbors":
        try:
            for w, s in nearest_neighbors(
                W, vocab, args.word, k=args.k, device=device
            ):
                print(f"{w:<24s} {s:+.4f}")
        except KeyError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    elif args.cmd == "analogy":
        try:
            for w, s in analogy_query(
                W, vocab, args.a, args.b, args.c, k=args.k, device=device
            ):
                print(f"{w:<24s} {s:+.4f}")
        except KeyError as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    elif args.cmd == "ws353":
        res = evaluate_pairs(
            W, vocab, load_word_pairs(args.pairs_file), device=device
        )
        print(json.dumps({
            "spearman": res.spearman, "pearson": res.pearson,
            "pairs_used": res.pairs_used, "pairs_total": res.pairs_total,
        }))
    elif args.cmd == "analogies":
        res = evaluate_analogies(
            W, vocab, args.questions_file, method=args.method, device=device
        )
        print(json.dumps({
            "method": args.method,
            "accuracy": res.accuracy,
            "correct": res.correct,
            "total": res.total,
            # previously computed but silently dropped: a question file
            # full of OOV/degenerate rows read as a clean 0-question pass
            "skipped_oov": res.skipped_oov,
            "skipped_degenerate": res.skipped_degenerate,
            "mean_gold_rank": res.mean_gold_rank,
            "by_section": res.by_section,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
