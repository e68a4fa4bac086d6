"""The readings a cell's limits are set from (PERF.md gives them).

    python3 -m gpubench.readings --workload <cell> --seeds 1,2,3 [--what program,control,half]

on a card, from the root of a checkout. For each seed, in one process:

  program  the numbers a run compares, for the program itself: the first
           steps through Trainer.train, then the reference;
  control  the same numbers with the reference computed in the nearest
           precision below the configuration's (every contraction's
           operands in float8 e4m3, one scale a tensor) put in the
           program's place;
  half     the reference with half of every batch left out, the loss its
           mean over the rest, in the program's place.

A state left unchanged reads 1 by construction (grad_gap, change_gap) and
is not run. Prints one JSON line: {what: {seed: numbers}}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict

from .gen import train as T
from .manifest import Manifest
from .run import Cell, cache_dirs


def read(manifest: Manifest, name: str, seeds, what, device: str = "cuda") -> Dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry = manifest.workload(name)
    traffic = manifest.traffic(entry["traffic"])
    config = manifest.config(entry["config"])
    out: Dict = {w: {} for w in what}
    for seed in seeds:
        cell = Cell(name, entry, config, traffic, seed, 0.0, False, device, time.perf_counter())
        s = T.Setup(cell, device)
        fs = T.first_steps(s) if "program" in what else None
        if fs is not None:
            fs.pop("state")
        s.trainer = None
        cell.release()
        n = int(traffic["first_steps"])
        ref = T.reference_steps(s, n)
        if "program" in what:
            out["program"][seed] = {**T.compare(s, fs, ref), **T.table_checks(s)}
        if "control" in what:
            out["control"][seed] = T.compare(s, T.reference_steps(s, n, quant="fp8"), ref)
        if "half" in what:
            out["half"][seed] = T.compare(s, T.reference_steps(s, n, half_batch=True), ref)
        del s
        cell.release()
        print(json.dumps({"seed": seed, **{w: out[w].get(seed) for w in what}}), file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="program,control,half")
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    what = [w for w in args.what.split(",") if w]
    seeds = [int(x) for x in args.seeds.split(",")]
    out = read(Manifest(root / "BENCHMARK.json"), args.workload, seeds, what)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
