"""One run of one cell:

    python3 -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Reads BENCHMARK.json there, builds the cell's
inputs and the program from the seed, warms every shape the cell uses
(set-up), measures for `--seconds` (the window), checks what the window's
path produced against the plain reference, and prints one JSON line last
on standard output: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics; its per-layer metrics with --trace 1),
`device`, with --trace 1 `breakdown`, and `checks`, each compared number
beside its limit (also the last lines on standard error).

Exits non-zero, printing no result, when there is no CUDA device or fewer
than the cell asks for, when the program or a file of the cell is
missing, or when a module of jax, jaxlib, flax or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .counts.trace import WINDOW, top
from .manifest import Manifest

#: the traced part of a window: its last seconds (Tracer)
TRACE_SECONDS = 10.0

#: top-level module names that may not be loaded (compared whole: the
#: port's word2vec_tpu_torch is not the JAX package word2vec_tpu)
FORBIDDEN = ("jax", "jaxlib", "flax", "word2vec_tpu")


def process_start() -> float:
    """The process's start on the perf_counter clock (/proc/self/stat's
    start time against the boot clock; this call's time where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


def forbidden_modules(mods=None) -> List[str]:
    mods = sys.modules if mods is None else mods
    return sorted(m for m in list(mods) if m.split(".", 1)[0] in FORBIDDEN)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so a second run there builds nothing. Python's bytecode
    too: where the installation ships no .pyc files and the environment
    forbids writing them, every process compiles torch's modules again
    (seconds of set-up, as unsteady as the host's CPU); call this before
    torch is imported."""
    b = root / "build"
    sys.pycache_prefix = str(b / "pycache")
    sys.dont_write_bytecode = False
    os.environ["W2V_KERNEL_BUILD_DIR"] = str(b / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(b / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(b / "triton")
    os.environ["USE_FLAX"] = "0"


def note(t_start: float, what: str) -> None:
    """One set-up mark on standard error: seconds since the process began."""
    print(f"gpubench: {time.perf_counter() - t_start:8.3f} s  {what}", file=sys.stderr, flush=True)


class Cell:
    """What a generator (gen/<kind>.py) gets: the cell's files, the run's
    arguments, and the device's hooks."""

    def __init__(self, name, entry, config, traffic, seed, seconds, trace, device, t_start):
        self.name, self.entry = name, entry
        self.config, self.traffic = config, traffic
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.t_start = device, t_start

    def note(self, what: str) -> None:
        note(self.t_start, what)

    @property
    def on_cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def warm_trace(self) -> None:
        """The profiler's first start in a process takes seconds: spend
        them in set-up."""
        import torch

        with self._profile():
            torch.ones(8, device=self.device).sum().item()

    def _profile(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def tracer(self) -> "Tracer":
        return Tracer(self._profile() if self.trace else None)

    def memory_peak(self) -> int:
        import torch

        if not self.on_cuda:
            return 0
        torch.cuda.synchronize()
        return int(torch.cuda.max_memory_allocated())

    def sync(self) -> None:
        import torch

        if self.on_cuda:
            torch.cuda.synchronize()

    def release(self) -> None:
        import torch

        gc.collect()
        if self.on_cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


class Tracer:
    """The profiler over the traced part of a window, marked by two host
    ranges (WINDOW.start, WINDOW.end) on the profiler's own clock; a no-op
    without --trace 1. A window longer than TRACE_SECONDS is traced over
    its last TRACE_SECONDS: reading a trace costs seconds per second
    traced, and a traced run has to end within its time limit."""

    def __init__(self, prof):
        self.prof, self.on = prof, False

    @staticmethod
    def _mark(name: str) -> None:
        import torch

        with torch.profiler.record_function(name):
            pass

    def begin(self) -> None:
        """Start the traced part (a no-op once started or without a profiler)."""
        if self.on or self.prof is None:
            return
        self.prof.start()
        self._mark(WINDOW + ".start")
        self.on = True

    def end(self):
        """Stop; the profiler, or None when nothing was traced."""
        if not self.on:
            return None
        self._mark(WINDOW + ".end")
        self.prof.stop()
        self.on = False
        return self.prof


def card() -> Dict:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        name, limit = (x.strip() for x in out[0].split(","))
        return {"smi_name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return {}


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> Tuple[Dict, List[str]]:
    """(the result line's object, the check lines) of one run."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    entry = manifest.workload(name)
    traffic = manifest.traffic(entry["traffic"])
    cell = Cell(name, entry, manifest.config(entry["config"]), traffic,
                seed, seconds, trace, device, t_start)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if trace:
        cell.warm_trace()
    gen = importlib.import_module(f"{__package__}.gen.{traffic['kind']}")
    out = gen.run(cell)
    metrics: Dict[str, Dict] = {}
    if not trace:
        for m in manifest.end_to_end(name):
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
    else:
        rec = {**out["trace"], "kind": traffic["kind"]}
        for m in manifest.per_layer(name):
            v = manifest.reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev: Dict = {"platform": "cpu", "kind": "cpu", "count": 1,
                 "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if cell.on_cuda:
        dev.update(platform="gpu", kind=torch.cuda.get_device_name(), count=int(entry["chips"]))
        dev.update(card())
    result: Dict = {"correct": False, "attempted": int(out["attempted"]),
                    "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace:
        rec = out["trace"]
        dev["busy_s"], dev["window_s"] = float(rec["busy_s"]), float(rec["window_s"])
        result["breakdown"] = {"device_ops": top(rec["ops"]), "idle_gaps": top(rec["gaps"])}
    limits = manifest.limits(name)
    checks = {k: {"value": float(v), "limit": limits.get(k)} for k, v in out["numbers"].items()}
    result["correct"] = bool(limits) and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    lines = [f"{k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m gpubench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    try:
        manifest = Manifest(root / "BENCHMARK.json")
        entry = manifest.workload(args.workload)
        cache_dirs(root)
        import torch

        note(t_start, "torch imported")
        if not torch.cuda.is_available():
            print("gpubench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(entry["chips"]):
            print(f"gpubench: the cell asks for {entry['chips']} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        torch.zeros(1, device="cuda")
        note(t_start, "CUDA context made")
        result, lines = run_cell(manifest, args.workload, args.seed, args.seconds,
                                 bool(args.trace), "cuda", t_start)
    except Exception:  # noqa: BLE001 — the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: forbidden modules loaded: {' '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
