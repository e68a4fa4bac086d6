"""Run manifests: what exactly did this run execute?

A copy of word2vec_tpu/obs/manifest.py for the PyTorch port, with the same
keys: `versions` records python, torch, CUDA and numpy (in place of jax,
jaxlib and libtpu) and `device` the card (torch.cuda) or the CPU.

Every telemetry-enabled run writes one `manifest.json` next to its metrics
so a JSONL record / bench artifact / prom scrape can always be traced back
to the REALIZED configuration — not the flags the user typed, but what the
planner resolved them to (band backend, plan source, probe count), on which
device, under which library versions, at which git sha: a number whose
provenance can't be reconstructed from its own directory is not evidence.

`manifest_dict` is pure assembly (`include_config=False` keeps a one-line
record short); `write_manifest`
adds the atomic tmp+replace file write the checkpoint writer uses.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

SCHEMA = 1


def git_sha() -> Optional[str]:
    """HEAD sha of the repo this package runs from; None outside a checkout
    (installed wheels, missing git binary) — the manifest must never make a
    run fail."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=root, capture_output=True, text=True, timeout=10,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    sha = (out.stdout or "").strip()
    return sha if out.returncode == 0 and sha else None


def runtime_versions() -> Dict[str, Optional[str]]:
    import numpy
    import torch

    return {
        "python": sys.version.split()[0],
        "torch": getattr(torch, "__version__", None),
        "cuda": torch.version.cuda,
        "numpy": numpy.__version__,
    }


def device_info(device=None) -> Dict:
    """Where the run actually executed (the --emit-device contract's data):
    the card the run trained on (`device`, default the current CUDA device
    when there is one), else the CPU. One process (multi-GPU is a later
    slice of the port)."""
    import torch

    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev is not None and dev.type == "cuda":
        return {
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(dev),
            "device_count": torch.cuda.device_count(),
            "process_count": 1,
            "process_index": 0,
        }
    return {
        "platform": "cpu",
        "device_kind": "cpu",
        "device_count": 1,
        "process_count": 1,
        "process_index": 0,
    }


def manifest_dict(
    config,
    vocab_size: Optional[int] = None,
    plan_resolution=None,
    include_config: bool = True,
    extra: Optional[Dict] = None,
    device=None,
) -> Dict:
    """Assemble a run manifest from the REALIZED config (pass the trainer's
    config, which carries any applied plan — not the pre-plan one)."""
    man: Dict = {
        "schema": SCHEMA,
        "created_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "argv": list(sys.argv),
        "vocab_size": vocab_size,
        # the realized step shapes, whether they came from flags or a plan
        "plan": config.current_plan().to_json(),
        "plan_source": "flags",
        "band_backend": config.band_backend,
        "kernel": config.resolved_kernel,
        "device": device_info(device),
        "versions": runtime_versions(),
        "git_sha": git_sha(),
    }
    if plan_resolution is not None:
        man["plan_source"] = plan_resolution.source
        man["plan_key"] = plan_resolution.key
        man["plan_predicted"] = plan_resolution.predicted
        man["plan_probes"] = len(plan_resolution.probes)
    if include_config:
        man["config"] = dataclasses.asdict(config)
    if extra:
        man.update(extra)
    return man


def write_manifest(path: str, config, **kwargs) -> Dict:
    """manifest_dict + atomic write; returns the written dict."""
    man = manifest_dict(config, **kwargs)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(man, f, indent=2, default=str)
        f.write("\n")
    os.replace(tmp, path)
    return man


def append_manifest_event(path: str, key: str, record: Dict) -> Optional[Dict]:
    """Append `record` to the manifest's `key` LIST field (creating it),
    atomically (the JAX package's elastic wiring keeps its `mesh_events`
    this way). Same never-fail-the-run contract as update_manifest."""
    try:
        with open(path) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    events = man.get(key)
    if not isinstance(events, list):
        events = []
    events.append(dict(record))
    return update_manifest(path, {key: events})


def update_manifest(path: str, fields: Dict) -> Optional[Dict]:
    """Merge `fields` into an existing manifest (atomic rewrite).

    The resilience wiring uses this to record how a run ENDED — `shutdown:
    clean|preempted|diverged`, recovery events — in the same file that
    already pins how it started, so one read answers both. Returns the
    updated dict, or None when the manifest is missing/unreadable: the
    update must never fail a run whose training result already exists."""
    try:
        with open(path) as f:
            man = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    man.update(fields)
    tmp = path + ".tmp"
    try:
        with open(tmp, "w") as f:
            json.dump(man, f, indent=2, default=str)
            f.write("\n")
        os.replace(tmp, path)
    except OSError:
        return None
    return man
