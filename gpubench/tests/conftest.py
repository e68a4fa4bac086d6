"""Shared fixtures of the benchmark's tests.

    python -m pytest gpubench/tests -q

Tests that need the card carry the `cuda` marker and skip inside the
`cuda` fixture (never at import) where torch sees no CUDA device.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: tiny training cells, on the CPU: the cell's configuration with
#: small counts (widths of a CPU test, not the cell's), for the harness's
#: own tests
TINY = {
    "tiny_ns.tiny_train": ("sgns_d300", "train_text8", "sgns_d300.train_text8"),
    "tiny_hs.tiny_train": ("sghs_d300", "train_text8", "sghs_d300.train_text8"),
}
#: the per-layer metric the tiny copy adds as a new reader file
NEW_METRIC = "tiny.words_per_step"
#: limits of the tiny training cells, from readings at their size on the
#: CPU over eight seeds (program max / fp8 control min): sgns loss 2.1e-6 /
#: 8.4e-6, grad 3.4e-4 / 1.6e-3, change 1.8e-4 / 1.9e-3; hs loss 1.2e-6 /
#: 5.6e-6, grad 2.5e-4 / 1.0e-3, change 8.9e-5 / 2.9e-3 (the cells' own
#: limits, set at their widths, do not hold at d 16)
TINY_LIMITS = {
    "tiny_ns.tiny_train": {"loss_gap": 5e-6, "grad_gap": 8e-4, "change_gap": 8e-4, "alias_mismatch": 0},
    "tiny_hs.tiny_train": {"loss_gap": 3e-6, "grad_gap": 6e-4, "change_gap": 6e-4, "huffman_mismatch": 0},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips elsewhere)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


def make_tiny(root: Path) -> Path:
    """A copy of the checkout's benchmark under `root` with the TINY cells
    added as new files and entries only. Returns the BENCHMARK.json path."""
    shutil.copytree(REPO / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    g = root / "gpubench"
    for cell, (cfg_name, traffic, like) in TINY.items():
        config, traffic_new = cell.split(".")
        cfg = json.loads((g / "configs" / f"{cfg_name}.json").read_text())
        t = cfg["trainer"]
        t.update(word_dim=16, batch_rows=8, shared_negatives=16, iters=50)
        if t["train_method"] == "hs":
            t["hs_dense_top"] = 32
        (g / "configs" / f"{config}.json").write_text(json.dumps(cfg))
        tr = json.loads((g / "traffic" / f"{traffic}.json").read_text())
        tr.update(vocab=2000, vocab_total_words=2_000_000, tokens=120_000)
        (g / "traffic" / f"{traffic_new}.json").write_text(json.dumps(tr))
        (g / "limits" / f"{cell}.json").write_text(json.dumps({"limits": TINY_LIMITS[cell]}))
        bench["configs"].append({"name": config, "source": "https://arxiv.org/abs/1310.4546",
                                 "file": f"gpubench/configs/{config}.json", "reduced": [],
                                 "why": "a CPU test's cell"})
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic_new,
                                   "chips": 1, "why": "a CPU test's cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    # a per-layer metric of its own: one new reader file and one entry
    (g / "metrics" / f"{NEW_METRIC}.py").write_text(
        "def read(rec):\n"
        "    return rec['words'] / rec['steps'] if rec.get('steps') else None\n")
    bench["per_layer"].append({"name": NEW_METRIC, "unit": "words/step", "better": "higher",
                               "source": "program_counter", "layer": "trainer loop",
                               "moves": "train_words_per_s", "workloads": ["tiny_ns.tiny_train"]})
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench, indent=1))
    return path


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(Manifest, checkout root) of the tiny copy, made once a session."""
    from gpubench.manifest import Manifest

    root = tmp_path_factory.mktemp("checkout")
    path = make_tiny(root)
    return Manifest(path, here=root / "gpubench"), root
