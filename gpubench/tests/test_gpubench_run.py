"""Whole runs of the harness on the CPU, at the tiny cells of conftest.py:
a sound run, and the timed path broken underneath, which `correct` has to
catch; a run without a card, and one without the program, print nothing."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import REPO
from gpubench.run import cache_dirs, forbidden_modules, run_cell

TRAIN = ["tiny_ns.tiny_train", "tiny_hs.tiny_train"]


def run(tiny, cell, trace=False):
    man, _ = tiny
    torch.manual_seed(0)
    return run_cell(man, cell, 2**31 + 7, 1.0, trace, device="cpu")[0]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_sound_run_is_correct(tiny, cell):
    res = run(tiny, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0
    assert all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell", TRAIN)
def test_a_traced_run_reports_its_per_layer_metrics(tiny, cell):
    man, _ = tiny
    res = run(tiny, cell, trace=True)
    assert res["correct"]
    assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    names = {m["name"] for m in man.per_layer(cell)}
    assert set(res["metrics"]) <= names
    assert res["metrics"]["step_mfu"]["value"] > 0


def _step_classes():
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.ops.hs_step import HsStep

    return BandStep, HsStep


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny, cell, monkeypatch):
    BandStep, HsStep = _step_classes()

    def no_update(self, *a, **k):
        return torch.zeros(())
        yield  # a step body is a generator

    monkeypatch.setattr(BandStep, "_update", no_update)
    monkeypatch.setattr(HsStep, "_update", no_update)
    monkeypatch.setattr(HsStep, "_dense_slice_add", lambda self, *a: None)
    res = run(tiny, cell)
    assert not res["correct"]
    assert res["checks"]["grad_gap"]["value"] > res["checks"]["grad_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_of_the_batch_left_out_is_caught(tiny, cell, monkeypatch):
    for cls in _step_classes():
        orig = cls.apply

        def half(self, params, tokens, draws, alpha, orig=orig):
            tokens = tokens.clone()
            tokens[tokens.shape[0] // 2:] = -1
            return orig(self, params, tokens, draws, alpha)

        monkeypatch.setattr(cls, "apply", half)
    res = run(tiny, cell)
    assert not res["correct"]


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this sandbox has a card")
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "sgns_d300.train_text8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", "sgns_d300.train_text8",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout == ""


def test_the_caches_sit_at_fixed_paths_inside_the_checkout(tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "pycache_prefix", sys.pycache_prefix)
    monkeypatch.setattr(sys, "dont_write_bytecode", sys.dont_write_bytecode)
    keys = ("W2V_KERNEL_BUILD_DIR", "TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "USE_FLAX")
    for k in keys:
        monkeypatch.setenv(k, "")
    cache_dirs(tmp_path)
    build = str(tmp_path / "build")
    assert all(os.environ[k].startswith(build) for k in keys[:3])
    assert sys.pycache_prefix.startswith(build) and not sys.dont_write_bytecode
    assert os.environ["USE_FLAX"] == "0"


@pytest.mark.parametrize("mods,bad", [
    (["word2vec_tpu_torch", "word2vec_tpu_torch.ops", "numpy"], []),
    (["word2vec_tpu", "word2vec_tpu.ops"], ["word2vec_tpu", "word2vec_tpu.ops"]),
    (["jax", "jaxlib.xla_client", "flax", "jax_like"], ["flax", "jax", "jaxlib.xla_client"]),
])
def test_the_forbidden_modules_compare_top_level_names_whole(mods, bad):
    assert forbidden_modules(dict.fromkeys(mods)) == bad


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, json, gpubench.reference.sgns, gpubench.reference.hs, "
            "gpubench.reference.streams, gpubench.reference.tables; "
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('word2vec_tpu_torch', 'word2vec_tpu', 'jax', 'jaxlib', 'flax'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []
    for f in (REPO / "gpubench" / "reference").glob("*.py"):
        assert not imported(f) & {"word2vec_tpu_torch", "word2vec_tpu", "jax", "jaxlib", "flax"}


def imported(path):
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_of_the_harness_imports_jax():
    for f in (REPO / "gpubench").rglob("*.py"):
        assert not imported(f) & {"jax", "jaxlib", "flax", "word2vec_tpu"}, f
