"""A later PR adds a configuration, a traffic mix, a cell and a per-layer
metric as new files and new entries only: the tiny copy of conftest.py
does, and its cells run with nothing of the harness edited."""

from __future__ import annotations

import hashlib

from conftest import NEW_METRIC, REPO, TINY
from gpubench.run import run_cell


def digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_the_copy_only_adds_files(tiny):
    _, root = tiny
    for f in (REPO / "gpubench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            g = root / f.relative_to(REPO)
            assert g.exists() and digest(g) == digest(f), f
    added = {p.name for p in (root / "gpubench" / "configs").iterdir()} - {
        p.name for p in (REPO / "gpubench" / "configs").iterdir()}
    assert added == {f"{c.split('.')[0]}.json" for c in TINY}


def test_the_new_cells_and_metric_are_found_by_name(tiny):
    man, _ = tiny
    for cell in TINY:
        assert man.workload(cell)["name"] == cell
        assert man.traffic(man.workload(cell)["traffic"])["kind"] == "train"
        assert man.limits(cell)
    assert NEW_METRIC in {m["name"] for m in man.per_layer("tiny_ns.tiny_train")}
    assert NEW_METRIC not in {m["name"] for m in man.per_layer("tiny_hs.tiny_train")}


def test_the_new_metric_is_reported_by_a_traced_run(tiny):
    man, _ = tiny
    res, _ = run_cell(man, "tiny_ns.tiny_train", 5, 1.0, True, device="cpu")
    assert res["metrics"][NEW_METRIC]["unit"] == "words/step"
    assert res["metrics"][NEW_METRIC]["value"] > 0
