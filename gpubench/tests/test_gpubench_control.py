"""The control and the faults fail the limits; the program passes them.

The control is the reference computed in float8 e4m3 (every contraction's
operands, one scale a tensor) put in the program's place; the fault is
half of every batch left out (the reference in the program's place). On
the CPU at the tiny cells of conftest.py; on the card at each cell's own
size, three seeds (python -m pytest gpubench/tests -m cuda, on a card)."""

from __future__ import annotations

import json

import pytest

from conftest import REPO
from gpubench.manifest import Manifest
from gpubench.readings import read

CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]


def fails(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.parametrize("cell", ["tiny_ns.tiny_train", "tiny_hs.tiny_train"])
def test_the_control_and_half_a_batch_fail_at_a_tiny_size(tiny, cell):
    man, _ = tiny
    limits = man.limits(cell)
    out = read(man, cell, [11, 12], ["program", "control", "half"], device="cpu")
    for seed in (11, 12):
        assert not fails(out["program"][seed], limits), out["program"][seed]
        assert fails(out["control"][seed], limits), out["control"][seed]
        assert fails(out["half"][seed], limits), out["half"][seed]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_half_a_batch_fail_at_the_cells_size(cuda, cell):
    man = Manifest(REPO / "BENCHMARK.json")
    limits = man.limits(cell)
    seeds = [3_000_000_901, 3_000_000_902, 3_000_000_903]
    out = read(man, cell, seeds, ["control", "half"], device=cuda)
    for seed in seeds:
        assert fails(out["control"][seed], limits), out["control"][seed]
        assert fails(out["half"][seed], limits), out["half"][seed]
