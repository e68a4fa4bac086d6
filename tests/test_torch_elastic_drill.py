"""The elastic layer in real processes on the CPU: three gloo ranks of the
port's CLI under the W2V_* contract with --multihost --elastic, each rank
in its own process group (killed with its store shepherds at the end),
under a hard timeout; the drill machinery is chip_smoke.py phase 16's
(ElasticLeg, el_reference), at a small width.

Tier 1 (the counterpart of tests/test_multiproc.py:148): rank 2 SIGKILLs
itself at a boundary (peer_dead), the survivors agree at the rendezvous,
snapshot the newest verified checkpoint and exec in place into generation
1 at world 2 (the store shepherd of the new rank 0 started before the
exec), and run to the end with exit 0; the continuation's vectors and
final checkpoint are BITWISE a fresh 2-process fleet resumed from the
snapshot; the manifest follows the fleet across the exec; no socket of
the old image reaches the new one.

Slow (`-m slow`, as the JAX drills are, tests/test_multiproc.py:21): the
grow leg (the victim started again and admitted at a sync boundary), the
rank-0 election and the policy eviction then re-admission, each with every
generation bitwise its fresh resume. Their logic is held by the
one-process tests of tests/test_torch_elastic.py.
"""

import json
import os
import signal
import sys

import numpy as np
import pytest

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
ROWS, LEN = 64, 32  # a shard: 4 batches of 16 rows -> 4 global steps an epoch
FLAGS = ["-size", "16", "-window", "2", "-negative", "3", "-min-count", "1",
         "--backend", "cpu", "--batch-rows", "16", "--max-sentence-len", str(LEN),
         "--chunk-steps", "4", "--dp-sync-every", "4", "-subsample", "0",
         "--quiet"]
PREFIX = [sys.executable, "-m", "word2vec_tpu_torch.cli"]
ENV = {"OMP_NUM_THREADS": "1", "PYTHONPATH": os.path.dirname(HERE)}


@pytest.fixture
def shards(tmp_path):
    from word2vec_tpu_torch.data.vocab import Vocab

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(60)]
    p = 1.0 / np.arange(1, 61)
    paths, toks = [], []
    for r in range(3):
        t = rng.choice(words, size=ROWS * LEN, p=p / p.sum())
        toks.extend(t)
        path = str(tmp_path / f"shard{r}.txt")
        with open(path, "w") as f:
            f.write(" ".join(t))
        paths.append(path)
    vocab = Vocab.from_counter(dict(zip(*np.unique(toks, return_counts=True))),
                               min_count=1)
    vocab.save(str(tmp_path / "vocab.txt"))
    return paths, ["-read-vocab", str(tmp_path / "vocab.txt")]


def _leg(tmp_path, shards, tag, mode, iters, extra, **kw):
    paths, vflags = shards
    flags = FLAGS + vflags + ["-iter", str(iters)]
    return cs.ElasticLeg(str(tmp_path), tag, PREFIX, flags, paths, mode, extra,
                         ENV, ckpt_every=4, deadline=5.0, **kw), flags


def _reference(tmp_path, leg, flags, g, members, stop_at=None):
    """A fresh fleet of generation g's shape resumed from its snapshot,
    started as soon as the snapshot exists (it runs beside the leg)."""
    snap = f"{leg.ck}.elastic_g{g}"
    leg.wait(lambda: os.path.isdir(snap), f"snapshot g{g}", 120.0,
             dead_ok=range(3))
    return cs.el_reference(
        str(tmp_path), f"ref{leg.tag}{g}", PREFIX, flags,
        [leg.shards[m] for m in members], snap, stop_at=stop_at, env=ENV,
        ckpt_every=4)


def _finish(kids, what):
    rcs, _ = cs.mp_finish(kids, what, timeout=120.0)
    for k in kids:
        cs.el_kill_group(k)
    return rcs


def _same_run(ck, vec, leg):
    return cs.npz_bitwise(ck, leg.ck) and \
        open(vec, "rb").read() == open(leg.out, "rb").read()


def test_shrink_through_exec_is_a_fresh_resume(tmp_path, shards):
    leg, flags = _leg(tmp_path, shards, "s", "shrink", 5,
                      {2: ["--faults", "peer_dead@8"]})
    try:
        leg.start()
        ref = _reference(tmp_path, leg, flags, 1, [0, 1])
        assert leg.procs[2].returncode == -signal.SIGKILL
        rcs = leg.finish(timeout=120.0, dead=(2,))
    finally:
        leg.stop()
    assert rcs[:2] == [0, 0], leg.tail(0) + leg.tail(1)
    man = leg.manifest()
    assert man["elastic_generation"] == 1 and man["shutdown"] == "clean"
    starts = leg.events("generation_start")
    assert [(e["gen"], e["world"], e["trigger"]) for e in starts] == [
        (0, 3, "launch"), (1, 2, "failure")]
    remesh = leg.events("remesh")
    assert len(remesh) == 1 and remesh[0]["kind"] == "shrink"
    assert remesh[0]["resume"] == leg.ck + ".elastic_g1"
    st = starts[1]["startup"]
    assert st["inherited_sockets"] == []  # the old group stayed behind
    assert st["shepherd_s"] < 1.0  # started by the old image, adopted
    first = leg.events("generation_first_boundary")
    assert [e["gen"] for e in first] == [1] and first[0]["nvcc_runs"] == []
    with open(os.path.join(leg.mdir, "metrics.jsonl")) as f:
        evs = [json.loads(x).get("event") for x in f]
    assert evs.count("remesh") == 1
    kids, ck, vec = ref
    assert _finish(kids, "the reference") == [0, 0]
    assert _same_run(ck, vec, leg)


@pytest.fixture(autouse=True)
def _no_process_left():
    yield
    for k in cs.EL_KIDS:
        cs.el_kill_group(k)
        if k.poll() is None:
            k.kill()
            k.wait()
    del cs.EL_KIDS[:]


def _slow_leg(tmp_path, shards, name, mode, iters, extra, drive, dead=()):
    """One of chip_smoke.py phase 16's legs at CPU width, with its checks:
    exits 0 (no 75/76), the manifest's generations, triggers and counters,
    and every generation bitwise its fresh resume."""
    leg, _ = _leg(tmp_path, shards, name, mode, iters, extra)
    try:
        drive(leg)
        rcs = leg.finish(timeout=240.0, dead=dead)
    finally:
        leg.stop()
    assert [r for i, r in enumerate(rcs) if i not in dead] == [0] * (3 - len(dead)), \
        leg.tail(0) + leg.tail(1) + leg.tail(2)
    worlds, triggers, fired = cs.el_check_manifest(leg, name)
    refs = cs.el_start_references(leg, name, PREFIX, ENV, ckpt_every=4)
    same = cs.el_check_references(leg, name, refs)
    assert all(same.values()) and sorted(same) == [g for g, _ in cs.EL_PLANS[name]]
    for e in leg.events("generation_start")[1:]:
        assert e["startup"]["inherited_sockets"] == []
    return leg, worlds, triggers, fired


@pytest.mark.slow
def test_grow_rejoiner_admitted_at_a_sync_boundary(tmp_path, shards):
    _, worlds, triggers, fired = _slow_leg(
        tmp_path, shards, "a", "shrink+grow", 40,
        {2: ["--faults", "peer_rejoin@8"]}, cs.el_leg_a)
    assert worlds == [3, 2, 3] and fired["peer_rejoin"] >= 1


@pytest.mark.slow
def test_rank0_dead_survivors_elect_and_continue(tmp_path, shards):
    leg, worlds, triggers, _ = _slow_leg(
        tmp_path, shards, "b", "shrink", 6,
        {0: ["--faults", "rank0_dead@8"]}, cs.el_leg_b, dead=(0,))
    assert worlds == [3, 2]
    start1 = leg.events("generation_start")[1]
    assert start1["rendezvous"] == f"127.0.0.1:{leg.eport + 1}"  # moved


@pytest.mark.slow
def test_policy_evicts_then_readmits_with_zero_failures(tmp_path, shards):
    extra = {p: ["--elastic-policy", cs.EL_POLICY, "--signal-window", "4"]
             + (["--faults", "stall@12:secs=1.0,stall@16:secs=1.0"] if p == 2 else [])
             for p in range(3)}
    leg, worlds, triggers, fired = _slow_leg(
        tmp_path, shards, "c", "shrink+grow", 40, extra, cs.el_leg_c)
    assert triggers == ["launch", "policy", "policy"]
    assert fired["policy_remesh"] >= 1
