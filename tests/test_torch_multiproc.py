"""The port's multi-process layer in real processes: two gloo ranks on the
CPU under the W2V_* contract (tests/torch_mp_worker.py), each test under a
hard timeout that kills its children, the rendezvous a file store under
tmp_path (no port to collide on).

Pins:
  * two ranks' global_agree_min/sum/max and global_heartbeat give the JAX
    package's one-process results combined; the stop vote (make_stop_check
    and PeerAgreement) stops both ranks at the agreement boundary; the
    metrics-row gather is in process order; the table backend is gloo
    (recorded, with why); the sync over two processes (one replica each,
    and two each), mean and delta, is BITWISE the one-process sync on the
    same tables, and JAX's;
  * a two-process ShardedTrainer (dp 2 mean and delta, dp 4 mean) ends
    BITWISE equal to the one-process ShardedTrainer of the same mesh fed
    the same global steps (RankFedTrainer: each rank's shard, rank order,
    equal words a step on every rank), its loss history equal on every
    rank; rank 0's export equals the reference's;
  * a rank SIGKILLed at a step ends the survivor within its sync deadline,
    with a SyncTimeout raised on the peer error (the counterpart of
    tests/test_multiproc.py:57).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

import torch_mp_worker as W  # noqa: E402
from word2vec_tpu.parallel import make_mesh as j_mesh  # noqa: E402
from word2vec_tpu.parallel import make_sync as j_sync  # noqa: E402
from word2vec_tpu.parallel import multihost as jmh  # noqa: E402
from word2vec_tpu.parallel.trainer import make_delta_sync as j_delta  # noqa: E402
from word2vec_tpu.parallel.trainer import replicate_params as j_replicate  # noqa: E402
from word2vec_tpu_torch.parallel import make_delta_sync, make_mesh, make_sync  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))


_launch = W.launch


def _u32(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def test_two_ranks_agree_heartbeat_and_sync(tmp_path):
    rcs, res, arrs, logs = _launch(tmp_path, {"mode": "agree"})
    assert rcs == [0, 0], logs
    vals = [5, 9]
    rows = [[float(r), float(r == 1), 16.0, 10.0 + r, 0.0, 0.0] for r in range(2)]
    for r in range(2):
        got = res[r]
        assert got["min"] == min(jmh.global_agree_min(v) for v in vals)
        assert got["sum"] == sum(jmh.global_agree_sum(v) for v in vals)
        assert got["max"] == max(jmh.global_agree_max(v) for v in vals)
        np.testing.assert_array_equal(
            np.asarray(got["heartbeat"]),
            np.concatenate([np.asarray(jmh.global_heartbeat(x)) for x in rows]))
        # rank 1's flag stops both, at the boundary only
        assert got["stop_check"] == [False, True]
        assert got["peer_agreement"] == [False, True]
        np.testing.assert_array_equal(np.asarray(got["rows"])[:, :, 0],
                                      [[1, 2], [1, 2]])
        topo = got["topology"]
        assert topo["table_backend"] == "gloo" and topo["staged"] is True
        assert topo["world"] == 2 and topo["process_index"] == r
        assert "CPU" in topo["reason"]
        assert got["stats"]["calls"] > 0
    for reps in (2, 4):
        base, tabs = W.tables(reps)
        one = make_mesh(reps, device="cpu")
        jm = j_mesh(dp=reps, tp=1)
        for mode in ("mean", "delta"):
            mine = [{"t": torch.from_numpy(tabs[r].copy())} for r in range(reps)]
            if mode == "mean":
                make_sync(one)(mine)
                want = np.asarray(j_sync(jm)({"t": tabs})["t"])
            else:
                make_delta_sync(one)(mine, {"t": torch.from_numpy(base.copy())})
                want = np.asarray(j_delta(jm)(
                    {"t": tabs}, j_replicate({"t": base}, jm))["t"])
            local = reps // 2
            for g in range(reps):
                fleet = arrs[g // local][f"{mode}{reps}_{g}"]
                np.testing.assert_array_equal(_u32(fleet), _u32(mine[g]["t"].numpy()))
                np.testing.assert_array_equal(_u32(fleet), _u32(want[g]))


ARMS = {
    "mean2": {"dp": 2, "sync_mode": "mean"},
    "delta2": {"dp": 2, "sync_mode": "delta"},
    "mean4": {"dp": 4, "sync_mode": "mean", "chunk_steps": 0},
}


def test_two_process_trainer_is_the_one_process_run_bitwise(tmp_path):
    rcs, res, arrs, logs = _launch(
        tmp_path, {"mode": "train", "arms": {k: dict(v) for k, v in ARMS.items()}},
        timeout=40.0)
    assert rcs == [0, 0], logs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, over in ARMS.items():
            over = dict(over)
            dp = over.pop("dp")
            ref = W.RankFedTrainer(W.config(**over), W.vocab(), W.shards(2), 2,
                                   dp=dp, device="cpu")
            state, rep = ref.train(log_every=1)
            want = ref.export_params(state)
            for r in range(2):
                assert res[r][name]["steps"] == rep.steps
                assert res[r][name]["loss"] == rep.loss_history, name
                assert 2 * res[r][name]["words"] == rep.total_words
            for k, v in want.items():
                np.testing.assert_array_equal(
                    _u32(arrs[0][f"{name}_{k}"]), _u32(v.float().numpy()),
                    err_msg=f"{name} {k}")
    finally:
        torch.set_num_threads(threads)


def test_killed_peer_ends_the_survivor_within_the_deadline(tmp_path):
    deadline = 6.0
    rcs, res, _, logs = _launch(
        tmp_path, {"mode": "kill", "kill_at": 3, "deadline": deadline}, timeout=30.0)
    assert rcs[1] == -9, logs  # the peer_dead fault: SIGKILL, no cleanup
    assert rcs[0] == 0, logs
    got = res[0]
    assert got["left"] == "SyncTimeout" or got["is_peer_failure"], got
    assert got["seconds"] < deadline + 10.0, got
    assert got["step"] >= 3


# ------------------------------------------------------- the CLI drill (slow)
def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow  # two CLI processes against one on a planted corpus
def test_two_cli_processes_match_one_on_the_planted_corpus(tmp_path):
    """The counterpart of tests/test_multiproc.py:24: `--multihost --dp 2`
    over two CLI processes (the W2V_* contract on localhost, one -train
    shard each, one shared -read-vocab) against one process at --dp 2 on
    the whole corpus; both recover the planted topics and agree within
    the JAX drill's gates (benchmarks/multiproc.py's eval)."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "benchmarks"))
    from parity import eval_vectors

    from word2vec_tpu.data.vocab import Vocab as JVocab
    from word2vec_tpu.utils.synthetic import topic_corpus, topic_similarity_pairs

    tokens, topic_of = topic_corpus(n_tokens=200_000, seed=0)
    pairs = topic_similarity_pairs(topic_of, seed=1)
    chunks = [tokens[i:i + 1000] for i in range(0, len(tokens), 1000)]
    (tmp_path / "full").write_text(" ".join(tokens))
    for r in range(2):
        (tmp_path / f"shard{r}").write_text(
            " ".join(w for c in chunks[r::2] for w in c))
    JVocab.build(chunks, min_count=5).save(str(tmp_path / "vocab.txt"))

    def cmd(train, out):
        return [sys.executable, "-m", "word2vec_tpu_torch.cli",
                "-train", str(train), "-read-vocab", str(tmp_path / "vocab.txt"),
                "-output", str(out), "-model", "sg", "-train_method", "ns",
                "-negative", "5", "-size", "64", "-window", "5", "-iter", "3",
                "-min-count", "5", "-subsample", "1e-4", "--backend", "cpu",
                "--dp", "2", "--quiet"]

    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE), OMP_NUM_THREADS="2")
    env.update(W2V_COORDINATOR=f"127.0.0.1:{_free_port()}", W2V_NUM_PROCS="2")
    kids = [subprocess.Popen(
        cmd(tmp_path / f"shard{r}", tmp_path / "multi.txt") + ["--multihost"],
        env=dict(env, W2V_PROC_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    one = subprocess.run(cmd(tmp_path / "full", tmp_path / "single.txt"),
                         env={k: v for k, v in env.items()
                              if not k.startswith("W2V_")},
                         capture_output=True, text=True, timeout=900)
    try:
        logs = [k.communicate(timeout=900)[0].decode(errors="replace") for k in kids]
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
    assert [k.returncode for k in kids] == [0, 0], logs
    assert one.returncode == 0, one.stderr[-2000:]
    multi = eval_vectors(str(tmp_path / "multi.txt"), pairs, topic_of)
    single = eval_vectors(str(tmp_path / "single.txt"), pairs, topic_of)
    assert multi["neighbor_purity@10"] > 0.9, (multi, single)
    assert single["neighbor_purity@10"] > 0.9, (multi, single)
    assert multi["cos_margin"] > 0.3 and single["cos_margin"] > 0.3, (multi, single)
    assert abs(multi["spearman"] - single["spearman"]) < 0.05, (multi, single)
    assert abs(multi["cos_margin"] - single["cos_margin"]) < 0.05, (multi, single)
