"""One process of the port's multi-process tests (tests/test_torch_multiproc.py).

Run as a script under the W2V_* contract: `python torch_mp_worker.py
SPEC.json`, W2V_COORDINATOR / W2V_NUM_PROCS / W2V_PROC_ID set. SPEC names a
mode and an output directory; the process joins the gloo group
(parallel/multihost.initialize_from_env), does the mode's work on the CPU
and writes `rank<p>.json` / `rank<p>.npz` there:

  agree  — global_agree_min/sum/max and global_heartbeat of per-rank
           values, the stop vote (make_stop_check, PeerAgreement), the
           metrics-row gather, and the cross-process make_sync /
           make_delta_sync over `tables(reps)` with reps/2 replicas each;
  train  — ShardedTrainer(dp) on this rank's shard of `shards()`; rank 0
           writes the exported tables;
  kill   — the same trainer under a sync deadline; rank 1 SIGKILLs itself
           at step `kill_at` (the peer_dead fault); rank 0 writes how it
           left;
  card_sync — the agree mode's syncs on the card (tests/test_torch_cuda.py).

Also the parent's side: `launch`, `shards`, `config` and
`RankFedTrainer`, the one-process ShardedTrainer fed the same global steps
(each rank's batches, rank order), which a fleet must equal bitwise.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from word2vec_tpu_torch import PackedCorpus, Vocab, Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.data.batcher import PAD, BatchIterator  # noqa: E402
from word2vec_tpu_torch.parallel import ShardedTrainer  # noqa: E402
from word2vec_tpu_torch.parallel import multihost  # noqa: E402

V, L, B = 50, 16, 4


def vocab() -> Vocab:
    counts = np.maximum((4000 / np.arange(1, V + 1)).astype(np.int64), 5)
    return Vocab([f"w{i}" for i in range(V)], counts)


def shards(procs: int = 2, rows: int = 24, seed: int = 5):
    """Each rank's corpus: `rows` sentences of exactly L tokens, so every
    batch carries B*L words on every rank and the alpha schedules agree."""
    v = vocab()
    p = v.counts / v.counts.sum()
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(procs):
        flat = rng.choice(V, size=rows * L, p=p).astype(np.int32)
        out.append(PackedCorpus.pack([flat[i:i + L] for i in range(0, flat.size, L)], L))
    return out


def config(**over) -> Word2VecConfig:
    kw = dict(model="sg", train_method="ns", negative=3, word_dim=16, window=3,
              min_count=1, subsample_threshold=0.0, iters=2, batch_rows=B,
              max_sentence_len=L, shared_negatives=8, seed=11, dp_sync_every=2,
              init_alpha=0.05, kernel="band", resident="off", chunk_steps=1)
    kw.update(over)
    return Word2VecConfig(**kw)


def tables(reps: int, seed: int = 0):
    """Drifted replicas of one base table (the sync tests' data)."""
    rng = np.random.default_rng(seed + reps)
    base = rng.normal(size=(40, 8)).astype(np.float32)
    drift = rng.normal(scale=1e-2, size=(reps, 40, 8)).astype(np.float32)
    drift[:, :3] *= 1e3
    return base, base[None] + drift


class RankFedTrainer(ShardedTrainer):
    """One process, the fleet's mesh, fed the fleet's global steps: each
    global step is rank 0's local_dp batches, then rank 1's, ... (the
    rank shards' own BatchIterators, seeded as each rank seeds its own)."""

    def __init__(self, cfg, vocab_, rank_shards, procs, **kw):
        self.rank_shards = rank_shards
        self.fleet = procs
        whole = PackedCorpus.pack(
            [s.flat[a:a + n] for s in rank_shards
             for a, n in zip(s.row_starts, s.row_lens)], cfg.max_sentence_len)
        super().__init__(cfg, vocab_, whole, **kw)

    def _rank_batchers(self):
        cfg = self.config
        return [BatchIterator(s, cfg.batch_rows, cfg.max_sentence_len,
                              seed=self.run_seed) for s in self.rank_shards]

    def _agreed_steps_per_epoch(self, batcher):
        per = self.dp // self.fleet
        return min(-(-b.steps_per_epoch() // per) for b in self._rank_batchers())

    def _global_batches(self, batcher, epoch, skip):
        per = self.dp // self.fleet
        limit = self._agreed_steps_per_epoch(batcher)
        its = [b.epoch(epoch, skip * per) for b in self._rank_batchers()]
        for _ in range(skip, limit):
            blocks, words = [], 0
            for it in its:
                for _ in range(per):
                    got = next(it, None)
                    if got is None:
                        blocks.append(np.full((self.config.batch_rows,
                                               self.config.max_sentence_len),
                                              PAD, np.int32))
                    else:
                        blocks.append(got[0])
                        words += got[1]
            yield np.concatenate(blocks, axis=0), words


def launch(tmp_path, spec, procs=2, timeout=25.0):
    """Run `procs` workers under the W2V_* contract (a file store under
    tmp_path), killing them all at the timeout. Returns (return codes,
    [rank json], [rank npz arrays], [rank output])."""
    import pathlib
    import subprocess

    tmp_path = pathlib.Path(tmp_path)
    out = tmp_path / "out"
    out.mkdir()
    spec = dict(spec, out=str(out), threads=1)
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(spec))
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.update({
        "W2V_COORDINATOR": f"file://{tmp_path}/store",
        "W2V_NUM_PROCS": str(procs),
        "OMP_NUM_THREADS": "1",
    })
    kids = []
    for p in range(procs):
        env["W2V_PROC_ID"] = str(p)
        kids.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(path)],
            env=dict(env), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for k in kids:
            o, _ = k.communicate(timeout=max(0.1, deadline - time.monotonic()))
            logs.append(o.decode(errors="replace"))
    finally:
        for k in kids:
            if k.poll() is None:
                k.kill()
                k.wait()
    res, arrs = [], []
    for p in range(procs):
        j = out / f"rank{p}.json"
        res.append(json.loads(j.read_text()) if j.exists() else None)
        n = out / f"rank{p}.npz"
        arrs.append(dict(np.load(n)) if n.exists() else None)
    return [k.returncode for k in kids], res, arrs, logs


def _params_npz(params):
    return {k: v.float().numpy() for k, v in params.items()}


def run_agree(spec, rank, procs):
    from word2vec_tpu_torch.resilience.shutdown import ShutdownHandler
    from word2vec_tpu_torch.resilience.watchdog import PeerAgreement

    from word2vec_tpu_torch.parallel import make_delta_sync, make_sync

    vals = [5, 9, 2, 7][rank]
    res = {
        "min": multihost.global_agree_min(vals),
        "sum": multihost.global_agree_sum(vals),
        "max": multihost.global_agree_max(vals),
        "heartbeat": multihost.global_heartbeat(
            [float(rank), float(rank == 1), 16.0, 10.0 + rank, 0.0, 0.0]).tolist(),
        "rows": multihost.gather_replica_rows(
            np.full((2, 1, 3), rank + 1, np.float32)).tolist(),
    }
    h = ShutdownHandler()
    h.requested = rank == 1
    check = h.make_stop_check(process_count=procs, agree_every=4)
    res["stop_check"] = [check(3), check(4)]
    pa = PeerAgreement(h, agree_every=4)
    res["peer_agreement"] = [pa.check(6), pa.check(8)]
    arrays = {}
    for reps in (2, 4):
        mesh = multihost.make_global_mesh(reps, 1, device="cpu")
        base, reps_t = tables(reps)
        for mode in ("mean", "delta"):
            mine = [{"t": torch.from_numpy(reps_t[mesh.replica_offset + j].copy())}
                    for j in range(mesh.local_replicas)]
            if mode == "mean":
                make_sync(mesh)(mine)
            else:
                make_delta_sync(mesh)(mine, {"t": torch.from_numpy(base.copy())})
            for j, m in enumerate(mine):
                arrays[f"{mode}{reps}_{mesh.replica_offset + j}"] = m["t"].numpy()
    res["topology"] = multihost.topology()
    res["stats"] = multihost.collective_stats()
    return res, arrays


def run_card_sync(spec, rank, procs):
    """The cross-process sync of `tables(reps)` on the card: both ranks on
    card 0 ("shared", gloo staged through host memory) or each on its own
    ("own", NCCL)."""
    from word2vec_tpu_torch.parallel import make_delta_sync, make_sync

    arrays = {}
    for reps in (2, 4):
        n = reps // procs
        devs = [torch.device("cuda", 0)] * n if spec["devices"] == "shared" else None
        mesh = multihost.make_global_mesh(reps, 1, devices=devs)
        base, reps_t = tables(reps)
        for mode in ("mean", "delta"):
            mine = [{"t": torch.from_numpy(reps_t[mesh.replica_offset + j].copy())
                     .to(mesh.devices[j])} for j in range(mesh.local_replicas)]
            if mode == "mean":
                make_sync(mesh)(mine)
            else:
                b = {"t": torch.from_numpy(base.copy()).to(mesh.devices[0])}
                make_delta_sync(mesh)(mine, b)
            for j, m in enumerate(mine):
                arrays[f"{mode}{reps}_{mesh.replica_offset + j}"] = m["t"].cpu().numpy()
    return {"topology": multihost.topology(),
            "stats": multihost.collective_stats()}, arrays


def run_train(spec, rank, procs):
    res, arrays = {}, {}
    for name, over in spec["arms"].items():
        dp = over.pop("dp")
        cfg = config(**over)
        tr = ShardedTrainer(cfg, vocab(), shards(procs)[rank], dp=dp, device="cpu")
        state, rep = tr.train(log_every=1)
        res[name] = {"loss": rep.loss_history, "steps": rep.steps,
                     "words": rep.total_words}
        if rank == 0:
            for k, v in _params_npz(tr.export_params(state)).items():
                arrays[f"{name}_{k}"] = v
    return res, arrays


def run_kill(spec, rank, procs):
    from word2vec_tpu_torch.resilience import watchdog
    from word2vec_tpu_torch.resilience.faults import FaultPlan

    watchdog.set_sync_deadline(spec["deadline"])
    cfg = config(iters=50)
    tr = ShardedTrainer(cfg, vocab(), shards(procs)[rank], dp=procs, device="cpu")
    if rank == 1:
        tr.fault_plan = FaultPlan.parse(f"peer_dead@{spec['kill_at']}")
    t0 = time.perf_counter()
    try:
        tr.train(log_every=0)
        out = {"left": "finished"}
    except Exception as e:  # noqa: BLE001 — what the survivor saw is the result
        out = {"left": type(e).__name__, "message": str(e)[:300],
               "is_peer_failure": watchdog.is_peer_failure(e),
               "cause": type(e.__cause__).__name__ if e.__cause__ else None}
    out["seconds"] = time.perf_counter() - t0
    out["step"] = getattr(tr.last_state, "step", None)
    return out, {}


def main() -> None:
    spec = json.load(open(sys.argv[1]))
    torch.set_num_threads(int(spec.get("threads", 1)))
    assert multihost.initialize_from_env()
    rank, procs = multihost.process_index(), multihost.process_count()
    run = {"agree": run_agree, "train": run_train, "kill": run_kill,
           "card_sync": run_card_sync}[spec["mode"]]
    res, arrays = run(spec, rank, procs)
    out = spec["out"]
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f, default=str)
    sys.stdout.flush()
    # no teardown: a survivor's group may hold a dead peer
    os._exit(0)


if __name__ == "__main__":
    main()
