"""The port's elastic layer (word2vec_tpu_torch/resilience/elastic.py, the
elastic names of parallel/multihost.py, parallel/coordservice.py and
ShardedTrainer.remesh) against the JAX package on the same inputs, in one
process (tests/test_elastic.py's cases):

  * rewrite_argv, default_peers, generation_env and from_env equal to
    JAX's;
  * pick_good_checkpoint / snapshot_checkpoint over checkpoints each
    package wrote, picked by each package: the same candidate, the same
    snapshot;
  * the ElasticServer decisions of both packages for the same scripted
    joins over real localhost TCP (shrink, transient wedge, late join, no
    verified checkpoint, grow, the slow grow leader, the dead waiter, the
    policy victim, the quorum-less abort, the shrink-mode reject, the
    election), both servers run side by side: equal decisions once the
    checkpoint dir is named alike; the hello re-announce bound;
  * the store shepherd: two gloo ranks joined through it, rank 0 (its
    parent) SIGKILLed, the survivor's bounded collective raises
    SyncTimeout within the deadline (no hang, no abort), the shepherd
    lingers; a rank refuses a store of another generation;
  * remesh on the CPU: bitwise a fresh trainer of the new shape resuming
    the same checkpoint (both layouts), a pure refactor of __init__, and
    within the repo's parity tolerance of JAX's remesh on the same tables
    and draws; the bounded metrics drain only with a deadline across
    processes.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from word2vec_tpu.parallel import multihost as jmh  # noqa: E402
from word2vec_tpu.resilience import elastic as jel  # noqa: E402
from word2vec_tpu_torch.parallel import multihost as tmh  # noqa: E402
from word2vec_tpu_torch.resilience import elastic as tel  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
torch.set_num_threads(1)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ argv and env
@pytest.mark.parametrize("argv,dp,resume", [
    (["-train", "shard2", "--dp", "6", "--faults", "peer_dead@6", "--elastic",
      "shrink", "--resume", "old_ck", "--inject-nan"], 4, "ck.elastic_g1"),
    (["-train", "s0"], 2, "snap"),
    (["--dp=6", "--faults=nan@3", "--resume=old"], 4, "new"),
    (["-train", "s1", "--faults", "stall@12:secs=0.5", "--dp", "3"], None, None),
])
def test_rewrite_argv_equal_to_jax(argv, dp, resume):
    got = tel.rewrite_argv(argv, dp=dp, resume=resume)
    assert got == jel.rewrite_argv(argv, dp=dp, resume=resume)
    assert "--faults" not in " ".join(got) and "--inject-nan" not in got


def test_default_peers_generation_env_and_names_equal_to_jax():
    for addr, world in (("10.0.0.1:9476", 3), ("127.0.0.1:20000", 5)):
        assert tel.default_peers(addr, world) == jel.default_peers(addr, world)
    for args in (("127.0.0.1:9001", 2, 1, 1), ("h:5", 4, 3, 7)):
        assert tmh.generation_env(*args) == jmh.generation_env(*args)
    for name in ("COORD", "PEERS", "GEN", "PORT0", "TRIGGER"):
        assert getattr(tmh, f"ENV_ELASTIC_{name}") == getattr(jmh, f"ENV_ELASTIC_{name}")


def test_from_env_equal_to_jax():
    env = {
        "W2V_COORDINATOR": "127.0.0.1:8477", "W2V_NUM_PROCS": "3",
        "W2V_PROC_ID": "1", "W2V_ELASTIC_GEN": "1",
        "W2V_ELASTIC_COORD": "127.0.0.1:9476",
        "W2V_ELASTIC_PEERS": "127.0.0.1:9476,127.0.0.1:9480,127.0.0.1:9481",
    }
    kw = dict(mode="shrink", argv=[], dp=6, ckpt_dir="ck", sync_deadline=5.0,
              max_reannounce=9)
    for e in (env, {k: v for k, v in env.items() if k != "W2V_ELASTIC_PEERS"},
              {k: v for k, v in env.items()
               if k not in ("W2V_ELASTIC_PEERS", "W2V_ELASTIC_COORD")}):
        j = jel.ElasticController.from_env(env=e, **kw)
        t = tel.ElasticController.from_env(env=e, **kw)
        assert (t.rank, t.world, t.gen, t.addr, t.peers, t.max_reannounce,
                t.join_window) == (j.rank, j.world, j.gen, j.addr, j.peers,
                                   j.max_reannounce, j.join_window)
        assert (t.store_host, t.store_port0) == (j.jax_host, j.jax_port0)
    assert tel.ElasticController.from_env(env={}, **kw) is None


def test_launch_prefix_keeps_the_way_the_process_started(monkeypatch):
    monkeypatch.setattr(sys, "orig_argv", ["py", "drill.py", "--x", "--", "-a", "b"])
    assert tel.launch_prefix(["-a", "b"]) == ["py", "drill.py", "--x", "--"]
    assert tel.launch_prefix(["-c"]) == [sys.executable, "-m", "word2vec_tpu_torch.cli"]


# --------------------------------------------------- checkpoint / snapshot
def _mini_checkpoint(pkg, path, step, fill):
    if pkg == "jax":
        from word2vec_tpu.config import Word2VecConfig
        from word2vec_tpu.io.checkpoint import save_checkpoint
        from word2vec_tpu.train import TrainState

        params = {"emb_in": np.full((4, 8), fill, np.float32),
                  "emb_out_ns": np.zeros((4, 8), np.float32)}
    else:
        from word2vec_tpu_torch.config import Word2VecConfig
        from word2vec_tpu_torch.io.checkpoint import save_checkpoint
        from word2vec_tpu_torch.train import TrainState

        params = {"emb_in": torch.full((4, 8), fill), "emb_out_ns": torch.zeros(4, 8)}
    save_checkpoint(path, TrainState(params=params, step=step, words_done=100,
                                     epoch=0), Word2VecConfig(min_count=1), keep=2)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_snapshot_walks_the_integrity_chain_like_jax(tmp_path, writer):
    got = {}
    for m in (jel, tel):
        d = tmp_path / f"{m.__name__.split('.')[0]}"
        d.mkdir()
        path = str(d / "ck")
        _mini_checkpoint(writer, path, 5, 1.0)
        _mini_checkpoint(writer, path, 10, 2.0)  # rotates the first to .old
        first = m.pick_good_checkpoint(path)
        with open(os.path.join(path, "state.npz"), "r+b") as f:
            f.truncate(16)  # tear the newest: the chain falls back to .old
        second = m.pick_good_checkpoint(path)
        snap = m.snapshot_checkpoint(path, gen=1)
        with np.load(os.path.join(snap, "state.npz")) as z:
            step = int(z["__step"])
        got[m] = (os.path.relpath(first, d), os.path.relpath(second, d),
                  os.path.relpath(snap, d), step,
                  m.snapshot_checkpoint(path, gen=1) == snap, os.path.isdir(path),
                  m.snapshot_checkpoint(str(d / "absent"), 1))
    assert got[tel] == got[jel] == ("ck", "ck.old", "ck.elastic_g1", 5, True, True,
                                    None)
    from word2vec_tpu_torch.io.checkpoint import verify_checkpoint

    verify_checkpoint(str(tmp_path / "word2vec_tpu_torch" / "ck.elastic_g1"))


# ------------------------------------------------------- rendezvous server
def _server(m, ck, world, mode="shrink+grow", gen=0, window=4.0):
    port = free_port()
    host = {"jax_host": "127.0.0.1", "jax_port0": 9000} if m is jel else \
        {"store_host": "127.0.0.1", "store_port0": 9000}
    srv = m.ElasticServer(f"127.0.0.1:{port}", world=world, ckpt_dir=ck,
                          mode=mode, gen=gen, join_window=window, **host)
    srv.start()
    assert srv.bound.wait(5.0) and not srv.bind_error
    return srv, f"127.0.0.1:{port}"


def _joins(m, addr, specs):
    """rendezvous() for each (rank, gen, kind, victim, delay) in a thread;
    the decisions by rank."""
    out = {}

    def run(rank, gen, kind, victim, delay):
        time.sleep(delay)
        try:
            out[rank] = m.rendezvous(addr, rank, gen, kind, 30.0, victim=victim)
        except Exception as e:  # noqa: BLE001 — surfaced by the test
            out[rank] = repr(e)

    ts = [threading.Thread(target=run, args=s, daemon=True) for s in specs]
    for t in ts:
        t.start()
    return ts, out


def _park(addr, rank, gen=0):
    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5.0)
    s.sendall(json.dumps({"op": "hello", "rank": rank, "gen": gen}).encode() + b"\n")
    buf = b""
    while not buf.endswith(b"\n"):
        buf += s.recv(4096)
    assert json.loads(buf)["status"] == "wait"
    return s


def _reply(sock):
    buf = b""
    sock.settimeout(10.0)
    while not buf.endswith(b"\n"):
        chunk = sock.recv(4096)
        if not chunk:
            break
        buf += chunk
    return json.loads(buf) if buf else None


def _norm(d, root):
    """A decision with the snapshot path relative to its tmp dir and the
    timing dropped."""
    if not isinstance(d, dict):
        return d
    d = {k: v for k, v in d.items() if k != "snapshot_wall_s"}
    if d.get("resume"):
        d["resume"] = os.path.relpath(d["resume"], root)
    if isinstance(d.get("reason"), str):
        d["reason"] = d["reason"].replace(root, "<root>")
    return d


def _scenario(name, m, root):
    """One scripted round against module m's server; the decisions (and
    what a parked waiter received), normalized."""
    ck = os.path.join(root, "ck")
    if name != "no_checkpoint":
        _mini_checkpoint("torch", ck, 7, 1.0)
    world, mode, window = {
        "shrink": (3, "shrink+grow", 3.0), "transient": (2, "shrink+grow", 10.0),
        "late": (3, "shrink+grow", 2.0), "no_checkpoint": (2, "shrink+grow", 2.0),
        "grow": (2, "shrink+grow", 5.0), "slow_leader": (2, "shrink+grow", 10.0),
        "dead_waiter": (2, "shrink+grow", 5.0), "policy": (3, "shrink+grow", 10.0),
        "quorum": (3, "shrink+grow", 1.0), "reject": (2, "shrink", 4.0),
    }[name]
    srv, addr = _server(m, ck, world, mode, window=window)
    if name == "slow_leader":
        srv.GRACE = 0.3
    res = {}
    try:
        if name in ("shrink", "late", "no_checkpoint", "transient"):
            ranks = (0, 1)
            ts, out = _joins(m, addr, [(r, 1, "shrink", None, 0.0) for r in ranks])
            for t in ts:
                t.join(30)
            res.update(out)
            if name == "late":
                ts, out = _joins(m, addr, [(2, 1, "shrink", None, 0.0)])
                ts[0].join(30)
                res["late"] = out[2]
        elif name in ("grow", "slow_leader", "dead_waiter"):
            assert m.startup_hello(addr, 1, 0, 5.0, 5.0) is None  # formation
            srv.mark_running()
            parked = [_park(addr, 2)]
            if name == "dead_waiter":
                parked.append(_park(addr, 3))
                parked[0].close()  # crashed while parked: FIN
                time.sleep(0.2)
            assert srv.grow_pending() == 1.0
            delay = 4 * srv.GRACE if name == "slow_leader" else 0.0
            ts, out = _joins(m, addr, [(1, 1, "grow", None, 0.0),
                                       (0, 1, "grow", None, delay)])
            for t in ts:
                t.join(30)
            res.update(out)
            res["admit"] = _reply(parked[-1])
            for p in parked:
                p.close()
            res["pending_after"] = srv.grow_pending()
        elif name == "policy":
            srv.mark_running()
            parked = _park(addr, 2)
            t0 = time.monotonic()
            ts, out = _joins(m, addr, [(r, 1, "policy_shrink", 2, 0.0) for r in (0, 1)])
            for t in ts:
                t.join(30)
            res.update(out)
            res["prompt"] = time.monotonic() - t0 < 5.0
            res["pending_after"] = srv.grow_pending()
            parked.close()
        elif name == "quorum":
            srv.mark_running()
            parked = _park(addr, 9)
            ts, out = _joins(m, addr, [(0, 1, "shrink", None, 0.0)])
            ts[0].join(30)
            res.update(out)
            res["view"] = (srv.gen, srv.world, srv.grow_pending())
            parked.close()
        elif name == "reject":
            srv.mark_running()
            try:
                m.startup_hello(addr, 1, 0, 5.0, 5.0)
            except m.ElasticError as e:
                res["reject"] = str(e)
        res["server"] = (srv.gen, srv.world)
    finally:
        srv.stop()
    return {k: _norm(v, root) for k, v in res.items()}


SCENARIOS = ["shrink", "transient", "late", "no_checkpoint", "grow",
             "slow_leader", "dead_waiter", "policy", "quorum", "reject"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_server_decisions_equal_to_jax(tmp_path, name):
    """tests/test_elastic.py:170-383 and :655-862: both packages' servers
    on the same scripted joins, run side by side."""
    got = {}

    def run(m):
        root = tmp_path / m.__name__.split(".")[0]
        root.mkdir()
        got[m] = _scenario(name, m, str(root))

    ts = [threading.Thread(target=run, args=(m,)) for m in (jel, tel)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(90)
    t, j = got[tel], got[jel]
    assert t == j
    if name == "shrink":
        assert t[0]["status"] == t[1]["status"] == "go"
        assert (t[0]["world"], t[0]["prev_world"], t[0]["rank"], t[1]["rank"]) == (2, 3, 0, 1)
        assert t[0]["coordinator"] == "127.0.0.1:9001"  # port0 + gen
        assert t[0]["resume"] == "ck.elastic_g1" and t["server"] == (1, 2)
    elif name == "transient":
        assert t[0]["world"] == 2 and t[1]["rank"] == 1
    elif name == "late":
        assert t["late"]["status"] == "late"
    elif name == "no_checkpoint":
        assert t[0]["status"] == "abort" and "integrity-verified" in t[0]["reason"]
    elif name in ("grow", "slow_leader", "dead_waiter"):
        assert t[0]["status"] == "go" and t[0]["world"] == 3
        assert t[0]["members"] == [0, 1]
        assert t["admit"]["status"] == "admit" and t["admit"]["rank"] == 2
        assert t["pending_after"] == 0.0
        assert t[0]["rejoined"] == ([3] if name == "dead_waiter" else [2])
    elif name == "policy":
        assert t[0]["world"] == 2 and t[0]["rejoined"] == [] and t["prompt"]
        assert t["pending_after"] == 1.0  # the evicted host stays parked
    elif name == "quorum":
        assert t[0]["status"] == "abort" and "quorum" in t[0]["reason"]
        assert t["view"] == (0, 3, 1.0)
    elif name == "reject":
        assert "rejoin is disabled" in t["reject"]


def _controller(m, rank, world, peers, ck):
    host = {"jax_host": "127.0.0.1", "jax_port0": 9000} if m is jel else \
        {"store_host": "127.0.0.1", "store_port0": 9000}
    return m.ElasticController(
        mode="shrink", argv=["-train", "x"], rank=rank, world=world, gen=0,
        dp=world * 2, elastic_addr=peers[0], ckpt_dir=ck, sync_deadline=2.0,
        join_window=6.0, peers=peers, **host)


def test_election_equal_to_jax(tmp_path):
    """Rank 0 and its rendezvous are dead: in both packages rank 1 binds
    its standby slot and hosts the round, rank 2 finds it there, and old
    rank 1 becomes rank 0 (tests/test_elastic.py:731)."""
    got = {}

    def run(m):
        root = tmp_path / m.__name__.split(".")[0]
        root.mkdir()
        ck = str(root / "ck")
        _mini_checkpoint("torch", ck, 7, 1.0)
        peers = [f"127.0.0.1:{free_port()}" for _ in range(3)]  # slot 0 dead
        c1, c2 = _controller(m, 1, 3, peers, ck), _controller(m, 2, 3, peers, ck)
        out = {}
        ts = [threading.Thread(target=lambda c=c, r=r: out.__setitem__(
            r, c._join_next_gen(1, "shrink")), daemon=True) for r, c in ((1, c1), (2, c2))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        try:
            got[m] = ({r: _norm(d, str(root)) for r, d in out.items()},
                      c1.elected == {"elected_rank": 1, "rendezvous": peers[1]},
                      c2.elected == {"elected_rank": 1, "rendezvous": peers[1]},
                      c1.addr == c2.addr == peers[1])
        finally:
            if c1.server is not None:
                c1.server.stop()

    ts = [threading.Thread(target=run, args=(m,)) for m in (jel, tel)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert got[tel] == got[jel]
    dec, e1, e2, moved = got[tel]
    assert dec[1]["status"] == dec[2]["status"] == "go" and e1 and e2 and moved
    assert (dec[1]["world"], dec[1]["members"], dec[1]["rank"], dec[2]["rank"]) == (
        2, [1, 2], 0, 1)


def test_election_without_peer_table_degrades(tmp_path):
    dead = f"127.0.0.1:{free_port()}"
    c = _controller(tel, 1, 3, [dead], str(tmp_path / "ck"))
    c.peers = [dead]
    with pytest.raises(tel.ElasticError, match="no standby peer table"):
        c._elect(1, "shrink")


def test_hello_reannounce_bound_and_phantom_probe_equal_to_jax():
    """A server that accepts and drops: the hello gives up after the
    re-announce bound with the same message; a probe of it is False
    (tests/test_elastic.py:313, :821, :862)."""
    port = free_port()
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(8)
    stop = threading.Event()

    def flap():
        while not stop.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                conn.settimeout(2.0)
                conn.recv(1024)
            except OSError:
                pass
            finally:
                conn.close()

    threading.Thread(target=flap, daemon=True).start()
    try:
        msgs = []
        for m in (jel, tel):
            t0 = time.monotonic()
            with pytest.raises(m.ElasticError) as ei:
                m.startup_hello(f"127.0.0.1:{port}", 2, 0, hello_timeout=10.0,
                                admit_timeout=20.0, max_reannounce=2)
            assert time.monotonic() - t0 < 10.0
            msgs.append(str(ei.value))
            assert m.probe_rendezvous(f"127.0.0.1:{port}", 1.0) is False
        assert msgs[0] == msgs[1] and "60s" in msgs[1] and "--rejoin-window" in msgs[1]
    finally:
        stop.set()
        srv.close()
    assert tel.probe_rendezvous(f"127.0.0.1:{free_port()}", 0.5) is False


# ------------------------------------------------------ the store shepherd
SHEPHERD_RANK = r"""
import os, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
from word2vec_tpu_torch.parallel import multihost as mh
from word2vec_tpu_torch.resilience import watchdog as wd
mh.initialize_from_env(elastic=True)
wd.set_sync_deadline(5.0)
rank = mh.process_index()
mh.all_gather_array(np.zeros(2), "warm")
print("joined", rank, os.getpid(), flush=True)
if rank == 0:
    print("shepherd", mh._coordservice.pid, flush=True)
    time.sleep(60)
time.sleep(1.0)  # rank 0 is SIGKILLed meanwhile
t0 = time.monotonic()
try:
    mh.all_gather_array(np.zeros(2), "after the kill")
    print("no error", flush=True)
except wd.SyncTimeout as e:
    print("SyncTimeout", round(time.monotonic() - t0, 3), e.what, flush=True)
os._exit(0)
"""


def test_shepherd_outlives_rank0_and_the_survivor_raises_synctimeout(tmp_path):
    script = tmp_path / "rank.py"
    script.write_text(SHEPHERD_RANK.format(repo=os.path.dirname(HERE)))
    port = free_port()
    env = dict(os.environ, W2V_COORDINATOR=f"127.0.0.1:{port}", W2V_NUM_PROCS="2",
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script)],
                              env=dict(env, W2V_PROC_ID=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True,
                              start_new_session=True) for r in range(2)]
    shepherd = None
    try:
        line = procs[0].stdout.readline()
        assert line.startswith("joined 0"), line
        shepherd = int(procs[0].stdout.readline().split()[1])
        os.kill(procs[0].pid, signal.SIGKILL)
        out, _ = procs[1].communicate(timeout=30)
        said = out.strip().splitlines()[-1].split()
        assert said[0] == "SyncTimeout" and float(said[1]) < 5.0, out
        assert procs[1].returncode == 0
        os.kill(shepherd, 0)  # alive: lingering after its leash closed
        # a client of another generation refuses this store
        from word2vec_tpu_torch.parallel.multihost import DistConfig, _join_elastic

        with pytest.raises(RuntimeError, match="belongs to generation 0, not 3"):
            _join_elastic(DistConfig(f"127.0.0.1:{port}", 2, 1), 3)
    finally:
        for p in procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        if shepherd is not None:
            try:
                os.kill(shepherd, signal.SIGKILL)
            except ProcessLookupError:
                pass


# ------------------------------------------------------ remesh (in process)
def tiny_setup(table_layout="split", iters=2, seed=3, pkg="torch"):
    """tests/test_elastic.py's _tiny_setup through either package."""
    import random

    random.seed(0)
    toks = []
    for _ in range(400):
        toks += ["x", random.choice("ab"), "y", "p", random.choice("cd"), "q"]
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "c.txt")
    with open(path, "w") as f:
        f.write(" ".join(toks))
    if pkg == "jax":
        from word2vec_tpu.config import Word2VecConfig
        from word2vec_tpu.data.batcher import PackedCorpus
        from word2vec_tpu.data.corpus import load_corpus
    else:
        from word2vec_tpu_torch.config import Word2VecConfig
        from word2vec_tpu_torch.data.batcher import PackedCorpus
        from word2vec_tpu_torch.data.corpus import load_corpus
    cfg = Word2VecConfig(
        iters=iters, window=2, min_count=1, word_dim=16, negative=3,
        batch_rows=8, max_sentence_len=32, chunk_steps=1, seed=seed,
        dp_sync_every=4, resident="off", table_layout=table_layout,
    )
    vocab, flat = load_corpus(path, min_count=1)
    return cfg, vocab, PackedCorpus.from_flat(flat, cfg.max_sentence_len)


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 2, 1), (4, 1, 1)])
@pytest.mark.filterwarnings("ignore::UserWarning")
def test_remesh_is_a_pure_refactor_of_init(shape):
    from word2vec_tpu_torch.parallel import ShardedTrainer

    dp, tp, sp = shape
    cfg, vocab, corpus = tiny_setup()
    tA = ShardedTrainer(cfg, vocab, corpus, dp=dp, tp=tp, sp=sp, device="cpu")
    tB = ShardedTrainer(cfg, vocab, corpus, dp=dp, tp=tp, sp=sp, device="cpu")
    tB.remesh(dp=dp, tp=tp, sp=sp)
    assert (tB.dp, tB.sp, tB.tp) == (tA.dp, tA.sp, tA.tp)
    sA, _ = tA.train(state=tA.init_state(), log_every=0)
    sB, _ = tB.train(state=tB.init_state(), log_every=0)
    assert _same(tA.export_params(sA), tB.export_params(sB))


@pytest.mark.parametrize("table_layout", ["split", "unified"])
@pytest.mark.filterwarnings("ignore::UserWarning")
def test_remesh_reshard_resume_is_a_fresh_trainer(table_layout, tmp_path):
    """Train at dp 4, checkpoint, remesh to (2, 2, 1) from the checkpoint
    and continue: bitwise a fresh trainer of that shape resuming the same
    checkpoint (tests/test_elastic.py:482); every runner and graph of the
    old mesh dropped, the replicas rebuilt."""
    import dataclasses

    from word2vec_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from word2vec_tpu_torch.parallel import ShardedTrainer, make_mesh
    from word2vec_tpu_torch.train import TrainState

    cfg, vocab, corpus = tiny_setup(table_layout=table_layout, iters=1)
    records = []
    t1 = ShardedTrainer(cfg, vocab, corpus, dp=4, device="cpu", log_fn=records.append)
    s1, _ = t1.train(state=t1.init_state(), log_every=0)
    ck = os.path.join(tmp_path, "ck")
    save_checkpoint(ck, TrainState(params=t1.export_params(s1), step=s1.step,
                                   words_done=s1.words_done, epoch=s1.epoch), cfg, vocab)
    old = t1._replicas
    cfg2 = dataclasses.replace(cfg, iters=2)
    t1.config = cfg2
    t1.remesh(mesh=make_mesh(2, 2, 1, device="cpu"), state=s1, checkpoint_dir=ck)
    assert (t1.dp, t1.tp, t1.sp) == (2, 2, 1) and not t1._runners
    assert t1._replicas is not old and len(t1._replicas) == 2
    assert all(len(r) == 2 for r in t1._replicas)  # tp 2 shard dicts
    s1, _ = t1.train(state=s1, log_every=0)
    t2 = ShardedTrainer(cfg2, vocab, corpus, dp=2, tp=2, device="cpu")
    s2, _, _ = load_checkpoint(ck)
    t2.import_params(s2.params, s2)
    s2, _ = t2.train(state=s2, log_every=0)
    assert s1.step == s2.step and _same(t1.export_params(s1), t2.export_params(s2))
    ev = [r for r in records if r.get("event") == "remesh"]
    assert ev and ev[-1]["mesh_size"] == 4 and ev[-1]["source"] == "checkpoint"
    assert "remesh" in [e["name"] for e in t1.flight.ring.events()]


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_remesh_checkpoint_dir_requires_state(tmp_path):
    from word2vec_tpu_torch.parallel import ShardedTrainer

    cfg, vocab, corpus = tiny_setup()
    t = ShardedTrainer(cfg, vocab, corpus, dp=2, device="cpu")
    with pytest.raises(ValueError, match="state"):
        t.remesh(dp=2, checkpoint_dir=os.path.join(tmp_path, "ck"))


@pytest.mark.parametrize("table_layout", ["split", "unified"])
@pytest.mark.filterwarnings("ignore::UserWarning")
def test_remesh_within_parity_of_jax(table_layout, monkeypatch):
    """The JAX trainer and the port's, on the same tables and the JAX
    trainer's draws (the port's draws_hook), trained one epoch at dp 2,
    remeshed live to dp 4 and trained on: tables within
    torch_parity.assert_params_close, equal steps and words."""
    import dataclasses

    import torch_parity as tp_
    from word2vec_tpu.parallel import ShardedTrainer as JSharded
    from word2vec_tpu.parallel import make_mesh as jmesh
    from word2vec_tpu_torch.models.params import params_from_numpy
    from word2vec_tpu_torch.ops.band_step import BandStep
    from word2vec_tpu_torch.parallel import ShardedTrainer
    from word2vec_tpu_torch.train import TrainState

    jcfg, jvocab, jcorpus = tiny_setup(table_layout=table_layout, iters=1, pkg="jax")
    cfg, vocab, corpus = tiny_setup(table_layout=table_layout, iters=1)
    jtr = JSharded(jcfg, jvocab, jcorpus, dp=2)
    ttr = ShardedTrainer(cfg, vocab, corpus, dp=2, device="cpu")
    monkeypatch.setattr(tp_, "V", len(vocab))
    monkeypatch.setattr(tp_, "B", cfg.batch_rows)
    monkeypatch.setattr(tp_, "L", cfg.max_sentence_len)
    js = jtr.init_state()
    host = {k: np.asarray(v[0]) for k, v in js.params.items()}
    ts = TrainState(params=None)
    ttr.import_params(params_from_numpy(host, ttr.config, "cpu"), ts)
    step = BandStep(ttr.config, ttr.tables)
    base = jax.random.key(ttr.run_seed ^ 0x5EED)
    ttr.draws_hook = lambda s, sub, r: tp_.jax_draws(
        step, jax.random.fold_in(jax.random.fold_in(base, s), r), jtr.tables)
    js, _ = jtr.train(state=js, log_every=0)
    ts, _ = ttr.train(state=ts, log_every=0)
    jtr.config = dataclasses.replace(jcfg, iters=2)
    ttr.config = dataclasses.replace(cfg, iters=2)
    jtr.remesh(mesh=jmesh(4, 1, 1), state=js)
    ttr.remesh(dp=4, state=ts)
    js, jrep = jtr.train(state=js, log_every=0)
    ts, trep = ttr.train(state=ts, log_every=0)
    assert ts.step == js.step and trep.total_words == jrep.total_words
    kw = dict(word_dim=16, table_layout=table_layout, dtype="float32")
    tp_.assert_params_close(ttr.export_params(ts), jtr.export_params(js), kw)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_bounded_drain_only_with_deadline(monkeypatch):
    """The metrics drain, the replica-sync wait and the agreement are the
    bounded channels (tests/test_elastic.py:577): without a deadline, or in
    one process, the drain is the plain fetch; with both, bounded_call."""
    from word2vec_tpu_torch.parallel import ShardedTrainer
    from word2vec_tpu_torch.resilience import watchdog as wd

    cfg, vocab, corpus = tiny_setup()
    t = ShardedTrainer(cfg, vocab, corpus, dp=2, device="cpu")

    def boom(*a, **k):
        raise AssertionError("bounded_call must not run without a deadline")

    monkeypatch.setattr(wd, "bounded_call", boom)
    assert t._device_get(lambda: 1.0) == 1.0
    t._bound_sync_wait()  # one process: no wait
    calls = []
    monkeypatch.setattr(wd, "bounded_call", lambda fn, **kw: calls.append(kw) or fn())
    t.procs = 2
    prev = wd.set_sync_deadline(5.0)
    try:
        assert t._device_get(lambda: 2.0) == 2.0
        t._bound_sync_wait()
        assert [c["what"] for c in calls] == ["sharded metrics fetch",
                                              "replica-sync collective"]
    finally:
        wd.set_sync_deadline(prev)
