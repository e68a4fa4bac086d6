"""The port's multi-process layer (word2vec_tpu_torch/parallel/multihost.py
and the process axis of parallel/trainer.py) against the JAX package, in
one process (the JAX side on the 8 virtual CPU devices of conftest.py).

Pins, case by case on the same inputs (tests/test_multihost.py):
  * DistConfig.from_env: the same configs and the same errors;
    initialize_from_env a no-op without the contract;
  * hybrid_axes: the same shapes and the same messages;
  * make_global_mesh: the one-process fallback is make_mesh (JAX's shape);
    over two processes (the process count patched) the local part of the
    data-major grid, and the refusal of a replica whose shards would
    span processes, naming hybrid_axes' rule;
  * assemble_local_replica equals JAX's on a virtual (2, 2, 2) mesh, split
    and unified layouts;
  * the one-process global_agree_* and global_heartbeat are the identity,
    as in JAX;
  * the cross-process make_sync / make_delta_sync over an in-process
    stand-in for the gather (one thread a process, a barrier-based
    all_gather) are BITWISE JAX's make_sync / make_delta_sync at 2 and 4
    replicas, f32 and bf16 tables, tp 1 and 2: every process's replicas
    hold the JAX pmean of all of them.
"""

import threading

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from word2vec_tpu.parallel import make_mesh as j_mesh  # noqa: E402
from word2vec_tpu.parallel import make_sync as j_sync  # noqa: E402
from word2vec_tpu.parallel import multihost as jmh  # noqa: E402
from word2vec_tpu.parallel.trainer import (  # noqa: E402
    assemble_local_replica as j_assemble,
    make_delta_sync as j_delta,
    replicate_params as j_replicate,
)
from word2vec_tpu_torch.parallel import (  # noqa: E402
    Mesh, assemble_local_replica, make_delta_sync, make_mesh, make_sync,
    multihost as tmh, replicate_params,
)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

CPU = torch.device("cpu")


def _u32(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("error", str(e))


# ------------------------------------------------------- the launch contract
ENVS = [
    {"W2V_COORDINATOR": "10.0.0.1:8476", "W2V_NUM_PROCS": "4", "W2V_PROC_ID": "2"},
    {},
    {"W2V_COORDINATOR": "h:1", "W2V_NUM_PROCS": "1"},
    {"W2V_COORDINATOR": "h:1", "W2V_NUM_PROCS": "2"},  # rank missing
    {"W2V_NUM_PROCS": "2", "W2V_PROC_ID": "1"},  # no coordinator
    {"W2V_COORDINATOR": "h:1", "W2V_NUM_PROCS": "2", "W2V_PROC_ID": "0"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_dist_config_from_env_matches_jax(env):
    def fields(pkg):
        def run():
            c = pkg.DistConfig.from_env(env)
            return None if c is None else (c.coordinator, c.num_processes, c.process_id)
        return run

    assert _outcome(fields(tmh)) == _outcome(fields(jmh))
    assert tmh.ENV_COORDINATOR == jmh.ENV_COORDINATOR
    assert tmh.ENV_NUM_PROCS == jmh.ENV_NUM_PROCS
    assert tmh.ENV_PROC_ID == jmh.ENV_PROC_ID


def test_init_method_and_noop_without_env():
    assert tmh.initialize_from_env({}) is False
    assert jmh.initialize_from_env({}) is False
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    assert tmh.DistConfig("h:8476", 2, 1).init_method == "tcp://h:8476"
    assert tmh.DistConfig("file:///s", 2, 1).init_method == "file:///s"


HYBRID = [(8, 2, 4, 2), (4, 1, 1, 4), (2, 1, 2, 2), (3, 1, 1, 2), (4, 1, 1, 0),
          (1, 2, 1, 2)]


@pytest.mark.parametrize("dp,sp,tp,n", HYBRID)
def test_hybrid_axes_matches_jax(dp, sp, tp, n):
    assert _outcome(lambda: tmh.hybrid_axes(dp, sp, tp, n)) == _outcome(
        lambda: jmh.hybrid_axes(dp, sp, tp, n))


# ---------------------------------------------------------- the global mesh
@pytest.mark.parametrize("dp,tp,sp", [(2, 2, 2), (4, 1, 1), (2, 2, 1)])
def test_make_global_mesh_single_process_is_make_mesh(dp, tp, sp):
    m = tmh.make_global_mesh(dp, tp, sp=sp, device="cpu")
    assert m == make_mesh(dp, tp, sp, device="cpu")
    assert m.shape == dict(jmh.make_global_mesh(dp, tp, sp=sp).shape)
    assert (m.procs, m.process, m.local_replicas) == (1, 0, dp * sp)


def _two_processes(monkeypatch, me):
    monkeypatch.setattr(tmh, "process_count", lambda: 2)
    monkeypatch.setattr(tmh, "process_index", lambda: me)
    decided = []
    monkeypatch.setattr(tmh, "_decide_table_backend", decided.append)
    return decided


def test_make_global_mesh_over_two_processes(monkeypatch):
    decided = _two_processes(monkeypatch, me=1)
    m = tmh.make_global_mesh(4, 2, device="cpu")
    # process 1 holds data coordinates 2, 3: global replicas 2, 3
    assert m.shape == {"data": 4, "seq": 1, "model": 2}
    assert (m.procs, m.process, m.local_dp, m.local_replicas) == (2, 1, 2, 2)
    assert m.replicas == 4 and m.replica_offset == 2
    assert len(m.devices) == 4 and decided == [m]
    m2 = tmh.make_global_mesh(2, 1, sp=2, device="cpu")
    assert (m2.local_dp, m2.local_replicas, m2.replica_offset) == (1, 2, 2)


@pytest.mark.parametrize("dp,tp,sp", [(1, 1, 2), (3, 1, 1), (1, 2, 1)])
def test_make_global_mesh_refuses_shards_spanning_processes(monkeypatch, dp, tp, sp):
    _two_processes(monkeypatch, me=0)
    with pytest.raises(ValueError) as e:
        tmh.make_global_mesh(dp, tp, sp=sp, device="cpu")
    msg = str(e.value)
    assert f"mesh dp*sp*tp = {dp}*{sp}*{tp} must cover" in msg
    assert "hybrid_axes" in msg
    with pytest.raises(ValueError) as je:
        jmh.hybrid_axes(dp, sp, tp, 2)
    assert str(je.value) in msg  # JAX's rule, in JAX's words


def test_local_devices_spread_over_cards(monkeypatch):
    assert tmh.local_devices(3, 1, "cpu") == [CPU] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(tmh, "resolve_device", lambda d: torch.device("cuda", 0))
    cards = [[d.index for d in tmh.local_devices(1, p, "cuda")] for p in range(3)]
    assert cards == [[0], [1], [0]]
    assert [d.index for d in tmh.local_devices(2, 1, "cuda")] == [0, 1]
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        tmh.local_devices(3, 0, "cuda")


# ------------------------------------------------- assemble_local_replica
@pytest.mark.parametrize("shape", [(10, 8), (10, 2, 8)], ids=["split", "unified"])
def test_assemble_local_replica_matches_jax(shape):
    rng = np.random.default_rng(3)
    table = rng.normal(size=shape).astype(np.float32)
    want = j_assemble(j_replicate({"t": table}, j_mesh(dp=2, tp=2, sp=2))["t"])
    reps = replicate_params({"t": torch.from_numpy(table)},
                            make_mesh(2, 2, 2, device="cpu"))
    got = assemble_local_replica(reps)["t"]
    np.testing.assert_array_equal(_u32(got.numpy()), _u32(want))
    np.testing.assert_array_equal(got.numpy(), table)
    assert all(got.data_ptr() != s["t"].data_ptr() for s in reps[0])  # a copy


def test_global_agreement_is_the_identity_in_one_process():
    for fn in ("global_agree_min", "global_agree_sum", "global_agree_max"):
        assert getattr(tmh, fn)(7) == getattr(jmh, fn)(7) == 7
    row = [0.0, 1.0, 16.0, 12.5, 0.0, 0.0]
    np.testing.assert_array_equal(tmh.global_heartbeat(row),
                                  np.asarray(jmh.global_heartbeat(row)))
    vals = np.ones((3, 2, 4), np.float32)
    assert tmh.gather_replica_rows(vals) is vals


# ------------------------------------ the cross-process sync's ordering
class ThreadGather:
    """An in-process all_gather among `procs` threads, one a process: each
    deposits copies of its tensors, and every one reads all of them back
    in process order (the contract of multihost.all_gather_tables)."""

    def __init__(self, procs):
        self.slots = [None] * procs
        self.barrier = threading.Barrier(procs)

    def for_process(self, p):
        def gather(tensors):
            self.slots[p] = [t.clone() for t in tensors]
            self.barrier.wait()
            out = [list(s) for s in self.slots]
            self.barrier.wait()
            return [tensors if q == p else out[q] for q in range(len(out))]
        return gather


def _run_processes(procs, work):
    errs = []

    def run(p):
        try:
            work(p)
        except BaseException as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(p,)) for p in range(procs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    if errs:
        raise errs[0]


@pytest.mark.parametrize("reps", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("mode", ["mean", "delta"])
def test_cross_process_sync_is_jax_bitwise(reps, dtype, tp, mode):
    procs = 2
    local = reps // procs
    rng = np.random.default_rng(reps * 10 + tp)
    base = rng.normal(size=(40, 8)).astype(np.float32)
    drift = rng.normal(scale=1e-2, size=(reps, 40, 8)).astype(np.float32)
    drift[:, :3] *= 1e3  # a few rows far from the base: rounding matters
    tables = base[None] + drift
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jtables = jnp.asarray(tables).astype(jdt)
    jbase = jnp.asarray(base).astype(jdt)
    jm = j_mesh(dp=reps, tp=tp)
    if mode == "mean":
        want = j_sync(jm)({"t": jtables})["t"]
    else:
        want = j_delta(jm)({"t": jtables}, j_replicate({"t": jbase}, jm))["t"]
    want = np.asarray(want.astype(jnp.float32))
    one = make_mesh(1, tp=tp, device="cpu")
    host = [torch.from_numpy(np.array(jtables[r].astype(jnp.float32))).to(tdt)
            for r in range(reps)]
    tbase = torch.from_numpy(np.array(jbase.astype(jnp.float32))).to(tdt)
    gathers = ThreadGather(procs)
    got = {}

    def work(p):
        mesh = Mesh((CPU,) * (local * tp), tp=tp, procs=procs, process=p)
        mine = [replicate_params({"t": host[p * local + j].clone()}, one)[0]
                for j in range(local)]
        gather = gathers.for_process(p)
        if mode == "mean":
            out = make_sync(mesh, gather=gather)(mine)
        else:
            b = replicate_params({"t": tbase.clone()}, one)[0]
            out = make_delta_sync(mesh, gather=gather)(mine, b)
        got[p] = [assemble_local_replica([rep])["t"].float().numpy() for rep in out]

    _run_processes(procs, work)
    for p in range(procs):
        for j in range(local):
            np.testing.assert_array_equal(_u32(got[p][j]), _u32(want[p * local + j]))
