"""Several processes on torch.distributed: the launch contract, the process
group, the global mesh and the host-side agreement.

Port of word2vec_tpu/parallel/multihost.py. The topology rule is the JAX
package's: the model (tensor) and seq (halo) axes carry traffic every
step, so a replica's tp and sp shards stay inside one process (the
lockstep sum of ops/shards.py); the data axis carries traffic only every
dp_sync_every steps (the replica sync, parallel/trainer.py), so it is the
only axis that spans processes. `hybrid_axes` factors dp into (procs) x
(dp / procs) and keeps sp and tp in the local factor.

Launch contract (the JAX package's names, so a launcher that starts the
JAX fleet starts this one unchanged), set on every process:

  W2V_COORDINATOR  host:port of process 0's rendezvous (e.g. 10.0.0.1:8476);
                   a value with a scheme (file:///shared/path) is handed to
                   init_process_group as it is
  W2V_NUM_PROCS    total process count
  W2V_PROC_ID      this process's rank in [0, num_procs)

Each process trains its own corpus shard (-train) on the cards it sees.
Process p's local_dp * sp * tp devices are, by default, the visible cards
from card (p * local_devices) mod count on, so two processes on a host
with two cards take one each, and two processes on a one-card host share
it (a card may repeat across processes, as it may inside one, A8a). The
assignment is in the mesh record (`topology()`).

Collectives. One gloo process group carries the host-side agreement (the
agree and heartbeat rows and the metrics rows are small CPU tensors). The
table collectives of the replica sync use NCCL when every process's home
card (the first device of its local mesh) is a distinct card, and gloo
otherwise, staged through page-locked host buffers (gloo's handling of
card tensors is not documented for all_gather, and NCCL refuses two ranks
on one card). The choice is made once, from a gloo all_gather of every
process's host name and home card UUID when the global mesh is built,
before the first table collective; `topology()` records it (the run
manifest and the mesh record carry it) and one line on stderr says it.

Every collective here is bounded (resilience/watchdog.bounded_call): with
a sync deadline installed a dead peer raises SyncTimeout instead of
hanging the fleet, and an error out of the distributed runtime is raised
as torch.distributed.DistBackendError, which is_peer_failure recognises.

Elastic fleets (resilience/elastic.py; CLI --elastic) re-form the group
in a new GENERATION after a shrink or a grow: the same processes exec'd
in place, each generation with its own store. The contract gains the JAX
package's names:

  W2V_ELASTIC_COORD   host:port of the elastic rendezvous (hosted by the
                      current rank 0's process; defaults to the gen-0
                      coordinator host at port + 1000); moves to the
                      lowest surviving rank's standby address when rank 0
                      dies and the survivors elect a new host
  W2V_ELASTIC_PEERS   comma list of per-rank standby rendezvous addresses
                      (entry r = where rank r would host the rendezvous if
                      elected; entry 0 == W2V_ELASTIC_COORD); defaults to
                      the elastic host at port + rank
  W2V_ELASTIC_GEN     the current generation (0 = the launch topology)
  W2V_ELASTIC_PORT0   the gen-0 coordinator port: generation g's store
                      listens on port0 + g, so a re-formed fleet never
                      joins a half-dead predecessor's store
  W2V_ELASTIC_TRIGGER what decided the current generation (failure |
                      policy | rejoin), recorded in the generation_start
                      mesh event

An elastic fleet's store does not live inside rank 0: rank 0 starts the
store shepherd (parallel/coordservice.py), a small process that hosts the
generation's TCPStore and outlives rank 0's death or exec, and every rank,
rank 0 included, joins it as a client (`initialize_from_env(elastic=True)`).
The shepherd stamps the store with its generation, and a rank that finds
another generation's stamp behind the address refuses to join it.

One process: `initialize_from_env` is a no-op without the contract,
`process_count()` is 1, `make_global_mesh` is make_mesh and every
agreement is the identity.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .mesh import Mesh, make_mesh

ENV_COORDINATOR = "W2V_COORDINATOR"
ENV_NUM_PROCS = "W2V_NUM_PROCS"
ENV_PROC_ID = "W2V_PROC_ID"
ENV_ELASTIC_COORD = "W2V_ELASTIC_COORD"
ENV_ELASTIC_PEERS = "W2V_ELASTIC_PEERS"
ENV_ELASTIC_GEN = "W2V_ELASTIC_GEN"
ENV_ELASTIC_PORT0 = "W2V_ELASTIC_PORT0"
ENV_ELASTIC_TRIGGER = "W2V_ELASTIC_TRIGGER"

#: how long init_process_group waits for every rank to arrive
INIT_TIMEOUT_S = 300.0
#: the store key the shepherd stamps with its generation
GEN_KEY = "w2v_elastic_gen"


def generation_env(coordinator: str, num_processes: int, process_id: int,
                   gen: int) -> dict:
    """The W2V_* environment a re-formed generation launches under: the
    one place the elastic exec spells the contract, so it can never drift
    from the names initialize_from_env reads."""
    return {
        ENV_COORDINATOR: coordinator,
        ENV_NUM_PROCS: str(int(num_processes)),
        ENV_PROC_ID: str(int(process_id)),
        ENV_ELASTIC_GEN: str(int(gen)),
    }

_initialized = False
#: the store shepherd (its Popen, or an adopted leash descriptor), held for
#: the life of this process: dropping it would close our end of the leash
#: pipe and start the shepherd's linger countdown mid-run (the exec or
#: death close is the intended one)
_coordservice = None
#: how this process joined its group: seconds waiting for the store and
#: in init_process_group, and the generation (init_stats())
_INIT_STATS: Dict = {}
#: the table-collective decision (topology()), made once
_topology: Optional[Dict] = None
_nccl_group = None
#: page-locked staging buffers of the gloo table gather, by layout
_staging: Dict[tuple, tuple] = {}
#: the table gather's time split (collective_stats())
_STATS = {"calls": 0, "bytes": 0, "d2h_ms": 0.0, "gather_ms": 0.0, "h2d_ms": 0.0}


@dataclasses.dataclass(frozen=True)
class DistConfig:
    coordinator: str
    num_processes: int
    process_id: int

    @classmethod
    def from_env(cls, env=os.environ) -> Optional["DistConfig"]:
        """None unless configured for > 1 process; a missing W2V_PROC_ID with
        the rest configured is a hard error (defaulting it to 0 would give
        two hosts rank 0 and hang the coordinator with no useful message)."""
        coord = env.get(ENV_COORDINATOR)
        if not coord:
            return None
        n = int(env.get(ENV_NUM_PROCS, "1"))
        if n <= 1:
            return None
        pid = env.get(ENV_PROC_ID)
        if pid is None:
            raise ValueError(
                f"{ENV_COORDINATOR}/{ENV_NUM_PROCS} are set but "
                f"{ENV_PROC_ID} is not; every host must export its rank"
            )
        return cls(coord, n, int(pid))

    @property
    def init_method(self) -> str:
        """The init_process_group address: tcp://<coordinator>, or the
        coordinator itself when it names a scheme (file://...)."""
        if "://" in self.coordinator:
            return self.coordinator
        return f"tcp://{self.coordinator}"


def _dist():
    import torch.distributed as dist

    return dist


def _start_shepherd(port, num_processes: int, gen: int):
    """The store shepherd (parallel/coordservice.py) of generation `gen`
    as a subprocess holding our stdin pipe as its liveness leash; it
    prints `ready` on its stdout once the store is bound."""
    import subprocess

    global _coordservice
    _coordservice = subprocess.Popen(
        [sys.executable, "-m", "word2vec_tpu_torch.parallel.coordservice",
         "--port", str(port), "--procs", str(num_processes), "--gen", str(gen)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
    )  # held for the life of this process: a GC'd Popen closes the leash
    return _coordservice


def _await_ready(ready_fd: int, port) -> None:
    line = os.read(ready_fd, 4096).decode(errors="replace")
    if "ready" not in line:
        raise RuntimeError(
            f"store shepherd failed to start on port {port} (got {line!r})"
        )


#: the shepherd an old image started for this process's generation before
#: it exec'd into it: "port:gen:leash_fd:ready_fd" (prestart_shepherd)
ENV_SHEPHERD = "W2V_ELASTIC_SHEPHERD"


def prestart_shepherd(coordinator: str, num_processes: int, gen: int,
                      env: Dict[str, str]) -> None:
    """Start generation `gen`'s store shepherd from the image about to
    exec into that generation's rank 0, so the shepherd's own start-up
    (an interpreter and torch) runs while the new image starts. Its leash
    and its ready line ride two inheritable pipe ends through the exec,
    named in env[ENV_SHEPHERD]; _join_elastic adopts them."""
    _, _, port = coordinator.rpartition(":")
    proc = _start_shepherd(port, num_processes, gen)
    leash, ready = proc.stdin.fileno(), proc.stdout.fileno()
    os.set_inheritable(leash, True)
    os.set_inheritable(ready, True)
    env[ENV_SHEPHERD] = f"{port}:{gen}:{leash}:{ready}"


def _adopt_shepherd(port: int, gen: int, env=os.environ) -> bool:
    """The shepherd the old image started for this generation, when env
    names one for this port and generation: wait for its ready line and
    hold its leash for the life of this process."""
    parts = env.get(ENV_SHEPHERD, "").split(":")
    if len(parts) != 4 or parts[:2] != [str(port), str(gen)]:
        return False
    leash, ready = int(parts[2]), int(parts[3])
    _await_ready(ready, port)
    global _coordservice
    _coordservice = leash  # never closed: the exec or death closes it
    return True


def _join_elastic(cfg: DistConfig, gen: int) -> None:
    """init_process_group for an ELASTIC fleet: the store lives in the
    shepherd, which rank 0 starts, and every rank joins it as a client.

    Why: a store hosted inside rank 0 dies with it, so a survivor that
    touches the store after rank 0's death (a new group, a late joiner)
    meets a dead endpoint, and rank 0's exec into the next generation
    would pull the store from under members still using it. With the store
    out of process, rank 0's loss breaks only the gloo pairs, which the
    bounded collectives turn into SyncTimeout (the detection path). The
    store's generation stamp is checked: a rank never joins a store of
    another generation that happens to listen on the port."""
    dist = _dist()
    host, _, port = cfg.coordinator.rpartition(":")
    t0 = time.monotonic()
    if cfg.process_id == 0 and _coordservice is None \
            and not _adopt_shepherd(int(port), gen):
        proc = _start_shepherd(port, cfg.num_processes, gen)
        try:
            _await_ready(proc.stdout.fileno(), port)
        except RuntimeError:
            proc.kill()
            proc.wait()
            raise
    t1 = time.monotonic()
    store = dist.TCPStore(
        host, int(port), cfg.num_processes, False,
        datetime.timedelta(seconds=INIT_TIMEOUT_S),
    )
    stamp = store.get(GEN_KEY).decode()
    if stamp != str(gen):
        raise RuntimeError(
            f"the store at {cfg.coordinator} belongs to generation {stamp}, "
            f"not {gen}: refusing to join another generation's fleet"
        )
    t2 = time.monotonic()
    dist.init_process_group(
        "gloo", store=store, world_size=cfg.num_processes,
        rank=cfg.process_id,
        timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
    )
    _INIT_STATS.update(
        shepherd_s=t1 - t0, store_wait_s=t2 - t1,
        group_init_s=time.monotonic() - t2,
    )


def initialize_from_env(env=os.environ, elastic: bool = False) -> bool:
    """Join the process group of the W2V_* contract (gloo; the table
    backend is chosen later, by make_global_mesh).

    Run it before the first card use on every process. Returns True when
    several processes are active (now or from an earlier call), False for
    one process (no contract: a no-op). Idempotent. With `elastic` (an
    elastic fleet, W2V_COORDINATOR a host:port), the generation's store is
    hosted by the shepherd rank 0 starts (_join_elastic); otherwise rank
    0 hosts it in process (init_method tcp://, or the coordinator's own
    scheme such as file://)."""
    global _initialized
    if _initialized:
        return True
    cfg = DistConfig.from_env(env)
    if cfg is None:
        return False
    dist = _dist()
    gen = int(env.get(ENV_ELASTIC_GEN, "0") or 0)
    _INIT_STATS.clear()
    _INIT_STATS["gen"] = gen
    if not dist.is_initialized():
        if elastic and "://" not in cfg.coordinator:
            _join_elastic(cfg, gen)
        else:
            t0 = time.monotonic()
            dist.init_process_group(
                "gloo", init_method=cfg.init_method,
                world_size=cfg.num_processes, rank=cfg.process_id,
                timeout=datetime.timedelta(seconds=INIT_TIMEOUT_S),
            )
            _INIT_STATS["group_init_s"] = time.monotonic() - t0
    _initialized = True
    return True


def init_stats() -> Dict:
    """How this process joined its group: the generation, and the seconds
    spent starting the shepherd, waiting for the store and in
    init_process_group (empty before initialize_from_env)."""
    return dict(_INIT_STATS)


def process_count() -> int:
    """The processes of the group: 1 without one."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    """This process's rank: 0 without a group."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def hybrid_axes(
    dp: int, sp: int, tp: int, num_slices: int
) -> tuple[tuple[int, int, int], tuple[int, int, int]]:
    """Factor the (data, seq, model) mesh into DCN x ICI shapes.

    Only the data axis may span slices (it syncs every dp_sync_every steps;
    seq/model traffic is per-step and must stay on ICI). Returns
    (dcn_shape, ici_shape), each (data, seq, model)-ordered, with
    dcn = (num_slices, 1, 1) and ici = (dp/num_slices, sp, tp). Here a
    slice is a process: ici is one process's local grid.
    """
    if num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if dp % num_slices != 0:
        raise ValueError(
            f"data-parallel width {dp} must be divisible by the slice count "
            f"{num_slices}: the data axis is the only one allowed to span "
            f"DCN, so each slice carries dp/num_slices replicas"
        )
    return (num_slices, 1, 1), (dp // num_slices, sp, tp)


def local_devices(
    n: int, process: int, device: DeviceLike = None
) -> List[torch.device]:
    """Process `process`'s n devices: on the CPU [cpu] * n; on the card
    the visible cards from card (process * n) mod count on (consecutive,
    mod count), so processes on one host spread over its cards and share
    them when there are fewer cards than processes. One process needs n
    distinct cards, as make_mesh does."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"a process's mesh part needs {n} devices, have {count}")
    start = process * n
    return [torch.device("cuda", (start + i) % count) for i in range(n)]


def make_global_mesh(
    dp: int,
    tp: int = 1,
    sp: int = 1,
    devices: Optional[Sequence[DeviceLike]] = None,
    device: DeviceLike = None,
) -> Mesh:
    """A (data, seq, model) mesh over the processes of the group.

    One process: make_mesh. Several: this process's part of the
    process-ordered global grid, data-major, so each process's local
    replicas are contiguous on the data axis (process p holds data
    coordinates [p * dp/procs, (p + 1) * dp/procs)). dp*sp*tp must cover
    the processes in whole replicas: a replica's tp and sp shards never
    span processes (hybrid_axes). `devices` are this process's own
    (default: local_devices). Decides the table backend (topology())."""
    procs = process_count()
    if procs == 1:
        return make_mesh(dp, tp, sp, devices=devices, device=device)
    for name, n in (("dp", dp), ("tp", tp), ("sp", sp)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    try:
        _, (local_dp, _, _) = hybrid_axes(dp, sp, tp, procs)
    except ValueError as e:
        raise ValueError(
            f"mesh dp*sp*tp = {dp}*{sp}*{tp} must cover the global device "
            f"set of {procs} processes in whole replicas (the model and seq "
            f"axes stay inside a process, hybrid_axes): {e}"
        ) from None
    me = process_index()
    n = local_dp * sp * tp
    if devices is None:
        devices = local_devices(n, me, device)
    local = make_mesh(local_dp, tp, sp, devices=devices)
    mesh = dataclasses.replace(local, procs=procs, process=me)
    _decide_table_backend(mesh)
    return mesh


def _card_id(dev: torch.device) -> Optional[str]:
    if dev.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(dev)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else f"cuda:{dev.index}"


def _decide_table_backend(mesh: Mesh) -> Dict:
    """NCCL when every process's home card is a distinct card, else gloo
    staged through host memory; decided once, from the topology."""
    global _topology, _nccl_group
    if _topology is not None:
        return _topology
    dist = _dist()
    home = mesh.devices[0]
    mine = {
        "host": socket.gethostname(),
        "card": _card_id(home),
        "devices": [str(d) for d in mesh.devices],
    }
    rows: List[Optional[Dict]] = [None] * mesh.procs
    _collective(lambda: dist.all_gather_object(rows, mine),
                "mesh topology all_gather")
    homes = [(r["host"], r["card"]) for r in rows]
    nccl = all(r["card"] for r in rows) and len(set(homes)) == len(homes)
    if nccl:
        _nccl_group = dist.new_group(backend="nccl")
        reason = "every process's home card is a distinct card"
    elif not all(r["card"] for r in rows):
        reason = "a process trains on the CPU"
    else:
        reason = "processes share a card (NCCL refuses two ranks on one card)"
    _topology = {
        "world": mesh.procs,
        "process_index": mesh.process,
        "table_backend": "nccl" if nccl else "gloo",
        "staged": not nccl,
        "agree_backend": "gloo",
        "reason": reason,
        "ranks": rows,
    }
    print(
        f"multihost: process {mesh.process} of {mesh.procs}, table "
        f"collectives over {_topology['table_backend']}"
        + (" staged through host memory" if not nccl else "")
        + f" ({reason}); devices {mine['devices']}",
        file=sys.stderr, flush=True,
    )
    return _topology


def topology() -> Optional[Dict]:
    """The multi-process record: world, this process's index, the table
    and agreement backends and why, and every process's host, home card
    and devices. None in one process (or before the global mesh)."""
    return _topology


# ------------------------------------------------------------ collectives
def _collective(fn: Callable, what: str):
    """Run one collective under the sync deadline (bounded_call). A
    runtime error out of it is raised as DistBackendError: the
    collective's source vouches for it (is_peer_failure's type gate)."""
    from ..resilience.watchdog import bounded_call

    dist = _dist()

    def run():
        try:
            return fn()
        except RuntimeError as e:
            if isinstance(e, dist.DistError):
                raise
            raise dist.DistBackendError(f"{what}: {e}") from e

    return bounded_call(run, what=what)


def all_gather_array(x: np.ndarray, what: str = "allgather") -> np.ndarray:
    """Every process's array (one shape and dtype on all) -> [P, *shape],
    over the gloo group."""
    dist = _dist()
    t = torch.from_numpy(np.ascontiguousarray(x))
    outs = [torch.empty_like(t) for _ in range(process_count())]
    _collective(lambda: dist.all_gather(outs, t), what)
    return np.stack([o.numpy() for o in outs])


def _global_agree(value: int, reduce_fn) -> int:
    if process_count() == 1:
        return value
    # Deadline-bounded: a peer that died mid-run turns this allgather into
    # an infinite hang for every survivor; with a sync deadline
    # (--sync-deadline) the hang becomes a SyncTimeout the CLI converts
    # into a coordinated abort-to-requeue.
    return int(reduce_fn(all_gather_array(
        np.asarray([value], dtype=np.int64), "global_agree allgather"
    )))


def global_agree_min(value: int) -> int:
    """The minimum of a per-process integer across all processes.

    Used to agree on a common number of global steps per epoch: processes
    feed their own corpus shards, and unequal shard sizes would otherwise
    make one process run a collective step the others never join (a hang,
    not an error). Single-process: identity.
    """
    return _global_agree(value, np.min)


def global_agree_sum(value: int) -> int:
    """Sum of a per-process integer across all processes (e.g. total corpus
    tokens for the batch-size auto-tuner). Single-process: identity."""
    return _global_agree(value, np.sum)


def global_agree_max(value: int) -> int:
    """Maximum of a per-process integer across all processes: the any-of
    vote of the preemption protocol (resilience/shutdown.py), so one
    process's SIGTERM flag becomes everyone's stop verdict at the same
    step boundary. Single-process: identity."""
    return _global_agree(value, np.max)


def global_heartbeat(values) -> np.ndarray:
    """Allgather one small float row per process -> [P, len(values)].

    The liveness channel of resilience/watchdog.PeerAgreement: at the
    agreement cadence every process contributes (process id, stop flag,
    step, step-time p50 ms, elastic flag, policy action) in ONE collective.
    Deadline-bounded like _global_agree. Single-process: [[*values]]
    without touching the collective machinery.
    """
    row = np.asarray(values, dtype=np.float64)
    if process_count() == 1:
        return row[None, :]
    return all_gather_array(row, "peer-liveness heartbeat allgather")


def gather_replica_rows(vals: np.ndarray) -> np.ndarray:
    """A dispatch's metrics of this process's local replicas [names,
    local, S] -> every replica's [names, P * local, S] in global replica
    order (process-major), one small gather."""
    if process_count() == 1:
        return vals
    g = all_gather_array(vals, "sharded metrics gather")
    return np.concatenate(list(g), axis=1)


def _staging_buffers(n: int, shape, dtype, procs: int, pin: bool):
    key = (n, tuple(shape), dtype, procs, pin)
    bufs = _staging.get(key)
    if bufs is None:
        def buf():
            return torch.empty((n, *shape), dtype=dtype, pin_memory=pin)

        bufs = (buf(), [buf() for _ in range(procs)])
        _staging[key] = bufs
    return bufs


def all_gather_tables(tensors: List[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Every process's local replicas of one table shard, process order:
    [[process 0's n tensors], [process 1's], ...] (n the same on all).
    This process's entries are the given tensors themselves; the others
    are on tensors[0]'s device. Through NCCL when topology() chose it,
    else staged through page-locked host buffers and gathered over gloo
    (as bytes)."""
    dist = _dist()
    procs, me = process_count(), process_index()
    home = tensors[0].device
    n = len(tensors)
    shape, dtype = tensors[0].shape, tensors[0].dtype
    nbytes = n * tensors[0].numel() * tensors[0].element_size()
    on_card = home.type == "cuda"
    if _nccl_group is not None and on_card:
        t0 = time.perf_counter()
        with torch.cuda.device(home):
            send = torch.stack([t.to(home) for t in tensors])
            outs = [torch.empty_like(send) for _ in range(procs)]

            def gather():
                dist.all_gather(outs, send, group=_nccl_group)
                torch.cuda.synchronize(home)

            _collective(gather, "replica-sync all_gather")
        _note(nbytes, 0.0, (time.perf_counter() - t0) * 1e3, 0.0)
        return [tensors if q == me else list(outs[q]) for q in range(procs)]
    send, recv = _staging_buffers(n, shape, dtype, procs, on_card)
    t0 = time.perf_counter()
    for i, t in enumerate(tensors):
        send[i].copy_(t, non_blocking=True)
    if on_card:
        torch.cuda.synchronize(home)
    t1 = time.perf_counter()
    # bytes on the wire: gloo's all_gather copies them, whatever the dtype
    _collective(
        lambda: dist.all_gather([r.view(torch.uint8) for r in recv],
                                send.view(torch.uint8)),
        "replica-sync all_gather",
    )
    t2 = time.perf_counter()
    out: List[List[torch.Tensor]] = []
    for q in range(procs):
        if q == me:
            out.append(list(tensors))
        else:
            out.append([recv[q][i].to(home, non_blocking=True, copy=True)
                        for i in range(n)])
    if on_card:
        # the staging buffers are refilled by the next gather: the copies
        # out of them land first
        torch.cuda.synchronize(home)
    _note(nbytes, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
          (time.perf_counter() - t2) * 1e3)
    return out


def _note(nbytes: int, d2h: float, gather: float, h2d: float) -> None:
    _STATS["calls"] += 1
    _STATS["bytes"] += nbytes
    _STATS["d2h_ms"] += d2h
    _STATS["gather_ms"] += gather
    _STATS["h2d_ms"] += h2d


def collective_stats() -> Dict:
    """The table gathers since the last reset: calls, bytes sent by this
    process, and the host-clock ms of staging out (d2h), the gather and
    staging in (h2d)."""
    return dict(_STATS)


def reset_collective_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0 if k in ("calls", "bytes") else 0.0
