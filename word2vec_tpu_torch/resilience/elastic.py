"""Elastic multi-host training: remesh on peer loss, sync-boundary rejoin.

Port of word2vec_tpu/resilience/elastic.py onto torch.distributed. Without
it a dead peer is a coordinated abort-to-requeue: every survivor's bounded
collective raises SyncTimeout, everyone checkpoints where safe and exits
75/76, and a scheduler restarts the WHOLE fleet. With it (CLI --elastic)
the survivors re-form the fleet at N-1 and keep training, and a restarted
host is admitted back at a sync boundary: no 75/76 on the elastic path, no
scheduler involvement.

The protocol, per failure leg (the JAX package's, wire format and decision
records included):

  SHRINK (a peer died)
    1. detect   — a deadline-bounded collective (the heartbeat allgather,
                  the replica-sync gather, the bounded metrics drain)
                  raises SyncTimeout on every survivor: at once when gloo
                  reports the closed pair ("Connection closed by peer"),
                  else within ~--sync-deadline.
    2. agree    — survivors cannot agree THROUGH the broken group (the
                  dead peer is a member of every collective), so
                  membership moves to the elastic rendezvous: a tiny TCP
                  barrier hosted by rank 0's process (`ElasticServer`,
                  address W2V_ELASTIC_COORD). Each survivor joins
                  generation g+1; the round closes when all current
                  members joined (a transient wedge: world unchanged), or
                  world-1 joined plus a short grace, or the join window
                  expires. Whoever did not join is declared dead. The
                  grace shortcut applies to SHRINK rounds only: in a grow
                  round the whole fleet is alive and the laggard is rank 0
                  itself, writing the grow-boundary checkpoint.
    3. snapshot — the server walks the shared checkpoint dir's integrity
                  chain (io/checkpoint: sha256 verify, .old fallback) and
                  copies the newest GOOD checkpoint to `<dir>.elastic_g<g>`,
                  the agreed, immutable resume point of the generation.
    4. remesh   — each survivor replaces its own process image in place
                  (`os.execve`, same pid, same scheduler allocation) with
                  the generation-g env: remapped rank, shrunken world, the
                  generation's own store on port0+g (hosted by the store
                  shepherd of the new rank 0, parallel/coordservice.py),
                  `--dp` rescaled, and `--resume <snapshot>`. A gloo group
                  has no member removal, and a process that held a CUDA
                  context, pinned buffers and gloo pairs starts clean only
                  as a new image (every descriptor is marked close-on-exec
                  first, so no socket of the old group reaches the new
                  one). Training continues bitwise the same as a fresh N-1
                  fleet resumed from the same snapshot, which is what
                  chip_smoke.py phase 16 and the CPU drill assert.
                  ShardedTrainer.remesh() is the in-process counterpart.

  GROW (a host came back)
    1. announce — the restarted host's CLI contacts the rendezvous BEFORE
                  joining the group and before any card use: the server
                  sees a hello that is not a member of the current
                  generation and parks it as a waiter (mode
                  "shrink+grow"; plain "shrink" rejects it), so a parked
                  host holds no context on the card while it waits.
    2. boundary — rank 0's PeerAgreement heartbeat row carries an elastic
                  column; when a waiter is pending the whole fleet reads it
                  from the SAME allgather and raises GrowRequested at the
                  same sync boundary.
    3. checkpoint + remesh — the fleet (still intact) writes a collective
                  checkpoint, joins generation g+1 (kind="grow", which
                  disables the world-1 grace shortcut), and the decision
                  includes the waiters, each probed for liveness first:
                  everyone (members on their join reply, waiters on their
                  parked hello connection) gets its new rank / world /
                  store address and execs into the grown generation,
                  resuming from the snapshot.

  ELECTION (rank 0, the rendezvous host, is the one that died)
    Every rank carries a per-rank STANDBY address table
    (W2V_ELASTIC_PEERS; entry r = where rank r would host the rendezvous).
    When the incumbent is unreachable, survivors elect the LOWEST
    SURVIVING RANK: each scans candidate slots in ascending rank order,
    waiting one stagger window per slot for that candidate to bind; the
    survivor whose own slot comes up first binds its standby address and
    hosts the round. The elected host becomes rank 0 of the next
    generation (members are ranked by old rank), so it also starts the
    next generation's store shepherd.

  POLICY SHRINK (no failure: resilience/policy.py decided to)
    An ElasticPolicy breach names a victim rank at a sync boundary
    (PolicyShrinkRequested rides the heartbeat like the grow channel).
    Everyone writes the collective checkpoint; the victim does NOT join the
    round: it execs into announce-only mode and parks as a rejoiner (mode
    shrink+grow) or exits 0, while the survivors join with
    kind="policy_shrink" carrying the victim's rank. A policy round closes
    as soon as all non-victim members joined, and parked waiters are NOT
    admitted into it; they stay parked for a later policy-gated grow.

Failure containment: if no integrity-verified checkpoint exists, the
election finds no live candidate, or the round ends without a quorum,
`remesh_and_exec` returns False and the caller falls back to the
abort-to-requeue contract (exit 75/76): elasticity degrades to it, never
past it. A member too wedged to join before the round closes gets a
"late" verdict and takes the same fallback.

Everything is observable: remesh events count w2v_remesh_total /
w2v_peer_rejoin_total, the mesh size is a gauge, every decision lands in
the manifest's `mesh_events` (carried across generations), and the
recovering process dumps its flight recorder as `flight_remesh_g<g>.json`
before the exec. The exec hands the next generation the clock reading it
left at (W2V_ELASTIC_EXEC_T, the system-wide monotonic clock) and the
moment the failure was seen (W2V_ELASTIC_DETECT_T), so the new generation
can name every part of the blackout.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple


class ElasticError(RuntimeError):
    """The elastic protocol could not proceed (rendezvous unreachable,
    degenerate decision, rejected announce); callers fall back to the
    abort-to-requeue semantics."""


class GrowRequested(RuntimeError):
    """Raised by PeerAgreement.check on EVERY fleet member at the same sync
    boundary when a restarted host is waiting for admission. The CLI
    catches it, writes a collective checkpoint, and re-forms the fleet at
    N+waiters through the rendezvous."""

    def __init__(self, step: int):
        self.step = int(step)
        super().__init__(
            f"elastic grow requested at sync boundary (step {step}): a "
            "restarted host announced itself and waits for admission"
        )


class PolicyShrinkRequested(RuntimeError):
    """Raised by PeerAgreement.check on EVERY fleet member at the same sync
    boundary when the elastic policy (resilience/policy.py) decided to
    shrink the fleet on purpose — zero failures involved. Carries the
    victim's CURRENT rank; the CLI writes a collective checkpoint, the
    victim leaves (announce-only exec or clean exit), and the survivors
    re-form at N-1 through a policy_shrink rendezvous round."""

    def __init__(self, step: int, victim: int):
        self.step = int(step)
        self.victim = int(victim)
        super().__init__(
            f"elastic policy shrink requested at sync boundary (step "
            f"{step}): evicting rank {victim}; survivors re-form at N-1"
        )


# --------------------------------------------------------------- wire format
# One JSON object per line, newline-terminated, over plain TCP. Small,
# debuggable with netcat, and entirely outside torch.distributed — the
# rendezvous must work precisely when the collectives don't.
_MAX_LINE = 1 << 16


def _send(sock: socket.socket, obj: Dict) -> None:
    sock.sendall(json.dumps(obj).encode() + b"\n")


def _recv(sock: socket.socket) -> Dict:
    buf = b""
    while not buf.endswith(b"\n"):
        chunk = sock.recv(4096)
        if not chunk:
            raise ElasticError("rendezvous connection closed")
        buf += chunk
        if len(buf) > _MAX_LINE:
            raise ElasticError("rendezvous message too large")
    return json.loads(buf.decode())


def _split_addr(addr: str) -> Tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host, int(port)


def default_peers(elastic_addr: str, world: int) -> List[str]:
    """The default per-rank standby-rendezvous table when W2V_ELASTIC_PEERS
    is not set: rank r's standby is the elastic host at port+r (entry 0 is
    the incumbent address itself). Real multi-host fleets should export the
    env with per-host addresses; the single-host drills work out of the
    box with this derivation."""
    host, port = _split_addr(elastic_addr)
    return [elastic_addr] + [f"{host}:{port + r}" for r in range(1, world)]


def _conn_alive(conn: socket.socket) -> bool:
    """Liveness probe for a parked connection. A waiter that crashed after
    announcing leaves a half-open socket — its OS sent FIN/RST, so a
    non-blocking recv returns EOF (b'') or raises; an alive waiter never
    sends after the hello, so the recv raises BlockingIOError. A stray
    readable byte still means the peer is alive (and is harmless to
    consume: the server only ever SENDS on a parked connection)."""
    try:
        conn.setblocking(False)
        chunk = conn.recv(1)
    except (BlockingIOError, InterruptedError):
        return True
    except OSError:
        return False
    finally:
        try:
            conn.setblocking(True)
        except OSError:
            pass
    return bool(chunk)


# ----------------------------------------------------------- checkpoint side
def pick_good_checkpoint(path: str) -> Optional[str]:
    """The newest checkpoint candidate (`path`, `.old`, ...) that passes
    the integrity chain (sha256 manifest verify); None when nothing does.
    Read-only — no quarantine: the rendezvous host must not mutate a
    directory other processes may be reading."""
    from ..io import checkpoint as ck

    for cand in ck.checkpoint_candidates(path):
        if not os.path.exists(os.path.join(cand, "state.npz")):
            continue
        try:
            ck.verify_checkpoint(cand)
        except ck.CheckpointError:
            continue
        return cand
    return None


def snapshot_checkpoint(path: str, gen: int) -> Optional[str]:
    """Copy the newest GOOD checkpoint to the generation's immutable resume
    point `<path>.elastic_g<gen>` (atomic, idempotent). Every member of the
    new generation resumes from this snapshot, so later checkpoint rotation
    in `path` can never pull the resume point out from under a member that
    boots slowly — and the chaos drill diffs against it."""
    dst = f"{path}.elastic_g{int(gen)}"
    if os.path.isdir(dst):
        return dst
    cand = pick_good_checkpoint(path)
    if cand is None:
        return None
    tmp = dst + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        shutil.copytree(cand, tmp)
        os.replace(tmp, dst)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)
        return None
    return dst


# ------------------------------------------------------------------- server
class ElasticServer(threading.Thread):
    """The rendezvous: membership barrier + admission queue, one per fleet,
    hosted inside rank 0's process as a daemon thread (it must keep serving
    while the main thread is itself recovering from a SyncTimeout, and it
    dies with the exec that ends the generation — the next generation's
    rank 0 binds the same stable address again).

    State: `gen` (current generation), `world` (current membership size),
    parked `waiters` (rejoin announces), and at most one active `round`
    (generation gen+1 being agreed). Decisions are computed by a per-round
    timer thread and replied on the held connections.
    """

    #: extra seconds granted to the last laggard once world-1 members joined
    GRACE = 2.0

    def __init__(
        self,
        bind_addr: str,
        world: int,
        ckpt_dir: str,
        store_host: str,
        store_port0: int,
        mode: str = "shrink",
        gen: int = 0,
        join_window: float = 10.0,
        self_rank: Optional[int] = None,
        log_fn: Optional[Callable[[Dict], None]] = None,
    ):
        super().__init__(name="elastic-rendezvous", daemon=True)
        self.bind_addr = bind_addr
        #: the old rank of the process HOSTING this server (rank 0
        #: normally; the elected rank after a re-election). Its decision
        #: reply is sent LAST: the moment that reply lands, the hosting
        #: process execs into the next generation — killing this server's
        #: threads mid-loop — so every other member's reply must already
        #: be on the wire (observed live: the elected host's instant exec
        #: stranded the other survivor into a spurious 'late' -> requeue).
        self.self_rank = self_rank
        self.world = int(world)
        self.ckpt_dir = ckpt_dir
        self.store_host = store_host
        self.store_port0 = int(store_port0)
        self.mode = mode
        self.gen = int(gen)
        self.join_window = float(join_window)
        self.log_fn = log_fn
        self.running_fleet = False
        self._lock = threading.Lock()
        #: [(announced rank, conn)] in announce order — admission order
        self._waiters: List[Tuple[int, socket.socket]] = []
        #: active round: {"gen", "members": {rank: conn}, "opened": t}
        self._round: Optional[Dict] = None
        self._sock: Optional[socket.socket] = None
        self._stopped = threading.Event()
        self.bound = threading.Event()
        self.bind_error: Optional[str] = None

    # ------------------------------------------------------------ lifecycle
    def run(self) -> None:
        host, port = _split_addr(self.bind_addr)
        try:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(16)
        except OSError as e:
            self.bind_error = str(e)
            self.bound.set()
            return
        self._sock = srv
        self.bound.set()
        while not self._stopped.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                break  # socket closed by stop()/exec
            threading.Thread(
                target=self._serve, args=(conn,),
                name="elastic-conn", daemon=True,
            ).start()

    def stop(self) -> None:
        self._stopped.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass

    def mark_running(self) -> None:
        """The fleet entered its training loop: from here on, a hello that
        claims membership of the current generation is a CRASHED member
        coming back, not a late starter — park it as a rejoiner."""
        self.running_fleet = True

    def grow_pending(self) -> float:
        """The elastic column of rank 0's heartbeat row: nonzero when a
        rejoiner waits for admission (one float compare per beat)."""
        with self._lock:
            return 1.0 if self._waiters else 0.0

    # ------------------------------------------------------------- handlers
    def _serve(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(30.0)
            msg = _recv(conn)
        except (ElasticError, OSError, ValueError):
            conn.close()
            return
        op = msg.get("op")
        if op == "ping":
            # protocol liveness probe (probe_rendezvous): a bare TCP
            # connect proves nothing — after a host dies, the kernel can
            # hand its freed port to ANOTHER process's ephemeral listener
            # (a survivor's gloo pair listener, observed live in the
            # rank-0-kill drill), which accepts and then resets. Only a
            # valid JSON reply proves the rendezvous lives here.
            try:
                _send(conn, {"status": "ok", "gen": self.gen,
                             "world": self.world})
            except OSError:
                pass
            conn.close()
        elif op == "hello":
            self._handle_hello(conn, msg)
        elif op == "join":
            self._handle_join(conn, msg)
        else:
            try:
                _send(conn, {"status": "error", "reason": f"bad op {op!r}"})
            except OSError:
                pass
            conn.close()

    def _handle_hello(self, conn: socket.socket, msg: Dict) -> None:
        rank = int(msg.get("rank", -1))
        hello_gen = int(msg.get("gen", 0))
        with self._lock:
            member = (
                not self.running_fleet
                and hello_gen == self.gen
                and 0 <= rank < self.world
            )
            if member:
                reply = {"status": "run", "gen": self.gen}
            elif self.mode == "shrink+grow":
                conn.settimeout(None)  # parked until an admission decision
                self._waiters.append((rank, conn))
                reply = {"status": "wait", "gen": self.gen}
            else:
                reply = {
                    "status": "reject",
                    "reason": (
                        f"elastic mode {self.mode!r}: rejoin is disabled "
                        "(the fleet only shrinks); requeue through the "
                        "scheduler instead"
                    ),
                }
        try:
            _send(conn, reply)
        except OSError:
            self._drop_waiter(conn)
            return
        if reply["status"] != "wait":
            conn.close()
        else:
            self._note({
                "event": "peer_announce", "rank": rank, "gen": self.gen,
            })

    def _drop_waiter(self, conn: socket.socket) -> None:
        with self._lock:
            self._waiters = [(r, c) for r, c in self._waiters if c is not conn]
        try:
            conn.close()
        except OSError:
            pass

    def _handle_join(self, conn: socket.socket, msg: Dict) -> None:
        rank = int(msg.get("rank", -1))
        gen = int(msg.get("gen", 0))
        kind = str(msg.get("kind", ""))
        with self._lock:
            if gen <= self.gen:
                # the round already decided without this member: it was
                # declared dead; it must fall back to abort-to-requeue and
                # come back through the announce path
                try:
                    _send(conn, {
                        "status": "late",
                        "reason": (
                            f"generation {gen} already decided (current "
                            f"{self.gen}); fall back to requeue"
                        ),
                    })
                except OSError:
                    pass
                conn.close()
                return
            if self._round is None or self._round["gen"] != gen:
                self._round = {
                    "gen": gen,
                    "members": {},
                    "opened": time.monotonic(),
                    "grow": False,
                    #: policy_shrink rounds name the evicted rank: the round
                    #: closes at world-1 (the victim will never join) and
                    #: parked waiters are NOT admitted into the decision
                    "victim": None,
                }
                threading.Thread(
                    target=self._run_round, args=(self._round,),
                    name="elastic-round", daemon=True,
                ).start()
            if kind == "grow":
                self._round["grow"] = True
            if kind == "policy_shrink" and msg.get("victim") is not None:
                self._round["victim"] = int(msg["victim"])
            old = self._round["members"].get(rank)
            self._round["members"][rank] = conn
            print(
                f"rendezvous[{self.bind_addr}]: gen={gen} join from rank "
                f"{rank} ({kind or 'shrink'})"
                + (" SUPERSEDES a stale conn" if old is not None else ""),
                file=sys.stderr, flush=True,
            )
        if old is not None:
            try:
                old.close()  # a retried join supersedes the stale conn
            except OSError:
                pass
        # the round thread owns the reply; this handler just parked the conn

    # -------------------------------------------------------------- rounds
    def _run_round(self, rnd: Dict) -> None:
        print(
            f"rendezvous[{self.bind_addr}]: round gen={rnd['gen']} opened "
            f"(world {self.world}, window {self.join_window:g}s)",
            file=sys.stderr, flush=True,
        )
        deadline = rnd["opened"] + self.join_window
        grace_applied = False
        while True:
            now = time.monotonic()
            with self._lock:
                n = len(rnd["members"])
                world = self.world
                victim = rnd.get("victim")
            if victim is not None:
                # policy shrink: everyone alive, exactly one member (the
                # named victim) deliberately absent — close the moment the
                # other world-1 joined; no grace games, no waiter admission
                if n >= world - 1 or now >= deadline:
                    break
                time.sleep(0.05)
                continue
            with self._lock:
                # In a grow round (any join carried kind="grow", or a
                # rejoiner is parked) the whole fleet is alive and the
                # missing member is typically rank 0 ITSELF, still writing
                # the grow-boundary checkpoint before it joins — routinely
                # longer than GRACE for real table sizes. Shrinking the
                # deadline would decide without rank 0, declare the
                # rendezvous host dead, and hand rank 0 of the next
                # generation to a host that cannot bind the stable
                # W2V_ELASTIC_COORD address. The grace shortcut is a
                # SHRINK-round optimization only.
                grow = rnd.get("grow", False) or bool(self._waiters)
            if n >= world:
                break  # everyone alive: a transient wedge, world unchanged
            if n >= world - 1 and not grace_applied and not grow:
                deadline = min(deadline, now + self.GRACE)
                grace_applied = True
            if now >= deadline:
                break
            time.sleep(0.05)
        self._decide(rnd)

    def _decide(self, rnd: Dict) -> None:
        t0 = time.monotonic()
        policy_victim = rnd.get("victim")
        with self._lock:
            members = sorted(rnd["members"].items())  # [(old rank, conn)]
            # A policy_shrink decision deliberately ignores parked waiters:
            # the evicted host re-announces as a waiter almost immediately,
            # and admitting it into the very round that evicts it would
            # undo the shrink. Waiters stay parked for a later grow round.
            waiters = [] if policy_victim is not None else list(self._waiters)
            gen = rnd["gen"]
            prev_world = self.world
        if not members:
            with self._lock:
                if self._round is rnd:
                    self._round = None
            return
        # Drop waiters that died while parked BEFORE they are counted: a
        # crashed rejoiner baked into new_world would make the fleet exec
        # into a generation with a rank that never starts, wedging the next
        # group init. (The failed _send at reply time is
        # too late — new_world has already gone out to the members.)
        live_waiters = []
        for old_rank, conn in waiters:
            if _conn_alive(conn):
                live_waiters.append((old_rank, conn))
                continue
            self._note({
                "event": "waiter_dead", "rank": old_rank, "gen": gen,
            })
            try:
                conn.close()
            except OSError:
                pass
        waiters = live_waiters
        if len(members) < prev_world - 1:
            # Quorum: the single-failure contract expects every survivor
            # (world-1 of them) in the round. Expiring with fewer means a
            # second concurrent failure, a partitioned survivor, or an
            # election race — and a "go" here would form a SPLINTER fleet
            # (observed pre-fix: two survivors each decided a world-1
            # generation and trained against the same shared checkpoint in
            # parallel). Degrade to abort-to-requeue instead; the round is
            # cleared so a later, complete round can still form this gen.
            print(
                f"rendezvous[{self.bind_addr}]: gen={gen} quorum not "
                f"reached ({len(members)} of {prev_world - 1} survivors); "
                "aborting the round",
                file=sys.stderr, flush=True,
            )
            self._reply_all(members, [], {
                "status": "abort",
                "reason": (
                    f"quorum not reached: {len(members)} of at least "
                    f"{prev_world - 1} expected members joined generation "
                    f"{gen} before the window closed — a second concurrent "
                    "failure or partition must requeue, not form a "
                    "splinter fleet"
                ),
            })
            with self._lock:
                if self._round is rnd:
                    self._round = None
            return
        resume = snapshot_checkpoint(self.ckpt_dir, gen)
        if resume is None:
            # nothing integrity-verified to resume from: the generation
            # cannot form — every joiner falls back to abort-to-requeue
            self._reply_all(members, waiters, {
                "status": "abort",
                "reason": (
                    f"no integrity-verified checkpoint under "
                    f"{self.ckpt_dir!r} to re-shard from"
                ),
            })
            with self._lock:
                if self._round is rnd:
                    self._round = None
            return
        new_world = len(members) + len(waiters)
        print(
            f"rendezvous[{self.bind_addr}]: gen={gen} decided "
            f"{prev_world}->{new_world} (members {[r for r, _ in members]}, "
            f"rejoined {[r for r, _ in waiters]}"
            + (f", victim {policy_victim}" if policy_victim is not None
               else "")
            + f") after {time.monotonic() - rnd['opened']:.1f}s",
            file=sys.stderr, flush=True,
        )
        coordinator = f"{self.store_host}:{self.store_port0 + gen}"
        base = {
            "status": "go",
            "gen": gen,
            "world": new_world,
            "prev_world": prev_world,
            "coordinator": coordinator,
            "resume": resume,
            "snapshot_wall_s": round(time.monotonic() - t0, 3),
            "members": [r for r, _ in members],
            "rejoined": [r for r, _ in waiters],
        }
        self._note({
            "event": "remesh_decision", "gen": gen, "kind":
            "policy_shrink" if policy_victim is not None else
            "grow" if waiters else
            ("transient" if len(members) == prev_world else "shrink"),
            "from_world": prev_world, "to_world": new_world,
            "members": base["members"], "rejoined": base["rejoined"],
            "victim": policy_victim,
            "rendezvous": self.bind_addr,
            "resume": resume,
        })
        # advance the server's view BEFORE any reply lands: a member acts
        # on its decision immediately (exec, re-hello) and must find the
        # server already in the new generation
        with self._lock:
            self.gen = gen
            self.world = new_world
            if policy_victim is None:
                self._waiters = []
            if self._round is rnd:
                self._round = None
            self.running_fleet = False  # the new generation re-marks it
        # Reply order matters: the member hosted in THIS process execs the
        # instant its reply lands, replacing the process image and killing
        # this thread — so its reply goes LAST, after every other member
        # and waiter already has theirs on the wire.
        self_entry = None
        for new_rank, (old_rank, conn) in enumerate(members):
            if old_rank == self.self_rank:
                self_entry = (new_rank, old_rank, conn)
                continue
            try:
                _send(conn, {**base, "rank": new_rank, "old_rank": old_rank})
            except OSError as e:
                print(
                    f"rendezvous[{self.bind_addr}]: gen={gen} 'go' to old "
                    f"rank {old_rank} FAILED ({e}); it will retry and get "
                    "'late' -> requeue",
                    file=sys.stderr, flush=True,
                )
            conn.close()
        for i, (old_rank, conn) in enumerate(waiters):
            try:
                _send(conn, {
                    **base,
                    "status": "admit",
                    "rank": len(members) + i,
                    "old_rank": old_rank,
                })
            except OSError:
                pass
            conn.close()
        if self_entry is not None:
            new_rank, old_rank, conn = self_entry
            try:
                _send(conn, {**base, "rank": new_rank, "old_rank": old_rank})
            except OSError:
                pass
            conn.close()

    def _reply_all(self, members, waiters, reply: Dict) -> None:
        for _, conn in list(members) + list(waiters):
            try:
                _send(conn, reply)
            except OSError:
                pass
            conn.close()
        if waiters:
            # only waiters that were actually replied-to are dropped; a
            # quorum abort keeps the parked (and uninvolved) rejoiners
            with self._lock:
                self._waiters = []

    def _note(self, rec: Dict) -> None:
        if self.log_fn is not None:
            try:
                self.log_fn(dict(rec))
            except Exception:  # noqa: BLE001 — telemetry must not kill it
                pass


# ------------------------------------------------------------------ clients
#: re-announce attempts a rejoiner gets when the rendezvous drops its
#: connection mid-handshake or mid-park. Each attempt opens a fresh hello
#: window (a legitimately parked rejoiner may wait far past hello_timeout
#: before a generation turnover forces it to re-announce), so the TOTAL
#: wait is bounded by _MAX_REANNOUNCE x (hello_timeout + admit_timeout)
#: rather than looping forever against a server that keeps accepting and
#: closing connections.
_MAX_REANNOUNCE = 6


def _connect(addr: str, overall_deadline: float) -> socket.socket:
    host, port = _split_addr(addr)
    while True:
        try:
            sock = socket.create_connection((host, port), timeout=5.0)
            if sock.getsockname() == sock.getpeername():
                # TCP self-connect: connecting to an EPHEMERAL-range port
                # with no listener can simultaneous-open onto ITSELF when
                # the kernel picks source port == destination port — the
                # socket then echoes your own bytes back, a phantom
                # rendezvous that eats the whole join budget (observed in
                # the rank-0-kill drill: a survivor's probe of the DEAD
                # incumbent connected "successfully" and its join spun on
                # its own echoed bytes for 60+s instead of electing).
                sock.close()
                raise OSError("self-connect: no listener at this port")
            return sock
        except OSError as e:
            if time.monotonic() >= overall_deadline:
                raise ElasticError(
                    f"elastic rendezvous at {addr} unreachable: {e}"
                ) from None
            time.sleep(0.3)


#: consecutive protocol failures (reset / garbage / closed before any
#: valid reply) before a join loop declares the address NOT-a-rendezvous.
#: A listener that accepts but never speaks the protocol is a phantom
#: (a recycled port), and burning the whole join budget against it is
#: exactly how a survivor misses its election window.
_MAX_PROTOCOL_STRIKES = 8


def probe_rendezvous(addr: str, budget: float) -> bool:
    """Is a LIVE RENDEZVOUS at `addr`? Connect + `ping` + valid JSON
    reply within `budget`. A bare connect is not evidence: freed ports
    get recycled into other processes' ephemeral listeners (gloo pair
    listeners, observed live), which accept and then reset."""
    deadline = time.monotonic() + budget
    while True:
        try:
            sock = _connect(addr, deadline)
        except ElasticError:
            return False
        try:
            sock.settimeout(min(5.0, max(1.0, deadline - time.monotonic())))
            _send(sock, {"op": "ping"})
            reply = _recv(sock)
            if isinstance(reply, dict) and reply.get("status"):
                return True
        except (ElasticError, OSError, ValueError):
            pass
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.3)


def rendezvous(addr: str, rank: int, gen: int, kind: str,
               timeout: float, victim: Optional[int] = None) -> Dict:
    """Join generation `gen` and block for the decision. Retries transient
    connection failures within `timeout`; a 'late'/'abort' decision is
    returned as-is (the caller falls back to abort-to-requeue). `victim`
    (policy_shrink joins only) names the evicted rank so the round can
    close at world-1 without waiting a grace window for a member that will
    never come. Consecutive protocol failures are bounded
    (_MAX_PROTOCOL_STRIKES): a port that accepts-and-resets is a phantom,
    not a slow server."""
    deadline = time.monotonic() + timeout
    strikes = 0
    while True:
        sock = _connect(addr, deadline)
        try:
            sock.settimeout(max(1.0, deadline - time.monotonic()))
            msg = {"op": "join", "rank": rank, "gen": gen, "kind": kind}
            if victim is not None:
                msg["victim"] = int(victim)
            _send(sock, msg)
            return _recv(sock)
        except (ElasticError, OSError, ValueError) as e:
            if time.monotonic() >= deadline:
                raise ElasticError(
                    f"rendezvous join (gen {gen}) failed: {e}"
                ) from None
            strikes += 1
            if strikes >= _MAX_PROTOCOL_STRIKES:
                raise ElasticError(
                    f"rendezvous join (gen {gen}): {strikes} consecutive "
                    f"protocol failures at {addr} (last: {e}) — a phantom "
                    "listener on a recycled port, not a rendezvous"
                ) from None
            print(
                f"elastic: rank {rank} join (gen {gen}) retrying after: "
                f"{e}",
                file=sys.stderr, flush=True,
            )
            time.sleep(0.3)
        finally:
            try:
                sock.close()
            except OSError:
                pass


def startup_hello(addr: str, rank: int, gen: int, hello_timeout: float,
                  admit_timeout: float,
                  max_reannounce: int = 0) -> Optional[Dict]:
    """The handshake of every non-leader elastic process, before it joins
    the group or touches the card.

    Returns None when the fleet is forming normally ("run": proceed with
    the launch env), or the admission decision when this process is a
    rejoiner that was parked and admitted at a sync boundary. Raises
    ElasticError on a reject or an unreachable rendezvous. A connection
    that dies mid-wait (the fleet's rank 0 exec'd between decision and
    reply, or a shrink re-formed the server) is retried transparently —
    the new generation's server re-parks the announce — up to
    `max_reannounce` times (CLI --rejoin-window; default _MAX_REANNOUNCE),
    so the total wait stays bounded; the exhaustion error spells out the
    bound it implies.
    """
    max_reannounce = int(max_reannounce) or _MAX_REANNOUNCE
    deadline = time.monotonic() + hello_timeout
    reannounces = 0
    while True:
        sock = _connect(addr, deadline)
        try:
            sock.settimeout(max(1.0, deadline - time.monotonic()))
            _send(sock, {"op": "hello", "rank": rank, "gen": gen})
            reply = _recv(sock)
            if reply.get("status") == "run":
                return None
            if reply.get("status") == "reject":
                raise ElasticError(reply.get("reason", "announce rejected"))
            if reply.get("status") == "wait":
                # parked: block for the admission decision (bounded by the
                # admit timeout, reset per successful park)
                sock.settimeout(admit_timeout)
                admitted = _recv(sock)
                if admitted.get("status") == "admit":
                    return admitted
                raise ElasticError(
                    f"admission failed: {admitted.get('reason', admitted)}"
                )
            raise ElasticError(f"unexpected hello reply: {reply}")
        except ElasticError as e:
            if "connection closed" not in str(e):
                raise
            # server went away mid-wait (generation turnover): re-announce
            # on a fresh hello window, but only max_reannounce times —
            # never an unbounded loop against a flapping server
            reannounces += 1
            if reannounces >= max_reannounce:
                bound = max_reannounce * (hello_timeout + admit_timeout)
                raise ElasticError(
                    f"elastic hello: rendezvous at {addr} dropped the "
                    f"connection {reannounces} times; giving up after a "
                    f"total bounded wait of up to {bound:.0f}s "
                    f"({max_reannounce} windows x (hello {hello_timeout:g}s "
                    f"+ admit {admit_timeout:g}s)); raise --rejoin-window "
                    "to wait through more generation turnovers"
                ) from None
            deadline = time.monotonic() + hello_timeout
            time.sleep(0.5)
        except (OSError, ValueError) as e:
            if time.monotonic() >= deadline:
                raise ElasticError(f"elastic hello failed: {e}") from None
            time.sleep(0.5)
        finally:
            try:
                sock.close()
            except OSError:
                pass


# ------------------------------------------------------------- argv rewrite
def rewrite_argv(
    argv: List[str],
    dp: Optional[int] = None,
    resume: Optional[str] = None,
    strip: Tuple[str, ...] = ("--faults", "--inject-nan"),
) -> List[str]:
    """The next generation's training argv: `--dp` rescaled to the new
    world, `--resume` pointing at the generation snapshot (replacing any
    prior resume), and injected faults STRIPPED — a fault plan belongs to
    the generation it was injected into; a peer_dead that re-fired after
    the recovery would kill the fleet it just healed. Everything else
    (shard path, vocab, geometry, telemetry dirs) carries over verbatim;
    geometry flags that differ from the checkpoint config are ignored by
    the resume path anyway (the checkpoint is authoritative)."""
    value_flags = {"--dp", "--resume", "--faults"}
    out: List[str] = []
    replaced = set()
    i = 0
    while i < len(argv):
        tok = argv[i]
        base, eq, _ = tok.partition("=")
        takes_value = base in value_flags and not eq
        if base in strip:
            i += 2 if takes_value and i + 1 < len(argv) else 1
            continue
        if base == "--dp" and dp is not None:
            out += ["--dp", str(dp)]
            replaced.add(base)
            i += 1 if eq else 2
            continue
        if base == "--resume" and resume is not None:
            out += ["--resume", resume]
            replaced.add(base)
            i += 1 if eq else 2
            continue
        out.append(tok)
        i += 1
    if dp is not None and "--dp" not in replaced:
        out += ["--dp", str(dp)]
    if resume is not None and "--resume" not in replaced:
        out += ["--resume", resume]
    return out


# --------------------------------------------------------------- controller
class ElasticController:
    """Per-process driver of the elastic protocol, owned by the CLI.

    rank 0 hosts the rendezvous server; every rank goes through `startup()`
    before it joins the group or touches the card, `mark_running()` when
    the loop starts,
    `grow_pending` as the heartbeat's elastic column, and
    `remesh_and_exec()` from the SyncTimeout / GrowRequested handlers —
    which replaces the process image on success and returns False when the
    caller must fall back to abort-to-requeue.
    """

    def __init__(
        self,
        mode: str,
        argv: List[str],
        rank: int,
        world: int,
        gen: int,
        dp: int,
        elastic_addr: str,
        store_host: str,
        store_port0: int,
        ckpt_dir: str,
        sync_deadline: float,
        step_deadline: float = 0.0,
        join_window: Optional[float] = None,
        hello_timeout: float = 60.0,
        admit_timeout: float = 3600.0,
        peers: Optional[List[str]] = None,
        max_reannounce: int = 0,
        log_fn: Optional[Callable[[Dict], None]] = None,
    ):
        self.mode = mode
        self.argv = list(argv)
        self.rank = int(rank)
        self.world = int(world)
        self.gen = int(gen)
        self.dp = int(dp)
        self.addr = elastic_addr
        self.store_host = store_host
        self.store_port0 = int(store_port0)
        self.ckpt_dir = ckpt_dir
        self.sync_deadline = float(sync_deadline)
        self.step_deadline = float(step_deadline)
        #: per-rank standby rendezvous table (W2V_ELASTIC_PEERS; entry r =
        #: where rank r hosts the rendezvous if elected, entry 0 = the
        #: incumbent). The election scans it in ascending rank order.
        self.peers = list(peers) if peers else default_peers(
            elastic_addr, int(world)
        )
        #: rejoin re-announce bound (CLI --rejoin-window; 0 = the module
        #: default _MAX_REANNOUNCE)
        self.max_reannounce = int(max_reannounce)
        #: set by a successful election: {"elected_rank", "rendezvous"}
        self.elected: Optional[Dict] = None
        # the shrink round must outlast detection skew across survivors:
        # one survivor detects at its next bounded collective (~sync
        # deadline) while another, wedged inside a synchronous dispatch,
        # only detects when its step watchdog fires (~step deadline) — the
        # window must cover the spread between the two legs
        self.join_window = (
            float(join_window) if join_window is not None
            else max(10.0, 2.0 * self.sync_deadline + self.step_deadline)
        )
        self.hello_timeout = float(hello_timeout)
        self.admit_timeout = float(admit_timeout)
        self.log_fn = log_fn
        self.server: Optional[ElasticServer] = None

    # ------------------------------------------------------------ creation
    @classmethod
    def from_env(
        cls,
        mode: str,
        argv: List[str],
        dp: int,
        ckpt_dir: str,
        sync_deadline: float,
        step_deadline: float = 0.0,
        max_reannounce: int = 0,
        env=os.environ,
        log_fn=None,
    ) -> Optional["ElasticController"]:
        """None when the multi-process env contract is absent (elastic is
        meaningless single-process; the CLI warns separately)."""
        from ..parallel import multihost as mh

        coord = env.get(mh.ENV_COORDINATOR)
        world = int(env.get(mh.ENV_NUM_PROCS, "1") or 1)
        if not coord or world <= 1:
            return None
        rank = int(env.get(mh.ENV_PROC_ID, "0") or 0)
        gen = int(env.get(mh.ENV_ELASTIC_GEN, "0") or 0)
        host, port = _split_addr(coord)
        port0 = int(env.get(mh.ENV_ELASTIC_PORT0, "") or (port - gen))
        eaddr = env.get(mh.ENV_ELASTIC_COORD) or f"{host}:{port0 + 1000}"
        peers_env = env.get(mh.ENV_ELASTIC_PEERS, "")
        peers = [p.strip() for p in peers_env.split(",") if p.strip()] or None
        return cls(
            mode=mode, argv=argv, rank=rank, world=world, gen=gen, dp=dp,
            elastic_addr=eaddr, store_host=host, store_port0=port0,
            ckpt_dir=ckpt_dir, sync_deadline=sync_deadline,
            step_deadline=step_deadline, peers=peers,
            max_reannounce=max_reannounce, log_fn=log_fn,
        )

    # ------------------------------------------------------------- startup
    def startup(self) -> None:
        """Run BEFORE multihost.initialize_from_env. Rank 0 binds the
        rendezvous; other ranks hello — and a rejoiner blocks here until a
        sync boundary admits it, then execs into the grown generation
        (this call never returns for an admitted rejoiner)."""
        if self.rank == 0:
            self.server = ElasticServer(
                self.addr, world=self.world, ckpt_dir=self.ckpt_dir,
                store_host=self.store_host, store_port0=self.store_port0,
                mode=self.mode, gen=self.gen,
                join_window=self.join_window, self_rank=self.rank,
                log_fn=self.log_fn,
            )
            self.server.start()
            self.server.bound.wait(timeout=10.0)
            if self.server.bind_error:
                raise ElasticError(
                    f"elastic rendezvous failed to bind {self.addr}: "
                    f"{self.server.bind_error}"
                )
            return
        last_err: Optional[ElasticError] = None
        for i, addr in enumerate(self._hello_addrs()):
            try:
                admitted = startup_hello(
                    addr, self.rank, self.gen,
                    # full patience for the launch address (rank 0 may bind
                    # later than our hello at fleet formation); standby
                    # slots get a short scan — a moved rendezvous is
                    # already listening or is not there at all
                    hello_timeout=(
                        self.hello_timeout if i == 0
                        else max(10.0, self.sync_deadline)
                    ),
                    admit_timeout=self.admit_timeout,
                    max_reannounce=self.max_reannounce,
                )
            except ElasticError as e:
                msg = str(e)
                if "unreachable" not in msg and "dropped the" not in msg:
                    raise  # a reject / failed admission is a real verdict
                # unreachable (or dropped past the bound): the rendezvous
                # may have been re-elected onto a survivor's standby
                # address — scan the peer table before giving up
                last_err = e
                continue
            self.addr = addr
            break
        else:
            raise last_err or ElasticError("elastic hello: no rendezvous")
        if admitted is not None:
            self._note({
                "event": "peer_rejoin", "gen": admitted["gen"],
                "rank": admitted["rank"], "world": admitted["world"],
            })
            self._exec(admitted)  # never returns

    def _hello_addrs(self) -> List[str]:
        """The incumbent first, then every standby slot — a rejoiner must
        find a rendezvous that moved (rank-0 loss + election) without an
        operator pointing it anywhere new."""
        out = [self.addr]
        for p in self.peers:
            if p and p not in out:
                out.append(p)
        return out

    def mark_running(self) -> None:
        if self.server is not None:
            self.server.mark_running()

    def grow_pending(self) -> float:
        if self.server is None:
            return 0.0
        return self.server.grow_pending()

    # ------------------------------------------------------------ election
    def _join_timeout(self) -> float:
        return self.join_window + 2.0 * self.sync_deadline + 30.0

    def _join_next_gen(self, gen: int, kind: str,
                       victim: Optional[int] = None) -> Dict:
        """Join generation `gen` at the incumbent rendezvous — or, when the
        incumbent is unreachable (rank 0 died WITH the rendezvous), run the
        deterministic re-election and join the elected host's round."""
        if self.server is not None:
            # we host the rendezvous ourselves: no reachability question
            return rendezvous(self.addr, self.rank, gen, kind,
                              timeout=self._join_timeout(), victim=victim)
        probe = max(2.0, min(self.sync_deadline or 5.0, 10.0))
        t_probe = time.monotonic()
        reachable = probe_rendezvous(self.addr, probe)
        print(
            f"elastic: rank {self.rank} incumbent {self.addr} "
            f"{'reachable' if reachable else 'UNREACHABLE'} "
            f"(probe {time.monotonic() - t_probe:.1f}s)",
            file=sys.stderr, flush=True,
        )
        if reachable:
            try:
                return rendezvous(self.addr, self.rank, gen, kind,
                                  timeout=self._join_timeout(),
                                  victim=victim)
            except ElasticError as e:
                # the incumbent died mid-round: fall through to election
                self._note({"event": "rendezvous_lost", "gen": gen,
                            "rendezvous": self.addr, "reason": str(e)})
        return self._elect(gen, kind, victim=victim)

    def _elect(self, gen: int, kind: str,
               victim: Optional[int] = None) -> Dict:
        """Deterministic rendezvous re-election: scan candidate slots in
        ascending rank order; each non-candidate waits one stagger window
        (covering the slowest survivor's detection leg) for that slot to
        bind before moving on; the survivor whose OWN slot comes up binds
        its standby address and hosts the round itself. The winner is the
        lowest surviving rank — which the members-sorted-by-old-rank
        assignment then makes rank 0 of the next generation, the host that
        can bind the moved W2V_ELASTIC_COORD."""
        peers = [p for p in (self.peers or []) if p]
        if len(peers) <= 1:
            from ..parallel import multihost as mh

            raise ElasticError(
                f"rendezvous at {self.addr} unreachable and no standby "
                f"peer table to elect from (set {mh.ENV_ELASTIC_PEERS})"
            )
        # the stagger must cover detection skew between survivors: one
        # notices at its next bounded collective (~sync deadline), another
        # only when its step watchdog fires (~step deadline)
        stage = self.join_window
        last_err: Optional[str] = None
        for c in range(1, len(peers)):
            addr = peers[c]
            print(
                f"elastic: rank {self.rank} election: candidate slot {c} "
                f"({addr})" + (" — binding (own slot)" if c == self.rank
                               else f" — waiting up to {stage:g}s"),
                file=sys.stderr, flush=True,
            )
            if c == self.rank:
                srv = ElasticServer(
                    addr, world=self.world, ckpt_dir=self.ckpt_dir,
                    store_host=_split_addr(addr)[0] or self.store_host,
                    store_port0=self.store_port0, mode=self.mode,
                    gen=self.gen,
                    join_window=self.join_window, self_rank=self.rank,
                    log_fn=self.log_fn,
                )
                srv.start()
                srv.bound.wait(timeout=10.0)
                if srv.bind_error:
                    last_err = f"own standby {addr}: {srv.bind_error}"
                    continue  # cannot host; keep scanning as a client
                self.server = srv
                self.addr = addr
                self.elected = {"elected_rank": self.rank,
                                "rendezvous": addr}
                self._note({"event": "rendezvous_election", "gen": gen,
                            "elected_rank": self.rank, "rendezvous": addr})
                return rendezvous(addr, self.rank, gen, kind,
                                  timeout=self._join_timeout(),
                                  victim=victim)
            try:
                # protocol-probe bounded by the stagger; COMMIT with the
                # full join budget once the candidate is VALIDATED (the
                # stagger must never cut short a round that is merely
                # waiting out its window, and a bare connect can be a
                # phantom on a recycled port)
                if not probe_rendezvous(addr, stage):
                    last_err = f"candidate {addr} not answering pings"
                    continue
                decision = rendezvous(addr, self.rank, gen, kind,
                                      timeout=self._join_timeout(),
                                      victim=victim)
            except ElasticError as e:
                last_err = str(e)
                continue
            self.addr = addr
            self.elected = {"elected_rank": c, "rendezvous": addr}
            self._note({"event": "rendezvous_election", "gen": gen,
                        "elected_rank": c, "rendezvous": addr})
            return decision
        raise ElasticError(
            f"rendezvous election failed: no candidate reachable "
            f"({last_err})"
        )

    # ------------------------------------------------------------ recovery
    def remesh_and_exec(
        self,
        kind: str,
        step: Optional[int],
        manifest_path: Optional[str] = None,
        hub=None,
        flight=None,
        metrics_dir: Optional[str] = None,
        trigger: str = "failure",
        victim: Optional[int] = None,
        detect_t: Optional[float] = None,
    ) -> bool:
        """The shrink/grow recovery: rendezvous into the next generation
        and replace this process image. Returns False (caller falls back to
        abort-to-requeue) when the round ends 'late'/'abort', the snapshot
        is missing, or the rendezvous is unreachable AND no survivor could
        be elected to host it. `trigger` names WHY this remesh happens
        (failure | policy | rejoin) and lands on the mesh_events row;
        `victim` is the policy_shrink eviction; `detect_t` the monotonic
        clock when this process saw the failure or the boundary (default:
        now), the start of the blackout the next generation reports."""
        gen = self.gen + 1
        t0 = time.monotonic()
        if detect_t is None:
            detect_t = t0
        print(
            f"elastic: rank {self.rank} joining generation {gen} "
            f"({kind}, trigger={trigger}) via {self.addr}",
            file=sys.stderr, flush=True,
        )
        try:
            decision = self._join_next_gen(gen, kind, victim=victim)
        except ElasticError as e:
            self._note({
                "event": "remesh_failed", "kind": kind, "gen": gen,
                "reason": str(e),
            })
            print(f"elastic: {e}; falling back to abort-to-requeue",
                  file=sys.stderr)
            return False
        agree_wall = time.monotonic() - t0
        print(
            f"elastic: rank {self.rank} got {decision.get('status')!r} for "
            f"generation {gen} in {agree_wall:.1f}s "
            f"(world {decision.get('world')})",
            file=sys.stderr, flush=True,
        )
        if decision.get("status") != "go" or not decision.get("resume"):
            self._note({
                "event": "remesh_failed", "kind": kind, "gen": gen,
                "reason": decision.get("reason", decision.get("status")),
            })
            print(
                f"elastic: generation {gen} not formed "
                f"({decision.get('reason', decision.get('status'))}); "
                "falling back to abort-to-requeue",
                file=sys.stderr,
            )
            return False
        new_world = int(decision["world"])
        if self.dp * new_world % self.world:
            self._note({
                "event": "remesh_failed", "kind": kind, "gen": gen,
                "reason": f"dp {self.dp} not rescalable "
                          f"{self.world}->{new_world}",
            })
            return False
        record = {
            "event": "remesh",
            "kind": kind,
            #: what decided this remesh — failure (a peer died), policy
            #: (resilience/policy.py chose to), or rejoin (a parked host's
            #: admission); the mesh_events audit key the drills assert on
            "trigger": trigger,
            #: the deciding rendezvous address (moved after an election)
            "rendezvous": self.addr,
            "gen": int(decision["gen"]),
            "from_world": self.world,
            "to_world": new_world,
            "at_step": step,
            "rank": int(decision["rank"]),
            "victim": victim,
            "agree_wall_s": round(agree_wall, 3),
            "snapshot_wall_s": decision.get("snapshot_wall_s"),
            "detect_to_round_s": round(t0 - detect_t, 3),
            "resume": decision["resume"],
            "rejoined": decision.get("rejoined", []),
            "mesh_size": None,  # the new generation logs the realized size
        }
        if self.elected is not None:
            record["election"] = dict(self.elected)
        if hub is not None:
            try:
                hub(dict(record))  # counts w2v_remesh_total
                if trigger == "policy":
                    # the policy-actuation counter (w2v_policy_remesh_total)
                    hub({"event": "policy_remesh", "kind": kind,
                         "gen": gen, "to_world": new_world,
                         "victim": victim})
                if decision.get("rejoined"):
                    hub({"event": "peer_rejoin",
                         "ranks": decision["rejoined"], "gen": gen})
            except Exception:  # noqa: BLE001
                pass
        if flight is not None and metrics_dir:
            try:
                flight.ring.instant("remesh", args={
                    "kind": kind, "gen": gen, "to_world": new_world,
                })
                flight.dump(
                    metrics_dir, reason=f"remesh_{kind}",
                    extra={"failure_step": step, "remesh": record},
                    filename=f"flight_remesh_g{gen}.json",
                )
            except Exception:  # noqa: BLE001
                pass
        if manifest_path:
            from ..obs.manifest import append_manifest_event

            if self.elected is not None:
                append_manifest_event(manifest_path, "mesh_events", {
                    "event": "rendezvous_election", "gen": gen,
                    **self.elected,
                })
            append_manifest_event(manifest_path, "mesh_events", record)
        self._exec(decision, trigger=trigger, handoff={
            "kind": kind, "at_step": step, "detect_t": detect_t,
            "round_start_t": t0, "round_s": agree_wall,
            "snapshot_s": decision.get("snapshot_wall_s"),
        })  # never returns
        return True  # pragma: no cover — unreachable

    # ---------------------------------------------------------------- exec
    def _exec(self, decision: Dict, trigger: str = "failure",
              handoff: Optional[Dict] = None) -> None:
        """Replace this process image with the next generation's: same pid,
        same scheduler allocation, a fresh CUDA context and process group.
        A gloo group has no member removal, and the old image's context,
        pinned buffers and gloo pairs go only with the image: the reason
        the elastic path never shows a 75/76 to the scheduler. `handoff`
        (the failure's clock, the round's and the snapshot's seconds) rides
        the environment to the new generation's blackout record."""
        from ..parallel import multihost as mh

        new_world = int(decision["world"])
        new_dp = self.dp * new_world // self.world
        argv = rewrite_argv(self.argv, dp=new_dp, resume=decision["resume"])
        env = dict(os.environ)
        env.update(mh.generation_env(
            decision["coordinator"], new_world, int(decision["rank"]),
            int(decision["gen"]),
        ))
        # The rendezvous follows rank 0: the next generation's COORD is the
        # standby address of whoever became rank 0 (== the incumbent when
        # rank 0 survived; the elected host's slot after a rank-0 loss),
        # and the per-rank standby table is rewritten in new-rank order so
        # a LATER election still has a correct map.
        members = [int(r) for r in decision.get("members", [])]
        members += [int(r) for r in decision.get("rejoined", [])]
        if (
            self.peers and members
            and all(0 <= r < len(self.peers) for r in members)
        ):
            new_peers = [self.peers[r] for r in members]
            env[mh.ENV_ELASTIC_PEERS] = ",".join(new_peers)
            env[mh.ENV_ELASTIC_COORD] = new_peers[0]
        else:
            env[mh.ENV_ELASTIC_COORD] = self.addr
        env[mh.ENV_ELASTIC_PORT0] = str(self.store_port0)
        env[mh.ENV_ELASTIC_TRIGGER] = trigger
        if self.elected is not None:
            # the election must survive the exec: rank 1+'s gen-0 process
            # has no manifest (metrics artifacts are primary-gated), so the
            # NEW generation's primary records it — generation_start grows
            # an `election` field and re-fires the counter event
            env["W2V_ELASTIC_ELECTED"] = (
                f"{self.elected['elected_rank']}:"
                f"{self.elected['rendezvous']}"
            )
        else:
            env.pop("W2V_ELASTIC_ELECTED", None)
        env["W2V_ELASTIC_HANDOFF"] = json.dumps(handoff or {})
        env["W2V_ELASTIC_EXEC_T"] = repr(time.monotonic())
        cmd = launch_prefix(self.argv) + argv
        self._note({
            "event": "remesh_exec", "gen": int(decision["gen"]),
            "rank": int(decision["rank"]), "world": new_world, "dp": new_dp,
        })
        print(
            f"elastic: exec into generation {decision['gen']} as rank "
            f"{decision['rank']}/{new_world} (dp {new_dp}, resume "
            f"{decision.get('resume')})",
            file=sys.stderr, flush=True,
        )
        shepherd = None
        if int(decision["rank"]) == 0:
            # the next generation's store starts now, beside the new image
            shepherd = (decision["coordinator"], new_world, int(decision["gen"]))
        _replace_image(cmd, env, shepherd)

    def exec_announce(self) -> None:
        """The policy-shrink victim's exit: replace this process image with
        an announce-only relaunch of the SAME generation env — the fresh
        CLI's elastic startup hellos the rendezvous, is parked as a
        rejoiner (the fleet has moved to gen+1, so the hello is a
        crashed-member-coming-back by the server's rules), and rejoins at a
        later policy-gated grow boundary. Faults are stripped like any
        other generation hand-off — an injected straggler stall must not
        follow the host back in."""
        argv = rewrite_argv(self.argv)
        env = dict(os.environ)
        env["W2V_ELASTIC_EXEC_T"] = repr(time.monotonic())
        env["W2V_ELASTIC_EVICTED"] = "1"
        env.pop("W2V_ELASTIC_HANDOFF", None)
        cmd = launch_prefix(self.argv) + argv
        self._note({
            "event": "policy_evict_exec", "gen": self.gen, "rank": self.rank,
        })
        _replace_image(cmd, env)

    def _note(self, rec: Dict) -> None:
        if self.log_fn is not None:
            try:
                self.log_fn(dict(rec))
            except Exception:  # noqa: BLE001
                pass


def launch_prefix(argv: List[str]) -> List[str]:
    """The command line this process was started with, less the CLI's own
    arguments: the next generation starts the way this one did (`python
    -m word2vec_tpu_torch.cli`, or a wrapper that calls cli.main). When
    the CLI's arguments are not the tail of the interpreter's command line
    (cli.main called in process), the module's own entry point."""
    orig = list(getattr(sys, "orig_argv", []) or [])
    n = len(argv)
    if n and len(orig) > n and orig[-n:] == list(argv):
        return orig[:-n]
    return [sys.executable, "-m", "word2vec_tpu_torch.cli"]


def _close_on_exec() -> None:
    """Mark every descriptor above stdio close-on-exec. Python's own
    sockets and pipes are, but the gloo pairs, the store client and the
    gloo loop's epoll and wake pipe are created inheritable by torch's C++
    side, and without this they would reach the next generation's image
    (open sockets to the old group; the drills check the new image holds
    none). Marking, not closing: the old image's threads may still poll
    these descriptors until the exec ends them."""
    try:
        fds = [int(f) for f in os.listdir("/proc/self/fd")]
    except OSError:
        fds = list(range(3, 1024))
    for fd in fds:
        if fd > 2:
            try:
                os.set_inheritable(fd, False)
            except OSError:
                pass  # already closed (the directory listing's own fd)


def _replace_image(cmd: List[str], env: Dict[str, str],
                   shepherd: Optional[Tuple[str, int, int]] = None) -> None:
    """execve into `cmd`, no descriptor of this image crossing over but
    the pipes of the next generation's store shepherd, when this process
    starts it (`shepherd` = (coordinator, world, gen); the new rank 0)."""
    sys.stdout.flush()
    sys.stderr.flush()
    _close_on_exec()
    env.pop("W2V_ELASTIC_SHEPHERD", None)
    if shepherd is not None:
        from ..parallel import multihost as mh

        try:
            mh.prestart_shepherd(*shepherd, env)
        except OSError as e:  # the new image starts its own
            print(f"elastic: shepherd prestart failed ({e})", file=sys.stderr)
    os.execve(sys.executable, cmd, env)


def inherited_sockets() -> List[int]:
    """The socket descriptors this process holds above stdio: at the start
    of an exec'd generation, any such is one the old image leaked ([] is
    the contract)."""
    fds = []
    try:
        names = os.listdir("/proc/self/fd")
    except OSError:
        return fds
    for f in names:
        try:
            if int(f) > 2 and os.readlink(f"/proc/self/fd/{f}").startswith("socket:"):
                fds.append(int(f))
        except OSError:
            pass  # the directory listing's own descriptor, closed by now
    return sorted(fds)
