"""Parallel training: a (dp, sp, tp) mesh of replicas, their
tensor-parallel shards and the periodic replica sync, in one process or
across several (the data axis only, parallel/multihost.py).

Port of word2vec_tpu/parallel/trainer.py (the JAX ShardedTrainer on a
(data, seq, model) mesh, parallel/mesh.py):

  params   — every table is split on its last (dim) axis into tp shards
             (param_spec of the JAX package: split tables [V, d/tp], the
             unified slab [V, 2, d/tp] with its 2-wide table axis whole);
             shard t of replica r is its own contiguous tensor on
             Mesh.shard_devices(r)[t], so a device holds V*d/tp floats a
             table. The port's counterpart of the JAX package's leading
             replica axis [DP*SP, V, ...] is a list of dp*sp replicas
             (`Replicas`), one a (data, seq) coordinate r = d*sp + s:
             replica r is a Params dict at tp = 1 and a list of its tp
             shard dicts at tp > 1. The list stays inside the trainer:
             init_state, the state train() returns and export_params hold
             one unreplicated [V, d] (or [V, 2, d]) Params dict, as
             Trainer's do, and a dict handed to train() is split into
             every replica. Only the live state a checkpoint_cb or a fault
             sees mid-run holds the list (export_params and fill_params
             read it).
  tokens   — a global step is dp consecutive [B, L] batches: data index d
             trains rows [d*B, (d+1)*B) of the step's [dp*B, L] rows, seq
             index s the haloed column slice [s*Lloc - W, (s+1)*Lloc + W)
             of them (ops/shards.halo_exchange), each with its own draws
             (device.seed_step: the data fold at dp > 1, then the seq fold
             at sp > 1; no fold over the model axis, so a replica's shards
             draw alike). A trailing partial step is padded with all -1
             row blocks.
  processes— with several processes (parallel/multihost.make_global_mesh)
             each process holds dp/procs data coordinates, its global
             replicas p * local + j, and feeds them from its own corpus
             shard: local_dp row blocks a global step, as many global
             steps an epoch as every process can feed (global_agree_min).
             Draws are keyed by the global replica index, so a fleet draws
             exactly what one process of the same mesh draws.
  step     — each replica runs its route's step (the four band routes and
             the hs and pair steps at tp = sp = 1; 'xla', hs and pair
             under the model and seq axes), as its own captured CUDA
             graph (ops/graphs.StepGraph): its tp shard bodies in
             lockstep, the partial logits summed in shard order on shard
             0's device at the JAX step's psum sites (ops/shards.py). A
             replica whose shards sit on different devices runs eagerly
             (StepGraph.split; the run manifest's `dispatch.split_shards`).
             Replicas on one card share the trainer's capture pool and
             stream (they never run at the same time); replicas on
             several cards each get their card's own.
  metrics  — the JAX trainer's contract psum(psum(v, model) / tp, (data,
             seq)): per replica the shards' sum in shard order over tp
             (StepGraph), then the sum over replicas in replica order
             (train.Trainer._note_metrics), which the divergence tripwire
             and the logs see; with several processes every process's
             replica rows first come together in one small gather
             (multihost.gather_replica_rows), so every rank sees the same
             global values.
  sync     — every dp_sync_every optimizer steps the dp*sp replicas are
             averaged in place, shard by shard (make_sync: the pmean over
             the data and seq axes; make_delta_sync: the delta mode,
             config.sync_mode). The JAX pmean is an XLA collective, not a
             Pallas kernel; torch ops are its port. Across cards the sum
             is staged through replica 0's shard's card. Across processes
             every replica's shard is gathered in global replica order
             (multihost.all_gather_tables; delta mode gathers the bf16
             wire deltas) and summed locally in that order, so the mean is
             bitwise the one-process mean (a ring all_reduce would sum in
             another order).

The sync writes into the replicas' own tensors (copy_, add_): every
replica's graph was captured against those tensors, and a sync that bound
new ones would leave the graphs training stale tables, silently.

ShardedTrainer subclasses train.Trainer: the epoch loop, the alpha
schedule, the metering, the telemetry and the checkpoint hooks are
inherited; the param layout, the batch grouping, the runners and the sync
hooks differ. The stop check is the Trainer's flag read in one process and
a resilience/watchdog.PeerAgreement across several (install_shutdown). At
tp = sp = 1, unlike the JAX package,
every kernel route trains under the mesh (ROADMAP C10): JAX's shard_map
cannot host a pallas_call, while here each replica's step is the
single-device step. At tp or sp > 1 the Pallas routes are refused, as the
JAX trainer refuses them: their kernels train whole rows of whole tables.

remesh() re-forms a live trainer over another mesh (the JAX trainer's
autoscaling primitive): every runner and graph dropped, the replicas
rebuilt, the tables carried over through export_params / import_params or
loaded from the newest good checkpoint.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Word2VecConfig
from ..data.batcher import PAD, BatchIterator, PackedCorpus, chunk_batches, epoch_order
from ..data.vocab import Vocab
from ..device import DeviceLike, on_device
from ..models.params import Params, convert_params_layout, params_layout
from ..ops import resident as res
from ..ops.graphs import capture_env, shard_list
from ..ops.shards import halo_exchange
from ..ops.tables import DeviceTables
from ..ops.train_step import make_chunk_runner
from ..train import Trainer, TrainState
from . import multihost
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh

#: gather(tensors) -> every process's local tensors, process order
#: (multihost.all_gather_tables; a stand-in in the tests)
Gather = Callable[[List[torch.Tensor]], List[List[torch.Tensor]]]

#: one replica: its Params dict at tp = 1, its tp shard dicts at tp > 1
Replica = Union[Params, List[Params]]
#: the replicas of a mesh, replica r = d*sp + s on Mesh.shard_devices(r)
Replicas = List[Replica]


def split_params(params: Params, tp: int) -> List[Params]:
    """[V, ..., d] tables -> tp views [V, ..., d/tp], shard t the dim slice
    [t*d/tp, (t+1)*d/tp) (the JAX package's param_spec: the last axis
    over the model axis, every other axis whole)."""
    if tp == 1:
        return [params]
    out: List[Params] = [{} for _ in range(tp)]
    for k, v in params.items():
        w = v.shape[-1] // tp
        for t in range(tp):
            out[t][k] = v[..., t * w:(t + 1) * w]
    return out


def concat_shards(shards: List[Params]) -> Params:
    """A replica's tp shards -> its [V, ..., d] tables, on shard 0's
    device (new tensors; the shard itself at tp = 1)."""
    if len(shards) == 1:
        return shards[0]
    home = next(iter(shards[0].values())).device
    return {
        k: torch.cat([s[k].to(home) for s in shards], dim=-1) for k in shards[0]
    }


def _placed(parts: List[Params], devices) -> Replica:
    """A replica's own buffers: each shard of `parts` copied into a
    contiguous tensor on its device (the dict itself at tp = 1)."""
    shards = [
        {k: torch.empty(v.shape, dtype=v.dtype, device=dev).copy_(v)
         for k, v in part.items()}
        for part, dev in zip(parts, devices)
    ]
    return shards[0] if len(shards) == 1 else shards


def replicate_params(params: Params, mesh: Mesh) -> Replicas:
    """[V, ...] tables -> dp*sp identical replicas, each split into its tp
    contiguous shards on its shard devices."""
    parts = split_params(params, mesh.tp)
    return [_placed(parts, mesh.shard_devices(r)) for r in range(mesh.replicas)]


def unreplicate_params(params: Replicas) -> Params:
    """Replica 0's tables, its shards concatenated; call after a sync,
    when the replicas are equal."""
    return concat_shards(shard_list(params[0]))


def assemble_local_replica(params: Replicas) -> Params:
    """One full [V, ...] Params dict, in new tensors, from this process's
    own replicas: after a sync every replica is identical, so this
    process's first one does, its tp shards concatenated on the dim (last)
    axis (the JAX package's assemble_local_replica; a replica's model
    shards never span processes, multihost.hybrid_axes)."""
    if isinstance(params[0], list):  # tp > 1: the concatenation is new
        return unreplicate_params(params)
    return {k: v.clone() for k, v in params[0].items()}


def _by_shard(params: Replicas) -> List[List[Params]]:
    """[shard t] -> [replica r's shard t dict], the replicas a sync
    averages together."""
    reps = [shard_list(p) for p in params]
    return [[rep[t] for rep in reps] for t in range(len(reps[0]))]


def _global_order(local: List[torch.Tensor], mesh: Mesh,
                  gather: Optional[Gather]) -> List[torch.Tensor]:
    """This process's replicas' tensors of one table shard -> every
    replica's, in global replica order (this process's entries are its
    own tensors; the rest gathered). One process: `local` itself."""
    if mesh.procs == 1:
        return local
    per = (gather or multihost.all_gather_tables)(local)
    out: List[torch.Tensor] = []
    for q, tabs in enumerate(per):
        out.extend(local if q == mesh.process else tabs)
    return out


def make_sync(mesh: Mesh, gather: Optional[Gather] = None
              ) -> Callable[[Replicas], Replicas]:
    """The replica mean, in place: sync(params) averages every table over
    the dp*sp replicas, shard by shard, and writes the mean into each of
    this process's replicas' own tensors (returning the same list).

    The mean is XLA's pmean on the CPU, bitwise at dp = 2 and 4 and over
    the data and seq axes (pinned by tests/test_torch_parallel.py and
    tests/test_torch_tp_sp.py against the JAX package's make_sync): the
    sum in replica order, in float32 (a bf16 table is summed in float32
    and rounded once), times the float32 reciprocal of dp*sp (XLA turns
    the division into that product). Across processes the replicas are
    gathered (`gather`, default multihost.all_gather_tables) and summed in
    the same global order on this process's first replica's device, so
    every process computes the one-process mean, bitwise."""
    recip = 1.0 / mesh.replicas

    def sync(params: Replicas) -> Replicas:
        for group in _by_shard(params):
            for k in group[0]:
                local = [p[k] for p in group]
                tables = _global_order(local, mesh, gather)
                home = tables[0]
                # f32 tables sum in replica 0's own buffer (a gathered copy
                # when replica 0 is another process's), others in a
                # float32 one
                acc = home if home.dtype == torch.float32 else home.float()
                for t in tables[1:]:
                    acc.add_(t.to(home.device))
                mean = acc.to(home.dtype).mul_(recip)
                for t in local:
                    if t.data_ptr() != mean.data_ptr():
                        t.copy_(mean)
        return params

    return sync


def make_delta_sync(mesh: Mesh, gather: Optional[Gather] = None
                    ) -> Callable[[Replicas, Replica], Replicas]:
    """Delta-mode reconciliation (config.sync_mode="delta"), in place:

        new = base + mean(bf16(params - base))

    over the dp*sp replicas, shard by shard, `base` the tables of the last
    sync (a replica's form: replica 0's devices; the caller keeps it as
    distinct buffers), so only the accumulated local updates are
    averaged, rounded to bf16 (the JAX package's wire dtype).
    sync(params, base) writes `new` into every replica and into `base`
    (the next sync's base).

    The bf16 mean is XLA's pmean of a bf16 operand on the CPU: the replica
    deltas summed in float32 in replica order and rounded to bf16 once,
    then scaled by 1/(dp*sp) (pinned bitwise at dp = 2 and 4 against the
    JAX package's make_delta_sync by tests/test_torch_parallel.py and
    tests/test_torch_multihost.py). Of a bf16 table XLA sums the exact
    float32 differences (its CPU backend computes the bf16 subtraction in
    float32 and does not round it before the all-reduce), and so does
    this. Across processes the gathered operand is a bf16 tensor either
    way, half the bytes of an f32 table: the bf16 wire delta of an f32
    table, a bf16 table itself (its float32 delta is taken after the
    gather); every process holds the same base (the tables of the last
    sync)."""
    recip = 1.0 / mesh.replicas

    def sync(params: Replicas, base: Replica) -> Replicas:
        for group, bshard in zip(_by_shard(params), shard_list(base)):
            for k in group[0]:
                b = bshard[k]
                if b.dtype == torch.bfloat16:
                    bf = b.float()
                    sent = [p[k] for p in group]
                else:
                    sent = [(p[k].to(b.device) - b).to(torch.bfloat16)
                            for p in group]
                acc = None
                for w in _global_order(sent, mesh, gather):
                    if b.dtype == torch.bfloat16:
                        wire = w.to(b.device).float().sub_(bf)
                    else:
                        wire = w.to(b.device).float()
                    acc = wire if acc is None else acc.add_(wire)
                mean = acc.to(torch.bfloat16).mul_(recip)
                b.add_(mean.to(b.dtype))
                for p in group:
                    p[k].copy_(b)
        return params

    return sync


def _reject_pallas(config: Word2VecConfig, mesh: Mesh) -> None:
    """The JAX trainer's _reject_pallas (parallel/trainer.py:121-138)
    under the model and seq axes: the kernel routes train whole rows of
    whole tables, so a dim-sharded or sequence-sharded step has no kernel
    to run. Refused up front, naming the mesh and the supported route."""
    if config.band_backend in ("pallas", "pallas_oa", "pallas_fused"):
        raise ValueError(
            f"band_backend={config.band_backend!r} is single-chip only "
            f"(plain Trainer, or data parallelism alone): a (dp, sp, tp) = "
            f"({mesh.dp}, {mesh.sp}, {mesh.tp}) mesh is the incompatible "
            "lever here, since its kernels train whole rows of whole "
            "tables. Use band_backend='xla' for sharded training, or drop "
            "the model and seq mesh axes"
        )


class ShardedTrainer(Trainer):
    """Data-, sequence- and tensor-parallel trainer over a (dp, sp, tp)
    mesh, in one process or, on the data axis, across several (see the
    module docstring); a (1, 1, 1) mesh trains exactly as Trainer does."""

    #: (step, micro sub-step, replica) -> Draws: each replica's draws
    #: instead of its generator (tests feed the JAX trainer's; eager only)
    draws_hook = None

    def __init__(
        self,
        config: Word2VecConfig,
        vocab: Vocab,
        corpus: PackedCorpus,
        dp: int = 1,
        tp: int = 1,
        sp: int = 1,
        mesh: Optional[Mesh] = None,
        log_fn=None,
        device: DeviceLike = None,
    ):
        self._apply_mesh(
            mesh if mesh is not None
            else multihost.make_global_mesh(dp, tp, sp, device=device),
            config,
        )
        self._last_sync_step: Optional[int] = None
        #: the agreed global steps an epoch, across processes (cached per
        #: corpus: agreeing is a collective)
        self._epoch_steps: Optional[int] = None
        self._replicas: Optional[Replicas] = None
        self._sync_base: Optional[Params] = None
        self._tables_by_dev: Dict[torch.device, DeviceTables] = {}
        self._envs: Dict[torch.device, tuple] = {}
        super().__init__(config, vocab, corpus, log_fn=log_fn,
                         device=self.mesh.devices[0])
        self._build_sync()

    # ------------------------------------------------------ mesh lifecycle
    def _apply_mesh(self, mesh: Mesh, config: Word2VecConfig) -> None:
        """Adopt `mesh` and its axis widths, and validate the config
        against the resolved shape with the JAX trainer's checks and
        messages (parallel/trainer.py:416-440)."""
        self.mesh = mesh
        self.dp = mesh.shape[DATA_AXIS]
        self.sp = mesh.shape[SEQ_AXIS]
        self.tp = mesh.shape[MODEL_AXIS]
        #: the (data, seq) replicas: the sync's width
        self.reps = self.dp * self.sp
        #: the processes of the mesh; this one feeds dp/procs data
        #: coordinates, the global replicas [offset, offset + local_reps)
        self.procs = mesh.procs
        if self.procs > 1 and self.dp % self.procs != 0:
            raise ValueError(
                f"multi-host: data-parallel width {self.dp} must be divisible "
                f"by the process count {self.procs} (each process feeds "
                f"dp/procs replicas; parallel/multihost.py)"
            )
        self.local_dp = self.dp // self.procs
        self.local_reps = mesh.local_replicas
        self.replica_offset = mesh.replica_offset
        if config.word_dim % self.tp != 0:
            raise ValueError(
                f"word_dim {config.word_dim} not divisible by tp={self.tp}"
            )
        if config.max_sentence_len % self.sp != 0:
            raise ValueError(
                f"max_sentence_len {config.max_sentence_len} not divisible "
                f"by sp={self.sp}"
            )
        if self.sp > 1 and config.max_sentence_len // self.sp < config.window:
            # halo_exchange is one hop: a slice shorter than the window
            # would need tokens from beyond its neighbours
            raise ValueError(
                f"per-shard slice {config.max_sentence_len // self.sp} is "
                f"shorter than window {config.window}; lower sp or raise "
                f"max_sentence_len"
            )
        if self.sp > 1 and config.scatter_mean:
            raise ValueError(
                "scatter_mean duplicate counts are shard-local and would "
                "diverge from single-chip semantics under sp > 1; use the "
                "default sum semantics with sequence parallelism"
            )
        if self.tp > 1 or self.sp > 1:
            _reject_pallas(config, mesh)

    def remesh(
        self,
        mesh: Optional[Mesh] = None,
        dp: int = 0,
        tp: int = 0,
        sp: int = 0,
        state: Optional[TrainState] = None,
        checkpoint_dir: Optional[str] = None,
    ) -> "ShardedTrainer":
        """Re-form this trainer over a new mesh, re-entrantly (the JAX
        trainer's remesh, parallel/trainer.py:449-547).

        Drops everything mesh-derived, as __init__ builds it: every runner
        and its captured graphs, the capture pools and streams, the
        replicas and their shards, the per-device tables, the resident
        corpus, the sync (and the delta sync's base) and the agreed steps
        an epoch; the new mesh is validated by the same _apply_mesh. Pass
        `mesh`, or axis widths (`dp` / `tp` / `sp`, defaulting to the
        current ones; the mesh is then multihost.make_global_mesh's on this
        trainer's device type). With `state`, the live tables are exported
        on the OLD mesh (replica-synced, export_params) and imported into
        the new one (import_params): continuing is then bitwise what a
        fresh trainer of the new shape does with the same tables. With
        `checkpoint_dir`, the tables and counters come instead from the
        newest GOOD checkpoint there (io/checkpoint.load_checkpoint: verify,
        quarantine, .old fallback), which needs a `state` to land in
        (ValueError otherwise). The next train() captures again.

        The process set cannot change inside a live process (a gloo group
        has no member removal): an elastic fleet re-enters through an exec
        (resilience/elastic.py) and a fresh trainer. This is the
        one-process operation.
        """
        host_params = ck_state = None
        if checkpoint_dir is not None:
            if state is None:
                raise ValueError(
                    "remesh(checkpoint_dir=...) re-shard-loads the "
                    "checkpoint tables into a live state and needs the "
                    "`state` to import them into — without it the loaded "
                    "params would be silently discarded. Pass state=, or "
                    "omit checkpoint_dir for a specs-only remesh."
                )
            from ..io.checkpoint import load_checkpoint

            ck_state, _cfg, _vocab = load_checkpoint(checkpoint_dir)
            host_params = ck_state.params
        elif state is not None:
            # synced and de-replicated on the OLD mesh; copies, so the old
            # replicas can go
            host_params = {k: v.clone() for k, v in self.export_params(state).items()}
        if mesh is None:
            mesh = multihost.make_global_mesh(
                dp or self.dp, tp or self.tp, sp or self.sp,
                device=self.mesh.devices[0].type,
            )
        old_cards = self.mesh.cards
        self._apply_mesh(mesh, self.config)
        self._runners.clear()
        self._env = None
        self._envs.clear()
        self._replicas = None
        self._params = None
        self._sync_base = None
        for dev in old_cards:
            if dev.type == "cuda":
                # the old graphs' pools, and the cuBLAS workspaces of their
                # capture streams, back to the allocator
                from ..tune.planner import free_probe_residue

                free_probe_residue(dev)
                break
        self._tables_by_dev.clear()
        self._resident = None
        self._resident_cache = None
        self._resident_ready = False
        self._epoch_steps = None
        self._last_sync_step = None
        if self.mesh.devices[0] != self.device:
            self.device = self.mesh.devices[0]
            self.tables = DeviceTables.build(self.vocab, self.config, self.device)
        self._build_sync()
        if state is not None and ck_state is not None:
            state.step = ck_state.step
            state.words_done = ck_state.words_done
            state.epoch = ck_state.epoch
        if state is not None and host_params is not None:
            self.import_params(host_params, state)
        self._log({
            "event": "remesh",
            "mesh_size": self.dp * self.sp * self.tp,
            "dp": self.dp, "sp": self.sp, "tp": self.tp,
            "source": "checkpoint" if checkpoint_dir else (
                "live" if state is not None else "specs-only"
            ),
        })
        if self.flight is not None:
            self.flight.ring.instant("remesh", args={
                "dp": self.dp, "sp": self.sp, "tp": self.tp,
            })
        return self

    def _build_sync(self) -> None:
        self.sync_fn = (
            make_delta_sync(self.mesh) if self.config.sync_mode == "delta"
            else make_sync(self.mesh)
        )

    def _tables_on(self, dev: torch.device) -> DeviceTables:
        """The frequency tables on `dev` (each card of the mesh its own)."""
        if dev == self.device:
            return self.tables
        if dev not in self._tables_by_dev:
            self._tables_by_dev[dev] = DeviceTables.build(self.vocab, self.config, dev)
        return self._tables_by_dev[dev]

    def _env_on(self, dev: torch.device):
        """The capture pool and stream of `dev`: the trainer's own on its
        first card, shared by every replica there."""
        if dev == self.device:
            if self._env is None:
                self._env = capture_env(dev)
            return self._env
        if dev not in self._envs:
            with on_device(dev):
                self._envs[dev] = capture_env(dev)
        return self._envs[dev]

    def _coord(self, r: int) -> Tuple[int, int]:
        """Replica r's (data, seq) coordinate (r global, or local for the
        local coordinate)."""
        return divmod(r, self.sp)

    @property
    def split_shards(self) -> bool:
        """Some replica's tp shards sit on different devices: its steps
        run eagerly (ops/graphs.StepGraph.split), never as a graph."""
        return any(
            len(set(self.mesh.shard_devices(j))) > 1
            for j in range(self.local_reps)
        )

    def refresh_vocab_tables(self) -> None:
        self._tables_by_dev.clear()
        super().refresh_vocab_tables()

    def _sync(self) -> None:
        for dev in self.mesh.cards:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    # -------------------------------------------------------------- params
    def _coerce_param_layout(self, params):
        if isinstance(params, dict):
            return super()._coerce_param_layout(params)
        coerce = super(ShardedTrainer, self)._coerce_param_layout
        return [
            [coerce(s) for s in p] if isinstance(p, list) else coerce(p)
            for p in params
        ]

    def _shards_of(self, src) -> List[Params]:
        """A replica's source as its tp shard dicts: a shard list as it
        is, a full-width Params dict split into views."""
        if isinstance(src, list):
            if len(src) != self.tp:
                raise ValueError(
                    f"{len(src)} shards handed to a trainer of tp={self.tp}"
                )
            return src
        return split_params(src, self.tp)

    def _adopt(self, params) -> Replicas:
        """The replicas' persistent buffers, holding `params`: a Replicas
        list (this process's replica j into replica j's buffers) or one
        unreplicated Params dict (split into every replica). Tables copied
        in from outside rebase the delta sync."""
        srcs = params if isinstance(params, list) else [params] * self.local_reps
        if len(srcs) != self.local_reps:
            raise ValueError(
                f"{len(srcs)} replicas handed to a trainer of "
                f"dp*sp={self.reps}"
                + (f" ({self.local_reps} in this process)"
                   if self.procs > 1 else "")
            )
        srcs = [self._shards_of(s) for s in srcs]
        mine = self._replicas
        same = mine is not None and all(
            sorted(m) == sorted(s) and all(
                m[k].shape == v.shape and m[k].dtype == v.dtype
                for k, v in s.items()
            )
            for rep, src in zip(mine, srcs)
            for m, s in zip(shard_list(rep), src)
        )
        copied = not same
        if not same:
            self._replicas = [
                _placed(src, self.mesh.shard_devices(r)) for r, src in enumerate(srcs)
            ]
            self._runners.clear()
        else:
            for rep, src in zip(mine, srcs):
                for m, s in zip(shard_list(rep), src):
                    for k, v in s.items():
                        if v.device != m[k].device or v.data_ptr() != m[k].data_ptr():
                            m[k].copy_(v)
                            copied = True
        self._params = shard_list(self._replicas[0])[0]
        if copied:
            self._reset_sync_base(self._replicas)
        return self._replicas

    def _detach_params(self, params: Replicas) -> Params:
        """train() hands back one Params dict, as Trainer does: copies of
        replica 0's tables (the run ended on a sync: _finalize), its
        shards concatenated."""
        return assemble_local_replica(params)

    def _all_shards(self, params: Replicas) -> Iterator[Params]:
        for p in params:
            yield from shard_list(p)

    def _check_finite(self, state: TrainState, metrics) -> None:
        for p in self._all_shards(state.params):
            super()._check_finite(
                TrainState(p, state.step, state.words_done, state.epoch), metrics
            )

    def fill_params(self, state: TrainState, value: float) -> None:
        for p in self._all_shards(state.params):
            super().fill_params(TrainState(p), value)

    def train(self, state: Optional[TrainState] = None, *args, **kw):
        """Trainer.train; tables handed in (or a fresh init) are taken to
        be reconciled at hand-off, so the sync cadence counts from the
        state's step. A state whose params are this trainer's live
        replicas (import_params, or a run continued in place) keeps its
        cadence."""
        if state is None or state.params is not self._replicas:
            self._last_sync_step = 0 if state is None else state.step
        return super().train(state, *args, **kw)

    # ------------------------------------------------------------- syncing
    def _reset_sync_base(self, params: Replicas) -> None:
        """Delta sync tracks the tables of the last sync: rebased whenever
        the replicas are (re)filled wholesale (init, import)."""
        if self.config.sync_mode == "delta":
            base = [{k: v.clone() for k, v in s.items()} for s in shard_list(params[0])]
            self._sync_base = base[0] if self.tp == 1 else base

    def _run_sync(self, params: Replicas) -> Replicas:
        if self.config.sync_mode == "delta":
            if self._sync_base is None:
                self._reset_sync_base(params)
            self.sync_fn(params, self._sync_base)
        else:
            self.sync_fn(params)
        self._bound_sync_wait()
        return params

    def _bound_sync_wait(self) -> None:
        """Deadline-bound the replica sync's completion with several
        processes: with a sync deadline installed (--sync-deadline) and
        peers, wait for the sync's device work in a bounded worker, so a
        wedge is attributed HERE and raises SyncTimeout for the coordinated
        abort. One process or no deadline: no wait, no added sync point
        (the step watchdog still bounds a one-process hang)."""
        if self.procs <= 1:
            return
        from ..resilience.watchdog import bounded_call, sync_deadline

        deadline = sync_deadline()
        if not deadline:
            return
        bounded_call(self._sync, what="replica-sync collective",
                     deadline=deadline)

    def _device_get(self, fn: Callable):
        """Deadline-bound the metrics fetch with several processes (the
        JAX trainer's _device_get): fetching a step's metrics waits on the
        step, which waits on the collectives before it, so with a dead
        peer the hang surfaces here, between the bounded agree and
        heartbeat boundaries. One process, or without --sync-deadline: the
        plain fetch."""
        if self.procs > 1:
            from ..resilience.watchdog import bounded_call, sync_deadline

            if sync_deadline():
                return bounded_call(fn, what="sharded metrics fetch")
        return fn()

    def _all_replica_rows(self, vals: np.ndarray) -> np.ndarray:
        """Every process's replica metric rows, global replica order (one
        small gather; the identity in one process)."""
        if self.procs <= 1:
            return vals
        return multihost.gather_replica_rows(vals)

    def _post_step(self, state: TrainState) -> None:
        """The replica sync, every dp_sync_every optimizer steps. The
        cadence is in optimizer steps, so one dispatch step of
        micro_steps sub-steps counts micro_steps of them; it is measured by
        distance, so a chunk (step += chunk) cannot step over a sync. The
        sync has its own span: it is not host overhead (obs/signals)."""
        cfg = self.config
        every = max(1, cfg.dp_sync_every // cfg.micro_steps)
        since = state.step - (self._last_sync_step or 0)
        if self.reps > 1 and cfg.dp_sync_every and since >= every:
            with self.phases.span("replica_sync"):
                self._run_sync(state.params)
            self._last_sync_step = state.step

    def _finalize(self, state: TrainState) -> None:
        if self.reps > 1 and self._last_sync_step != state.step:
            with self.phases.span("replica_sync"):
                self._run_sync(state.params)
            self._last_sync_step = state.step

    def set_corpus(self, corpus) -> None:
        """Segment swap (stream/driver.py): the segment's step counters
        restart at 0, and so does the sync cadence; the agreed steps an
        epoch are agreed again for the new corpus."""
        super().set_corpus(corpus)
        self._last_sync_step = None
        self._epoch_steps = None

    def install_shutdown(self, handler, agree_every: int = 0) -> None:
        """The cooperative stop across processes: a preemption notice
        usually hits ONE process, but every process must leave the step
        loop at the same global step or the survivors hang in a collective
        the stopped one never joins. With several processes the stop check
        is a resilience/watchdog.PeerAgreement (the agreed vote, with a
        liveness heartbeat: stragglers logged by process, and under
        --sync-deadline a dead peer raises SyncTimeout instead of hanging),
        at the replica-sync dispatch cadence by default (a stop lands where
        replicas reconcile anyway). One process: the flag read."""
        if self.procs <= 1:
            self.stop_check = handler.make_stop_check()
            return
        from ..resilience.watchdog import PeerAgreement

        if agree_every <= 0:
            agree_every = max(
                1, self.config.dp_sync_every // self.config.micro_steps
            )
        self.stop_check = PeerAgreement(
            handler,
            agree_every=agree_every,
            step_time_fn=lambda: (
                self.watchdog.step_stats().get("p50_ms", 0.0)
                if self.watchdog is not None else 0.0
            ),
            log_fn=self.log_fn,
            flight=self.flight,
            # the elastic grow and policy channels ride the heartbeat row,
            # so the whole fleet acts at one sync boundary (cli.py wires
            # both before calling install_shutdown)
            elastic_fn=self.elastic_poll,
            policy_fn=self.policy_poll,
            signals=self.signals,
            phases=self.phases,
        ).check

    # -------------------------------------------------------- the batches
    def _agreed_steps_per_epoch(self, batcher: BatchIterator) -> int:
        """Global steps an epoch: ceil(batches / local_dp), agreed across
        processes as the minimum (multihost.global_agree_min, once a
        corpus): each process feeds its own shard and every global step is
        a collective, so all must run the same count (a process whose
        shard packs one more step would enter a collective alone)."""
        local = -(-batcher.steps_per_epoch() // self.local_dp)
        if self.procs == 1:
            return local
        if self._epoch_steps is None:
            self._epoch_steps = multihost.global_agree_min(local)
        return self._epoch_steps

    def _resume_skip(self, state: TrainState, batcher: BatchIterator) -> int:
        """Resume position in global steps (the step counter's unit)."""
        spe = self._agreed_steps_per_epoch(batcher)
        skip = state.step - state.epoch * spe
        if 0 <= skip <= spe:
            return skip
        return self._note_resume_fallback(state, skip, spe)

    def _resolve_chunk_len(self, batcher: BatchIterator) -> int:
        """Chunk length in global steps, capped to a divisor of the sync
        interval: syncs run at dispatch boundaries and land exactly on the
        per-step cadence."""
        cfg = self.config
        if cfg.chunk_steps == 1 or self.debug_nans:
            return 1
        steps = self._agreed_steps_per_epoch(batcher)
        if cfg.chunk_steps == 0:
            s, _ = cfg.chunk_geometry(steps, cap=cfg.chunk_cap)
        else:
            s = min(cfg.chunk_steps, steps)
        if self.reps > 1 and cfg.dp_sync_every:
            every = max(1, cfg.dp_sync_every // cfg.micro_steps)
            s = min(s, every)
            while every % s:
                s -= 1
        return max(1, s)

    def _global_batches(
        self, batcher: BatchIterator, epoch: int, skip: int
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """The epoch's global steps from global step `skip` on, this
        process's part of each: local_dp consecutive [B, L] batches of its
        shard as one [local_dp*B, L] array and their words; the trailing
        partial step padded with all -1 row blocks; no more than the agreed
        steps (a larger shard drops its excess this epoch)."""
        local_dp = self.local_dp
        limit = self._agreed_steps_per_epoch(batcher)
        emitted = min(skip, limit)
        buf: List[np.ndarray] = []
        words = 0
        for tokens, w in batcher.epoch(epoch, skip * local_dp):
            buf.append(tokens)
            words += w
            if len(buf) == local_dp:
                if emitted >= limit:
                    return
                yield np.concatenate(buf, axis=0), words
                emitted += 1
                buf, words = [], 0
        if buf and emitted < limit:
            pad = [np.full_like(buf[0], PAD)] * (local_dp - len(buf))
            yield np.concatenate(buf + pad, axis=0), words

    # ------------------------------------------------------- the dispatch
    def _build_resident(self):
        """Several processes stream: their corpus shards share no row
        order (resident='on' warns and streams, as in JAX)."""
        if self.procs > 1:
            if self.config.resident == "on":
                import warnings

                warnings.warn(
                    "config.resident='on' is single-process only (multi-host "
                    "feeds per-process corpus shards with no shared row "
                    "order); streaming from host.",
                    stacklevel=2,
                )
            return None
        return super()._build_resident()

    def _make_resident_runtime(self):
        """The corpus placed once on each card of the mesh."""
        return {dev: res.device_corpus(self.corpus, dev) for dev in self.mesh.cards}

    def _home(self, j: int) -> torch.device:
        """Local replica j's first shard's device (its graph, draws and
        sums)."""
        return self.mesh.shard_devices(j)[0]

    def _row_len(self) -> int:
        """The token columns a replica trains: L, or a sequence shard's
        haloed Lloc + 2W."""
        cfg = self.config
        if self.sp == 1:
            return cfg.max_sentence_len
        return cfg.max_sentence_len // self.sp + 2 * cfg.window

    def _runner(self, chunk_len: int):
        """One runner a replica, each with its graph captured on the
        replica's buffers (ops/graphs.ChunkRunner with replica / stride,
        and its (data, seq) folds and halo under sequence parallelism);
        a replica on the CPU, or one whose shards span devices, runs
        eagerly."""
        graphed = self.graphs and not self.debug_nans
        resident = self._resident is not None
        key = (chunk_len, resident, graphed)
        runners = self._runners.get(key)
        cfg = self.config
        if runners is None:
            runners = []
            for j in range(self.local_reps):
                r = self.replica_offset + j  # the global replica
                devs = self.mesh.shard_devices(j)
                dev = devs[0]
                tables = self._tables_on(dev)
                on_card = graphed and dev.type == "cuda"
                mesh_kw = dict(tp=self.tp, sp=self.sp)
                if resident:
                    runner = res.make_resident_chunk_runner(
                        cfg, tables, graphed=on_card, **mesh_kw)
                else:
                    runner = make_chunk_runner(
                        cfg, tables, graphed=on_card,
                        fused=cfg.fused_tables and chunk_len > 1, **mesh_kw,
                    )
                if self.reps > 1:
                    d, s = self._coord(r)
                    runner.replica, runner.stride = r, self.dp
                    runner.block = d
                    runner.fold = (d if self.dp > 1 else None,
                                   s if self.sp > 1 else None)
                    runner.halo = (s, self.sp) if self.sp > 1 else None
                if self.tp > 1:
                    runner.shard_tables = [self._tables_on(x) for x in devs]
                if on_card:
                    runner.env = self._env_on(dev)
                runners.append(runner)
            self._runners[key] = runners
        hook = self.draws_hook
        if hook is not None and self.reps == 1:
            hook = lambda step, sub: self.draws_hook(step, sub, 0)  # noqa: E731
        self.capture_s = 0.0
        for j, runner in enumerate(runners):
            dev = self._home(j)
            runner.draws_hook = hook
            with on_device(dev):
                if resident:
                    g = runner.resident_graph(
                        self._replicas[j], self._resident[dev], chunk_len,
                        self.corpus.num_rows,
                    )
                else:
                    g = runner.stream_graph(
                        self._replicas[j],
                        (chunk_len, cfg.batch_rows, self._row_len()),
                    )
            self.capture_s += g.capture_s
        return runners

    def _gather_metrics(self, ms: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """Per-replica metrics [S] -> {name: [local replicas, S]} on the
        first card (the drain gathers every process's rows and sums them,
        train.Trainer._note_metrics)."""
        names = tuple(ms[0])
        rows = [torch.stack([m[k] for k in names]).to(self.device) for m in ms]
        stacked = torch.stack(rows, dim=1)
        return {k: stacked[i] for i, k in enumerate(names)}

    def _chunk_dispatches(
        self,
        state: TrainState,
        batcher: BatchIterator,
        runners,
        epoch: int,
        skip: int,
        chunk_len: int,
    ) -> Iterator[Tuple[List[int], Callable]]:
        """One epoch's dispatches of global steps (Trainer._chunk_dispatches
        over this process's replicas): each replica's runner on its row
        block of every step, replica after replica (one card runs them in
        turn; several cards run them at once), then the replicas' metrics
        gathered."""
        cfg = self.config
        B = cfg.batch_rows
        seed = self.run_seed
        devs = [self._home(j) for j in range(self.local_reps)]
        if self._resident is not None:
            order = epoch_order(seed, epoch, self.corpus.num_rows)
            # a global step takes dp row blocks of B rows each
            step_words = res.epoch_step_words(self.corpus, order, B * self.dp)
            orders = {
                dev: torch.from_numpy(order.astype(np.int32)).to(dev)
                for dev in self.mesh.cards
            }
            for t0 in range(skip, len(step_words), chunk_len):
                words_list = [int(w) for w in step_words[t0:t0 + chunk_len]]

                def dispatch(al, n, t0=t0):
                    ms = []
                    with self.phases.span("dispatch"):
                        for r, (runner, dev) in enumerate(zip(runners, devs)):
                            with on_device(dev):
                                ms.append(runner(
                                    self._replicas[r], self._resident[dev],
                                    orders[dev], seed, state.step, t0, al, steps=n,
                                ))
                        return self._gather_metrics(ms)

                yield words_list, dispatch
            return
        for tokens, words_list in chunk_batches(
            self._global_batches(batcher, epoch, skip), chunk_len
        ):

            def dispatch(al, n, tokens=tokens):
                gs = []
                with self.phases.span("h2d"):
                    for r, (runner, dev) in enumerate(zip(runners, devs)):
                        with on_device(dev):
                            gs.append(runner.stage(
                                self._replicas[r], self._replica_tokens(tokens, r)
                            ))
                ms = []
                with self.phases.span("dispatch"):
                    for r, (runner, dev) in enumerate(zip(runners, devs)):
                        with on_device(dev):
                            ms.append(runner.run(
                                gs[r], self._replicas[r], al, seed, state.step, n
                            ))
                    return self._gather_metrics(ms)

            yield words_list, dispatch

    def _replica_tokens(self, tokens: np.ndarray, j: int):
        """Local replica j's tokens of a [S, local_dp*B, L] chunk: its
        local data row block [d*B, (d+1)*B), and under sequence
        parallelism the haloed column slice of its seq shard
        (ops/shards.halo_exchange)."""
        B = self.config.batch_rows
        d, s = self._coord(j)
        block = tokens[:, d * B:(d + 1) * B]
        if self.sp == 1:
            return np.ascontiguousarray(block)
        return halo_exchange(
            torch.from_numpy(block), s, self.sp, self.config.window
        ).contiguous()

    # ------------------------------------------------------------- planning
    def plan_constraints(self) -> Dict:
        """The planner's constraints over the mesh: at tp = sp = 1 every
        kernel route is allowed (each replica's step is the single-device
        step; ROADMAP C10); under the model or seq axes none is (the
        trainer refuses them, _reject_pallas). dp is the live divider."""
        return {
            "dp": self.dp, "sp": self.sp, "tp": self.tp,
            "allow_pallas": self.tp == 1 and self.sp == 1,
            "corpus_mode": self.config.corpus_mode,
        }

    def plan_shapes(self) -> Dict:
        """Realized per-dispatch shapes over the mesh: dp row blocks a
        global step, an L/sp column slice and a d/tp dim slice a shard,
        the sync-capped chunk length."""
        shapes = super().plan_shapes()
        cfg = self.config
        shapes.update(
            dp=self.dp, sp=self.sp, tp=self.tp,
            rows_per_dispatch=cfg.batch_rows * self.dp,
            cols_per_shard=cfg.max_sentence_len // self.sp,
            dim_per_shard=cfg.word_dim // self.tp,
        )
        return shapes

    # ----------------------------------------------------------------- api
    def export_params(self, state: TrainState) -> Params:
        """The synced, de-replicated [V, d] tables: of the live replicas,
        copies of this process's first replica on its first device, its
        shards concatenated (assemble_local_replica; a pending sync runs
        first, so a quality probe scores what the JAX trainer's does, and
        with several processes every process must call this, since the
        sync is a collective); a state that already holds one Params dict
        (what train() returns, a checkpoint's) as it is."""
        if isinstance(state.params, dict):
            return state.params
        if self.reps > 1 and self._last_sync_step != state.step:
            self._run_sync(state.params)
            self._last_sync_step = state.step
        return assemble_local_replica(state.params)

    def import_params(self, params: Params, state: TrainState) -> None:
        """Unreplicated tables (a checkpoint's, a single-device run's) into
        every replica's persistent buffers, split into its shards, in this
        trainer's table layout
        (models/params.convert_params_layout converts the other one);
        the delta sync rebases and the cadence counts from state.step."""
        target = self.config.table_layout
        if params_layout(params) != target:
            params = convert_params_layout(params, target)
        state.params = self._adopt(params)
        self._last_sync_step = state.step
