"""One-process data-parallel training: dp replicas and their periodic sync.

Port of word2vec_tpu/parallel/trainer.py at tp = sp = 1 (the JAX
ShardedTrainer on a (dp, 1, 1) mesh):

  params   — every replica holds a full copy of the tables on its device
             (parallel/mesh.Mesh.devices[r]); the port's counterpart of the
             JAX package's leading replica axis [DP, V, ...] is a list of dp
             Params dicts (`Replicas`), replica r's tensors on its device.
             The list stays inside the trainer: init_state, the state
             train() returns and export_params hold one Params dict, as
             Trainer's do, and a dict handed to train() is copied into
             every replica. Only the live state a checkpoint_cb or a fault
             sees mid-run holds the list (export_params and fill_params
             read it).
  tokens   — a global step is dp consecutive [B, L] batches: replica r
             trains rows [r*B, (r+1)*B) of the step's [dp*B, L] rows, with
             its own draws (device.replica_seed, the counterpart of
             fold_in(key, axis_index("data"))). A trailing partial step is
             padded with all -1 row blocks.
  step     — each replica runs the single-device step of its route (the
             four band routes, the hs and pair steps), as its own captured
             CUDA graph (ops/graphs.StepGraph); nothing crosses replicas
             inside a step. Replicas on one card share the trainer's
             capture pool and stream (they never run at the same time);
             replicas on several cards each get their card's own.
  metrics  — per-step metrics and the health counters are the sums over
             replicas, in replica order (the JAX trainer's psum over the
             data axis): the divergence tripwire and the logs see the sums.
  sync     — every dp_sync_every optimizer steps the replicas are averaged
             in place (make_sync: the pmean; make_delta_sync: the delta
             mode, config.sync_mode). The JAX pmean is an XLA collective,
             not a Pallas kernel; torch ops are its port. Across cards the
             sum is staged through replica 0's card.

The sync writes into the replicas' own tensors (copy_, add_): every
replica's graph was captured against those tensors, and a sync that bound
new ones would leave the graphs training stale tables, silently.

ShardedTrainer subclasses train.Trainer: the epoch loop, the alpha
schedule, the metering, the telemetry and the checkpoint hooks are
inherited; the param layout, the batch grouping, the runners and the sync
hooks differ. The stop check is the Trainer's flag read (one process:
there is nobody to agree with). Unlike the JAX package, every kernel route
trains under the mesh (ROADMAP C10): JAX's shard_map cannot host a
pallas_call, while here each replica's step is the single-device step.

Not in this slice: the model and seq axes (ROADMAP A8b), several processes
(multihost, the peer agreement, assemble_local_replica; ROADMAP A8c) and
remesh (A10e).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import Word2VecConfig
from ..data.batcher import PAD, BatchIterator, PackedCorpus, chunk_batches, epoch_order
from ..data.vocab import Vocab
from ..device import DeviceLike
from ..models.params import Params, convert_params_layout, params_layout
from ..ops import resident as res
from ..ops.graphs import capture_env
from ..ops.tables import DeviceTables
from ..ops.train_step import make_chunk_runner
from ..train import Trainer, TrainState
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, make_mesh

#: one Params dict a replica, replica r's tensors on Mesh.devices[r]
Replicas = List[Params]


def _on(dev: torch.device):
    """Make `dev` the current CUDA device (a no-op on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def replicate_params(params: Params, mesh: Mesh) -> Replicas:
    """[V, ...] tables -> dp identical copies, replica r's on its device."""
    return [
        {k: torch.empty(v.shape, dtype=v.dtype, device=dev).copy_(v)
         for k, v in params.items()}
        for dev in mesh.devices
    ]


def unreplicate_params(params: Replicas) -> Params:
    """Replica 0's tables; call after a sync, when the replicas are equal."""
    return params[0]


def make_sync(mesh: Mesh) -> Callable[[Replicas], Replicas]:
    """The replica mean, in place: sync(params) averages every table over
    the replicas and writes the mean into each replica's own tensors
    (returning the same list).

    The mean is XLA's pmean on the CPU, bitwise at dp = 2 and 4 (pinned
    by tests/test_torch_parallel.py against the JAX package's make_sync):
    the sum in replica order, in float32 (a bf16 table is summed in
    float32 and rounded once), times the float32 reciprocal of dp (XLA
    turns the division by dp into that product)."""
    recip = 1.0 / len(mesh.devices)

    def sync(params: Replicas) -> Replicas:
        for k in params[0]:
            tables = [p[k] for p in params]
            home = tables[0]
            # f32 tables sum in replica 0's own buffer, others in a float32 one
            acc = home if home.dtype == torch.float32 else home.float()
            for t in tables[1:]:
                acc.add_(t.to(home.device))
            mean = acc.to(home.dtype).mul_(recip)
            for t in tables:
                if t.data_ptr() != mean.data_ptr():
                    t.copy_(mean)
        return params

    return sync


def make_delta_sync(mesh: Mesh) -> Callable[[Replicas, Params], Replicas]:
    """Delta-mode reconciliation (config.sync_mode="delta"), in place:

        new = base + mean(bf16(params - base))

    over the replicas, `base` the tables of the last sync (replica 0's
    device; the caller keeps it as a distinct buffer), so only the
    accumulated local updates are averaged, rounded to bf16 (the JAX
    package's wire dtype). sync(params, base) writes `new` into every
    replica and into `base` (the next sync's base).

    The bf16 mean is XLA's pmean of a bf16 operand on the CPU: the replica
    deltas summed in float32 in replica order and rounded to bf16 once,
    then scaled by 1/dp (pinned bitwise at dp = 2 and 4 against the JAX
    package's make_delta_sync by tests/test_torch_parallel.py)."""
    recip = 1.0 / len(mesh.devices)

    def sync(params: Replicas, base: Params) -> Replicas:
        for k in params[0]:
            b = base[k]
            acc = None
            for p in params:
                wire = (p[k].to(b.device) - b).to(torch.bfloat16).float()
                acc = wire if acc is None else acc.add_(wire)
            mean = acc.to(torch.bfloat16).mul_(recip)
            b.add_(mean.to(b.dtype))
            for p in params:
                p[k].copy_(b)
        return params

    return sync


class ShardedTrainer(Trainer):
    """Data-parallel trainer over dp replicas in one process (see the
    module docstring); dp = 1 trains exactly as Trainer does."""

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
            mesh if mesh is not None else make_mesh(dp, tp, sp, device=device)
        )
        self._last_sync_step: Optional[int] = None
        self._replicas: Optional[Replicas] = None
        self._sync_base: Optional[Params] = None
        self._tables_by_dev: Dict[torch.device, DeviceTables] = {}
        self._envs: Dict[torch.device, tuple] = {}
        super().__init__(config, vocab, corpus, log_fn=log_fn,
                         device=self.mesh.devices[0])
        self._build_sync()

    # ------------------------------------------------------ mesh lifecycle
    def _apply_mesh(self, mesh: Mesh) -> None:
        """Adopt `mesh` and its axis widths (tp = sp = 1: make_mesh refuses
        the others, so the JAX trainer's divisibility checks cannot fire)."""
        self.mesh = mesh
        self.dp = mesh.shape[DATA_AXIS]
        self.sp = mesh.shape[SEQ_AXIS]
        self.tp = mesh.shape[MODEL_AXIS]

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
            with _on(dev):
                self._envs[dev] = capture_env(dev)
        return self._envs[dev]

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
        return [super(ShardedTrainer, self)._coerce_param_layout(p) for p in params]

    def _adopt(self, params) -> Replicas:
        """The replicas' persistent buffers, holding `params`: a Replicas
        list (replica r's into replica r's buffers) or one unreplicated
        Params dict (copied into every replica). Tables copied in from
        outside rebase the delta sync."""
        srcs = params if isinstance(params, list) else [params] * self.dp
        if len(srcs) != self.dp:
            raise ValueError(
                f"{len(srcs)} replicas handed to a trainer of dp={self.dp}"
            )
        mine = self._replicas
        same = mine is not None and all(
            sorted(m) == sorted(s) and all(
                m[k].shape == v.shape and m[k].dtype == v.dtype
                for k, v in s.items()
            )
            for m, s in zip(mine, srcs)
        )
        copied = not same
        if not same:
            self._replicas = replicate_params(srcs[0], self.mesh)
            for m, s in zip(self._replicas[1:], srcs[1:]):
                for k, v in s.items():
                    m[k].copy_(v)
            self._runners.clear()
        else:
            for m, s in zip(mine, srcs):
                for k, v in s.items():
                    if v.device != m[k].device or v.data_ptr() != m[k].data_ptr():
                        m[k].copy_(v)
                        copied = True
        self._params = self._replicas[0]
        if copied:
            self._reset_sync_base(self._replicas)
        return self._replicas

    def _detach_params(self, params: Replicas) -> Params:
        """train() hands back one Params dict, as Trainer does: copies of
        replica 0's tables (the run ended on a sync: _finalize)."""
        return super()._detach_params(params[0])

    def _check_finite(self, state: TrainState, metrics) -> None:
        for p in state.params:
            super()._check_finite(
                TrainState(p, state.step, state.words_done, state.epoch), metrics
            )

    def fill_params(self, state: TrainState, value: float) -> None:
        for p in state.params:
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
            self._sync_base = {k: v.clone() for k, v in params[0].items()}

    def _run_sync(self, params: Replicas) -> Replicas:
        self._harvest_capture("replica_sync")
        if self.config.sync_mode == "delta":
            if self._sync_base is None:
                self._reset_sync_base(params)
            return self.sync_fn(params, self._sync_base)
        return self.sync_fn(params)

    def _post_step(self, state: TrainState) -> None:
        """The replica sync, every dp_sync_every optimizer steps. The
        cadence is in optimizer steps, so one dispatch step of
        micro_steps sub-steps counts micro_steps of them; it is measured by
        distance, so a chunk (step += chunk) cannot step over a sync. The
        sync has its own span: it is not host overhead (obs/signals)."""
        cfg = self.config
        every = max(1, cfg.dp_sync_every // cfg.micro_steps)
        since = state.step - (self._last_sync_step or 0)
        if self.dp > 1 and cfg.dp_sync_every and since >= every:
            with self.phases.span("replica_sync"):
                self._run_sync(state.params)
            self._last_sync_step = state.step

    def _finalize(self, state: TrainState) -> None:
        if self.dp > 1 and self._last_sync_step != state.step:
            with self.phases.span("replica_sync"):
                self._run_sync(state.params)
            self._last_sync_step = state.step

    def set_corpus(self, corpus) -> None:
        """Segment swap (stream/driver.py): the segment's step counters
        restart at 0, and so does the sync cadence."""
        super().set_corpus(corpus)
        self._last_sync_step = None

    # -------------------------------------------------------- the batches
    def _agreed_steps_per_epoch(self, batcher: BatchIterator) -> int:
        """Global steps an epoch: ceil(batches / dp)."""
        return -(-batcher.steps_per_epoch() // self.dp)

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
        if self.dp > 1 and cfg.dp_sync_every:
            every = max(1, cfg.dp_sync_every // cfg.micro_steps)
            s = min(s, every)
            while every % s:
                s -= 1
        return max(1, s)

    def _global_batches(
        self, batcher: BatchIterator, epoch: int, skip: int
    ) -> Iterator[Tuple[np.ndarray, int]]:
        """The epoch's global steps from global step `skip` on: dp
        consecutive [B, L] batches as one [dp*B, L] array and their words;
        the trailing partial step padded with all -1 row blocks."""
        buf: List[np.ndarray] = []
        words = 0
        for tokens, w in batcher.epoch(epoch, skip * self.dp):
            buf.append(tokens)
            words += w
            if len(buf) == self.dp:
                yield np.concatenate(buf, axis=0), words
                buf, words = [], 0
        if buf:
            pad = [np.full_like(buf[0], PAD)] * (self.dp - len(buf))
            yield np.concatenate(buf + pad, axis=0), words

    # ------------------------------------------------------- the dispatch
    def _make_resident_runtime(self):
        """The corpus placed once on each card of the mesh."""
        return {dev: res.device_corpus(self.corpus, dev) for dev in self.mesh.cards}

    def _runner(self, chunk_len: int):
        """One runner a replica, each with its graph captured on the
        replica's buffers (ops/graphs.ChunkRunner with replica / stride);
        a replica on the CPU runs eagerly."""
        graphed = self.graphs and not self.debug_nans
        resident = self._resident is not None
        key = (chunk_len, resident, graphed)
        runners = self._runners.get(key)
        cfg = self.config
        if runners is None:
            runners = []
            for r, dev in enumerate(self.mesh.devices):
                tables = self._tables_on(dev)
                on_card = graphed and dev.type == "cuda"
                if resident:
                    runner = res.make_resident_chunk_runner(cfg, tables, graphed=on_card)
                else:
                    runner = make_chunk_runner(
                        cfg, tables, graphed=on_card,
                        fused=cfg.fused_tables and chunk_len > 1,
                    )
                if self.dp > 1:
                    runner.replica, runner.stride = r, self.dp
                if on_card:
                    runner.env = self._env_on(dev)
                runners.append(runner)
            self._runners[key] = runners
        hook = self.draws_hook
        if hook is not None and self.dp == 1:
            hook = lambda step, sub: self.draws_hook(step, sub, 0)  # noqa: E731
        self.capture_s = 0.0
        for r, (runner, dev) in enumerate(zip(runners, self.mesh.devices)):
            runner.draws_hook = hook
            with _on(dev):
                if resident:
                    g = runner.resident_graph(
                        self._replicas[r], self._resident[dev], chunk_len,
                        self.corpus.num_rows,
                    )
                else:
                    g = runner.stream_graph(
                        self._replicas[r],
                        (chunk_len, cfg.batch_rows, cfg.max_sentence_len),
                    )
            self.capture_s += g.capture_s
        return runners

    def _gather_metrics(self, ms: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """Per-replica metrics [S] -> {name: [dp, S]} on the first card
        (the drain sums the replica rows, train.Trainer._note_metrics)."""
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
        over replicas): each replica's runner on its row block of every
        step, replica after replica (one card runs them in turn; several
        cards run them at once), then the replicas' metrics gathered."""
        cfg = self.config
        B = cfg.batch_rows
        seed = self.run_seed
        devs = self.mesh.devices
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
                    self._harvest_capture("resident_chunk")
                    ms = []
                    with self.phases.span("dispatch"):
                        for r, (runner, dev) in enumerate(zip(runners, devs)):
                            with _on(dev):
                                ms.append(runner(
                                    self._replicas[r], self._resident[dev],
                                    orders[dev], seed, state.step, t0, al, steps=n,
                                ))
                        return self._gather_metrics(ms)

                yield words_list, dispatch
            return
        program = "train_step" if chunk_len == 1 else "train_chunk"
        for tokens, words_list in chunk_batches(
            self._global_batches(batcher, epoch, skip), chunk_len
        ):

            def dispatch(al, n, tokens=tokens):
                self._harvest_capture(program)
                gs = []
                with self.phases.span("h2d"):
                    for r, (runner, dev) in enumerate(zip(runners, devs)):
                        with _on(dev):
                            gs.append(runner.stage(
                                self._replicas[r],
                                np.ascontiguousarray(tokens[:, r * B:(r + 1) * B]),
                            ))
                ms = []
                with self.phases.span("dispatch"):
                    for r, (runner, dev) in enumerate(zip(runners, devs)):
                        with _on(dev):
                            ms.append(runner.run(
                                gs[r], self._replicas[r], al, seed, state.step, n
                            ))
                    return self._gather_metrics(ms)

            yield words_list, dispatch

    # ------------------------------------------------------------- planning
    def plan_constraints(self) -> Dict:
        """The planner's constraints over the mesh: every kernel route is
        allowed (each replica's step is the single-device step; ROADMAP
        C10), dp is the live divider."""
        return {
            "dp": self.dp, "sp": self.sp, "tp": self.tp, "allow_pallas": True,
            "corpus_mode": self.config.corpus_mode,
        }

    def plan_shapes(self) -> Dict:
        """Realized per-dispatch shapes over the mesh: dp row blocks a
        global step, the sync-capped chunk length."""
        shapes = super().plan_shapes()
        cfg = self.config
        shapes.update(
            dp=self.dp, sp=self.sp, tp=self.tp,
            rows_per_dispatch=cfg.batch_rows * self.dp,
            cols_per_shard=cfg.max_sentence_len,
            dim_per_shard=cfg.word_dim,
        )
        return shapes

    # ----------------------------------------------------------------- api
    def export_params(self, state: TrainState) -> Params:
        """The synced, de-replicated tables: of the live replicas, copies
        of replica 0's on its device (a pending sync runs first, so a
        quality probe scores what the JAX trainer's does); a state
        that already holds one Params dict (what train() returns, a
        checkpoint's) as it is."""
        if isinstance(state.params, dict):
            return state.params
        if self.dp > 1 and self._last_sync_step != state.step:
            self._run_sync(state.params)
            self._last_sync_step = state.step
        return {k: v.clone() for k, v in state.params[0].items()}

    def import_params(self, params: Params, state: TrainState) -> None:
        """Unreplicated tables (a checkpoint's, a single-device run's) into
        every replica's persistent buffers, in this trainer's table layout
        (models/params.convert_params_layout converts the other one);
        the delta sync rebases and the cadence counts from state.step."""
        target = self.config.table_layout
        if params_layout(params) != target:
            params = convert_params_layout(params, target)
        state.params = self._adopt(params)
        self._last_sync_step = state.step
