"""One optimizer step over static buffers, replayed as a CUDA graph.

The counterpart of the JAX package's jit_train_step (and, S at a time, of
the lax.scan in make_chunk_runner): XLA compiles a step into one program,
which the host dispatches with one call; here a `StepGraph` captures one
optimizer step, all of its micro sub-steps included, as one CUDA graph,
and every replay is one step. A replay costs the host a few microseconds,
where the same step issued eagerly from Python costs ~100 launches.

Static buffers (allocated once; the graph reads and writes them at every
replay, whatever Python values they held at capture):
  inputs   `alphas` [S] f32, the learning rate of each step of a chunk;
           `slot` [1] int64, the step's index in the chunk (each step
           advances it); whatever `batch(slot)` reads: the chunk's tokens
           [S, B, L] (ops/train_step.make_chunk_runner) or the resident
           corpus, the epoch's row order and the chunk's first batch index
           (ops/resident.make_resident_chunk_runner);
  outputs  `out` [len(names), S] f32: loss_sum, pairs, clip_engaged,
           nonfinite_loss and hs_tail_dropped of each step (METRICS
           order), then, with config.health_metrics, the health counters
           of obs/health.instrument_step (obs/health.health_names: the
           step's alpha_sum, grad_sq, nonfinite_params and update_sq_<table>),
           written into the step's slot;
  state    the params, updated in place (the JAX package donates them).
The step's draws come from a private generator that `run` re-seeds with
device.step_seed(run seed, step) before each step; the graph registers it,
so every replay reads the new seed (CUDAGraph.register_generator_state).

Capture: one warm-up step runs eagerly on the capture stream on CLONES of
the params (every kernel, cuBLAS and the sort workspaces meet the stream
once; the run's params do not move and no step is counted), then the step
is captured on the trainer's private capture stream in "thread_local"
error mode: a host sync or another unsafe call in the step fails the
capture instead of being baked in, while other threads of the process
(a query engine serving on the same card while the streaming driver
captures again after a vocabulary growth) go on with their own device
work, which no capture records. A capture that fails raises; nothing
falls back to eager. On the CPU, or with graphed=False, `run` calls the
same step eagerly.

Tensor parallelism (parallel/trainer.py, tp > 1): a graph trains one
replica's tp shards, each its own dict of [V, d/tp] tables. Every micro
sub-step draws once and runs the tp shard bodies in lockstep (ops/
shards.lockstep: the shard-order sums at the psum sites on shard 0's
device), so all of a replica's shards, their sums included, are one
captured graph when they share a card. A replica whose shards sit on
different devices (two cards; a card and the CPU) is not captured: its
steps run eagerly, the draws, tokens and sums copied between the devices
(`StepGraph.split` says so, and the trainer's run manifest records it).
The step's metrics are then the JAX trainer's model-axis contract
psum(v, model) / tp over the shards' micro-summed metrics.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import seed_step
from ..models.params import FUSED_KEY, FUSED_SUBTABLES, Params, unfuse_tables
from ..obs.health import HealthStep, health_names
from . import launch
from .shards import lockstep, shard_sum
from .steps import make_step
from .train_step import Draws

#: the metrics of a step, in the rows of StepGraph.out, each summed over
#: the step's micro sub-steps (nonfinite_loss: the sub-steps whose loss_sum
#: is not finite; hs_tail_dropped: the two-tier hs tail slots dropped by
#: compaction, 0 on every other route; ops/train_step.finish_metrics),
#: computed inside the captured step. Readers take them by name.
METRICS = ("loss_sum", "pairs", "clip_engaged", "nonfinite_loss", "hs_tail_dropped")

#: slot [1] int64 -> the step's tokens [B, L] int32
BatchFn = Callable[[torch.Tensor], torch.Tensor]
#: (step, micro sub-step) -> the draws to use (a test hook, eager only);
#: a data-parallel replica's graph calls it as (step, sub-step, replica)
DrawsHook = Callable[..., Draws]


def capture_env(device: torch.device) -> Tuple[object, torch.cuda.Stream]:
    """(memory pool, capture stream) for the graphs of one trainer: its
    graphs share one pool (they never run concurrently, and every tensor
    that outlives a replay is a static buffer outside the pool) and one
    stream (the pool's allocations belong to it)."""
    return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)


def _on_device(draws: Draws, dev: torch.device) -> Draws:
    """`draws` with every tensor on `dev` (the tensors themselves where
    they are there already)."""
    def to(t):
        return t if t is None or t.device == dev else t.to(dev)

    sr = None if draws.sr is None else tuple(to(u) for u in draws.sr)
    return Draws(to(draws.u_sub), to(draws.w_eff), to(draws.negs), sr)


def shard_list(params) -> List[Params]:
    """The tp shards of a replica: a list of shard dicts as it is, one
    Params dict as a list of one."""
    return params if isinstance(params, list) else [params]


def copy_in(dst: torch.Tensor, src) -> None:
    """dst <- src (numpy, or a tensor on any device) on the current stream,
    without a host sync: a host source on its way to the card goes through
    page-locked memory, whose caching allocator keeps the buffer from
    being refilled until the copy has landed."""
    if isinstance(src, np.ndarray):
        src = torch.from_numpy(src)
    if dst.is_cuda and src.device.type == "cpu" and not src.is_pinned():
        src = src.pin_memory()
    dst.copy_(src, non_blocking=True)


class StepGraph:
    """One optimizer step (config.micro_steps sub-steps) over static
    buffers; see the module docstring. `step` is any step of the router
    (ops/steps.make_step: BandStep, HsStep, PairStep), all with the
    draw / apply contract. `params` are the tensors the graph updates in
    place for its whole life: one Params dict, or a replica's list of tp
    shard dicts (shard t the step's d/tp slice; `step` is then a shard's
    step, make_step(..., tp=tp)). `replica` is the replica the graph
    trains (parallel/trainer.py; None for a single-device run): the third
    argument of draws_hook. `fold` = (data, seq) re-seeds the draws
    (device.seed_step: the data replica's fold at dp > 1, the sequence
    shard's at sp > 1); by default (replica, None). `shard_steps` gives
    each shard its step when the shards sit on different devices (each
    step reads its own device's frequency tables); by default `step`
    serves every shard."""

    def __init__(
        self,
        step,
        params: Params,
        batch: BatchFn,
        S: int,
        *,
        graphed: bool,
        env: Optional[Tuple[object, torch.cuda.Stream]] = None,
        replica: Optional[int] = None,
        fold: Optional[Tuple[Optional[int], Optional[int]]] = None,
        shard_steps: Optional[list] = None,
    ):
        self.step = step
        self.replica = replica
        self.fold = (replica, None) if fold is None else tuple(fold)
        self.params = params
        self.shards = shard_list(params)
        self.shard_steps = shard_steps or [step] * len(self.shards)
        self.batch = batch
        self.S = S
        self.micro = step.config.micro_steps
        devs = [next(iter(p.values())).device for p in self.shards]
        dev = devs[0]
        self.device = dev
        #: the device of each tp shard; `split`: they differ, and the
        #: replica's steps run eagerly (no graph spans two devices)
        self.shard_devices = devs
        self.split = any(d != dev for d in devs)
        self.gen = torch.Generator(device=dev)
        self.alphas = torch.zeros(S, dtype=torch.float32, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        #: the rows of `out`: METRICS, then the health counters of an
        #: instrumented step (computed inside the step, so inside the graph)
        self.names = METRICS + (
            health_names(self.shards[0]) if isinstance(step, HealthStep) else ()
        )
        self.out = torch.zeros((len(self.names), S), dtype=torch.float32, device=dev)
        self.draws_hook: Optional[DrawsHook] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: launches of one replay, by wrapper (the capture's record)
        self.launches: Optional[Dict[str, int]] = None
        #: seconds of warm-up and capture
        self.capture_s = 0.0
        self._at = 0  # the step being run (for draws_hook)
        if graphed and dev.type == "cuda" and not self.split:
            self._capture(env or capture_env(dev))

    @property
    def metrics(self) -> Dict[str, torch.Tensor]:
        """{name: [S]} views of `out`, in `names` order."""
        return {k: self.out[i] for i, k in enumerate(self.names)}

    def _apply(self, shards: List[Params], tokens, draws: Draws, alpha):
        """One sub-step on every shard: the step alone on one shard, the
        shards' bodies in lockstep on several (inputs copied to each
        shard's device). Returns each shard's metrics, in shard order."""
        if len(shards) == 1:
            return [self.step.apply(shards[0], tokens, draws, alpha)]
        bodies = []
        for p, dev, step in zip(shards, self.shard_devices, self.shard_steps):
            if dev == self.device:
                bodies.append(step.body(p, tokens, draws, alpha))
            else:
                bodies.append(step.body(
                    p, tokens.to(dev), _on_device(draws, dev), alpha.to(dev)))
        return lockstep(bodies, self.device)

    def _body(self, params) -> None:
        shards = shard_list(params)
        tokens = self.batch(self.slot)
        alpha = self.alphas.index_select(0, self.slot).reshape(())
        B = tokens.shape[0]
        if B % self.micro:
            raise ValueError(
                f"batch_rows {B} not divisible by micro_steps {self.micro}"
            )
        totals = None
        # micro_steps: sequential optimizer sub-steps over row blocks of
        # the batch, updates visible between them (ops/train_step.py micro
        # wrapper); the step's generator feeds them in turn, one draw for
        # every shard of the replica
        for i, sub in enumerate(tokens.chunk(self.micro, dim=0)):
            if self.draws_hook is not None:
                at = (self._at, i) + (() if self.replica is None else (self.replica,))
                draws = self.draws_hook(*at)
            else:
                draws = self.step.draw(self.gen, sub)
            ms = self._apply(shards, sub, draws, alpha)
            totals = ms if totals is None else [
                {k: t[k] + m[k] for k in t} for t, m in zip(totals, ms)
            ]
        if len(shards) == 1:
            total = totals[0]
        else:
            # the JAX trainer's metrics contract over the model axis:
            # psum(v, model) / tp of each shard's micro-summed metrics
            tp = len(shards)
            total = {
                k: shard_sum([t[k] for t in totals], self.device) / tp
                for k in totals[0]
            }
        vals = torch.stack([total[k].float() for k in self.names]).reshape(-1, 1)
        self.out.index_copy_(1, self.slot, vals)
        self.slot.add_(1)

    def _capture(self, env) -> None:
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "capturing the step needs torch.cuda.CUDAGraph."
                "register_generator_state (the step draws from a private "
                f"generator); torch {torch.__version__} has none"
            )
        pool, side = env
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            clones = [{k: v.clone() for k, v in p.items()} for p in self.shards]
            self._body(clones)  # warm-up: trains the clones only
            self.slot.zero_()
            self.out.zero_()
        cur.wait_stream(side)
        del clones
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        with launch.recording() as rec:
            with torch.cuda.graph(
                graph, pool=pool, stream=side, capture_error_mode="thread_local"
            ):
                self._body(self.params)
        torch.cuda.synchronize(self.device)
        self.graph, self.launches = graph, dict(rec)
        self.capture_s = time.perf_counter() - t0

    def run(self, seed: int, step: int) -> None:
        """Optimizer step `step` of the run seeded `seed`, in the next slot."""
        seed_step(self.gen, seed, step, *self.fold)
        self._at = step
        if self.graph is not None:
            if self.draws_hook is not None:
                raise ValueError("draws_hook runs the step eagerly only")
            self.graph.replay()
            launch.add_counts(self.launches)
        else:
            self._body(self.params)

    def dispatch(
        self, alphas, seed: int, step0: int, steps: Optional[int] = None
    ) -> Dict[str, torch.Tensor]:
        """Steps step0 .. step0 + steps - 1 in slots 0 .. steps - 1, slot i
        at alphas[i]; slots past `steps` (a chunk's pad steps, provable
        no-ops) are skipped and read 0. No host sync. Returns `metrics`,
        which the next dispatch overwrites."""
        steps = self.S if steps is None else steps
        if not 0 <= steps <= self.S:
            raise ValueError(f"{steps} steps do not fit a chunk of {self.S}")
        self.slot.zero_()
        if steps < self.S:
            self.out.zero_()
        copy_in(self.alphas, alphas)
        for i in range(steps):
            self.run(seed, step0 + i)
        return self.metrics


class ChunkRunner:
    """S sequential optimizer steps a call, over a StepGraph of S slots
    (ops/train_step.make_chunk_runner; the streaming path):

        runner(params, tokens [S, B, L], seed, step0, alphas [S], steps=None)
            -> {"loss_sum": [S], "pairs": [S], "clip_engaged": [S],
                "nonfinite_loss": [S]}

    Step i runs on tokens[i] at alphas[i] with the draws of step step0 + i
    of the run seeded `seed` (device.step_seed), exactly as the per-step
    driver does, so chunked and per-step training give the same
    trajectory. Only the first `steps` slots run: a padded trailing
    chunk's all-PAD batches are provable no-ops, skipped. params are
    updated in place; the runner captures one graph per params and chunk
    shape and copies each call's inputs into its static buffers. The
    metrics are device tensors that the next call overwrites.

    fused (default config.fused_tables): the two split tables are
    restacked into one persistent [V, 2, d] slab (copy_, the layout of
    models/params.fuse_tables) for the chunk's lifetime and unstacked at
    its end, so the steps scatter each sorted id set once at doubled
    width; the trajectory is bitwise the unfused one.

    `draws_hook(step, sub)`, when set, supplies each sub-step's draws
    instead of the generator (tests feed the JAX package's draws; eager
    runs only).

    `replica` (None, or the replica index at dp > 1) and `stride` (the
    data-parallel width) place the runner's graphs in a data-parallel
    trainer (parallel/trainer.py): the replica's draws, its hook called as
    draws_hook(step, sub, replica), and on the resident path the batches
    (t0 + slot) * stride + replica of the epoch's order. Under sequence
    parallelism the trainer also sets `block` (the replica's data index,
    its row block), `fold` (the (data, seq) folds of its draws,
    StepGraph) and `halo` = (s, sp): the resident batch is then sequence
    shard s's haloed slice of the row block (ops/shards.halo_exchange).
    tp / sp > 1 build the step of one tensor-parallel shard and one
    sequence shard (ops/steps.make_step); the params handed to the runner
    are then a replica's list of tp shard dicts, and `shard_tables` (set
    by the trainer) the frequency tables on each shard's device."""

    def __init__(
        self, config, tables, *, fused: Optional[bool] = None,
        graphed: bool = True, tp: int = 1, sp: int = 1,
    ):
        self.config = config
        self.fused = config.fused_tables if fused is None else fused
        self.step = make_step(config, tables, fused=self.fused, tp=tp, sp=sp)
        self._step_kw = dict(fused=self.fused, tp=tp, sp=sp)
        self.shard_tables: Optional[list] = None
        self.graphed = graphed
        #: (pool, stream) shared by this runner's graphs; a trainer shares
        #: one between its runners
        self.env: Optional[Tuple[object, torch.cuda.Stream]] = None
        self.draws_hook: Optional[DrawsHook] = None
        self.replica: Optional[int] = None
        self.stride = 1
        self.block: Optional[int] = None
        self.fold: Optional[Tuple[Optional[int], Optional[int]]] = None
        self.halo: Optional[Tuple[int, int]] = None
        self._graphs: Dict[tuple, StepGraph] = {}
        self._slabs: List[torch.Tensor] = []

    # ---------------------------------------------------------- fused slab
    def _buffers(self, params):
        """The params the graph updates: `params` itself, or the
        persistent fused slab (one a tp shard)."""
        if not self.fused:
            return params
        shards = shard_list(params)
        slabs = []
        for i, p in enumerate(shards):
            ein = p[FUSED_SUBTABLES[0]]
            shape = (ein.shape[0], 2, ein.shape[1])
            s = self._slabs[i] if i < len(self._slabs) else None
            if s is None or s.shape != shape or s.dtype != ein.dtype or s.device != ein.device:
                s = torch.zeros(shape, dtype=ein.dtype, device=ein.device)
            slabs.append(s)
        self._slabs = slabs
        work = [{FUSED_KEY: s} for s in slabs]
        return work if isinstance(params, list) else work[0]

    def run(self, g: StepGraph, params, alphas, seed, step0, steps):
        """Dispatch the staged graph `g` (stage / resident_graph): steps
        step0 .. step0 + steps - 1 at `alphas`; see StepGraph.dispatch."""
        shards = shard_list(params)
        if self.fused:
            for p, slab in zip(shards, self._slabs):
                torch.stack([p[k] for k in FUSED_SUBTABLES], dim=-2, out=slab)
        m = g.dispatch(alphas, seed, step0, steps)
        if self.fused:
            for p, slab in zip(shards, self._slabs):
                for k, v in unfuse_tables({FUSED_KEY: slab}).items():
                    p[k].copy_(v)
        return m

    def shard_steps(self) -> Optional[list]:
        """Each shard's step when shard_tables puts a shard on another
        device than the runner's step (one step a device)."""
        if self.shard_tables is None:
            return None
        by_tables = {id(self.step.tables): self.step}
        return [
            by_tables.setdefault(id(tb), make_step(self.config, tb, **self._step_kw))
            for tb in self.shard_tables
        ]

    def _cached(self, key: tuple, work, make: Callable[[bool], StepGraph]):
        """The graph of `key` over `work`, made by make(graphed) on first use."""
        key = key + tuple(v.data_ptr() for p in shard_list(work) for v in p.values())
        g = self._graphs.get(key)
        if g is None:
            dev = next(iter(shard_list(work)[0].values())).device
            graphed = self.graphed and dev.type == "cuda"
            if graphed and self.env is None:
                self.env = capture_env(dev)
            g = self._graphs[key] = make(graphed)
        g.draws_hook = self.draws_hook
        return g

    # ----------------------------------------------------------- streaming
    def stream_graph(self, params, shape: Tuple[int, int, int]) -> StepGraph:
        """The graph for [S, B, L] token chunks, captured on first use (L
        is a sequence shard's haloed Lloc + 2W under sequence
        parallelism)."""
        S, B, L = shape
        work = self._buffers(params)

        def make(graphed):
            dev = next(iter(shard_list(work)[0].values())).device
            tokens = torch.full((S, B, L), -1, dtype=torch.int32, device=dev)
            g = StepGraph(
                self.step, work,
                lambda slot: tokens.index_select(0, slot).reshape(B, L), S,
                graphed=graphed, env=self.env, replica=self.replica,
                fold=self.fold, shard_steps=self.shard_steps(),
            )
            g.tokens = tokens
            return g

        return self._cached(("stream", S, B, L), work, make)

    def stage(self, params, tokens) -> StepGraph:
        """The graph for `tokens` [S, B, L] with them copied into its
        static input (the host-to-device leg of a dispatch; no host sync)."""
        g = self.stream_graph(params, tuple(tokens.shape))
        copy_in(g.tokens, tokens)
        return g

    def __call__(self, params, tokens, seed: int, step0: int, alphas,
                 steps: Optional[int] = None) -> Dict[str, torch.Tensor]:
        g = self.stage(params, tokens)
        return self.run(g, params, alphas, seed, step0, steps)
