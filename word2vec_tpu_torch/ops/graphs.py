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
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import seed_step
from ..models.params import FUSED_KEY, FUSED_SUBTABLES, Params, unfuse_tables
from ..obs.health import HealthStep, health_names
from . import launch
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
    place for its whole life. `replica` is the data-parallel replica the
    graph trains (parallel/trainer.py, dp > 1): its draws are the
    replica's (device.replica_seed); None for a single-device run."""

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
    ):
        self.step = step
        self.replica = replica
        self.params = params
        self.batch = batch
        self.S = S
        self.micro = step.config.micro_steps
        dev = next(iter(params.values())).device
        self.device = dev
        self.gen = torch.Generator(device=dev)
        self.alphas = torch.zeros(S, dtype=torch.float32, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        #: the rows of `out`: METRICS, then the health counters of an
        #: instrumented step (computed inside the step, so inside the graph)
        self.names = METRICS + (
            health_names(params) if isinstance(step, HealthStep) else ()
        )
        self.out = torch.zeros((len(self.names), S), dtype=torch.float32, device=dev)
        self.draws_hook: Optional[DrawsHook] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: launches of one replay, by wrapper (the capture's record)
        self.launches: Optional[Dict[str, int]] = None
        #: seconds of warm-up and capture
        self.capture_s = 0.0
        self._at = 0  # the step being run (for draws_hook)
        if graphed and dev.type == "cuda":
            self._capture(env or capture_env(dev))

    @property
    def metrics(self) -> Dict[str, torch.Tensor]:
        """{name: [S]} views of `out`, in `names` order."""
        return {k: self.out[i] for i, k in enumerate(self.names)}

    def _body(self, params: Params) -> None:
        tokens = self.batch(self.slot)
        alpha = self.alphas.index_select(0, self.slot).reshape(())
        B = tokens.shape[0]
        if B % self.micro:
            raise ValueError(
                f"batch_rows {B} not divisible by micro_steps {self.micro}"
            )
        total = None
        # micro_steps: sequential optimizer sub-steps over row blocks of
        # the batch, updates visible between them (ops/train_step.py micro
        # wrapper); the step's generator feeds them in turn
        for i, sub in enumerate(tokens.chunk(self.micro, dim=0)):
            if self.draws_hook is not None:
                at = (self._at, i) + (() if self.replica is None else (self.replica,))
                draws = self.draws_hook(*at)
            else:
                draws = self.step.draw(self.gen, sub)
            m = self.step.apply(params, sub, draws, alpha)
            total = m if total is None else {k: total[k] + m[k] for k in total}
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
            clones = {k: v.clone() for k, v in self.params.items()}
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
        seed_step(self.gen, seed, step, self.replica)
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
    (t0 + slot) * stride + replica of the epoch's order."""

    def __init__(
        self, config, tables, *, fused: Optional[bool] = None,
        graphed: bool = True,
    ):
        self.config = config
        self.fused = config.fused_tables if fused is None else fused
        self.step = make_step(config, tables, fused=self.fused)
        self.graphed = graphed
        #: (pool, stream) shared by this runner's graphs; a trainer shares
        #: one between its runners
        self.env: Optional[Tuple[object, torch.cuda.Stream]] = None
        self.draws_hook: Optional[DrawsHook] = None
        self.replica: Optional[int] = None
        self.stride = 1
        self._graphs: Dict[tuple, StepGraph] = {}
        self._slab: Optional[torch.Tensor] = None

    # ---------------------------------------------------------- fused slab
    def _buffers(self, params: Params) -> Params:
        """The params the graph updates: `params` itself, or the
        persistent fused slab."""
        if not self.fused:
            return params
        ein = params[FUSED_SUBTABLES[0]]
        shape = (ein.shape[0], 2, ein.shape[1])
        s = self._slab
        if s is None or s.shape != shape or s.dtype != ein.dtype or s.device != ein.device:
            self._slab = torch.zeros(shape, dtype=ein.dtype, device=ein.device)
        return {FUSED_KEY: self._slab}

    def run(self, g: StepGraph, params: Params, alphas, seed, step0, steps):
        """Dispatch the staged graph `g` (stage / resident_graph): steps
        step0 .. step0 + steps - 1 at `alphas`; see StepGraph.dispatch."""
        if self.fused:
            torch.stack([params[k] for k in FUSED_SUBTABLES], dim=-2, out=self._slab)
        m = g.dispatch(alphas, seed, step0, steps)
        if self.fused:
            for k, v in unfuse_tables({FUSED_KEY: self._slab}).items():
                params[k].copy_(v)
        return m

    def _cached(self, key: tuple, work: Params, make: Callable[[bool], StepGraph]):
        """The graph of `key` over `work`, made by make(graphed) on first use."""
        key = key + tuple(v.data_ptr() for v in work.values())
        g = self._graphs.get(key)
        if g is None:
            dev = next(iter(work.values())).device
            graphed = self.graphed and dev.type == "cuda"
            if graphed and self.env is None:
                self.env = capture_env(dev)
            g = self._graphs[key] = make(graphed)
        g.draws_hook = self.draws_hook
        return g

    # ----------------------------------------------------------- streaming
    def stream_graph(self, params: Params, shape: Tuple[int, int, int]) -> StepGraph:
        """The graph for [S, B, L] token chunks, captured on first use."""
        S, B, L = shape
        work = self._buffers(params)

        def make(graphed):
            dev = next(iter(work.values())).device
            tokens = torch.full((S, B, L), -1, dtype=torch.int32, device=dev)
            g = StepGraph(
                self.step, work,
                lambda slot: tokens.index_select(0, slot).reshape(B, L), S,
                graphed=graphed, env=self.env, replica=self.replica,
            )
            g.tokens = tokens
            return g

        return self._cached(("stream", S, B, L), work, make)

    def stage(self, params: Params, tokens) -> StepGraph:
        """The graph for `tokens` [S, B, L] with them copied into its
        static input (the host-to-device leg of a dispatch; no host sync)."""
        g = self.stream_graph(params, tuple(tokens.shape))
        copy_in(g.tokens, tokens)
        return g

    def __call__(self, params: Params, tokens, seed: int, step0: int, alphas,
                 steps: Optional[int] = None) -> Dict[str, torch.Tensor]:
        g = self.stage(params, tokens)
        return self.run(g, params, alphas, seed, step0, steps)
