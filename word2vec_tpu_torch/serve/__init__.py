"""Embedding serving for the PyTorch port (word2vec_tpu/serve/ in the JAX
package).

Training exports tables; this package answers queries against them:

  query.py   — QueryEngine: a row-normalized table resident on the engine's
               device (the card unless the caller asks for the CPU; f32 or
               bf16, int8 files dequantize on load) and one batched top-k
               behind every similarity / neighbor / analogy query. eval/
               runs on the same engine.
  server.py  — asyncio HTTP/JSON server: request coalescing into padded
               device batches, an LRU result cache, bounded-queue load
               shedding (429), graceful SIGTERM drain (exit 0, or
               EXIT_PREEMPTED=75 past the drain deadline), serve metrics
               through obs/export.MetricsHub, request/batch spans on the
               flight recorder's TraceRing, and FaultPlan chaos hooks.
  __main__   — `python -m word2vec_tpu_torch.serve --vectors vec.txt ...`
"""

from .query import QueryEngine, get_engine, unit_norm  # noqa: F401
