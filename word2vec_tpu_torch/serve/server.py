"""Async embedding server: coalesced batches, LRU cache, shed, drain, chaos.

A port of word2vec_tpu/serve/server.py onto the port's QueryEngine: the
same routes, status codes, JSON bodies, `w2v_serve_*` metric names,
coalescing, cache, shedding, drain and exit codes. The batch runs in an
executor thread on the engine's device (set explicitly: a thread's
default CUDA device is not the engine's), and an allocation failure is
recognized by its type, torch.OutOfMemoryError, which both a real CUDA
OOM and the injected `oom` fault raise.

Stdlib-asyncio HTTP/1.1 + JSON (the container bakes no web framework; the
protocol surface is 5 routes and hand-parsing it keeps the dependency set
at zero):

    GET  /healthz                      liveness + table shape
    GET  /stats                        ServeStats snapshot as JSON
    GET  /metrics                      Prometheus text exposition
    GET  /v1/neighbors?word=w&k=10     curl-friendly single queries
         /v1/analogy?a=&b=&c=&k=5
         /v1/similarity?w1=&w2=
    POST /v1/query                     {"op": ...} or {"queries": [...]}

Request lifecycle — the tentpole mechanics:

  COALESCING  Query items land on one asyncio queue. The batcher takes the
  first item, keeps collecting for `coalesce_ms` (or until `max_batch`),
  then runs ONE padded device batch through the shared QueryEngine kernel
  in a worker thread (neighbors and analogies pack into the same [B, 3]
  ids+weights batch; similarities ride along as a pair-dot). The window
  trades p50 (queries wait for the window) against throughput (bigger
  matmuls, fewer dispatches) — PERF.md banks the tradeoff.

  CACHE  (op, words, k) hits return immediately and never enter the queue.

  SHEDDING  More than `max_pending` queued+running queries -> 429 with
  Retry-After, counted in `serve_shed_429_total`. A bounded queue keeps
  tail latency honest under overload instead of growing it unboundedly.

  DRAIN  SIGTERM (or `begin_drain()`) stops accepting connections, lets
  every accepted request finish, flushes sinks, exports the trace, dumps
  flight.json, exits 0. Past `drain_deadline_s` (or on a second signal) it
  exits EXIT_PREEMPTED=75 — the same requeue contract training uses
  (resilience/shutdown). SIGUSR1 dumps flight_usr1.json without stopping
  (resilience/shutdown.install_usr1_dump, shared with the trainers).

  CHAOS  `--faults` reuses resilience/faults.FaultPlan with the serve kinds
  {stall, hang, sigterm, oom}: stall/hang sleep in the batch executor (a
  slow device — the event loop, healthz, and shedding stay live), sigterm
  kills mid-request (the drain drill), and oom raises a
  torch.OutOfMemoryError the server absorbs as 503s for that batch while
  staying up, as it does a real CUDA allocation failure.

Observability: every request and batch is an 'X' span on the flight
recorder's TraceRing (`--trace DIR` exports a schema-valid Chrome-trace
doc; crash/drain paths dump flight.json), and ServeStats snapshots flow
through obs/export.MetricsHub to Prometheus gauges `w2v_serve_*`.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import json
import os
import signal
import time
import urllib.parse
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..obs.export import EVENT_COUNTERS, MetricsHub, PrometheusTextfile
from ..obs.flight import FlightRecorder
from ..obs.trace import chrome_trace_doc, write_trace
from ..resilience import faults as faults_mod
from ..resilience.shutdown import EXIT_PREEMPTED
from .metrics import LRUCache, ServeStats
from .query import QueryEngine, _next_pow2

#: fault kinds a serve FaultPlan may carry (resilience/faults.py); training
#: kinds that poison params or SIGKILL (nan, peer_dead) are rejected loudly
#: at startup instead of misfiring mid-request
SERVE_FAULT_KINDS = ("stall", "hang", "sigterm", "oom")

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 429: "Too Many Requests",
            500: "Internal Server Error", 503: "Service Unavailable",
            504: "Gateway Timeout"}


class _MemoryProm(PrometheusTextfile):
    """A PrometheusTextfile that never touches disk: the `/metrics`
    endpoint's backing store when no --metrics-dir/--prom-textfile is
    configured (render() is shared with the file-backed sink)."""

    def __init__(self):
        self.path = ""
        self._gauges = {}
        self._counters = {name: 0.0 for name in EVENT_COUNTERS.values()}
        self._hists = {}

    def _write(self) -> None:  # no file behind it
        pass


@dataclasses.dataclass
class ServeConfig:
    host: str = "127.0.0.1"
    port: int = 0                    # 0 = ephemeral (the bound port is
    coalesce_ms: float = 2.0         # printed in the ready line)
    max_batch: int = 256
    max_pending: int = 1024
    cache_size: int = 4096
    max_k: int = 100
    default_k: int = 10
    request_timeout_s: float = 30.0
    drain_deadline_s: float = 10.0
    stats_every_s: float = 5.0
    #: derived-signal window seconds (obs/signals.py serve mode): each
    #: closed wall-clock window emits one serve_qps/serve_p99_ms/cache_hit
    #: signal row into signals_p<pid>.jsonl under metrics_dir — the
    #: standalone fleet aggregator (python -m word2vec_tpu.obs.fleet)
    #: merges replica rows by epoch-derived window id. 0 disables.
    signal_window_s: float = 10.0
    metrics_dir: Optional[str] = None
    prom_textfile: Optional[str] = None
    trace_dir: Optional[str] = None
    faults: Optional[object] = None  # resilience.faults.FaultPlan
    install_signals: bool = False
    #: records fed into the metrics hub at construction (before the first
    #: request): the serve CLI's startup quality probe publishes its
    #: w2v_quality_* gauges + probe counter here, so a table exported
    #: mid-training serves its measured quality on /metrics from request 0
    startup_records: Optional[list] = None


class _Shed(Exception):
    """Control-flow for refused queries: (status, error message)."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


@dataclasses.dataclass
class _WorkItem:
    op: str                        # neighbors | analogy | similarity
    ids: np.ndarray                # [3] (topk) or [2] (similarity)
    weights: Optional[np.ndarray]  # [3] for topk, None for similarity
    k: int
    future: "asyncio.Future"
    enq: float                     # perf_counter at enqueue
    cache_key: Tuple = ()          # populated by _admit


class _FaultState:
    """The FaultPlan.on_step shim: serve batches stand in for optimizer
    steps. params stays None — the allowed serve kinds never touch it."""

    def __init__(self, step: int):
        self.step = step
        self.params = None


class EmbeddingServer:
    """One engine, one coalescing batcher, one asyncio listener."""

    def __init__(self, engine: QueryEngine, config: Optional[ServeConfig] = None):
        self.engine = engine
        self.cfg = config or ServeConfig()
        if self.cfg.max_batch > engine.MAX_BATCH_BUCKET:
            raise ValueError(
                f"max_batch {self.cfg.max_batch} exceeds the engine's "
                f"batch bucket cap {engine.MAX_BATCH_BUCKET}"
            )
        plan = self.cfg.faults
        if plan is not None:
            bad = [f.kind for f in plan.faults
                   if f.kind not in SERVE_FAULT_KINDS]
            if bad:
                raise ValueError(
                    f"fault kind(s) {bad} not servable (serve supports: "
                    f"{', '.join(SERVE_FAULT_KINDS)})"
                )
        self.stats = ServeStats()
        self.cache = LRUCache(self.cfg.cache_size)
        self.flight = FlightRecorder()
        self.hub = MetricsHub()
        if self.cfg.prom_textfile:
            self.prom = self.hub.add(PrometheusTextfile(self.cfg.prom_textfile))
        elif self.cfg.metrics_dir:
            os.makedirs(self.cfg.metrics_dir, exist_ok=True)
            self.prom = self.hub.add(PrometheusTextfile(
                os.path.join(self.cfg.metrics_dir, "serve.prom")))
        else:
            self.prom = self.hub.add(_MemoryProm())
        if self.cfg.metrics_dir:
            from ..utils.logging import jsonl_logger

            self.hub.add(jsonl_logger(
                os.path.join(self.cfg.metrics_dir, "serve_metrics.jsonl")))
        # derived-signal plane, serve mode (obs/signals.py): windowed
        # serve_qps / serve_p99_ms / cache_hit rows for the replica fleet
        # aggregator, keyed on epoch seconds (replicas share no step
        # counter; NTP-grade alignment is enough for aggregation)
        self.signals = None
        if self.cfg.signal_window_s:
            from ..obs.signals import SignalEngine

            self.signals = SignalEngine(
                window_s=self.cfg.signal_window_s,
                metrics_dir=self.cfg.metrics_dir,
                host=os.getpid(),
                flight=self.flight,
                log_fn=self.hub,
            )
        for rec in self.cfg.startup_records or []:
            self.hub(dict(rec))
        self.port: Optional[int] = None
        self.exit_reason: Optional[str] = None
        self._draining = False
        self._busy = 0          # requests read but not yet fully responded
        self._queued = 0        # query items enqueued but unresolved
        self._batch_no = 0
        self._conns: set = set()
        self._usr1_uninstall = lambda: None

    # ----------------------------------------------------------- lifecycle
    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._loop = loop
        self._done: "asyncio.Future" = loop.create_future()
        self._queue: "asyncio.Queue" = asyncio.Queue()
        # event faults (oom) are consulted through the module-level active
        # plan, same as training's checkpoint injection point
        self._prev_plan = (faults_mod.activate(self.cfg.faults)
                           if self.cfg.faults is not None else None)
        self._server = await asyncio.start_server(
            self._client, self.cfg.host, self.cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._batcher_task = loop.create_task(self._batcher_main())
        self._stats_task = loop.create_task(self._stats_loop())
        if self.cfg.install_signals:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    loop.add_signal_handler(sig, self.begin_drain)
                except (NotImplementedError, RuntimeError, ValueError):
                    pass
            if self.cfg.metrics_dir:
                from ..resilience.shutdown import install_usr1_dump

                self._usr1_uninstall = install_usr1_dump(
                    self.cfg.metrics_dir, flight=self.flight)

    async def run(self) -> int:
        """Serve until drained/failed; returns the process exit code
        (0 = clean drain, EXIT_PREEMPTED=75 = forced, 1 = crash)."""
        if self.port is None:
            await self.start()
        code = await self._done
        await self._shutdown(code)
        return code

    def begin_drain(self) -> None:
        """First call: stop accepting, finish in-flight, then exit 0.
        Second call (the operator's second SIGTERM): stop waiting, exit
        EXIT_PREEMPTED now — mirroring ShutdownHandler's escalation."""
        if self._draining:
            self._finish(EXIT_PREEMPTED, "forced")
            return
        self._draining = True
        self._server.close()
        self._loop.create_task(self._drain_task())

    async def _drain_task(self) -> None:
        deadline = self._loop.time() + self.cfg.drain_deadline_s
        while self._loop.time() < deadline:
            if self._busy == 0 and self._queued == 0:
                self._finish(0, "drained")
                return
            await asyncio.sleep(0.01)
        self._finish(EXIT_PREEMPTED, "drain_deadline")

    def _finish(self, code: int, reason: str) -> None:
        if not self._done.done():
            self.exit_reason = reason
            self._done.set_result(code)

    async def _shutdown(self, code: int) -> None:
        await self._queue.put(None)  # batcher stop sentinel
        self._stats_task.cancel()
        for t in (self._batcher_task, self._stats_task):
            try:
                await asyncio.wait_for(t, 5.0)
            except (asyncio.CancelledError, asyncio.TimeoutError):
                pass
        self._usr1_uninstall()
        if self.cfg.faults is not None:
            faults_mod.activate(self._prev_plan)
        for w in list(self._conns):
            try:
                w.close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._publish_stats(final=True)
        self.hub.close()
        if self.cfg.trace_dir:
            doc = chrome_trace_doc(
                self.flight.ring.events(), process_name="serve",
                metadata={"serve": True, "exit_reason": self.exit_reason},
                origin_unix_s=self.flight.ring.wall0,
            )
            write_trace(os.path.join(self.cfg.trace_dir, "trace.json"), doc)
        if self.cfg.metrics_dir:
            # ALWAYS leave a flight: the chaos drill's contract is "drain
            # or 75, with a flight.json present" either way
            reason = {0: "drained"}.get(code, "preempted")
            self.flight.dump(
                self.cfg.metrics_dir, reason,
                extra={"exit_code": code, "exit_reason": self.exit_reason,
                       "stats": self.stats.snapshot(self.cache)},
            )

    # ----------------------------------------------------------- batching
    async def _batcher_main(self) -> None:
        try:
            await self._batcher()
        except Exception as e:  # noqa: BLE001 — batcher death = server down
            if self.cfg.metrics_dir:
                self.flight.dump(self.cfg.metrics_dir, "serve_crash",
                                 extra={"error": repr(e)})
            self._finish(1, f"batcher_crash: {e!r}")

    async def _batcher(self) -> None:
        loop = self._loop
        window = max(0.0, self.cfg.coalesce_ms) / 1e3
        while True:
            item = await self._queue.get()
            if item is None:
                return
            batch = [item]
            if window > 0 and self.cfg.max_batch > 1:
                deadline = loop.time() + window
                while len(batch) < self.cfg.max_batch:
                    left = deadline - loop.time()
                    if left <= 0:
                        break
                    try:
                        nxt = await asyncio.wait_for(self._queue.get(), left)
                    except asyncio.TimeoutError:
                        break
                    if nxt is None:
                        await self._queue.put(None)
                        break
                    batch.append(nxt)
            else:
                while len(batch) < self.cfg.max_batch:
                    try:
                        nxt = self._queue.get_nowait()
                    except asyncio.QueueEmpty:
                        break
                    if nxt is None:
                        await self._queue.put(None)
                        break
                    batch.append(nxt)
            self._batch_no += 1
            step = self._batch_no
            t0 = time.perf_counter()
            try:
                results = await loop.run_in_executor(
                    None, self._run_batch, step, batch)
            except Exception as e:  # noqa: BLE001 — fail THIS batch, serve on
                oom = isinstance(e, torch.OutOfMemoryError)
                msg = ("allocation failure (device out of memory): " if oom
                       else "batch execution failed: ") + str(e)
                self.flight.log_record(
                    {"event": "serve_batch_error", "step": step, "error": msg})
                results = {id(it): _Shed(503, msg) for it in batch}
            dur = time.perf_counter() - t0
            topk_n = sum(1 for it in batch if it.weights is not None)
            self.stats.observe_batch(len(batch), _next_pow2(max(1, topk_n)))
            self.flight.note_step(step, t0, dur, kind="step",
                                  fill=len(batch))
            for it in batch:
                res = results.get(id(it))
                if it.future.done():    # request timed out / cancelled
                    continue
                if isinstance(res, Exception):
                    it.future.set_exception(res)
                else:
                    it.future.set_result(res)

    def _run_batch(self, step: int, batch: List[_WorkItem]) -> Dict[int, Dict]:
        """Executor-thread body: fault hooks + the device batch. A raised
        exception fails the WHOLE batch (the caller converts to 503s)."""
        dev = self.engine.table.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return self._run_batch_on_device(step, batch)

    def _run_batch_on_device(self, step: int,
                             batch: List[_WorkItem]) -> Dict[int, Dict]:
        plan = self.cfg.faults
        if plan is not None:
            plan.on_step(_FaultState(step))   # stall / hang / sigterm
        faults_mod.raise_if_active("oom", where=f"serve_batch {step}")
        out: Dict[int, Dict] = {}
        topk = [it for it in batch if it.weights is not None]
        sims = [it for it in batch if it.weights is None]
        if topk:
            ids = np.stack([it.ids for it in topk])
            w = np.stack([it.weights for it in topk])
            kmax = max(it.k for it in topk)
            for it, (idx, sc) in zip(topk,
                                     self.engine.batch_topk(ids, w, kmax)):
                pairs = self.engine._decode(idx[: it.k], sc[: it.k])
                out[id(it)] = {"neighbors": [[wd, s] for wd, s in pairs]}
        if sims:
            ij = np.stack([it.ids for it in sims])
            cos = self.engine.pair_cosines(ij[:, 0], ij[:, 1])
            for it, c in zip(sims, cos):
                out[id(it)] = {"similarity": float(c)}
        return out

    # ------------------------------------------------------------ queries
    async def handle_query(self, q: Dict) -> Tuple[int, Dict]:
        """One query dict -> (status, payload).

        Raises nothing: every failure mode is a status + error payload
        (OOV 404, malformed 400, shed 429, draining/failed-batch 503,
        timeout 504)."""
        t0 = time.perf_counter()
        op = q.get("op")
        status, payload = 200, {}
        try:
            key, item = self._admit(q)
            if item is None:       # cache hit
                payload = dict(key)
            else:
                self._queued += 1
                self.stats.adjust_inflight(1)
                try:
                    payload = await asyncio.wait_for(
                        item.future, self.cfg.request_timeout_s)
                except asyncio.TimeoutError:
                    raise _Shed(504, "query timed out in the batch queue")
                finally:
                    self._queued -= 1
                    self.stats.adjust_inflight(-1)
                self.cache.put(item.cache_key, dict(payload))
                payload = dict(payload)
            payload["op"] = op
        except KeyError as e:
            status, payload = 404, {"op": op, "error": str(e).strip('"')}
        except _Shed as e:
            status, payload = e.status, {"op": op, "error": str(e)}
        except ValueError as e:
            status, payload = 400, {"op": op, "error": str(e)}
        dur = time.perf_counter() - t0
        self.stats.observe_request(str(op), dur, error=status != 200)
        self.flight.ring.complete(
            "request", t0, dur, args={"op": str(op), "status": status})
        return status, payload

    def _admit(self, q: Dict):
        """Parse + cache-check + shed-check; returns (cached_payload, None)
        on a hit or (None-keyed, _WorkItem) after enqueueing."""
        op = q.get("op")
        k = q.get("k", self.cfg.default_k)
        if not isinstance(k, int) or k < 1 or k > self.cfg.max_k:
            raise ValueError(
                f"k must be an int in [1, {self.cfg.max_k}], got {k!r}")
        if op == "neighbors":
            words = (q.get("word"),)
            if not isinstance(words[0], str):
                raise ValueError("neighbors needs a 'word' string")
            wid = self.engine.ids_of(words)
            ids = np.array([wid[0]] * 3, np.int32)
            weights = np.array([1.0, 0.0, 0.0], np.float32)
        elif op == "analogy":
            words = tuple(q.get(x) for x in ("a", "b", "c"))
            if not all(isinstance(w, str) for w in words):
                raise ValueError("analogy needs 'a', 'b', 'c' strings")
            ids = self.engine.ids_of(words).astype(np.int32)
            weights = np.array([-1.0, 1.0, 1.0], np.float32)
        elif op == "similarity":
            words = tuple(q.get(x) for x in ("w1", "w2"))
            if not all(isinstance(w, str) for w in words):
                raise ValueError("similarity needs 'w1', 'w2' strings")
            ids = self.engine.ids_of(words).astype(np.int32)
            weights, k = None, 1
        else:
            raise ValueError(
                f"op must be neighbors|analogy|similarity, got {op!r}")
        cache_key = (op, words, k)
        hit = self.cache.get(cache_key)
        if hit is not None:
            return hit, None
        if self._draining:
            raise _Shed(503, "draining: server is shutting down")
        if self._queued >= self.cfg.max_pending:
            self.stats.observe_shed()
            raise _Shed(429, f"overloaded: {self._queued} queries pending")
        item = _WorkItem(op=op, ids=ids, weights=weights, k=k,
                         future=self._loop.create_future(),
                         enq=time.perf_counter(), cache_key=cache_key)
        self._queue.put_nowait(item)
        return None, item

    # --------------------------------------------------------------- http
    async def _client(self, reader: "asyncio.StreamReader",
                      writer: "asyncio.StreamWriter") -> None:
        self._conns.add(writer)
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                self._busy += 1
                try:
                    method, path, headers, body = req
                    try:
                        status, payload, ctype = await self._route(
                            method, path, body)
                    except Exception as e:  # noqa: BLE001 — one bad request
                        status, ctype = 500, "application/json"
                        payload = {"error": f"internal error: {e!r}"}
                        self.flight.log_record(
                            {"event": "serve_500", "error": repr(e)})
                    keep = headers.get("connection", "").lower() != "close"
                    await self._write_response(
                        writer, status, payload, ctype, keep)
                finally:
                    self._busy -= 1
                if not keep:
                    break
        except (asyncio.IncompleteReadError, ConnectionError,
                asyncio.LimitOverrunError):
            pass
        finally:
            self._conns.discard(writer)
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    @staticmethod
    async def _read_request(reader):
        line = await reader.readline()
        if not line or not line.strip():
            return None
        parts = line.decode("latin-1").split()
        if len(parts) < 3:
            return None
        method, target = parts[0], parts[1]
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        try:
            n = int(headers.get("content-length", "0") or "0")
        except ValueError:
            n = 0
        if n > 0:
            body = await reader.readexactly(n)
        return method, target, headers, body

    @staticmethod
    async def _write_response(writer, status: int, payload, ctype: str,
                              keep: bool) -> None:
        if isinstance(payload, (dict, list)):
            body = (json.dumps(payload) + "\n").encode()
        elif isinstance(payload, str):
            body = payload.encode()
        else:
            body = payload
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}\r\n"
            f"Content-Type: {ctype}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep else 'close'}\r\n"
            + ("Retry-After: 1\r\n" if status == 429 else "")
            + "\r\n"
        )
        writer.write(head.encode("latin-1") + body)
        await writer.drain()

    async def _route(self, method: str, target: str,
                     body: bytes) -> Tuple[int, object, str]:
        parsed = urllib.parse.urlsplit(target)
        path = parsed.path
        if method == "GET" and path == "/healthz":
            return 200, {"ok": True, "vocab": self.engine.V,
                         "dim": self.engine.d,
                         "table_dtype": self.engine.table_dtype,
                         "draining": self._draining}, "application/json"
        if method == "GET" and path == "/stats":
            return 200, self.stats.snapshot(self.cache), "application/json"
        if method == "GET" and path == "/metrics":
            self._publish_stats()
            return 200, self.prom.render(), "text/plain; version=0.0.4"
        if method == "GET" and path.startswith("/v1/"):
            qs = {k: v[-1] for k, v in
                  urllib.parse.parse_qs(parsed.query).items()}
            op = path[len("/v1/"):]
            q: Dict = {"op": op, **qs}
            if "k" in q:
                try:
                    q["k"] = int(q["k"])
                except ValueError:
                    return 400, {"error": f"k must be an int, got {q['k']!r}"
                                 }, "application/json"
            status, payload = await self.handle_query(q)
            return status, payload, "application/json"
        if method == "POST" and path == "/v1/query":
            try:
                doc = json.loads(body.decode("utf-8") or "{}")
            except (ValueError, UnicodeDecodeError) as e:
                return 400, {"error": f"bad JSON body: {e}"}, "application/json"
            if isinstance(doc, dict) and "queries" in doc:
                qs = doc["queries"]
                if not isinstance(qs, list) or not qs:
                    return 400, {"error": "'queries' must be a non-empty list"
                                 }, "application/json"
                results = await asyncio.gather(
                    *(self.handle_query(q) if isinstance(q, dict)
                      else _not_a_dict() for q in qs))
                return 200, {"results": [
                    {**payload, "status": status}
                    for status, payload in results
                ]}, "application/json"
            if isinstance(doc, dict):
                status, payload = await self.handle_query(doc)
                return status, payload, "application/json"
            return 400, {"error": "body must be a JSON object"
                         }, "application/json"
        if path in ("/healthz", "/stats", "/metrics", "/v1/query"):
            return 405, {"error": f"{method} not allowed on {path}"
                         }, "application/json"
        return 404, {"error": f"no route {method} {path}"}, "application/json"

    # ------------------------------------------------------------- metrics
    def _publish_stats(self, final: bool = False) -> None:
        rec = self.stats.snapshot(self.cache)
        if final:
            rec["kind"] = "serve_final"
        try:
            self.hub(rec)
        except Exception:  # noqa: BLE001 — a sink must not kill serving
            pass
        if self.signals is not None:
            try:
                self.signals.observe_serve(rec)
                if final:
                    self.signals.finish()
                    self.signals.close()
            except Exception:  # noqa: BLE001 — signals must not kill serving
                pass

    async def _stats_loop(self) -> None:
        every = max(0.05, self.cfg.stats_every_s)
        while True:
            await asyncio.sleep(every)
            self._publish_stats()


async def _not_a_dict() -> Tuple[int, Dict]:
    return 400, {"error": "each query must be a JSON object"}


async def serve_forever(engine: QueryEngine, config: ServeConfig,
                        ready_cb=None) -> int:
    """Build, start, announce (ready_cb(server) after bind), run to exit."""
    server = EmbeddingServer(engine, config)
    await server.start()
    if ready_cb is not None:
        ready_cb(server)
    return await server.run()
