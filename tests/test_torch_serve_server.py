"""The port's embedding server (word2vec_tpu_torch/serve/server.py) on
device="cpu", against the JAX server (word2vec_tpu/serve/server.py).

Each test drives a real EmbeddingServer over a real localhost socket inside
one asyncio.run(), as tests/test_serve_server.py does: the event loop, HTTP
parsing, batcher and executor path are the production ones; signals are
replaced by direct begin_drain() calls. The JAX test classes are carried
over one case each (routes, coalescing, cache and shed, drain, chaos,
observability); then one table and one request list through both servers
(same statuses, neighbor and analogy word lists in order, scores and
similarities within 1e-6 on f32 tables and 1e-3 on bf16 tables, the same
/stats keys, equal deterministic counters, the same /metrics names); and
the allocation-failure classification: an injected `oom`, a
torch.OutOfMemoryError from inside batch_topk, and a plain RuntimeError.
"""

import asyncio
import json
import re

import numpy as np
import pytest
import torch

from word2vec_tpu.data.vocab import Vocab as JVocab
from word2vec_tpu.resilience.faults import FaultPlan as JFaultPlan
from word2vec_tpu.serve import query as jq
from word2vec_tpu.serve import server as jserver

from word2vec_tpu_torch.data.vocab import Vocab
from word2vec_tpu_torch.obs.trace import load_trace, validate_trace_doc
from word2vec_tpu_torch.resilience.faults import FaultPlan
from word2vec_tpu_torch.resilience.shutdown import EXIT_PREEMPTED
from word2vec_tpu_torch.serve import query as tq
from word2vec_tpu_torch.serve.server import EmbeddingServer, ServeConfig

WORDS = ["man", "woman", "king", "queen", "apple", "banana", "cherry"]


def _engine():
    vocab = Vocab(WORDS, np.ones(len(WORDS), np.int64))
    rng = np.random.default_rng(3)
    W = rng.normal(size=(len(WORDS), 8)).astype(np.float32)
    return tq.QueryEngine(W, vocab, device="cpu")


async def _http(port, method, path, body=None):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    req = (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
           f"Content-Length: {len(data)}\r\nConnection: close\r\n\r\n"
           ).encode() + data
    w.write(req)
    await w.drain()
    raw = await r.read()
    w.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    try:
        doc = json.loads(payload)
    except ValueError:
        doc = payload.decode()
    return status, doc


def run_with_server(coro_fn, engine=None, server_cls=EmbeddingServer,
                    config_cls=ServeConfig, **cfg_kw):
    """Start a server on an ephemeral port, run coro_fn(server), then
    drain; returns (coro result, exit code, server)."""

    async def main():
        srv = server_cls(engine or _engine(), config_cls(**cfg_kw))
        await srv.start()
        try:
            out = await coro_fn(srv)
        finally:
            srv.begin_drain()
            code = await srv.run()
        return out, code, srv

    return asyncio.run(main())


class TestRoutes:
    def test_healthz_and_queries(self):
        async def body(srv):
            st, h = await _http(srv.port, "GET", "/healthz")
            assert st == 200 and h["ok"] and h["vocab"] == len(WORDS)
            st, nb = await _http(
                srv.port, "GET", "/v1/neighbors?word=king&k=3")
            assert st == 200 and len(nb["neighbors"]) == 3
            assert all(w != "king" for w, _ in nb["neighbors"])
            st, an = await _http(srv.port, "POST", "/v1/query", {
                "op": "analogy", "a": "man", "b": "woman", "c": "king",
                "k": 2})
            assert st == 200 and len(an["neighbors"]) == 2
            st, sim = await _http(srv.port, "POST", "/v1/query", {
                "op": "similarity", "w1": "king", "w2": "queen"})
            assert st == 200 and -1.001 <= sim["similarity"] <= 1.001
            st, sim2 = await _http(
                srv.port, "GET", "/v1/similarity?w1=king&w2=queen")
            assert st == 200 and sim2["similarity"] == sim["similarity"]
            return True

        out, code, _ = run_with_server(body, coalesce_ms=0.5)
        assert out and code == 0

    def test_batch_post_and_errors(self):
        async def body(srv):
            st, doc = await _http(srv.port, "POST", "/v1/query", {
                "queries": [
                    {"op": "neighbors", "word": "king", "k": 2},
                    {"op": "neighbors", "word": "zzz"},
                    {"op": "bogus"},
                ]})
            assert st == 200
            r = doc["results"]
            assert r[0]["status"] == 200 and len(r[0]["neighbors"]) == 2
            assert r[1]["status"] == 404 and "'zzz'" in r[1]["error"]
            assert r[2]["status"] == 400
            st, _ = await _http(srv.port, "GET", "/nope")
            assert st == 404
            st, _ = await _http(srv.port, "POST", "/healthz")
            assert st == 405
            st, doc = await _http(
                srv.port, "GET", "/v1/neighbors?word=king&k=bad")
            assert st == 400
            return True

        out, code, _ = run_with_server(body, coalesce_ms=0.5)
        assert out and code == 0


class TestCoalescing:
    def test_concurrent_queries_share_batches(self):
        async def body(srv):
            await asyncio.gather(*[
                _http(srv.port, "POST", "/v1/query",
                      {"op": "neighbors", "word": w, "k": 2})
                for w in WORDS])
            return srv.stats.batches_total

        batches, code, srv = run_with_server(
            body, coalesce_ms=100.0, cache_size=0)
        assert 1 <= batches < len(WORDS)
        assert srv.stats.batch_items_total == len(WORDS)
        assert code == 0

    def test_zero_window_still_serves(self):
        async def body(srv):
            st, nb = await _http(
                srv.port, "GET", "/v1/neighbors?word=king&k=2")
            assert st == 200 and nb["neighbors"]
            return True

        out, code, _ = run_with_server(body, coalesce_ms=0.0)
        assert out and code == 0


class TestCacheAndShed:
    def test_lru_cache_hit(self):
        async def body(srv):
            await _http(srv.port, "GET", "/v1/neighbors?word=king&k=3")
            before = srv.cache.hits
            st, _ = await _http(
                srv.port, "GET", "/v1/neighbors?word=king&k=3")
            assert st == 200
            assert srv.cache.hits == before + 1
            await _http(srv.port, "GET", "/v1/neighbors?word=king&k=4")
            assert srv.cache.misses >= 2
            return True

        out, code, _ = run_with_server(body, coalesce_ms=0.5)
        assert out and code == 0

    def test_bounded_queue_sheds_429(self):
        async def body(srv):
            results = await asyncio.gather(*[
                _http(srv.port, "POST", "/v1/query",
                      {"op": "neighbors", "word": WORDS[i % len(WORDS)],
                       "k": 2 + i % 5})
                for i in range(24)])
            statuses = [st for st, _ in results]
            assert 429 in statuses
            assert 200 in statuses
            shed = [doc for st, doc in results if st == 429]
            assert "overloaded" in shed[0]["error"]
            assert srv.stats.shed_429_total >= 1
            return True

        out, code, _ = run_with_server(
            body, coalesce_ms=150.0, max_pending=2, cache_size=0)
        assert out and code == 0


class TestDrain:
    def test_drain_answers_inflight_then_exits_0(self):
        async def main():
            srv = EmbeddingServer(_engine(), ServeConfig(
                coalesce_ms=200.0, cache_size=0, drain_deadline_s=5.0))
            await srv.start()
            pending = [asyncio.ensure_future(_http(
                srv.port, "POST", "/v1/query",
                {"op": "neighbors", "word": w, "k": 2})) for w in WORDS[:4]]
            await asyncio.sleep(0.05)
            srv.begin_drain()
            code = await srv.run()
            answered = await asyncio.gather(*pending)
            return answered, code, srv

        answered, code, srv = asyncio.run(main())
        assert [st for st, _ in answered] == [200] * 4
        assert code == 0 and srv.exit_reason == "drained"

    def test_second_drain_forces_75(self):
        async def main():
            srv = EmbeddingServer(_engine(), ServeConfig(
                drain_deadline_s=60.0))
            await srv.start()
            srv.begin_drain()
            srv.begin_drain()     # the operator's second SIGTERM
            return await srv.run(), srv

        code, srv = asyncio.run(main())
        assert code == EXIT_PREEMPTED == 75 and srv.exit_reason == "forced"

    def test_draining_refuses_new_queries(self):
        async def main():
            srv = EmbeddingServer(_engine(), ServeConfig(
                coalesce_ms=100.0, drain_deadline_s=5.0))
            await srv.start()
            port = srv.port
            r, w = await asyncio.open_connection("127.0.0.1", port)
            hold = asyncio.ensure_future(_http(
                port, "POST", "/v1/query",
                {"op": "neighbors", "word": "king", "k": 2}))
            await asyncio.sleep(0.02)
            srv.begin_drain()
            body = json.dumps(
                {"op": "neighbors", "word": "queen", "k": 2}).encode()
            w.write((f"POST /v1/query HTTP/1.1\r\nHost: t\r\n"
                     f"Content-Length: {len(body)}\r\n\r\n"
                     ).encode() + body)
            await w.drain()
            status_line = await r.readline()
            st = int(status_line.split()[1])
            raw = b""
            while b"\r\n\r\n" not in raw:
                raw += await r.read(256)
            w.close()
            code = await srv.run()
            st_held, _ = await hold
            return st, st_held, code

        st, st_held, code = asyncio.run(main())
        assert st == 503
        assert st_held == 200
        assert code == 0


class TestChaos:
    def test_oom_fault_fails_batch_503_server_survives(self):
        async def body(srv):
            st1, doc1 = await _http(
                srv.port, "GET", "/v1/neighbors?word=king&k=2")
            st2, doc2 = await _http(
                srv.port, "GET", "/v1/neighbors?word=queen&k=2")
            return (st1, doc1), (st2, doc2)

        (st1, doc1), (st2, doc2) = run_with_server(
            body, coalesce_ms=0.5, cache_size=0,
            faults=FaultPlan.parse("oom:times=1"))[0]
        assert st1 == 503 and "allocation failure" in doc1["error"]
        assert st2 == 200 and doc2["neighbors"]

    def test_stall_fault_keeps_healthz_live(self):
        async def body(srv):
            t0 = asyncio.get_event_loop().time()
            slow = asyncio.ensure_future(_http(
                srv.port, "GET", "/v1/neighbors?word=king&k=2"))
            await asyncio.sleep(0.1)
            st, h = await _http(srv.port, "GET", "/healthz")
            dt = asyncio.get_event_loop().time() - t0
            assert st == 200 and h["ok"] and dt < 0.5
            st_slow, _ = await slow
            assert st_slow == 200
            return True

        out, code, _ = run_with_server(
            body, coalesce_ms=0.5, cache_size=0,
            faults=FaultPlan.parse("stall@1:secs=0.4"))
        assert out and code == 0

    def test_unservable_fault_kind_rejected(self):
        with pytest.raises(ValueError, match="not servable"):
            EmbeddingServer(_engine(), ServeConfig(
                faults=FaultPlan.parse("nan@1")))


class TestObservability:
    def test_metrics_stats_trace_flight(self, tmp_path):
        mdir = str(tmp_path / "mdir")
        tdir = str(tmp_path / "tdir")

        async def body(srv):
            for w in ("king", "queen", "king"):
                await _http(srv.port, "POST", "/v1/query",
                            {"op": "neighbors", "word": w, "k": 2})
            st, stats = await _http(srv.port, "GET", "/stats")
            st2, prom = await _http(srv.port, "GET", "/metrics")
            return stats, prom

        (stats, prom), code, srv = run_with_server(
            body, coalesce_ms=0.5, metrics_dir=mdir, trace_dir=tdir,
            stats_every_s=60.0)
        assert code == 0
        assert stats["serve_requests_total"] == 3
        assert stats["serve_cache_hits"] == 1
        for field in ("w2v_serve_p50_ms", "w2v_serve_p99_ms",
                      "w2v_serve_qps", "w2v_serve_cache_hit_rate",
                      "w2v_serve_batch_fill_mean",
                      "w2v_serve_latency_seconds_bucket"):
            assert field in prom, prom
        doc = load_trace(str(tmp_path / "tdir" / "trace.json"))
        counts = validate_trace_doc(doc)
        assert counts.get("X", 0) >= 2
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
        assert "request" in names and "step" in names
        fl = json.load(open(str(tmp_path / "mdir" / "flight.json")))
        assert fl["reason"] == "drained" and fl["exit_code"] == 0
        assert fl["stats"]["serve_requests_total"] == 3
        validate_trace_doc(fl["trace"])
        assert (tmp_path / "mdir" / "serve.prom").exists()

    def test_request_timeout_504(self):
        async def body(srv):
            return await _http(
                srv.port, "GET", "/v1/neighbors?word=king&k=2")

        (st, doc), code, _ = run_with_server(
            body, coalesce_ms=0.5, cache_size=0, request_timeout_s=0.05,
            faults=FaultPlan.parse("stall@1:secs=0.5"))
        assert st == 504 and "timed out" in doc["error"]


# ------------------------------------------------ parity with the JAX server
PV, PD = 96, 16
TOL = {"float32": 1e-6, "bfloat16": 1e-3}


def _parity_requests(rng):
    """A fixed request list (method, path, body): every route, repeats
    (cache hits), OOV (404), malformed (400) and a POST batch of five
    misses against max_pending=3 (its last two queries are shed 429 —
    the batch's handlers all admit before any completes)."""
    w = [f"w{i}" for i in rng.integers(0, PV, size=40)]
    reqs = [("GET", "/healthz", None)]
    for i in range(10):
        reqs.append(("GET", f"/v1/neighbors?word={w[i]}&k={1 + i % 12}",
                     None))
    for i in range(6):
        a, b, c = w[10 + 3 * i: 13 + 3 * i]
        reqs.append(("POST", "/v1/query", {"op": "analogy", "a": a, "b": b,
                                           "c": c, "k": 3 + i}))
    for i in range(4):
        reqs.append(("GET", f"/v1/similarity?w1={w[30 + i]}&w2={w[34 + i]}",
                     None))
    reqs.append(("GET", f"/v1/neighbors?word={w[0]}&k=1", None))  # hit
    reqs.append(("POST", "/v1/query", {"op": "analogy", "a": w[10],
                                       "b": w[11], "c": w[12], "k": 3}))
    reqs.append(("GET", "/v1/neighbors?word=nope&k=3", None))
    reqs.append(("GET", "/v1/analogy?a=w1&b=w2", None))
    reqs.append(("POST", "/v1/query", {"op": "neighbors", "word": "w3",
                                       "k": 0}))
    reqs.append(("POST", "/v1/query", {"queries": [
        {"op": "neighbors", "word": f"w{60 + j}", "k": 4} for j in range(5)
    ] + [{"op": "similarity", "w1": "w1", "w2": "w1"}, 7]}))
    reqs.append(("POST", "/v1/query", {"queries": [
        {"op": "analogy", "a": "w5", "b": "w6", "c": "w7", "k": 2},
        {"op": "similarity", "w1": "w8", "w2": "w9"},
    ]}))
    return reqs


def _results(doc):
    """Flatten a response body into its query results."""
    if isinstance(doc, dict) and "results" in doc:
        return doc["results"]
    return [doc]


def _serve_all(server_cls, config_cls, engine, reqs):
    async def body(srv):
        out = []
        for method, path, b in reqs:
            out.append(await _http(srv.port, method, path, b))
        _, stats = await _http(srv.port, "GET", "/stats")
        _, prom = await _http(srv.port, "GET", "/metrics")
        return out, stats, prom

    (out, stats, prom), code, _ = run_with_server(
        body, engine=engine, server_cls=server_cls, config_cls=config_cls,
        coalesce_ms=0.5, max_pending=3, stats_every_s=60.0)
    assert code == 0
    return out, stats, prom


def _metric_names(prom):
    return {m.group(1) for m in re.finditer(r"^([a-zA-Z_:][\w:]*)",
                                            prom, re.M)}


@pytest.mark.parametrize("dtype", list(TOL))
def test_server_parity_with_jax(dtype):
    rng = np.random.default_rng(11)
    W = rng.normal(size=(PV, PD)).astype(np.float32)
    W[20:24] = W[20]                      # exact ties across the top-k cut
    counts = {f"w{i}": 1000 - i for i in range(PV)}
    t_eng = tq.QueryEngine(W, Vocab.from_counter(counts, 1),
                           table_dtype=dtype, device="cpu")
    j_eng = jq.QueryEngine(W, JVocab.from_counter(counts, 1),
                           table_dtype=dtype)
    reqs = _parity_requests(np.random.default_rng(12))
    t_out, t_stats, t_prom = _serve_all(
        EmbeddingServer, ServeConfig, t_eng, reqs)
    j_out, j_stats, j_prom = _serve_all(
        jserver.EmbeddingServer, jserver.ServeConfig, j_eng, reqs)

    tol = TOL[dtype]
    n_topk = n_sim = 0
    for (ts, td), (js, jd), req in zip(t_out, j_out, reqs):
        assert ts == js, req
        for tr, jr in zip(_results(td), _results(jd), strict=True):
            if not isinstance(jr, dict):
                assert tr == jr
                continue
            assert tr.keys() == jr.keys(), req
            assert tr.get("status") == jr.get("status"), req
            assert tr.get("error") == jr.get("error"), req
            if "neighbors" in jr:
                n_topk += 1
                assert [w for w, _ in tr["neighbors"]] == \
                    [w for w, _ in jr["neighbors"]], req
                np.testing.assert_allclose(
                    [s for _, s in tr["neighbors"]],
                    [s for _, s in jr["neighbors"]], rtol=0, atol=tol)
            if "similarity" in jr:
                n_sim += 1
                assert abs(tr["similarity"] - jr["similarity"]) <= tol
    assert n_topk >= 20 and n_sim >= 5
    assert sorted(t_stats) == sorted(j_stats)
    for key in ("serve_requests_total", "serve_errors_total",
                "serve_shed_429_total", "serve_cache_hits",
                "serve_cache_misses", "serve_cache_size",
                "serve_requests_neighbors", "serve_requests_analogy",
                "serve_requests_similarity"):
        assert t_stats[key] == j_stats[key], key
    assert t_stats["serve_shed_429_total"] == 3
    assert t_stats["serve_cache_hits"] >= 2
    assert _metric_names(t_prom) == _metric_names(j_prom)


# ------------------------------------------ allocation-failure classification
def _raise_oom(*a, **k):
    raise torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")


def _raise_runtime(*a, **k):
    raise RuntimeError("cuBLAS status not supported")


@pytest.mark.parametrize("case", ["injected", "oom_type", "runtime"])
def test_batch_failures_classified(case, monkeypatch):
    eng = _engine()
    faults = None
    if case == "injected":
        faults = FaultPlan.parse("oom:times=1")
    else:
        real = eng.batch_topk
        calls = []

        def flaky(*a, **k):
            calls.append(1)
            if len(calls) == 1:
                (_raise_oom if case == "oom_type" else _raise_runtime)()
            return real(*a, **k)

        monkeypatch.setattr(eng, "batch_topk", flaky)

    async def body(srv):
        first = await _http(srv.port, "GET", "/v1/neighbors?word=king&k=2")
        second = await _http(srv.port, "GET", "/v1/neighbors?word=king&k=2")
        return first, second

    ((st1, doc1), (st2, doc2)), code, srv = run_with_server(
        body, engine=eng, coalesce_ms=0.5, cache_size=0, faults=faults)
    assert st1 == 503
    if case == "runtime":
        assert doc1["error"] == (
            "batch execution failed: cuBLAS status not supported")
    else:
        want = ("injected fault: out of memory allocating device buffer "
                "at serve_batch 1" if case == "injected"
                else "CUDA out of memory. Tried to allocate 2.00 GiB")
        assert doc1["error"] == (
            "allocation failure (device out of memory): " + want)
    assert st2 == 200 and [w for w, _ in doc2["neighbors"]] == [
        w for w, _ in eng.neighbors_batch(["king"], k=2)[0]]
    assert srv.stats.errors_total == 1 and code == 0


def test_injected_oom_matches_the_jax_server():
    """The same injected fault through both servers: one 503 carrying the
    allocation-failure message, then the same answer."""

    async def body(srv):
        return [await _http(srv.port, "GET", "/v1/neighbors?word=king&k=2")
                for _ in range(2)]

    t_out = run_with_server(body, coalesce_ms=0.5, cache_size=0,
                            faults=FaultPlan.parse("oom:times=1"))[0]
    vocab = JVocab(WORDS, np.ones(len(WORDS), np.int64))
    W = np.random.default_rng(3).normal(size=(len(WORDS), 8)).astype(
        np.float32)
    j_out = run_with_server(
        body, engine=jq.QueryEngine(W, vocab),
        server_cls=jserver.EmbeddingServer, config_cls=jserver.ServeConfig,
        coalesce_ms=0.5, cache_size=0,
        faults=JFaultPlan.parse("oom:times=1"))[0]
    assert [s for s, _ in t_out] == [s for s, _ in j_out] == [503, 200]
    prefix = "allocation failure (device out of memory): "
    assert t_out[0][1]["error"].startswith(prefix)
    assert j_out[0][1]["error"].startswith(prefix)
    assert [w for w, _ in t_out[1][1]["neighbors"]] == [
        w for w, _ in j_out[1][1]["neighbors"]]
