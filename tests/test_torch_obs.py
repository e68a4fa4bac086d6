"""The port's observability modules (word2vec_tpu_torch/obs/{trace,flight,
export,signals,quality}.py and serve/metrics.py) against the JAX
package's on the same inputs: chrome_trace_doc / merge_traces /
validate_trace_doc of the same events equal; FlightRecorder.snapshot with
the same keys and rows; PrometheusTextfile.render byte-equal for the same
records; Histogram.to_record, SignalEngine.observe_serve rows and the
training-window rows equal; ServeStats and LRUCache alike; score_table on
one table and one probe set within 1e-6; QualityProbe on torch params
(split and unified) scoring what the JAX probe scores on jax params; the
sentinel's escalation the same."""

import json
import math
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from word2vec_tpu.data.vocab import Vocab as JVocab
from word2vec_tpu.obs import export as jexport
from word2vec_tpu.obs import flight as jflight
from word2vec_tpu.obs import quality as jquality
from word2vec_tpu.obs import signals as jsignals
from word2vec_tpu.obs import trace as jtrace
from word2vec_tpu.serve import metrics as jmetrics
from word2vec_tpu.serve import query as jq

from word2vec_tpu_torch.data.vocab import Vocab
from word2vec_tpu_torch.obs import export as texport
from word2vec_tpu_torch.obs import flight as tflight
from word2vec_tpu_torch.obs import quality as tquality
from word2vec_tpu_torch.obs import signals as tsignals
from word2vec_tpu_torch.obs import trace as ttrace
from word2vec_tpu_torch.serve import metrics as tmetrics
from word2vec_tpu_torch.serve import query as tq


@pytest.fixture(autouse=True)
def _fresh_engines():
    jq.clear_engine_cache()
    tq.clear_engine_cache()
    yield
    jq.clear_engine_cache()
    tq.clear_engine_cache()


# ------------------------------------------------------------------ trace
EVENTS = [
    {"name": "step", "ph": "X", "ts": 10.0, "dur": 5.5, "tid": 9001,
     "args": {"step": 3}},
    {"name": "request", "ph": "X", "ts": 11.0, "dur": 1.0, "tid": 77,
     "args": {"op": "neighbors", "status": 200}},
    {"name": "health", "ph": "C", "ts": 12.5, "tid": 9001,
     "args": {"loss": 0.5}},
    {"name": "heartbeat", "ph": "i", "ts": 13.0, "tid": 77, "s": "p"},
    {"name": "step", "ph": "X", "ts": 20.0, "dur": 4.0, "tid": 9001,
     "args": {"step": 4}},
]


def _doc(mod, pid, shift=0.0):
    evs = [dict(e, ts=e["ts"] + shift) for e in EVENTS]
    doc = mod.chrome_trace_doc(evs, process_index=pid, process_name="serve",
                               metadata={"serve": True})
    doc["metadata"].pop("exported_utc")
    return doc


@pytest.mark.parametrize("pid", [0, 3])
def test_chrome_trace_doc_equal(pid):
    t, j = _doc(ttrace, pid), _doc(jtrace, pid)
    assert t == j
    assert ttrace.validate_trace_doc(t) == jtrace.validate_trace_doc(j)


def test_merge_traces_equal():
    docs = [(_doc(m, 1, 7.0), _doc(m, 0)) for m in (ttrace, jtrace)]
    assert ttrace.merge_traces(list(docs[0])) == jtrace.merge_traces(
        list(docs[1]))
    assert ttrace.merge_traces([]) == jtrace.merge_traces([])


@pytest.mark.parametrize("bad", [
    {}, {"traceEvents": [3]}, {"traceEvents": [{"name": "x", "ph": "X",
                                                "pid": 0, "tid": 0,
                                                "ts": 1.0}]},
    {"traceEvents": [{"name": "x", "ph": "i", "pid": "a", "tid": 0}]},
])
def test_validate_rejects_alike(bad):
    with pytest.raises(ValueError) as te:
        ttrace.validate_trace_doc(bad)
    with pytest.raises(ValueError) as je:
        jtrace.validate_trace_doc(bad)
    assert str(te.value) == str(je.value)


def test_ring_bounded_and_roundtrip(tmp_path):
    rings = [m.TraceRing(capacity=3) for m in (ttrace, jtrace)]
    for r in rings:
        for i in range(5):
            r.complete(f"s{i}", r.t0 + i * 1e-3, 1e-4, args={"i": i})
    (t, j) = rings
    assert t.dropped == j.dropped == 2
    strip = [{k: v for k, v in e.items() if k != "tid"} for e in t.events()]
    assert strip == [{k: v for k, v in e.items() if k != "tid"}
                     for e in j.events()]
    path = ttrace.write_trace(str(tmp_path / "t" / "trace.json"),
                              ttrace.chrome_trace_doc(t.events()))
    assert ttrace.load_trace(path)["traceEvents"][-1]["args"] == {"i": 4}


# ----------------------------------------------------------------- flight
def _feed(rec):
    rec.note_step(7, rec.ring.t0 + 0.01, 0.002, kind="step", fill=4)
    rec.note_counters(7, {"loss": 0.25, "flag": True, "name": "x"})
    rec.note_heartbeat([[0, 0, 7, 1.5]], 7)
    rec.note_quality({"quality_spearman": 0.5})
    rec.note_signal({"event": "signals", "window": 1})
    rec.note_mem({"mem_bytes_in_use": 10})
    rec.log_record({"event": "serve_batch_error", "step": 7})
    return rec.snapshot("drained", extra={"exit_code": 0})


def test_flight_snapshot_same_keys_and_rows(tmp_path):
    t = _feed(tflight.FlightRecorder(steps=4))
    j = _feed(jflight.FlightRecorder(steps=4))
    assert sorted(t) == sorted(j)
    for key in ("event", "reason", "last_step", "dropped_events", "counters",
                "log_records", "quality", "signals", "memory", "exit_code"):
        assert t[key] == j[key], key
    assert [e["name"] for e in t["trace"]["traceEvents"]] == [
        e["name"] for e in j["trace"]["traceEvents"]]
    assert t["trace"]["metadata"]["process_index"] == 0
    ttrace.validate_trace_doc(t["trace"])
    fr = tflight.FlightRecorder()
    prev = tflight.activate(fr)
    try:
        assert tflight.active() is fr
        path = tflight.dump_active(str(tmp_path / "m"), "sigusr1")
    finally:
        tflight.activate(prev)
    assert json.load(open(path))["reason"] == "sigusr1"
    assert tflight.dump_active(str(tmp_path / "m"), "x") is None


# ----------------------------------------------------------------- export
def _records():
    hist = jsignals.Histogram(buckets=(0.001, 0.01))
    for v in (0.0005, 0.002, 0.5):
        hist.observe(v)
    return [
        {"serve_requests_total": 3, "serve_p99_ms": 1.25, "flag": True,
         "name": "x", "serve_latency_seconds_hist": hist.to_record(),
         "phases": {"dispatch": {"p50_ms": 1.0, "n": 3, "ok": True},
                    "bad": 4}},
        {"event": "quality_probe", "step": 0},
        {"event": "slo_breach", "rule": "x"},
        {"event": "signals", "window": 3, "signal_serve_qps": 12.5,
         "step_time_seconds_hist": hist.to_record(), "mode": "serve"},
        {"event": "unknown_event", "value": 1.0},
        {"quality_norm_ratio_in_out": float("inf"), "neg": float("-inf"),
         "nan": float("nan"), "serve_requests_total": 4},
    ]


def test_prometheus_render_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    sinks = [texport.prometheus_textfile(str(tmp_path / "t" / "m.prom")),
             jexport.prometheus_textfile(str(tmp_path / "j" / "m.prom"))]
    for rec in _records():
        for s in sinks:
            s(dict(rec))
    t, j = sinks
    assert t.render() == j.render()
    t.close(), j.close()
    assert (tmp_path / "t" / "m.prom").read_bytes() == (
        tmp_path / "j" / "m.prom").read_bytes()
    assert texport.EVENT_COUNTERS == jexport.EVENT_COUNTERS
    # the JAX cost harvest's rows aside: the port has no harvest
    assert texport.GAUGE_EVENTS == tuple(
        e for e in jexport.GAUGE_EVENTS if e != "cost_harvest")


def test_hub_detaches_a_failing_sink():
    seen = []

    def bad(rec):
        raise OSError("disk full")

    class Closer:
        closed = False

        def __call__(self, rec):
            seen.append(rec)

        def close(self):
            Closer.closed = True

    hub = texport.MetricsHub(bad, None, Closer())
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        hub({"a": 1})
        hub({"a": 2})
    assert len(hub.sinks) == 1 and seen == [{"a": 1}, {"a": 2}]
    assert any("detached" in str(x.message) for x in w)
    hub.close()
    assert Closer.closed


# ---------------------------------------------------------------- signals
def test_histogram_record_equal():
    vals = np.random.default_rng(0).exponential(0.05, size=200)
    th, jh = tsignals.Histogram(), jsignals.Histogram()
    for v in vals:
        th.observe(v)
        jh.observe(v)
    assert th.to_record() == jh.to_record()
    assert tsignals.percentile(list(vals), 0.99) == jsignals.percentile(
        list(vals), 0.99)
    assert tsignals.INPUT_PHASES + tsignals.COMPUTE_PHASES == (
        "batcher_wait", "dispatch", "device_wait")


def _serve_rows(mod, tmp):
    rows = []
    eng = mod.SignalEngine(window_s=10.0, metrics_dir=str(tmp), host=5,
                           log_fn=rows.append)
    stats = tmetrics.ServeStats()
    for i, now in enumerate((1000.0, 1004.0, 1012.0, 1013.0, 1031.0)):
        stats.observe_request("neighbors", 0.001 * (i + 1))
        rec = stats.snapshot()
        rec["serve_qps"] = 10.0 * (i + 1)
        rec["serve_cache_hit_rate"] = 0.1 * i
        eng.observe_serve(rec, now=now)
    eng.finish()
    eng.close()
    with open(tmp / "signals_p5.jsonl") as f:
        lines = [json.loads(x) for x in f]
    return rows, lines, eng.signal_stats()


def test_signal_engine_serve_rows_equal(tmp_path):
    (tmp_path / "t").mkdir(), (tmp_path / "j").mkdir()
    t = _serve_rows(tsignals, tmp_path / "t")
    j = _serve_rows(jsignals, tmp_path / "j")
    assert t == j
    assert len(t[0]) == 3 and t[0][0]["mode"] == "serve"


def _training_rows(mod, monkeypatch):
    clock = iter(np.arange(0.0, 100.0, 0.125))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(clock)))
    rows = []
    eng = mod.SignalEngine(window=4, log_fn=rows.append, host=1)
    eng.note_heartbeat([[0, 0, 5, 2.0], [1, 0, 5, 6.0], [2, 0, 5, 3.0]], 5)
    eng({"quality_spearman": 0.75})
    for step in range(0, 13, 2):
        eng.on_boundary(step, step * 100)
    eng.finish(step=13, words_done=1300)
    return rows, eng.report()


def test_signal_engine_training_rows_equal(monkeypatch):
    t = _training_rows(tsignals, monkeypatch)
    j = _training_rows(jsignals, monkeypatch)
    assert t == j and len(t[0]) == 4


# ------------------------------------------------------------ serve stats
def test_serve_stats_and_cache_alike():
    ts, js = tmetrics.ServeStats(), jmetrics.ServeStats()
    tc, jc = tmetrics.LRUCache(2), jmetrics.LRUCache(2)
    for s, c in ((ts, tc), (js, jc)):
        for i in range(6):
            s.observe_request("neighbors" if i % 2 else "analogy",
                              0.001 * i, error=i == 5)
        s.observe_shed()
        s.observe_batch(3, 4)
        s.adjust_inflight(2)
        for k in ("a", "b", "a", "c", "b"):
            if c.get((k,)) is None:
                c.put((k,), {"v": k})
    t, j = ts.snapshot(tc), js.snapshot(jc)
    assert sorted(t) == sorted(j)
    for key in t:
        if key not in ("serve_qps", "serve_uptime_s"):
            assert t[key] == j[key], key
    assert len(tc) == len(jc) == 2
    assert tmetrics.LATENCY_BUCKETS == jmetrics.LATENCY_BUCKETS


# ---------------------------------------------------------------- quality
QV, QD = 60, 12


@pytest.fixture(scope="module")
def qcase(tmp_path_factory):
    rng = np.random.default_rng(5)
    W = rng.normal(size=(QV + 4, QD)).astype(np.float32)  # 4 reserve rows
    W_out = rng.normal(size=(QV + 4, QD)).astype(np.float32)
    counts = {f"w{i}": 1000 - i for i in range(QV)}
    words = list(counts)
    pairs = [(words[i], words[i + 1], float(rng.uniform(0, 10)))
             for i in range(0, 40, 2)] + [("w1", "zz", 3.0)]
    analogies = [tuple(words[j] for j in rng.choice(QV, 4, replace=False))
                 for _ in range(30)] + [("w1", "w2", "w3", "w1"),
                                        ("w1", "w2", "zz", "w4")]
    d = tmp_path_factory.mktemp("probe")
    pfile, afile = d / "pairs.csv", d / "q.txt"
    pfile.write_text("".join(f"{a},{b},{g}\n" for a, b, g in pairs))
    afile.write_text(": probe\n" + "".join(" ".join(q) + "\n"
                                           for q in analogies))
    return (W, W_out, Vocab.from_counter(counts, 1),
            JVocab.from_counter(counts, 1), str(pfile), str(afile))


def _assert_records_close(t, j):
    assert sorted(t) == sorted(j)
    for key, jv in j.items():
        if math.isinf(jv):
            assert t[key] == jv, key
        else:
            assert abs(t[key] - jv) <= 1e-6, (key, t[key], jv)


def test_probe_sets_equal(qcase):
    _, _, tv, jv, pfile, afile = qcase
    t = tquality.ProbeSet.from_files(tv, pfile, afile)
    j = jquality.ProbeSet.from_files(jv, pfile, afile)
    assert (t.pairs, t.analogies, t.tracked, t.source) == (
        j.pairs, j.analogies, j.tracked, j.source)
    t = tquality.ProbeSet.synthesize(tv)
    j = jquality.ProbeSet.synthesize(jv)
    assert (t.pairs, t.analogies, t.tracked, t.source) == (
        j.pairs, j.analogies, j.tracked, j.source)


@pytest.mark.parametrize("with_prev", [False, True])
def test_score_table_equal(qcase, with_prev):
    W, W_out, tv, jv, pfile, afile = qcase
    tset = tquality.ProbeSet.from_files(tv, pfile, afile)
    jset = jquality.ProbeSet.from_files(jv, pfile, afile)
    prev_t = prev_j = None
    if with_prev:
        W2 = W + np.float32(0.3) * np.random.default_rng(9).normal(
            size=W.shape).astype(np.float32)
        _, prev_t = tquality.score_table(W2, tv, tset, device="cpu")
        _, prev_j = jquality.score_table(W2, jv, jset)
    t_rec, t_nb = tquality.score_table(W, tv, tset, prev_neighbors=prev_t,
                                       W_out=W_out, device="cpu")
    j_rec, j_nb = jquality.score_table(W, jv, jset, prev_neighbors=prev_j,
                                       W_out=W_out)
    _assert_records_close(t_rec, j_rec)
    assert "quality_spearman" in t_rec and "quality_analogy_accuracy" in t_rec
    assert ("quality_drift_jaccard_mean" in t_rec) == with_prev
    assert t_rec["quality_analogy_skipped_oov"] == 1.0
    assert t_rec["quality_analogy_skipped_degenerate"] == 1.0
    assert sorted(t_nb) == sorted(j_nb)
    for i in t_nb:
        assert np.array_equal(t_nb[i], j_nb[i])


@pytest.mark.parametrize("layout", ["split", "unified"])
def test_quality_probe_equal(qcase, layout):
    W, W_out, tv, jv, pfile, afile = qcase
    if layout == "split":
        tparams = {"emb_in": torch.from_numpy(W),
                   "emb_out_ns": torch.from_numpy(W_out)}
    else:
        tparams = {"emb_ns_fused": torch.from_numpy(np.stack([W, W_out], 1))}
    jparams = {"emb_in": jnp.asarray(W), "emb_out_ns": jnp.asarray(W_out)}
    tlog, jlog = [], []
    tfr, jfr = tflight.FlightRecorder(), jflight.FlightRecorder()
    tp = tquality.QualityProbe(
        tv, tquality.ProbeSet.from_files(tv, pfile, afile), every=5,
        log_fn=tlog.append, flight=tfr,
        sentinel=tquality.QualitySentinel(budget=2, floor=0.99))
    jp = jquality.QualityProbe(
        jv, jquality.ProbeSet.from_files(jv, pfile, afile), every=5,
        log_fn=jlog.append, flight=jfr,
        sentinel=jquality.QualitySentinel(budget=2, floor=0.99))
    assert tp.due(5) and not tp.due(4)
    for step in (5, 10):
        t = tp.probe(tparams, step)
        j = jp.probe(jparams, step)
        t.pop("quality_probe_ms"), j.pop("quality_probe_ms")
        _assert_records_close(t, j)
    strip = [{k: v for k, v in r.items() if k != "quality_probe_ms"}
             for r in tlog]
    assert [r.get("event") for r in strip] == [r.get("event") for r in jlog]
    assert "quality_drift_jaccard_mean" in t
    assert [r.get("event") for r in tfr.records] == [
        r.get("event") for r in jfr.records]


def test_sentinel_escalates_alike():
    seq = [{"quality_spearman": s, "quality_effective_rank": r}
           for s, r in ((0.9, 40.0), (0.3, 40.0), (0.2, 39.0), (0.95, 41.0),
                        (0.1, 9.0), (0.1, 9.0), (0.1, 9.0), (0.1, 9.0))]
    out = []
    for mod in (tquality, jquality):
        s = mod.QualitySentinel(budget=2, floor=0.5, grace=1)
        acts = []
        for i, rec in enumerate(seq):
            try:
                acts.append(s.observe(rec, i))
            except mod.QualityAlert as e:
                acts.append(("alert", str(e), e.record()))
                break
        out.append(acts)
    assert out[0] == out[1] and out[0][-1][0] == "alert"
