"""The port's device telemetry (word2vec_tpu_torch/obs/{devmem,profiler}.py,
resilience/shutdown.install_usr2_profile) against the JAX package, on the
CPU.

Pins:
  * under W2V_FAKE_MEMORY_STATS the memory ledger's rows, summary,
    forecast and dump equal the JAX ledger's for the same samples; without
    it the CPU rows are present and zero in both; the trainer's ledger
    (table_place at entry, train_step on its cadence) reports the same
    device_memory as the JAX trainer; swap_table samples serve_swap;
  * validate_capture_doc accepts and rejects the same documents as the
    JAX gate, and a CPU ProfilerCapture window (requested, scheduled,
    finished mid-window) writes a manifest that passes it, with the trace
    file it names;
  * a real SIGUSR2 requests a window and writes mem_usr2.json.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.batcher import PackedCorpus as JCorpus  # noqa: E402
from word2vec_tpu.obs import devmem as jdevmem  # noqa: E402
from word2vec_tpu.obs.profiler import validate_capture_doc as j_validate  # noqa: E402
from word2vec_tpu.train import Trainer as JTrainer  # noqa: E402
from word2vec_tpu.utils.synthetic import (  # noqa: E402
    zipf_corpus_ids as j_ids, zipf_vocab as j_vocab,
)

from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.data.batcher import PackedCorpus  # noqa: E402
from word2vec_tpu_torch.obs import devmem  # noqa: E402
from word2vec_tpu_torch.obs.export import MetricsHub, PrometheusTextfile  # noqa: E402
from word2vec_tpu_torch.obs.profiler import (  # noqa: E402
    TRACE_FILE, ProfilerCapture, validate_capture_doc,
)
from word2vec_tpu_torch.resilience.shutdown import install_usr2_profile  # noqa: E402
from word2vec_tpu_torch.serve.query import QueryEngine  # noqa: E402
from word2vec_tpu_torch.train import Trainer  # noqa: E402
from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab  # noqa: E402

FAKE = "bytes_limit=1000000,bytes_in_use=300000,peak_bytes_in_use=400000"
CFG = dict(model="sg", train_method="ns", negative=3, word_dim=16, window=2,
           batch_rows=4, max_sentence_len=16, min_count=1, seed=9, iters=2)


def _both(**kw):
    tv, jv = zipf_vocab(40, 4000), j_vocab(40, 4000)
    t = Trainer(Word2VecConfig(**CFG, **kw), tv,
                PackedCorpus.pack(zipf_corpus_ids(tv, 3000, seed=5), 16),
                device="cpu")
    j = JTrainer(JConfig(**CFG, **kw), jv,
                 JCorpus.pack(j_ids(jv, 3000, seed=5), 16))
    return t, j


def _drive(mod, **kw):
    """One ledger through init, table placement, a boundary cadence and a
    swap; returns (rows, summary, forecast)."""
    led = mod.MemoryLedger(sample_every=10, row_bytes=128, **kw)
    led.sample("init")
    led.sample("table_place", step=0)
    for step in range(35):
        led.on_boundary(step)
    led.sample("serve_swap")
    return list(led.rows), led.summary(), led.forecast(), led


@pytest.mark.parametrize("fake", [FAKE, "bytes_limit=1000,bytes_in_use=990",
                                  None])
def test_ledger_matches_jax(monkeypatch, tmp_path, fake):
    if fake is None:
        monkeypatch.delenv(devmem.FAKE_STATS_ENV, raising=False)
    else:
        monkeypatch.setenv(devmem.FAKE_STATS_ENV, fake)
    assert devmem.FAKE_STATS_ENV == jdevmem.FAKE_STATS_ENV
    t_rows, t_sum, t_fc, t_led = _drive(devmem, vocab_reserve=5)
    j_rows, j_sum, j_fc, j_led = _drive(
        jdevmem, vocab_reserve=5, devices=[] if fake is None else None)
    assert t_rows == j_rows and t_sum == j_sum and t_fc == j_fc
    assert t_sum["phases"]["train_step"]["samples"] == 4  # 0, 10, 20, 30
    if fake is None:
        # the CPU: present-from-zero rows, available False, no crash
        assert t_sum["available"] is False
        assert all(r["mem_available"] == 0 and r["mem_bytes_in_use"] == 0
                   for r in t_rows)
    docs = []
    for led, name in ((t_led, "t.json"), (j_led, "j.json")):
        doc = json.load(open(led.dump(str(tmp_path / name), reason="sigusr2")))
        doc.pop("created_utc")
        docs.append(doc)
    assert docs[0] == docs[1]


def test_statless_rows_render_from_zero(monkeypatch, tmp_path):
    monkeypatch.delenv(devmem.FAKE_STATS_ENV, raising=False)
    prom = PrometheusTextfile(str(tmp_path / "m.prom"))
    led = devmem.MemoryLedger(log_fn=MetricsHub(prom))
    row = led.sample("init")
    assert row["mem_available"] == 0 and "mem_headroom_frac" not in row
    text = open(str(tmp_path / "m.prom")).read()
    assert "w2v_mem_bytes_in_use 0.0" in text
    assert "w2v_mem_available 0.0" in text
    assert devmem.device_memory_stats("cpu") is None


def test_helpers_match_jax():
    for dtype in ("float32", "bfloat16"):
        assert devmem.table_row_bytes(Word2VecConfig(**CFG, dtype=dtype)) == \
            jdevmem.table_row_bytes(JConfig(**CFG, dtype=dtype))
    for stats in ({"bytes_limit": 200, "bytes_in_use": 50}, {"bytes_in_use": 5},
                  {"bytes_limit": 10, "bytes_in_use": 20}):
        assert devmem.headroom_fraction(stats) == jdevmem.headroom_fraction(stats)


@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_trainer_ledger_like_jax(monkeypatch, chunk_steps):
    """The trainer's ledger hook: the same device_memory report as the JAX
    trainer (table_place at entry, train_step on the cadence, the flight
    ring's memory rows)."""
    monkeypatch.setenv(devmem.FAKE_STATS_ENV, FAKE)
    t, j = _both(chunk_steps=chunk_steps)
    reps = []
    for tr, mod in ((t, devmem), (j, jdevmem)):
        tr.devmem = mod.MemoryLedger(sample_every=8, flight=tr.flight,
                                     row_bytes=mod.table_row_bytes(tr.config))
        _, rep = tr.train(log_every=0)
        reps.append(rep.device_memory)
        assert tr.flight.snapshot("test")["memory"]
    assert reps[0] == reps[1]
    dm = reps[0]
    assert dm["available"] is True and dm["peak_bytes"] == 400000
    assert dm["phases"]["table_place"]["samples"] == 1
    assert dm["growth_forecast"]["rows_remaining"] == 700000 // (2 * 16 * 4)


def test_swap_table_samples_the_active_ledger(monkeypatch):
    monkeypatch.setenv(devmem.FAKE_STATS_ENV, FAKE)
    vocab = zipf_vocab(20, 400)
    W = np.random.default_rng(0).normal(size=(20, 8)).astype(np.float32)
    eng = QueryEngine(W, vocab, device="cpu")
    led = devmem.MemoryLedger()
    prev = devmem.activate(led)
    try:
        eng.swap_table(W * 2, vocab)
    finally:
        devmem.activate(prev)
    assert led.phases["serve_swap"]["samples"] == 1
    eng.swap_table(W, vocab)  # no ledger: a no-op
    assert led.samples == 1


# -------------------------------------------------------------- profiler
OK_DOC = {"schema": 1, "event": "profiler_capture", "reason": "r",
          "status": "ok", "armed_step": 5, "stopped_step": 8,
          "trace_dir": "d", "files": ["trace.json"], "steps_budget": 2}
CAPTURE_DOCS = [
    OK_DOC,
    {"schema": 1, "event": "profiler_capture", "reason": "r",
     "status": "error", "error": "boom", "steps_budget": 2},
    {"schema": 99},
    "not a dict",
    {"schema": 1, "event": "other", "reason": "r"},
    {"schema": 1, "event": "profiler_capture", "reason": ""},
    {"schema": 1, "event": "profiler_capture", "reason": "r", "status": "maybe"},
    dict(OK_DOC, armed_step=9),
    dict(OK_DOC, stopped_step="8"),
    {k: v for k, v in OK_DOC.items() if k != "trace_dir"},
    {k: v for k, v in OK_DOC.items() if k != "files"},
    {k: v for k, v in OK_DOC.items() if k != "steps_budget"},
    {"schema": 1, "event": "profiler_capture", "reason": "r",
     "status": "error", "steps_budget": 2},
]


def _gate(fn, doc):
    try:
        return ("ok", fn(doc))
    except ValueError as e:
        return ("rejected", str(e))


@pytest.mark.parametrize("i", range(len(CAPTURE_DOCS)))
def test_capture_gate_matches_jax(i):
    doc = CAPTURE_DOCS[i]
    assert _gate(validate_capture_doc, doc) == _gate(j_validate, doc)


def _doc(cap, i=0):
    doc = json.load(open(cap.manifests[i]))
    validate_capture_doc(doc)
    return doc


def test_cpu_window_writes_a_valid_capture(tmp_path):
    cap = ProfilerCapture(str(tmp_path), steps=2, cooldown_s=0.0)
    cap.on_boundary(0)  # idle
    assert not cap.active and cap.request("unit_test")
    cap.on_boundary(3)
    assert cap.active
    cap.on_boundary(4)
    assert cap.active
    cap.on_boundary(5)  # 3 + 2 reached
    assert not cap.active
    doc = _doc(cap)
    assert (doc["armed_step"], doc["stopped_step"], doc["reason"]) == (
        3, 5, "unit_test")
    assert doc["status"] == "ok" and doc["files"] == [TRACE_FILE]
    trace = json.load(open(os.path.join(doc["trace_dir"], TRACE_FILE)))
    assert "traceEvents" in trace
    assert cap.timing["start_ms"] >= 0 and cap.timing["stop_ms"] >= 0
    # scheduled windows and a window the run ends inside
    cap.schedule(10, 12)
    cap.on_boundary(10)
    assert cap.active and _doc(cap)  # manifest 1 still there
    cap.finish(11)
    doc = _doc(cap, 1)
    assert (doc["reason"], doc["armed_step"], doc["stopped_step"]) == (
        "scheduled", 10, 11)
    assert cap.summary()["captures"] == 2


def test_profiler_start_failure_writes_an_error_manifest(tmp_path, monkeypatch):
    from word2vec_tpu_torch.obs import profiler

    def boom():
        raise RuntimeError("profiler already enabled")

    monkeypatch.setattr(profiler, "_start_profiler", boom)
    cap = ProfilerCapture(str(tmp_path), steps=2, cooldown_s=0.0)
    cap.request("unit_test")
    cap.on_boundary(1)
    assert not cap.active
    doc = _doc(cap)
    assert doc["status"] == "error" and "already enabled" in doc["error"]


def test_real_sigusr2_requests_a_window_and_dumps_the_ledger(tmp_path,
                                                            monkeypatch):
    monkeypatch.setenv(devmem.FAKE_STATS_ENV, FAKE)
    led = devmem.MemoryLedger()
    cap = ProfilerCapture(str(tmp_path), steps=2, cooldown_s=0.0)
    orig = signal.getsignal(signal.SIGUSR2)
    uninstall = install_usr2_profile(str(tmp_path), cap, led)
    try:
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 10
        while not os.path.exists(tmp_path / "mem_usr2.json"):
            assert time.monotonic() < deadline, "no mem_usr2.json"
            time.sleep(0.01)
    finally:
        uninstall()
    assert signal.getsignal(signal.SIGUSR2) == orig
    cap.on_boundary(7)  # the handler only requested; the boundary arms
    assert cap.active
    cap.on_boundary(9)
    doc = _doc(cap)
    assert doc["reason"] == "sigusr2"
    mem = json.load(open(tmp_path / "mem_usr2.json"))
    assert mem["reason"] == "sigusr2" and mem["summary"]["available"] is True
    assert led.phases["sigusr2"]["samples"] == 1
