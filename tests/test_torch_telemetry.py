"""The port's host telemetry modules against the JAX package's (CPU):
obs/phases, obs/manifest, obs/slo, obs/fleet, obs/watch and obs/tracediff
on the same inputs.

Pins:
  * PhaseRecorder on one scripted sequence of spans, timed iterations and
    notes, with both packages' clocks patched to the same script: the same
    report, snapshot, verdict, open spans and wedged phase;
  * manifest_dict: the same keys (and device keys), the library versions
    aside; update_manifest / append_manifest_event the same documents;
  * parse_slo on the JAX tests' rule strings (the rules, and the error
    text of every bad spec) and SloEvaluator on the same window series:
    the same events and summaries;
  * fleet merge_rows / fleet_doc / validate_fleet_doc / FleetAggregator,
    watch.render, and tracediff summarize / diff on the same rows and
    trace documents: equal outputs.
"""

import json
import random

import pytest

pytest.importorskip("jax")

from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.obs import fleet as jfleet  # noqa: E402
from word2vec_tpu.obs import manifest as jman  # noqa: E402
from word2vec_tpu.obs import phases as jphases  # noqa: E402
from word2vec_tpu.obs import slo as jslo  # noqa: E402
from word2vec_tpu.obs import tracediff as jdiff  # noqa: E402
from word2vec_tpu.obs import watch as jwatch  # noqa: E402

from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.obs import fleet as tfleet  # noqa: E402
from word2vec_tpu_torch.obs import manifest as tman  # noqa: E402
from word2vec_tpu_torch.obs import phases as tphases  # noqa: E402
from word2vec_tpu_torch.obs import signals as tsignals  # noqa: E402
from word2vec_tpu_torch.obs import slo as tslo  # noqa: E402
from word2vec_tpu_torch.obs import tracediff as tdiff  # noqa: E402
from word2vec_tpu_torch.obs import watch as twatch  # noqa: E402
from word2vec_tpu_torch.obs.trace import TraceRing, chrome_trace_doc  # noqa: E402


# ---------------------------------------------------------------- phases
class _Clock:
    """A scripted perf_counter: each read advances by the next delta."""

    def __init__(self, deltas):
        self.t = 100.0
        self.deltas = list(deltas)

    def perf_counter(self):
        self.t += self.deltas.pop(0) if self.deltas else 0.001
        return self.t


def _script(mod, monkeypatch):
    rng = random.Random(5)
    clock = _Clock([rng.uniform(1e-4, 5e-3) for _ in range(400)])
    monkeypatch.setattr(mod, "time", clock)
    rec = mod.PhaseRecorder()
    out = {"empty": (rec.report(), rec.verdict(), rec.wedged_phase())}
    for i in range(12):
        for _ in rec.timed_iter(iter([i]), "batcher_wait"):
            with rec.span("h2d"):
                pass
            with rec.span("dispatch"):
                pass
            if i % 3 == 0:
                with rec.span("device_wait"):
                    pass
            if i % 5 == 4:
                rec.note("checkpoint", 0.02 * i)
    span = rec.span("quality_probe")
    span.__enter__()
    with rec.span("device_wait"):
        out["open"] = sorted(rec.open_spans())
        out["wedged"] = rec.wedged_phase()
    span.__exit__(None, None, None)
    out["report"] = rec.report()
    out["snapshot"] = rec.snapshot()
    out["verdict"] = rec.verdict()
    rec.reset()
    out["reset"] = rec.report()
    return out


def test_phase_recorder_matches_jax(monkeypatch):
    j = _script(jphases, monkeypatch)
    t = _script(tphases, monkeypatch)
    assert t == j
    assert t["report"]["verdict"] == "compute-bound"
    assert t["wedged"] == "device_wait" and t["reset"] is None


def test_signals_reads_the_phase_tuples():
    assert tsignals.INPUT_PHASES is tphases.INPUT_PHASES
    assert tphases.INPUT_PHASES == jphases.INPUT_PHASES
    assert tphases.COMPUTE_PHASES == jphases.COMPUTE_PHASES


# -------------------------------------------------------------- manifest
def test_manifest_keys_match_jax(tmp_path):
    kw = dict(negative=5, word_dim=32, band_backend="pallas_fused",
              table_layout="unified", band_chunk=16)
    jm = jman.manifest_dict(JConfig(**kw), vocab_size=10, extra={"x": 1})
    tm = tman.manifest_dict(Word2VecConfig(**kw), vocab_size=10,
                            extra={"x": 1}, device="cpu")
    assert sorted(tm) == sorted(jm)
    assert sorted(tm["device"]) == sorted(jm["device"])
    assert tm["device"]["platform"] == "cpu"
    assert sorted(tm["versions"]) == ["cuda", "numpy", "python", "torch"]
    for k in ("schema", "vocab_size", "plan", "plan_source", "band_backend",
              "kernel", "git_sha", "x"):
        assert tm[k] == jm[k], k


def test_manifest_updates_match_jax(tmp_path):
    docs = {}
    for name, mod, cfg in (("j", jman, JConfig()), ("t", tman, Word2VecConfig())):
        path = str(tmp_path / f"{name}.json")
        mod.write_manifest(path, cfg, vocab_size=3, include_config=False)
        mod.update_manifest(path, {"shutdown": "clean", "final_step": 7})
        mod.append_manifest_event(path, "mesh_events", {"gen": 0})
        mod.append_manifest_event(path, "mesh_events", {"gen": 1})
        doc = json.load(open(path))
        docs[name] = {k: v for k, v in doc.items()
                      if k not in ("created_utc", "argv", "versions", "device")}
    assert docs["t"] == docs["j"]
    assert docs["t"]["mesh_events"] == [{"gen": 0}, {"gen": 1}]
    assert tman.update_manifest(str(tmp_path / "missing.json"), {}) is None


# ------------------------------------------------------------------- slo
GOOD_SPECS = [
    "serve_p99_ms>250:for=2,throughput_wps<0.8*baseline",
    "tp<0.8*baseline:for=3:baseline=2",
    "tp<10:for=1",
    "p99>100:for=2",
    "throughput_wps<0.5*baseline:for=3",
    "quality_planted<0.5",
    "",
    "  ",
]
BAD_SPECS = ["bogus@x", "a<1,qps>>5", "qps<banana", "qps<0.8*peak",
             "qps<1:for=0", "qps<1:hold=3", "qps<1:for", "9bad<1",
             "a<1,b<2,c<x"]


@pytest.mark.parametrize("spec", GOOD_SPECS)
def test_parse_slo_matches_jax(spec):
    assert [r.to_json() for r in tslo.parse_slo(spec)] == [
        r.to_json() for r in jslo.parse_slo(spec)]
    assert [str(r) for r in tslo.parse_slo(spec)] == [
        str(r) for r in jslo.parse_slo(spec)]


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_slo_errors_match_jax(spec):
    with pytest.raises(jslo.SloError) as je:
        jslo.parse_slo(spec)
    with pytest.raises(tslo.SloError) as te:
        tslo.parse_slo(spec)
    assert str(te.value) == str(je.value) and "at offset" in str(te.value)


def test_parse_slo_json_file_matches_jax(tmp_path):
    p = tmp_path / "rules.json"
    p.write_text(json.dumps(["throughput_wps<0.5*baseline:for=4",
                             {"rule": "serve_p99_ms>100"}]))
    assert [r.to_json() for r in tslo.parse_slo(str(p))] == [
        r.to_json() for r in jslo.parse_slo(str(p))]


SERIES = [
    ("tp<0.8*baseline:for=3:baseline=2",
     [{"tp": v} for v in (100.0, 100.0, 50.0, 50.0, 50.0, 50.0, 100.0)]),
    ("tp<10:for=1", [{"tp": 1.0}] * 5),
    ("serve_p99_ms>10", [{"tp": 1.0}] * 3),
    ("p99>100:for=2,tp<0.5*baseline", [{"p99": 50.0, "tp": 9.0},
                                       {"p99": 150.0, "tp": 9.0},
                                       {"p99": 150.0, "tp": 2.0},
                                       {"p99": 20.0, "tp": 2.0},
                                       {"p99": 20.0, "tp": 9.0}]),
]


@pytest.mark.parametrize("i", range(len(SERIES)))
def test_slo_evaluator_matches_jax(i):
    spec, series = SERIES[i]
    jev = jslo.SloEvaluator(jslo.parse_slo(spec))
    tev = tslo.SloEvaluator(tslo.parse_slo(spec))
    for w, vals in enumerate(series):
        assert tev.evaluate(dict(vals), w) == jev.evaluate(dict(vals), w)
    assert tev.summary() == jev.summary()


# ----------------------------------------------------------------- fleet
def _host_rows(host, windows, p50_ms, wps, clock0=0.0):
    return [{
        "event": "signals", "window": w, "host": host,
        "step": (w + 1) * 10, "window_wall_s": round(0.5 + clock0, 4),
        "signal_throughput_wps": wps, "signal_step_time_p50_ms": p50_ms,
        "signal_input_bound_ratio": 0.1 * host,
    } for w in windows]


FLEETS = {
    "three-skewed": (_host_rows(0, [0, 1, 2], 10.0, 1000.0)
                     + _host_rows(1, [0, 1, 2], 11.0, 950.0, 3600.0)
                     + _host_rows(2, [0, 1, 2], 40.0, 400.0, -7200.0)),
    "partial": _host_rows(0, [0, 1], 10.0, 100.0) + _host_rows(1, [1], 10.0, 100.0),
    "single": _host_rows(0, [0], 50.0, 100.0),
}


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_merge_and_doc_match_jax(name):
    rows = list(FLEETS[name])
    random.Random(3).shuffle(rows)
    tm, jm = tfleet.merge_rows(list(rows)), jfleet.merge_rows(list(rows))
    assert tm == jm
    tdoc = tfleet.fleet_doc(tm, window_steps=10)
    jdoc = jfleet.fleet_doc(jm, window_steps=10)
    tdoc.pop("created_utc", None), jdoc.pop("created_utc", None)
    assert tdoc == jdoc
    assert tfleet.validate_fleet_doc(tdoc) == jfleet.validate_fleet_doc(jdoc)
    slo = {"state": "warn", "breaches_total": 0, "warns_total": 1,
           "rules": [{"rule": "tp<1", "state": "warn"}]}
    assert twatch.render(tdoc, slo=slo) == jwatch.render(jdoc, slo=slo)


def test_fleet_validate_errors_match_jax():
    doc = tfleet.fleet_doc(tfleet.merge_rows(_host_rows(0, [0, 1], 1.0, 1.0)))
    doc["windows"][1]["window"] = 0
    for bad in ({"schema": 99}, doc):
        with pytest.raises(ValueError) as je:
            jfleet.validate_fleet_doc(json.loads(json.dumps(bad)))
        with pytest.raises(ValueError) as te:
            tfleet.validate_fleet_doc(json.loads(json.dumps(bad)))
        assert str(te.value) == str(je.value)


def test_fleet_aggregator_matches_jax(tmp_path):
    recs, docs = {}, {}
    for name, mod in (("j", jfleet), ("t", tfleet)):
        d = tmp_path / name
        d.mkdir()
        for host, p50 in ((0, 10.0), (1, 45.0)):
            with open(d / f"signals_p{host}.jsonl", "w") as f:
                for r in _host_rows(host, [0, 1], p50, 500.0):
                    f.write(json.dumps(r) + "\n")
        agg = mod.FleetAggregator(str(d), window_steps=10)
        recs[name] = [agg.aggregate(), agg.aggregate()]
        with open(d / "signals_p0.jsonl", "a") as f:
            f.write(json.dumps(_host_rows(0, [2], 10.0, 500.0)[0]) + "\n")
        recs[name].append(agg.aggregate(force=True))
        doc = json.loads((d / "fleet.json").read_text())
        doc.pop("created_utc", None)
        docs[name] = doc
    assert recs["t"] == recs["j"] and recs["t"][1] is None
    assert docs["t"] == docs["j"]


# ------------------------------------------------------------- tracediff
def _trace(step_ms, chunk):
    """A two-dispatch trace doc: parents with args.steps, four spans."""
    ring = TraceRing()
    t = 10.0
    for i in range(4):
        w = chunk
        for name, ms in (("batcher_wait", 0.2), ("h2d", 0.1),
                         ("dispatch", step_ms * 0.1), ("device_wait", step_ms * w)):
            ring.complete(name, t, ms / 1e3)
            t += ms / 1e3
        ring.complete("chunk" if w > 1 else "step", t - step_ms * w / 1e3,
                      step_ms * w / 1e3, args={"step": (i + 1) * w, "steps": w})
    return chrome_trace_doc(ring.events(), process_index=0)


@pytest.mark.parametrize("chunks", [(1, 1), (1, 4), (4, 2)])
def test_tracediff_matches_jax(chunks):
    a, b = _trace(2.0, chunks[0]), _trace(3.5, chunks[1])
    assert tdiff.summarize(a) == jdiff.summarize(a)
    assert tdiff.summarize(a["traceEvents"]) == jdiff.summarize(a["traceEvents"])
    assert tdiff.diff(a, b) == jdiff.diff(a, b)
    assert tdiff.summarize(b)["steps"] == 4 * chunks[1]
