"""The port's CLI telemetry (word2vec_tpu_torch/cli.py, --backend cpu)
against the JAX CLI, both in process on one tiny corpus (CPU).

Both runs resume from one checkpoint written by the JAX package's saver
(whose config both CLIs adopt: health_metrics on, divergence_budget 2),
with a learning rate (init_alpha 1e-30) that leaves every table cell where
it is (the updates fall below the cells' ulp), so the two packages'
quality probes score the same tables although their draws differ.

Pins:
  * --metrics-dir --trace --quality-probe-every --probe-pairs --slo
    --signal-window --emit-device: the same files in the metrics and trace
    dirs, the same Prometheus names (the cost harvest's byte and flop
    totals aside: torch has no compiled cost analysis to read them from),
    the same manifest keys (those of the unported layers aside), quality
    rows within 1e-6 at the
    same steps, every step record with the health fields, and a trace
    whose step parents count every step;
  * a divergence (rc 2), a QualityAlert (rc 3) and a preemption (rc 75):
    the same exit code, flight.json reason, failure step and manifest
    `shutdown` in both packages;
  * --debug-nans on a NaN checkpoint: FloatingPointError in both, before
    any step (the JAX run raises copying the params in; the port checks
    the tables at entry);
  * the telemetry off (a fresh run, no --metrics-dir): no health fields.
"""

import json
import os
import re
import shutil

import numpy as np
import pytest

import chip_smoke

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from word2vec_tpu.cli import main as jmain  # noqa: E402
from word2vec_tpu.config import Word2VecConfig as JConfig  # noqa: E402
from word2vec_tpu.data.corpus import load_corpus as j_load  # noqa: E402
from word2vec_tpu.io import checkpoint as jck  # noqa: E402
from word2vec_tpu.resilience import shutdown as jshutdown  # noqa: E402
from word2vec_tpu.train import TrainState as JState  # noqa: E402

from word2vec_tpu_torch.cli import main as tmain  # noqa: E402
from word2vec_tpu_torch.obs import tracediff  # noqa: E402
from word2vec_tpu_torch.obs.trace import load_trace, validate_trace_doc  # noqa: E402
from word2vec_tpu_torch.resilience import shutdown as tshutdown  # noqa: E402

#: the JAX cost harvest's totals, read from XLA's cost analysis: the
#: port's harvest rows carry none (obs/harvest.py)
UNPORTED_PROM = ("w2v_cost_harvest_flops", "w2v_cost_harvest_bytes",
                 "w2v_cost_harvest_temp_bytes", "w2v_cost_harvest_code_bytes")
STEPS = 24  # the corpus's steps per epoch at 4 x 32


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("telemetry")
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)]
    p = 1.0 / np.arange(1, 41)
    (d / "c.txt").write_text(" ".join(rng.choice(words, size=3000, p=p / p.sum())))
    (d / "pairs.txt").write_text("".join(
        f"w{i},w{i + 1},{(7 * i) % 10}\n" for i in range(0, 20, 2)))
    jv, _ = j_load(str(d / "c.txt"), min_count=1)
    cfg = JConfig(negative=3, word_dim=16, window=2, min_count=1,
                  subsample_threshold=0.0, batch_rows=4, max_sentence_len=32,
                  chunk_steps=1, init_alpha=1e-30, kernel="band", seed=3,
                  health_metrics=True, divergence_budget=2)
    r = np.random.default_rng(2)
    tables = {k: r.normal(size=(len(jv), 16)).astype(np.float32) / 4
              for k in ("emb_in", "emb_out_ns")}
    for name, poison in (("ck", False), ("nan", True)):
        t = {k: v.copy() for k, v in tables.items()}
        if poison:
            t["emb_in"][0, :] = np.nan
        jck.save_checkpoint(str(d / name), JState(
            {k: jnp.asarray(v) for k, v in t.items()}, step=0, words_done=0,
            epoch=0), cfg, jv)
    return d


def _args(work, pkg, ck="ck", *extra):
    out = ["-train", str(work / "c.txt"), "-output", "", "--quiet",
           "--resume", str(work / ck), "--metrics-dir", str(work / (pkg + "m")),
           "--log-every", "6"] + list(extra)
    if pkg.startswith("t"):
        out += ["--backend", "cpu"]
    return out


def _run(work, pkg, *args):
    for sub in ("m", "tr"):
        shutil.rmtree(work / (pkg + sub), ignore_errors=True)
    main = jmain if pkg.startswith("j") else tmain
    return main(_args(work, pkg, *args))


def _prom_names(path):
    return {re.split(r"[{ ]", line)[0] for line in open(path)
            if line.startswith("w2v_")}


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_telemetry_run_matches_jax(work, capsys):
    flags = ["--trace", None, "--quality-probe-every", "6", "--probe-pairs",
             str(work / "pairs.txt"), "--signal-window", "5", "--slo",
             "throughput_wps<0.01*baseline:for=3", "--emit-device"]
    for pkg in ("j", "t"):
        flags[1] = str(work / (pkg + "tr"))
        assert _run(work, pkg, "ck", *flags) == 0
        assert "device: cpu cpu" in capsys.readouterr().err
    jm, tm = work / "jm", work / "tm"
    assert sorted(os.listdir(tm)) == sorted(os.listdir(jm)) == [
        "fleet.json", "manifest.json", "metrics.jsonl", "metrics.prom",
        "signals_p0.jsonl"]
    assert sorted(os.listdir(work / "ttr")) == sorted(os.listdir(work / "jtr"))
    jnames = {n for n in _prom_names(jm / "metrics.prom")
              if not n.startswith(UNPORTED_PROM)}
    assert _prom_names(tm / "metrics.prom") == jnames
    jman = json.load(open(jm / "manifest.json"))
    tman = json.load(open(tm / "manifest.json"))
    assert set(tman) == set(jman)
    assert set(tman) == set(chip_smoke.TEL_MANIFEST_KEYS)  # phase 9's copy
    assert tman["shutdown"] == jman["shutdown"] == "clean"
    assert tman["final_step"] == jman["final_step"] == STEPS

    jrec, trec = _records(jm / "metrics.jsonl"), _records(tm / "metrics.jsonl")
    jq = [r for r in jrec if "quality_row_norm_p50" in r]
    tq = [r for r in trec if "quality_row_norm_p50" in r]
    assert [r["step"] for r in tq] == [r["step"] for r in jq] == [6, 12, 18, 24]
    for a, b in zip(tq, jq):
        assert set(a) == set(b)
        for k in a:
            if k != "quality_probe_ms":
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6,
                                           err_msg=k)
    steps = [r for r in trec if "loss" in r and "event" not in r]
    assert [r["step"] for r in steps] == [6, 12, 18, 24]
    for r in steps:
        assert r["nonfinite_params"] == 0 and r["grad_norm"] >= 0
        assert {"update_norm_emb_in", "update_norm_emb_out_ns",
                "alpha_device", "phases"} <= set(r)
    jsteps = [r for r in jrec if "loss" in r and "event" not in r]
    assert {k for k in steps[0] if k != "hs_tail_dropped"} == set(jsteps[0])
    assert {"signals", "fleet", "train_report", "mesh"} <= {
        r.get("event") for r in trec}

    doc = load_trace(str(work / "ttr" / "trace.json"))
    validate_trace_doc(doc)
    assert tracediff.summarize(doc)["steps"] == STEPS


def _flight(work, pkg):
    doc = json.load(open(work / (pkg + "m") / "flight.json"))
    man = json.load(open(work / (pkg + "m") / "manifest.json"))
    return doc, man


EXITS = {
    "diverged": (2, "nan", []),  # the checkpoint's divergence_budget 2
    "quality_alert": (3, "ck", ["--quality-probe-every", "6", "--probe-pairs",
                                None, "--quality-budget", "1",
                                "--quality-floor", "0.99",
                                "--quality-grace", "0"]),
    "preempted": (75, "ck", []),
}


@pytest.mark.parametrize("reason", list(EXITS))
def test_abnormal_exits_dump_flight_like_jax(work, reason, monkeypatch):
    rc, ck, extra = EXITS[reason]
    extra = [str(work / "pairs.txt") if a is None else a for a in extra]
    if reason == "preempted":
        monkeypatch.setattr(jshutdown.ShutdownHandler, "make_stop_check",
                            lambda self, *a, **k: lambda step: step >= 9)
        monkeypatch.setattr(tshutdown.ShutdownHandler, "make_stop_check",
                            lambda self: lambda step: step >= 9)
    got = {}
    for pkg in ("j", "t"):
        assert _run(work, pkg, ck, *extra) == rc
        got[pkg] = _flight(work, pkg)
    (jdoc, jman), (tdoc, tman) = got["j"], got["t"]
    assert tdoc["reason"] == jdoc["reason"] == reason
    assert tdoc["failure_step"] == jdoc["failure_step"]
    assert tman["shutdown"] == jman["shutdown"]
    if reason == "diverged":
        bad = [c for c in tdoc["counters"] if c.get("nonfinite_params", 0) > 0]
        assert bad and tman["divergence"]["step"] == jman["divergence"]["step"]
    if reason == "quality_alert":
        assert tdoc["quality"] and tman["quality_alert"]["step"] == 12


def test_debug_nans_raises_before_any_step_like_jax(work):
    for pkg in ("j", "t"):
        with pytest.raises(FloatingPointError) as e:
            _run(work, pkg, "nan", "--debug-nans")
        recs = _records(work / (pkg + "m") / "metrics.jsonl")
        assert not [r for r in recs if "loss" in r]  # no step ran
    assert "non-finite emb_in at entry (step 0)" in str(e.value)


def test_telemetry_off_adds_no_health_fields(work):
    """A fresh run without --metrics-dir: health_metrics stays off, so the
    step records carry the always-on non-finite count only, and a resumed
    run's checkpoint keeps health_metrics off."""
    jsonl = work / "off.jsonl"
    ck = work / "offck"
    args = ["-train", str(work / "c.txt"), "-output", "", "--quiet",
            "--backend", "cpu", "-negative", "3", "-size", "16",
            "-min-count", "1", "-subsample", "0", "--batch-rows", "4",
            "--max-sentence-len", "32", "--log-every", "6",
            "--log-jsonl", str(jsonl), "--checkpoint-dir", str(ck)]
    assert tmain(args) == 0
    steps = [r for r in _records(jsonl) if "loss" in r and "event" not in r]
    assert steps and all("grad_norm" not in r and "update_norm_emb_in" not in r
                         for r in steps)
    assert all(r["nonfinite_loss_steps"] == 0 for r in steps)
    from word2vec_tpu_torch.io.checkpoint import load_checkpoint

    cfg = load_checkpoint(str(ck))[1]
    assert not cfg.health_metrics and cfg.quality_probe_every == 0


# ------------------------------------------------------------ the trainer
@pytest.mark.parametrize("dispatch", [dict(chunk_steps=1),
                                      dict(chunk_steps=4, resident="off"),
                                      dict(chunk_steps=4, resident="on")],
                         ids=["per-step", "chunk4", "resident"])
def test_trainer_telemetry_hooks(dispatch, tmp_path):
    """health_metrics, the config-built quality probe, a signal engine and
    the flight recorder on one Trainer run: the report's phases, signals
    and health; a probe row at each due boundary under its span; every
    step on the flight timeline; health fields in every log record."""
    import torch_parity as tp_
    from word2vec_tpu_torch import Trainer
    from word2vec_tpu_torch.obs.signals import SignalEngine
    from word2vec_tpu_torch.obs.slo import SloEvaluator, parse_slo

    cfg = tp_.trainer_cfg(health_metrics=True, quality_probe_every=4,
                          **dispatch)
    vocab, corpus = tp_.small_corpus()
    logs = []
    tr = Trainer(cfg, vocab, corpus, log_fn=logs.append, device="cpu")
    tr.signals = SignalEngine(
        window=4, phases=tr.phases, flight=tr.flight,
        metrics_dir=str(tmp_path),
        slo=SloEvaluator(parse_slo("throughput_wps<0.01*baseline:for=3")))
    state, rep = tr.train(log_every=4)
    assert rep.phases["verdict"] in ("compute-bound", "input-bound")
    assert {"dispatch", "device_wait", "batcher_wait",
            "quality_probe"} <= set(rep.phases["phases"])
    assert rep.signals["windows"] >= 2 and rep.signals["slo"]["state"] == "ok"
    assert rep.health["grad_norm_cumulative"] > 0
    assert rep.health["observations"] == rep.steps
    probes = [r for r in logs if "quality_row_norm_p50" in r]
    assert len(probes) == tr.quality_probe.probes >= rep.steps // 4 - 1
    assert tr.quality_probe.timing["score_ms"] > 0
    assert tracediff.summarize(tr.flight.ring.events())["steps"] == rep.steps
    steps = [r for r in logs if "loss" in r and "event" not in r]
    assert steps and all(r["nonfinite_params"] == 0 and r["grad_norm"] > 0
                         and r["alpha_device"] > 0 for r in steps)


def test_debug_nans_names_the_first_non_finite_step():
    """A table cell poisoned at the step-3 boundary (the checkpoint hook
    sees the live tables): the eager run raises at step 4, the next one."""
    import torch_parity as tp_
    from word2vec_tpu_torch import Trainer

    vocab, corpus = tp_.small_corpus()
    tr = Trainer(tp_.trainer_cfg(chunk_steps=4), vocab, corpus, device="cpu")
    tr.debug_nans = True

    def poison(state):
        state.params["emb_in"][0, 0] = float("nan")

    with pytest.raises(FloatingPointError, match="non-finite loss, emb_in, .* at step 4$"):
        tr.train(checkpoint_cb=poison, checkpoint_every=3)
    assert tr.last_state.step == 4
