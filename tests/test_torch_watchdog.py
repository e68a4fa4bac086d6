"""The port's step-deadline watchdog (word2vec_tpu_torch/resilience/
watchdog.py) and its wiring in the trainer and the CLI, against the JAX
package, on the CPU.

Pins:
  * the cases of tests/test_watchdog.py's TestStepWatchdog, TestOpenSpans
    and TestBoundedCall (the peer cases come with the multi-process
    layer): it fires when no beat lands, beats keep it quiet, the
    adaptive and grace deadlines equal the JAX watchdog's on the same
    laps, a wedged device_wait span is named in stall.json, the stacks
    and the manifest (stall.json with the JAX record's keys);
  * the trainer beats every boundary without firing (per-step and
    chunk_steps=4) and a `hang` fault trips it in process (on_fire);
  * the CLI: a hang past --step-deadline exits 76 with stall.json,
    stall_stacks.txt, flight.json (reason stalled) and `shutdown: stalled`
    (one subprocess: the fire path os._exits), then --resume ends bitwise
    equal to the uninterrupted run; a bad deadline exits 1 with the JAX
    CLI's message.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from word2vec_tpu.cli import main as jmain  # noqa: E402
from word2vec_tpu.obs.phases import PhaseRecorder as JPhases  # noqa: E402
from word2vec_tpu.resilience import watchdog as jwatchdog  # noqa: E402

from word2vec_tpu_torch import Word2VecConfig  # noqa: E402
from word2vec_tpu_torch.cli import main as tmain  # noqa: E402
from word2vec_tpu_torch.data.batcher import PackedCorpus  # noqa: E402
from word2vec_tpu_torch.obs.phases import PhaseRecorder  # noqa: E402
from word2vec_tpu_torch.resilience.faults import FaultPlan  # noqa: E402
from word2vec_tpu_torch.resilience.shutdown import EXIT_PREEMPTED  # noqa: E402
from word2vec_tpu_torch.resilience.watchdog import (  # noqa: E402
    EXIT_STALLED, StepWatchdog, SyncTimeout, bounded_call, set_sync_deadline,
    sync_deadline,
)
from word2vec_tpu_torch.train import Trainer  # noqa: E402
from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _trainer(**kw):
    kw.setdefault("iters", 2)
    cfg = Word2VecConfig(
        model="sg", train_method="ns", negative=3, word_dim=16, window=2,
        batch_rows=4, max_sentence_len=16, min_count=1, seed=9, **kw,
    )
    vocab = zipf_vocab(40, 4000)
    corpus = PackedCorpus.pack(zipf_corpus_ids(vocab, 3000, seed=5), 16)
    return Trainer(cfg, vocab, corpus, device="cpu")


# ------------------------------------------------------------ StepWatchdog
class TestStepWatchdog:
    def test_fires_when_no_beat_lands(self):
        rec = {}
        wd = StepWatchdog(deadline=0.2, grace_secs=0.2,
                          on_fire=lambda r: rec.update(r))
        wd.arm()
        try:
            assert wd.fired.wait(3.0), "watchdog never fired"
        finally:
            wd.disarm()
        assert rec["event"] == "stalled"
        assert 0.2 <= rec["elapsed_s"] < 2 * 0.2 + 0.2
        assert "main-loop" in rec["phase"]  # nothing was open

    def test_beats_keep_it_quiet_and_disarm_stops_it(self):
        wd = StepWatchdog(deadline=0.2, grace_secs=0.2, on_fire=lambda r: None)
        wd.arm()
        for step in range(8):
            wd.beat(step)
            time.sleep(0.03)
        assert not wd.fired.is_set()
        wd.disarm()
        time.sleep(0.5)  # well past the deadline, but disarmed
        assert not wd.fired.is_set()

    @pytest.mark.parametrize("laps, deadline", [([0.1] * 10, 0.05),
                                                 ([0.1] * 10, 3.0),
                                                 ([0.01, 0.3, 0.02] * 5, 0.2)])
    def test_adaptive_deadline_equals_jax(self, laps, deadline):
        got = []
        for cls in (StepWatchdog, jwatchdog.StepWatchdog):
            wd = cls(deadline=deadline, factor=4.0, grace_secs=9.0,
                     on_fire=lambda r: None)
            wd._beats, wd._laps = len(laps), list(laps)
            got.append((wd.effective_deadline(), wd.step_stats()))
        assert got[0] == got[1]
        if deadline < 1:
            assert got[0][0] == pytest.approx(4.0 * np.percentile(laps, 90),
                                              rel=0.05)

    def test_grace_window_before_min_beats(self):
        wd = StepWatchdog(deadline=0.1, grace_secs=7.0, min_beats=2,
                          on_fire=lambda r: None)
        assert wd.effective_deadline() == 7.0  # capture grace
        wd.beat(1)
        assert wd.effective_deadline() == 7.0  # still < min_beats
        wd.beat(2)
        assert wd.effective_deadline() < 7.0  # adaptive now
        assert StepWatchdog(deadline=20).grace_secs == 120.0
        assert jwatchdog.StepWatchdog(deadline=20).grace_secs == 120.0

    def test_stall_artifacts_and_manifest_like_jax(self, tmp_path):
        records = {}
        for name, cls, rec_cls in (("t", StepWatchdog, PhaseRecorder),
                                   ("j", jwatchdog.StepWatchdog, JPhases)):
            mdir = tmp_path / name
            os.makedirs(mdir)
            man = mdir / "manifest.json"
            man.write_text(json.dumps({"schema": 1, "shutdown": None}))
            rec, done = {}, threading.Event()

            def on_fire(r, rec=rec, done=done):
                rec.update(r)
                done.set()

            phases = rec_cls()
            wd = cls(deadline=0.15, grace_secs=0.15, phases=phases,
                     metrics_dir=str(mdir), manifest_path=str(man),
                     on_fire=on_fire)
            # a device_wait span wedged open in another thread, as the
            # lagged fetch blocks on a wedged card
            release = threading.Event()

            def wedged(phases=phases, release=release):
                with phases.span("device_wait"):
                    release.wait(5.0)

            t = threading.Thread(target=wedged, daemon=True)
            t.start()
            time.sleep(0.05)
            wd.arm()
            wd.beat(7)
            try:
                assert done.wait(3.0)
            finally:
                release.set()
                wd.disarm()
            assert rec["step"] == 7 and rec["phase"] == "device_wait"
            assert rec["open_spans"]["device_wait"] > 0
            stall = json.loads((mdir / "stall.json").read_text())
            assert stall["phase"] == "device_wait" and stall["step"] == 7
            stacks = (mdir / "stall_stacks.txt").read_text()
            assert "Thread" in stacks and "wedged" in stacks
            man_out = json.loads(man.read_text())
            assert man_out["shutdown"] == "stalled"
            assert man_out["stall"]["step"] == 7
            records[name] = stall
        assert sorted(records["t"]) == sorted(records["j"])

    def test_exit_code_distinct(self):
        assert EXIT_STALLED == jwatchdog.EXIT_STALLED == 76
        assert EXIT_STALLED not in (0, 1, 2, 3, EXIT_PREEMPTED)

    def test_rejects_nonpositive_deadline(self):
        with pytest.raises(ValueError):
            StepWatchdog(deadline=0)


# ----------------------------------------------------- PhaseRecorder spans
class TestOpenSpans:
    def test_open_and_wedged(self):
        rec = PhaseRecorder()
        assert rec.open_spans() == {}
        assert rec.wedged_phase() is None
        with rec.span("h2d"):
            with rec.span("device_wait"):
                opens = rec.open_spans()
                assert set(opens) == {"h2d", "device_wait"}
                assert opens["h2d"] >= opens["device_wait"]
                # the loop-stalling phase beats the overlapped h2d
                assert rec.wedged_phase() == "device_wait"
            assert rec.wedged_phase() == "h2d"
        assert rec.open_spans() == {}
        assert rec.wedged_phase() is None

    def test_timed_iter_next_is_an_open_span(self):
        rec = PhaseRecorder()
        seen = {}

        def gen():
            seen.update(rec.open_spans())
            yield 1

        assert list(rec.timed_iter(gen(), "batcher_wait")) == [1]
        assert "batcher_wait" in seen  # open WHILE blocked in next()
        assert rec.open_spans() == {}

    def test_exception_inside_span_still_closes(self):
        rec = PhaseRecorder()
        with pytest.raises(RuntimeError):
            with rec.span("checkpoint"):
                raise RuntimeError("boom")
        assert rec.open_spans() == {}


# ------------------------------------------------------------ bounded_call
class TestBoundedCall:
    def test_no_deadline_is_a_plain_call(self):
        assert bounded_call(lambda: 42) == 42

    def test_returns_value_under_deadline(self):
        assert bounded_call(lambda: 7, deadline=2.0) == 7

    def test_times_out_with_named_what(self):
        with pytest.raises(SyncTimeout, match="agree channel"):
            bounded_call(lambda: time.sleep(5), what="agree channel",
                         deadline=0.1)

    @pytest.mark.parametrize("deadline", [None, 2.0])
    def test_reraises_errors_unchanged(self, deadline):
        err = RuntimeError("Gloo AllGather failed: connection reset by peer")

        def boom():
            raise err

        with pytest.raises(RuntimeError) as e:
            bounded_call(boom, deadline=deadline)
        assert e.value is err

    def test_module_deadline_scoping(self):
        prev = set_sync_deadline(0.1)
        try:
            assert sync_deadline() == 0.1
            with pytest.raises(SyncTimeout):
                bounded_call(lambda: time.sleep(5), what="x")
        finally:
            set_sync_deadline(prev)
        prev = set_sync_deadline(0)
        try:
            assert sync_deadline() is None
        finally:
            set_sync_deadline(prev)


# ------------------------------------------------------- trainer wiring
@pytest.mark.parametrize("chunk_steps", [1, 4])
def test_trainer_beats_every_boundary_no_fire(chunk_steps):
    t = _trainer(chunk_steps=chunk_steps)
    t.watchdog = wd = StepWatchdog(deadline=60.0)
    state, rep = t.train(log_every=0)
    assert not wd.fired.is_set()
    assert not wd._armed  # disarmed on exit
    if chunk_steps == 1:
        assert wd._beats == rep.steps  # one beat per optimizer step
    else:
        # chunked dispatch beats at chunk boundaries: fewer, but present
        assert 1 <= wd._beats < rep.steps
    assert wd.step_stats().get("laps", 0) >= 1


def test_hang_fault_trips_watchdog_in_process():
    t = _trainer(chunk_steps=1, iters=1)
    t.fault_plan = FaultPlan.parse("hang@3:secs=1.5")
    rec = {}
    # after min_beats the adaptive deadline is max(0.25, 4 x p90 of ms
    # steps) = 0.25 s, well under the 1.5 s hang
    t.watchdog = wd = StepWatchdog(
        deadline=0.25, grace_secs=30.0, on_fire=lambda r: rec.update(r),
    )
    state, rep = t.train(log_every=0)  # completes after the 1.5 s sleep
    assert wd.fired.is_set()
    assert rec["step"] == 3
    assert t.fault_plan.log[0]["kind"] == "hang"
    assert rep.steps > 3  # the run went on; only the CLI converts to exit


# ------------------------------------------------------------- CLI chaos
@pytest.fixture
def corpus_file(tmp_path):
    rng = np.random.default_rng(0)
    toks = []
    for _ in range(400):
        toks += ["x", str(rng.choice(["a", "b"])), "y",
                 "p", str(rng.choice(["c", "d"])), "q"]
    p = tmp_path / "corpus.txt"
    p.write_text(" ".join(toks))
    return str(p)


def _common(corpus_file):
    return [
        "-train", corpus_file, "-size", "8", "-negative", "2",
        "-min-count", "1", "--backend", "cpu", "--batch-rows", "4",
        "--max-sentence-len", "32", "--chunk-steps", "1", "--quiet",
    ]


def test_cli_stall_exits_stalled_then_resume_bitwise(tmp_path, corpus_file):
    ck, mdir = str(tmp_path / "ck"), str(tmp_path / "mdir")
    common = _common(corpus_file)
    deadline = 2.0
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "word2vec_tpu_torch.cli", *common,
         "-output", str(tmp_path / "v_stall.txt"), "-iter", "3",
         "--seed", "3", "--checkpoint-dir", ck, "--checkpoint-every", "5",
         "--faults", "hang@10:secs=120", "--step-deadline", str(deadline),
         "--metrics-dir", mdir],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    wall = time.perf_counter() - t0
    assert out.returncode == EXIT_STALLED, out.stderr[-2000:]
    assert wall < 120, wall
    assert "watchdog: no step boundary" in out.stderr
    stall = json.loads(open(os.path.join(mdir, "stall.json")).read())
    assert stall["step"] >= 10
    assert stall["elapsed_s"] <= 2 * deadline + 1.0
    assert "phase" in stall and "boundary_stats" in stall
    assert os.path.getsize(os.path.join(mdir, "stall_stacks.txt")) > 0
    fl = json.loads(open(os.path.join(mdir, "flight.json")).read())
    assert fl["reason"] == "stalled"
    fl_steps = [
        e["args"]["step"] for e in fl["trace"]["traceEvents"]
        if e.get("ph") == "X" and e["name"] in ("step", "chunk")
    ]
    assert fl_steps and max(fl_steps) <= stall["step"]
    man = json.load(open(os.path.join(mdir, "manifest.json")))
    assert man["shutdown"] == "stalled"
    assert not os.path.exists(tmp_path / "v_stall.txt")  # no export

    clean, res = str(tmp_path / "clean.txt"), str(tmp_path / "resumed.txt")
    assert tmain(common + ["-output", clean, "-iter", "3", "--seed", "3"]) == 0
    assert tmain(common + ["-output", res, "-iter", "3", "--seed", "3",
                           "--resume", ck]) == 0
    assert open(clean).read() == open(res).read()


def test_cli_rejects_bad_deadline_like_jax(corpus_file, capsys):
    errs = []
    for main in (tmain, jmain):
        assert main(_common(corpus_file) + ["--step-deadline", "-1"]) == 1
        errs.append(capsys.readouterr().err)
    assert "--step-deadline must be >= 0" in errs[0] and errs[0] == errs[1]
