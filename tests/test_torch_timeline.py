"""The trainer's dispatch timeline (word2vec_tpu_torch/obs/flight.py
DispatchTimeline, FlightRecorder.note_dispatch, flight.last(); train.py's
loop and its epoch_prep span) and the benchmark's two readers of it
(gpubench/metrics/trainer.host_paced_share.py,
device_idle_share.in_dispatch.py).

On the CPU the card's events are a fake with a scripted clock (record /
query / elapsed_time, as torch.cuda.Event, each event tied to the stream it
was recorded on, as a card's events are to their card): the totals are the
sum of the rows, a row is starved exactly where the previous end's query
said it had passed, an epoch's first dispatch is flagged, the rows are
bounded and the totals are not, every event lands on the trainer's stream,
nothing is recorded without a recorder, the timeline adds no host sync or
event wait, the recorder outlives its trainer as flight.last(), a SIGUSR1
dumps it when no run is active, and a trace document carries the clock's
Unix origin. The card tests inject a host delay every dispatch and read the
starved share it predicts, and time a trainer on a card other than the
process's current one. Run them on a card with

    python -m pytest tests/test_torch_timeline.py -q --noconftest
"""

import gc
import json
import os
import signal
import time
import weakref
from pathlib import Path

import pytest
import torch

from gpubench.manifest import Manifest
from word2vec_tpu_torch import PackedCorpus, Trainer, Word2VecConfig
from word2vec_tpu_torch.obs import flight
from word2vec_tpu_torch.obs.flight import (
    DEVICE_TRACK, DISPATCH_TOTALS, DispatchTimeline, FlightRecorder,
)
from word2vec_tpu_torch.obs.trace import chrome_trace_doc, validate_trace_doc
from word2vec_tpu_torch.resilience.shutdown import install_usr1_dump
from word2vec_tpu_torch.utils.synthetic import zipf_corpus_ids, zipf_vocab

REPO = Path(__file__).resolve().parents[1]
CELLS = ["sgns_d300.train_text8", "sghs_d300.train_text8"]
HOST_PACED, IN_DISPATCH = "trainer.host_paced_share", "device_idle_share.in_dispatch"


class FakeClock:
    """The card's clock for FakeEvent: each record() lands `tick` ms after
    the one before; query() answers from `starved(n)` for its n-th call;
    `streams` are the streams the events were recorded on, in order."""

    def __init__(self, starved=lambda n: n % 3 == 0, tick=lambda n: 1.0 + n % 4):
        self.t, self.n_rec = 0.0, 0
        self.queries, self.answers, self.syncs = 0, [], 0
        self.streams = []
        self._starved, self._tick = starved, tick

    def event(self):
        return FakeEvent(self)


class FakeStream:
    def __init__(self, device):
        self.device = device


STREAM = FakeStream("cuda:0")


class FakeEvent:
    def __init__(self, clock):
        self.clock, self.t, self.stream = clock, None, None

    def record(self, stream=None):
        c = self.clock
        c.t += c._tick(c.n_rec)
        c.n_rec += 1
        c.streams.append(stream)
        self.t, self.stream = c.t, stream

    def query(self):
        c = self.clock
        ans = bool(c._starved(c.queries))
        c.queries += 1
        c.answers.append(ans)
        return ans

    def elapsed_time(self, end):
        assert self.t is not None and end.t is not None
        # a card times an event only against one of its own card
        assert self.stream is not None and end.stream is self.stream
        return end.t - self.t

    def synchronize(self):
        self.clock.syncs += 1


def _drive(timeline, plan, end_stream=STREAM):
    """plan: [(steps, epoch_first)]; each dispatch begun, its end event
    recorded on `end_stream` (the trainer's: the timeline's) and issued,
    and closed one dispatch late, as the trainer's loop does. The card's
    times of each dispatch's start and end, in order."""
    timeline.open()
    marks, pending, step = [], None, 0
    for steps, first in plan:
        mark = timeline.begin(first)
        end = timeline.end_event()
        end.record(end_stream)
        mark = timeline.issued(mark, end)
        step += steps
        marks.append((mark[1].t, mark[-1].t))
        if pending is not None:
            DispatchTimeline.close(*pending)
        pending = (mark, step, steps)
    DispatchTimeline.close(*pending)
    return marks


PLAN = [(4, True), (4, False), (4, False), (2, False),
        (4, True), (4, False), (3, False)]


def test_timeline_rows_and_totals():
    clock = FakeClock()
    fr = FlightRecorder()
    marks = _drive(DispatchTimeline(fr, clock.event, STREAM), PLAN)
    rows, tot = fr.dispatch_rows(), fr.dispatch_totals()
    assert len(rows) == len(PLAN) == tot["dispatches"]
    assert [r["steps"] for r in rows] == [s for s, _ in PLAN]
    assert [r["step"] for r in rows] == [4, 8, 12, 14, 18, 22, 25]
    assert [r["epoch_first"] for r in rows] == [f for _, f in PLAN]
    # one query a dispatch but the first (it has no previous end), and a
    # row is starved exactly where that query said the end had passed
    assert clock.queries == len(PLAN) - 1
    assert [r["starved"] for r in rows] == [False] + clock.answers
    for i, (r, (start, end)) in enumerate(zip(rows, marks)):
        assert r["device_s"] == pytest.approx((end - start) / 1e3)
        prev = marks[i - 1][1] if i else start
        assert r["gap_s"] == pytest.approx((start - prev) / 1e3)
    assert sum(r["steps"] for r in rows) == 25
    assert tot["device_s"] == pytest.approx(sum(r["device_s"] for r in rows))
    assert tot["gap_s"] == pytest.approx(sum(r["gap_s"] for r in rows))
    assert tot["starved_s"] == pytest.approx(
        sum(r["gap_s"] for r in rows if r["starved"]))
    assert tot["queued_s"] == pytest.approx(
        sum(r["gap_s"] for r in rows if not r["starved"]))
    assert tot["starved_epoch_s"] == pytest.approx(
        sum(r["gap_s"] for r in rows if r["starved"] and r["epoch_first"]))
    assert sum(r["starved"] for r in rows) > 0
    assert tot["starved_epoch_s"] > 0 and set(tot) == set(DISPATCH_TOTALS)
    assert clock.syncs == 0 and set(clock.streams) == {STREAM}
    # every row on the ring's device track, at its start on the ring axis
    dev = [e for e in fr.ring.events() if e["tid"] == DEVICE_TRACK]
    assert [e["args"]["step"] for e in dev] == [r["step"] for r in rows]
    assert [e["name"] for e in dev] == ["device"] * len(rows)
    starts = [e["ts"] for e in dev]
    for a, b, m0, m1 in zip(starts, starts[1:], marks, marks[1:]):
        assert b - a == pytest.approx(1e3 * (m1[0] - m0[0]), abs=0.2)
    assert [e["dur"] for e in dev] == [
        pytest.approx(1e3 * (e - s), abs=0.1) for s, e in marks]
    # a new call starts from nothing
    _drive(DispatchTimeline(fr, FakeClock().event, STREAM), PLAN[:2])
    assert fr.dispatch_totals()["dispatches"] == len(fr.dispatch_rows()) == 2


def test_rows_bounded_totals_whole(monkeypatch):
    monkeypatch.setattr(FlightRecorder, "DISPATCH_ROWS", 5)
    fr = FlightRecorder()
    plan = [(2, i % 6 == 0) for i in range(17)]
    _drive(DispatchTimeline(fr, FakeClock().event, STREAM), plan)
    rows, tot = fr.dispatch_rows(), fr.dispatch_totals()
    assert len(rows) == 5 and rows[-1]["step"] == 34
    assert tot["dispatches"] == 17
    assert tot["device_s"] > sum(r["device_s"] for r in rows)
    assert fr.snapshot("t")["dispatch"] == {"totals": tot, "rows": rows}
    assert "dispatch" not in FlightRecorder().snapshot("t")
    assert FlightRecorder().dispatch_totals() is None


# ----------------------------------------------------------- the trainer
def _trainer(device="cpu", **over):
    vocab = zipf_vocab(50, 5000)
    corpus = PackedCorpus.pack(zipf_corpus_ids(vocab, 1500, seed=3, sentence_len=37), 24)
    base = dict(model="sg", train_method="ns", negative=3, word_dim=16, window=3,
                min_count=1, subsample_threshold=1e-3, iters=2, batch_rows=4,
                max_sentence_len=24, band_chunk=8, shared_negatives=8, seed=11,
                chunk_steps=4, kernel="band")
    base.update(over)
    return Trainer(Word2VecConfig(**base), vocab, corpus, device=device)


def _fake_streams(monkeypatch):
    """One fake stream a trainer, on its device, as Trainer._stream()."""
    streams = {}
    monkeypatch.setattr(
        Trainer, "_stream", lambda self: streams.setdefault(id(self), FakeStream(self.device)))


def _fake_timeline(monkeypatch, clock, snapshot=True):
    """The card's timeline on the CPU: fake events on the trainer's own
    stream, one fake stream a trainer, and (`snapshot`) the card's
    snapshot, which records the timeline's end events."""
    if snapshot:
        _card_like_snapshot(monkeypatch, clock, [])
    _fake_streams(monkeypatch)
    monkeypatch.setattr(
        Trainer, "_dispatch_timeline",
        lambda self: None if self.flight is None
        else DispatchTimeline(self.flight, clock.event, self._stream()))


def _count(monkeypatch, counts):
    for name in ("_sync", "_device_get"):
        orig = getattr(Trainer, name)

        def counted(self, *a, _orig=orig, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(self, *a)

        monkeypatch.setattr(Trainer, name, counted)


def _card_like_snapshot(monkeypatch, clock, flags):
    """The card's snapshot on the CPU: its metrics copy marked by an event
    on the trainer's stream that the drain then waits on (the timeline's
    end event with the timeline, as on the card, else a new one of
    `clock`)."""
    orig = Trainer._snapshot
    _fake_streams(monkeypatch)

    def snapshot(self, metrics, done=None):
        names, host, _ = orig(self, metrics)
        flags.append(done is not None)
        if done is None:
            done = clock.event()
        done.record(self._stream())
        return names, host, done

    monkeypatch.setattr(Trainer, "_snapshot", snapshot)


@pytest.mark.parametrize("resident", ["on", "off"])
def test_trainer_rows_one_a_dispatch(monkeypatch, resident):
    clock = FakeClock()
    _fake_timeline(monkeypatch, clock)
    tr = _trainer(resident=resident)
    _, rep = tr.train(log_every=0)
    rows = tr.flight.dispatch_rows()
    spe = -(-tr.corpus.num_rows // 4)
    assert sum(r["steps"] for r in rows) == rep.steps == 2 * spe
    assert len(rows) == 2 * -(-spe // 4)
    assert [r["epoch_first"] for r in rows].count(True) == 2
    assert rows[0]["epoch_first"] and rows[len(rows) // 2]["epoch_first"]
    assert rep.dispatch == tr.flight.dispatch_totals()
    assert rep.dispatch["dispatches"] == len(rows)
    # one query a dispatch but the first; the drain's one wait a dispatch
    assert clock.queries == len(rows) - 1 and clock.syncs == len(rows)
    assert flight.last() is tr.flight
    # the epoch's preparation is its own span, once an epoch, outside the
    # verdict's phases; next() of the dispatches is batcher_wait, once a
    # dispatch
    ph = rep.phases["phases"]
    assert ph["epoch_prep"]["count"] == 2
    assert ph["batcher_wait"]["count"] == len(rows)
    inp = ph["batcher_wait"]["total_ms"]
    comp = ph["dispatch"]["total_ms"] + ph["device_wait"]["total_ms"]
    assert rep.phases["input_fraction"] == pytest.approx(inp / (inp + comp), abs=1e-4)


def test_no_recorder_no_rows(monkeypatch):
    clock = FakeClock()
    _fake_timeline(monkeypatch, clock, snapshot=False)
    tr = _trainer()
    tr.flight = None
    _, rep = tr.train(log_every=0)
    assert rep.dispatch is None and clock.n_rec == 0
    assert flight.last() is None
    # on the CPU the trainer makes no timeline of its own
    monkeypatch.undo()
    tr = _trainer()
    _, rep = tr.train(log_every=0)
    assert rep.dispatch is None and tr.flight.dispatch_totals() is None


def test_timeline_adds_no_host_wait(monkeypatch):
    """The trainer's syncs and metric waits per dispatch, with the timeline
    and without, the drain's wait on the card's snapshot event included:
    the same; the timeline only queries (one a dispatch but the first)."""
    got = {}
    for arm in ("off", "on"):
        with monkeypatch.context() as m:
            counts, timing, clock = {}, [], FakeClock()
            _count(m, counts)
            _card_like_snapshot(m, clock, timing)
            if arm == "on":
                _fake_timeline(m, clock, snapshot=False)
            tr = _trainer(resident="on")
            _, rep = tr.train(log_every=0)
            n = tr.flight.dispatch_totals()
            got[arm] = (counts, clock.syncs, clock.queries, set(timing), n)
    dispatches = got["on"][4]["dispatches"]
    assert dispatches > 4 and got["off"][4] is None
    assert got["on"][0] == got["off"][0] == {"_sync": 2, "_device_get": dispatches}
    assert got["on"][1] == got["off"][1] == dispatches  # the drain's wait
    assert (got["off"][2], got["on"][2]) == (0, dispatches - 1)
    assert (got["off"][3], got["on"][3]) == ({False}, {True})


def test_events_on_the_trainers_stream(monkeypatch):
    """Every event of a run, the metrics copy's end event included, lands
    on the stream of the trainer's own card, which need not be the
    process's current one; an end recorded on another card's stream cannot
    be timed against its start."""
    clock, timing = FakeClock(), []
    _fake_timeline(monkeypatch, clock, snapshot=False)
    _card_like_snapshot(monkeypatch, clock, timing)
    tr = _trainer(resident="on")
    _, rep = tr.train(log_every=0)
    assert rep.dispatch["dispatches"] == len(tr.flight.dispatch_rows()) > 4
    assert set(timing) == {True}
    assert set(clock.streams) == {tr._stream()} and tr._stream().device == tr.device
    # the end on the current card's stream, the start on the trainer's
    with pytest.raises(AssertionError):
        _drive(DispatchTimeline(FlightRecorder(), FakeClock().event, STREAM), PLAN,
               end_stream=FakeStream("cuda:0"))


def test_last_outlives_its_trainer(monkeypatch):
    _fake_timeline(monkeypatch, FakeClock())
    tr = _trainer()
    fr = tr.flight
    tr.train(log_every=0)
    ref = weakref.ref(tr)
    del tr
    gc.collect()
    assert ref() is None
    assert flight.last() is fr and fr.dispatch_totals()["dispatches"] > 0


def test_usr1_dumps_the_last_recorder(tmp_path, monkeypatch):
    fr = FlightRecorder()
    _drive(DispatchTimeline(fr, FakeClock().event, STREAM), PLAN)
    monkeypatch.setattr(flight, "_LAST", fr)
    prev = flight.activate(None)
    uninstall = install_usr1_dump(str(tmp_path))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        for _ in range(100):
            if (tmp_path / "flight_usr1.json").exists():
                break
            time.sleep(0.01)
    finally:
        uninstall()
        flight.activate(prev)
    doc = json.load(open(tmp_path / "flight_usr1.json"))
    assert doc["dispatch"]["totals"]["dispatches"] == len(PLAN)


def test_trace_doc_carries_the_clock_origin():
    fr = FlightRecorder()
    _drive(DispatchTimeline(fr, FakeClock().event, STREAM), PLAN)
    doc = fr.snapshot("t")["trace"]
    validate_trace_doc(doc)
    assert doc["metadata"]["clock_origin_unix_us"] == round(1e6 * fr.ring.wall0, 1)
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["name"] == "thread_name"}
    assert DEVICE_TRACK in names
    # Unix time of an event = origin + ts
    ev = [e for e in doc["traceEvents"] if e["name"] == "device"][0]
    unix_us = doc["metadata"]["clock_origin_unix_us"] + ev["ts"]
    assert abs(unix_us / 1e6 - (fr.ring.wall0 + ev["ts"] / 1e6)) < 1e-3
    plain = chrome_trace_doc(fr.ring.events())
    assert "clock_origin_unix_us" not in plain["metadata"]


# --------------------------------------------------------------- readers
def _readers():
    man = Manifest(REPO / "BENCHMARK.json")
    for name, layer in ((HOST_PACED, "trainer loop"), (IN_DISPATCH, "device")):
        entry = [m for m in man.doc["per_layer"] if m["name"] == name]
        assert entry and entry[0]["workloads"] == CELLS
        assert entry[0]["layer"] == layer and entry[0]["moves"] == "train_words_per_s"
    return man.reader(HOST_PACED), man.reader(IN_DISPATCH)


def _recorder(rows):
    fr = FlightRecorder()
    fr.open_dispatches()
    for step, steps, dev, gap, starved in rows:
        fr.note_dispatch(step, steps, dev, gap, starved, epoch_first=False)
    return fr


ROWS = [  # step, steps, device_s, gap_s, starved
    (4, 4, 0.040, 0.0, False),
    (8, 4, 0.040, 0.002, True),
    (12, 4, 0.040, 0.0001, False),
    (16, 4, 0.040, 0.050, True),   # the traced part's first: the sync
    (20, 4, 0.040, 0.003, True),
    (22, 2, 0.020, 0.0002, False),
]


@pytest.mark.parametrize("traced_steps", [10, 22])
def test_readers_on_synthetic_rows(monkeypatch, traced_steps):
    host_paced, in_dispatch = _readers()
    monkeypatch.setattr(flight, "_LAST", _recorder(ROWS))
    rec = {"kind": "train", "steps": traced_steps, "window_s": 0.2, "busy_s": 0.19}
    first = {10: 3, 22: 0}[traced_steps]
    cut = ROWS[first][3]
    span = sum(r[2] + r[3] for r in ROWS) - cut
    starved = sum(r[3] for r in ROWS if r[4]) - (cut if ROWS[first][4] else 0.0)
    assert host_paced(rec) == pytest.approx(100 * starved / span)
    gaps = sum(r[3] for r in ROWS[first + 1:])
    assert in_dispatch(rec) == pytest.approx(100 * (0.2 - 0.19 - gaps) / 0.2)


def test_readers_none_paths(monkeypatch):
    host_paced, in_dispatch = _readers()
    rec = {"kind": "train", "steps": 10, "window_s": 0.2, "busy_s": 0.19}
    monkeypatch.setattr(flight, "_LAST", None)
    assert host_paced(rec) is None and in_dispatch(rec) is None
    monkeypatch.setattr(flight, "_LAST", FlightRecorder())  # no rows
    assert host_paced(rec) is None and in_dispatch(rec) is None
    monkeypatch.setattr(flight, "_LAST", _recorder(ROWS))
    for bad in ({**rec, "steps": 9}, {**rec, "steps": 99}, {**rec, "kind": "serve"},
                {**rec, "steps": 0}):
        assert host_paced(bad) is None and in_dispatch(bad) is None
    # a program without the timeline (no flight.last)
    monkeypatch.delattr(flight, "last")
    assert host_paced(rec) is None and in_dispatch(rec) is None


# -------------------------------------------------------------- the card
@pytest.mark.cuda
@pytest.mark.parametrize("delay_s", [0.0, 0.02])
def test_injected_host_delay_starves_the_card(delay_s):
    """A host delay of 20 ms a dispatch (the checkpoint hook, every
    dispatch) on a run whose dispatch takes D <= 5 ms of device time: the
    loop runs one dispatch ahead, so the card starves by the delay's excess
    over the queued dispatch, a share (20 - D) / 20 of the span; without
    the delay the card is kept fed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    vocab = zipf_vocab(5000, 1_000_000)
    corpus = PackedCorpus.pack(zipf_corpus_ids(vocab, 1_000_000, seed=3), 192)
    tr = Trainer(Word2VecConfig(
        model="sg", train_method="ns", negative=5, word_dim=128, window=5,
        min_count=1, iters=50, batch_rows=64, max_sentence_len=192,
        chunk_steps=2, resident="on", kernel="band", seed=5,
    ), vocab, corpus, device="cuda")
    state, _ = tr.train(log_every=0, max_steps=8)  # the capture
    state, rep = tr.train(
        state=state, log_every=0, max_steps=8 + 2 * 60,
        checkpoint_cb=(lambda s: time.sleep(delay_s)) if delay_s else None,
        checkpoint_every=1 if delay_s else 0,
    )
    rows = tr.flight.dispatch_rows()
    tot = rep.dispatch
    assert len(rows) == tot["dispatches"] == 60
    d_ms = 1e3 * tot["device_s"] / tot["dispatches"]
    assert 0.5 < d_ms <= 5.0, d_ms
    share = tot["starved_s"] / (tot["device_s"] + tot["gap_s"])
    print(f"delay {delay_s} s: D {d_ms:.4f} ms, starved share {share:.4f}")
    if delay_s:
        want = (20.0 - d_ms) / 20.0
        assert abs(share - want) <= 0.1 * want, (share, want, d_ms)
    else:
        assert share < 0.5, (share, d_ms)


@pytest.mark.cuda
def test_timeline_on_a_card_not_the_current_one():
    """A trainer on the host's last card while the process's current card
    stays the first: its dispatches are timed on its own card's clock."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev = f"cuda:{torch.cuda.device_count() - 1}"
    assert torch.cuda.current_device() == 0
    vocab = zipf_vocab(5000, 200_000)
    corpus = PackedCorpus.pack(zipf_corpus_ids(vocab, 200_000, seed=3), 192)
    tr = Trainer(Word2VecConfig(
        model="sg", train_method="ns", negative=5, word_dim=128, window=5,
        min_count=1, iters=5, batch_rows=64, max_sentence_len=192,
        chunk_steps=2, resident="on", kernel="band", seed=5,
    ), vocab, corpus, device=dev)
    state, rep = tr.train(log_every=0, max_steps=24)
    assert torch.cuda.current_device() == 0
    rows = tr.flight.dispatch_rows()
    # chunks of 2 steps, an epoch's last one shorter
    assert len(rows) == rep.dispatch["dispatches"] >= 12
    assert sum(r["steps"] for r in rows) == rep.steps == 24
    assert all(r["device_s"] > 0 and r["gap_s"] >= 0 for r in rows)
    assert {v.device for v in state.params.values()} == {torch.device(dev)}
