"""The port's chaos plan and its resilience helpers
(word2vec_tpu_torch/resilience/{faults,watchdog,shutdown}.py) against the
JAX package's on the same inputs: FaultPlan.parse on every spec of the
module docstring plus JSON plans gives the same faults, the same parse
errors, and the same firing log; the nan kind poisons torch params; the
event kinds raise the same errors (oom as torch.OutOfMemoryError, with
the JAX message's tail); SyncTimeout reads the same; install_usr1_dump
writes flight_usr1.json and stacks_usr1.txt on a real SIGUSR1."""

import json
import os
import signal
import time

import numpy as np
import pytest
import torch

from word2vec_tpu.resilience import faults as jfaults
from word2vec_tpu.resilience import watchdog as jwatchdog

from word2vec_tpu_torch.obs import flight as flight_mod
from word2vec_tpu_torch.obs.flight import FlightRecorder
from word2vec_tpu_torch.obs.trace import validate_trace_doc
from word2vec_tpu_torch.resilience import faults as tfaults
from word2vec_tpu_torch.resilience import watchdog as twatchdog
from word2vec_tpu_torch.resilience.shutdown import install_usr1_dump

#: every spec of the faults.py module docstring, then combinations
SPECS = [
    "nan@40", "stall@10:secs=0.5", "hang@10:secs=300", "sigterm@25",
    "peer_dead@25", "peer_rejoin@25", "rank0_dead@25", "sync_timeout@25",
    "ckpt_oserror:times=2", "oom", "oom:times=3", "stream_stall@2:secs=1",
    "vocab_growth@3:n=5", "hang@7", "",
    "nan@40,sigterm@80,ckpt_oserror:times=2,stall@10:secs=0.5",
    "oom:times=1,stall@5:secs=0.2,hang@26:secs=60",
    " nan@1 , stall@2 ,, hang@3:secs=7:times=2",
]

BAD = [
    "bogus@3", "nan@x", "nan@3:zzz=1", "nan@3:times", "nan@-1",
    "nan@1:times=0", "nan@40,bogus@x", "nan@1,stall@2, sigterm@zzz",
    "stall@2:secs=x", "stall@2:secs=-1", "vocab_growth@1:n=0",
]

JSON_PLANS = [
    [{"kind": "nan", "step": 7, "times": 2}],
    [{"kind": "oom", "times": 2}, {"kind": "stall", "step": 3, "secs": 0.1,
                                   "fired": 5}],
    [{"kind": "nan"}, {"kind": "bogus"}],
    [{"kind": "nan"}, 3],
    [{"kind": "hang", "step": 1, "wat": 2}],
]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_same_faults(spec):
    t, j = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert t.to_json() == j.to_json()
    assert bool(t) == bool(j)


@pytest.mark.parametrize("spec", BAD)
def test_parse_same_errors(spec):
    with pytest.raises(ValueError) as te:
        tfaults.FaultPlan.parse(spec)
    with pytest.raises(ValueError) as je:
        jfaults.FaultPlan.parse(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("plan", range(len(JSON_PLANS)))
def test_parse_json_plans(plan, tmp_path):
    f = tmp_path / "plan.json"
    f.write_text(json.dumps(JSON_PLANS[plan]))
    try:
        j = jfaults.FaultPlan.parse(str(f)).to_json()
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tfaults.FaultPlan.parse(str(f))
        assert str(te.value) == str(e)
        return
    assert tfaults.FaultPlan.parse(str(f)).to_json() == j


class _State:
    def __init__(self, step, params=None):
        self.step = step
        self.params = params


def test_step_faults_same_log():
    spec = "stall@2:secs=0,stall@2:secs=0:times=2,hang@4:secs=0,nan@9"
    t, j = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    for step in (0, 1, 2, 3, 5, 6):
        t.on_step(_State(step))
        j.on_step(_State(step))
    assert t.log == j.log and len(t.log) == 4
    assert t.to_json() == j.to_json()


def test_nan_fault_poisons_torch_params():
    p = tfaults.FaultPlan([tfaults.Fault("nan", step=3)])
    params = {"emb_in": torch.ones(4, 3), "emb_out_ns": torch.zeros(4, 3),
              "emb_ns_fused": torch.ones(4, 2, 3, dtype=torch.bfloat16)}
    before = {k: v.data_ptr() for k, v in params.items()}
    state = _State(2, params)
    p.on_step(state)
    assert all(torch.isfinite(v).all() for v in params.values())
    state.step = 3
    p.on_step(state)
    for k, v in params.items():
        assert torch.isnan(v.float()).all() and v.data_ptr() == before[k]
    assert params["emb_ns_fused"].dtype == torch.bfloat16
    assert p.log == [{"kind": "nan", "step": 3, "at_step": 3}]
    fresh = {"emb_in": torch.ones(2, 2)}
    p.on_step(_State(4, fresh))           # spent: no second firing
    assert torch.isfinite(fresh["emb_in"]).all()


def test_sync_timeout_fault_raises_the_port_class():
    t = tfaults.FaultPlan.parse("sync_timeout@2:secs=5")
    j = jfaults.FaultPlan.parse("sync_timeout@2:secs=5")
    with pytest.raises(twatchdog.SyncTimeout) as te:
        t.on_step(_State(2))
    with pytest.raises(jwatchdog.SyncTimeout) as je:
        j.on_step(_State(2))
    assert str(te.value) == str(je.value)
    assert te.value.deadline == je.value.deadline == 5.0
    assert te.value.what == je.value.what
    assert t.log == j.log


def test_segment_faults_same_log():
    class Driver:
        def __init__(self):
            self.grown = []

        def force_growth(self, n):
            self.grown.append(n)

    spec = "stream_stall@1:secs=0,vocab_growth@2:n=4:times=2"
    t, j = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    dt, dj = Driver(), Driver()
    for seg in range(5):
        t.on_segment(seg, dt)
        j.on_segment(seg, dj)
    assert t.log == j.log and dt.grown == dj.grown == [4, 4]


@pytest.mark.parametrize("kind", ["ckpt_oserror", "oom"])
def test_event_faults_raise_like_the_jax_ones(kind):
    plans = (tfaults.FaultPlan.parse(f"{kind}:times=2"),
             jfaults.FaultPlan.parse(f"{kind}:times=2"))
    errs = []
    for mod, plan in zip((tfaults, jfaults), plans):
        prev = mod.activate(plan)
        try:
            assert mod.active() is plan
            got = []
            for _ in range(2):
                with pytest.raises(Exception) as e:
                    mod.raise_if_active(kind, where="serve_batch 4")
                got.append(e.value)
            mod.raise_if_active(kind, where="serve_batch 4")  # spent
        finally:
            mod.activate(prev)
        assert mod.active() is prev
        errs.append(got)
    assert plans[0].log == plans[1].log and len(plans[0].log) == 2
    for te, je in zip(*errs):
        if kind == "oom":
            assert isinstance(te, torch.OutOfMemoryError)
            assert str(je).startswith("RESOURCE_EXHAUSTED: ")
            assert str(je) == "RESOURCE_EXHAUSTED: " + str(te)
        else:
            assert type(te) is type(je) is OSError
            assert str(te) == str(je)


def test_raise_if_active_without_a_plan_is_a_no_op():
    prev = tfaults.activate(None)
    try:
        tfaults.raise_if_active("oom", where="x")
    finally:
        tfaults.activate(prev)


def test_dump_all_stacks(tmp_path):
    path = str(tmp_path / "stacks.txt")
    twatchdog.dump_all_stacks(path)
    text = open(path).read()
    assert "test_dump_all_stacks" in text and "thread" in text


@pytest.mark.parametrize("explicit", [True, False])
def test_usr1_dumps_without_stopping(tmp_path, explicit):
    fr = FlightRecorder()
    fr.note_step(5, time.perf_counter(), 0.01)
    mdir = str(tmp_path / "m")
    prev = flight_mod.activate(None if explicit else fr)
    orig = signal.getsignal(signal.SIGUSR1)
    uninstall = install_usr1_dump(mdir, fr if explicit else None)
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = time.monotonic() + 10
        while not os.path.exists(os.path.join(mdir, "flight_usr1.json")):
            assert time.monotonic() < deadline, "no flight_usr1.json"
            time.sleep(0.01)
    finally:
        uninstall()
        flight_mod.activate(prev)
    assert signal.getsignal(signal.SIGUSR1) == orig
    fl = json.loads(open(os.path.join(mdir, "flight_usr1.json")).read())
    assert fl["reason"] == "sigusr1" and fl["last_step"] == 5
    validate_trace_doc(fl["trace"])
    stacks = open(os.path.join(mdir, "stacks_usr1.txt")).read()
    assert "test_usr1_dumps_without_stopping" in stacks


def test_fault_defaults_match():
    for kind in tfaults.KINDS:
        assert tfaults.Fault(kind).to_json() == jfaults.Fault(kind).to_json()
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.EVENT_KINDS == jfaults.EVENT_KINDS
    assert np.isclose(tfaults.Fault("hang").secs, 3600.0)
