"""The port's peer layer (word2vec_tpu_torch/resilience/watchdog.py,
resilience/shutdown.py) and its multi-process refusals, against the JAX
package on the same inputs, in one process.

Pins:
  * PeerAgreement.check and inspect (tests/test_watchdog.py:239-282,
    :523-540): off the cadence no collective and False; on it the flag of
    the one-process heartbeat; the straggler and desync warnings, their
    records and their once-only latch; 6-column (policy) rows accepted;
    the heartbeat rows recorded on the flight timeline — each the same
    verdict, warning text and record as the JAX class on the same rows;
  * is_peer_failure on the same messages: the JAX fragments and the gloo
    peer-death messages seen when a rank is SIGKILLed mid-all_gather
    ("Connection closed by peer ... remote worker crashing"), each named,
    under torch.distributed's DistBackendError / DistNetworkError /
    DistStoreError and a class of a torch.distributed module; a plain
    RuntimeError or TimeoutError with the same words stays a program
    error; bounded_call turns a peer error into SyncTimeout, bounded or
    not;
  * make_stop_check(process_count, agree_every) at process counts 1 and 2
    with the agreement patched (tests/test_resilience.py:325-335);
  * StreamRun refuses vocab_reserve > 0 with more than one process, in the
    JAX driver's words.
"""

import warnings

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch.distributed as tdist  # noqa: E402

from word2vec_tpu.resilience import shutdown as jshutdown  # noqa: E402
from word2vec_tpu.resilience import watchdog as jwatchdog  # noqa: E402
from word2vec_tpu_torch.parallel import multihost as tmh  # noqa: E402
from word2vec_tpu_torch.resilience import shutdown as tshutdown  # noqa: E402
from word2vec_tpu_torch.resilience import watchdog as twatchdog  # noqa: E402

PKGS = {"jax": (jwatchdog, jshutdown), "torch": (twatchdog, tshutdown)}


def _both(fn):
    """fn(watchdog, shutdown) for each package -> {pkg: (result, warnings, records)}."""
    out = {}
    for name, (wd, sd) in PKGS.items():
        records = []
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            res = fn(wd, sd, records)
        out[name] = (res, [str(x.message) for x in w], records)
    return out


# ---------------------------------------------------------- PeerAgreement
def test_check_off_the_cadence_is_local_and_false():
    def run(wd, sd, records):
        h = sd.ShutdownHandler()
        h.requested = True
        return wd.PeerAgreement(h, agree_every=16).check(7)

    got = _both(run)
    assert got["torch"] == got["jax"] and got["torch"][0] is False


def test_check_on_the_cadence_resolves_the_flag():
    def run(wd, sd, records):
        h = sd.ShutdownHandler()
        pa = wd.PeerAgreement(h, agree_every=16, step_time_fn=lambda: 12.5)
        first = pa.check(16)
        h.requested = True
        return [first, pa.check(32)]

    got = _both(run)
    assert got["torch"] == got["jax"] and got["torch"][0] == [False, True]


ROWS = {
    "straggler": (np.asarray([[0.0, 0.0, 8.0, 20.0], [1.0, 0.0, 8.0, 21.0],
                              [2.0, 0.0, 8.0, 500.0]]), 8),
    "desync": (np.asarray([[0.0, 0.0, 8.0, 1.0], [1.0, 0.0, 4.0, 1.0]]), 8),
    "policy_cols": (np.asarray([[0, 0, 8, 10.0, 0.0, 0.0], [1, 0, 8, 12.0, 0.0, 0.0],
                                [2, 0, 8, 900.0, 0.0, 3.0]]), 8),
    "quiet": (np.asarray([[0.0, 0.0, 8.0, 20.0], [1.0, 0.0, 8.0, 30.0]]), 8),
}


@pytest.mark.parametrize("case", list(ROWS))
def test_inspect_gives_the_jax_verdicts(case):
    rows, step = ROWS[case]

    def run(wd, sd, records):
        pa = wd.PeerAgreement(sd.ShutdownHandler(), agree_every=4,
                              log_fn=records.append)
        pa.inspect(rows, step)
        later = np.array(rows, dtype=np.float64)
        later[:, 2] += 4
        pa.inspect(later, step + 4)  # warned once, not every boundary
        return None

    got = _both(run)
    assert got["torch"] == got["jax"]
    _, warned, records = got["torch"]
    assert len(warned) == len(records) == {
        "straggler": 1, "desync": 1, "policy_cols": 1, "quiet": 0}[case]
    if case == "straggler":
        assert records[0]["event"] == "straggler" and records[0]["process"] == 2
        assert "process 2 is a straggler" in warned[0]
    if case == "desync":
        assert records[0]["event"] == "peer_desync"
        assert "desynchronized" in warned[0]


def test_heartbeat_rows_land_on_the_flight_timeline():
    class Flight:
        def __init__(self):
            self.beats = []

        def note_heartbeat(self, rows, step):
            self.beats.append((rows, step))

    def run(wd, sd, records):
        fl = Flight()
        wd.PeerAgreement(sd.ShutdownHandler(), agree_every=2, flight=fl,
                         step_time_fn=lambda: 3.0).check(4)
        return fl.beats

    got = _both(run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [([[0.0, 0.0, 4.0, 3.0, 0.0, 0.0]], 4)]


# -------------------------------------------------------- is_peer_failure
MESSAGES = {
    "gloo_closed": "[/pytorch/third_party/gloo/gloo/transport/tcp/pair.cc:553] "
                   "Connection closed by peer [127.0.0.1]:53446. This is "
                   "typically caused by a remote worker crashing. Check the "
                   "logs of the remote worker before reporting an error.",
    "gloo_reset": "Gloo AllGather failed: Read error [127.0.0.1]:47170: "
                  "Connection reset by peer",
    "collective_wrapped": "replica-sync all_gather: [pair.cc:553] Connection "
                          "closed by peer [127.0.0.1]:41234",
    "barrier": "DEADLINE_EXCEEDED: Barrier timed out. Barrier_id: agree_42",
    "coord_barrier": "Coordination service barrier timeout: tasks [2] did not "
                     "reach the barrier",
    "heartbeat": "Task 1 heartbeat timeout; the task may have restarted",
    "recorded_heartbeat": "ABORTED: Task 2 recorded heartbeat timeout and is "
                          "marked dead",
    "refused": "Connection refused",
}


class FakeXlaRuntimeError(Exception):
    pass


FakeXlaRuntimeError.__module__ = "jaxlib.xla_extension"


class RendezvousClosed(RuntimeError):
    pass


RendezvousClosed.__module__ = "torch.distributed.elastic.rendezvous.api"


#: messages the JAX classifier knows too (the rest are gloo's own spellings)
JAX_KNOWN = {"gloo_closed", "gloo_reset", "barrier", "coord_barrier",
             "heartbeat", "recorded_heartbeat", "refused"}


@pytest.mark.parametrize("name", list(MESSAGES))
def test_is_peer_failure_on_the_runtime_messages(name):
    msg = MESSAGES[name]
    for klass in (tdist.DistBackendError, tdist.DistNetworkError,
                  tdist.DistStoreError, RendezvousClosed):
        assert twatchdog.is_peer_failure(klass(msg)), (klass, msg)
    # the JAX runtime's type vouches in both packages, on JAX's fragments
    assert twatchdog.is_peer_failure(FakeXlaRuntimeError(msg))
    assert jwatchdog.is_peer_failure(FakeXlaRuntimeError(msg)) == (name in JAX_KNOWN)
    # the same words from application code stay program errors (type gate)
    assert not twatchdog.is_peer_failure(RuntimeError(msg))
    assert not twatchdog.is_peer_failure(TimeoutError(msg))


def test_program_errors_of_the_runtime_are_not_peer_failures():
    assert not twatchdog.is_peer_failure(tdist.DistBackendError("Invalid scalar type"))
    assert not jwatchdog.is_peer_failure(FakeXlaRuntimeError("Invalid scalar type"))


@pytest.mark.parametrize("deadline", [None, 2.0])
def test_bounded_call_turns_a_peer_error_into_sync_timeout(deadline):
    err = tdist.DistBackendError(MESSAGES["gloo_closed"])

    def boom():
        raise err

    with pytest.raises(twatchdog.SyncTimeout, match="failed on a peer error") as e:
        twatchdog.bounded_call(boom, what="replica-sync all_gather",
                               deadline=deadline)
    assert e.value.__cause__ is err


# ---------------------------------------------------------- make_stop_check
def test_make_stop_check_at_one_and_two_processes(monkeypatch):
    calls = []
    monkeypatch.setattr(tmh, "global_agree_max",
                        lambda v: calls.append(v) or v)
    got = {}
    for name, (_, sd) in PKGS.items():
        h = sd.ShutdownHandler()
        h.requested = True
        one = h.make_stop_check(process_count=1)
        two = h.make_stop_check(process_count=2, agree_every=16)
        got[name] = [one(7), two(7), two(16)]
    assert got["torch"] == got["jax"] == [True, False, True]
    assert calls == [1]  # the vote ran once, at the boundary


# ------------------------------------------------------------- streaming
def test_stream_run_refuses_growth_across_processes(monkeypatch):
    from word2vec_tpu.stream.driver import StreamRun as JStreamRun
    from word2vec_tpu_torch.stream.driver import StreamRun

    class Stub:
        class config:
            min_count = 1
            vocab_reserve = 8

    monkeypatch.setattr(tmh, "process_count", lambda: 2)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    with pytest.raises(ValueError) as t:
        StreamRun(Stub(), source=None)
    with pytest.raises(ValueError) as j:
        JStreamRun(Stub(), source=None)
    assert str(t.value) == str(j.value)
    assert "vocab_reserve > 0 with process_count > 1" in str(t.value)
    Stub.config.vocab_reserve = 0
    StreamRun(Stub(), source=None)  # no growth: a fleet may stream
