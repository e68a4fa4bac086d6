"""Preemption-safe shutdown: cooperative stop at the next step boundary.

A copy of word2vec_tpu/resilience/shutdown.py for the PyTorch port: the
stop check (one process: a flag read; several: the agreed vote of
parallel/multihost.global_agree_max), the SIGUSR1 flight dump
(install_usr1_dump) and the SIGUSR2 device dump (install_usr2_profile: a
bounded profiler window, obs/profiler.py, and the memory ledger,
obs/devmem.py).

Preemptible fleets deliver SIGTERM with a short grace window before the
hard kill. Dying mid-step wastes every step since the last checkpoint and,
with an unlucky landing inside a checkpoint write, risks a torn
checkpoint. The protocol here:

  1. `ShutdownHandler.install()` registers SIGTERM/SIGINT handlers that only
     SET A FLAG. The first signal is a request; a second delivery of the
     same signal restores the original disposition and re-raises it, so an
     operator's double Ctrl-C (or a scheduler escalating to a second
     SIGTERM) still kills a wedged process the classic way.
  2. The trainer polls `stop_check(step)` at every dispatch boundary and
     returns cleanly with `TrainReport.interrupted = "preempted"` instead
     of raising — its params are consistent.
  3. The CLI writes a final checkpoint and exits with EXIT_PREEMPTED so an
     external scheduler can distinguish "requeue me with --resume" from
     success (0) and failure.
"""

from __future__ import annotations

import os
import signal
import warnings
from typing import Callable, List, Optional

#: exit code of a preempted-but-checkpointed run (EX_TEMPFAIL: "try again
#: later" — the conventional requeue signal, distinct from 0=ok, 1=usage
#: error, 2=diverged)
EXIT_PREEMPTED = 75

#: the default request signals: the scheduler's eviction notice and the
#: operator's Ctrl-C
DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class ShutdownHandler:
    """Flag-setting signal handler with second-signal escalation."""

    def __init__(self, signals=DEFAULT_SIGNALS):
        self.signals = tuple(signals)
        self.requested = False
        #: the signal number that requested the stop (None until then)
        self.signum: Optional[int] = None
        self._previous: List = []
        self._installed = False

    # ------------------------------------------------------------ install
    def install(self) -> "ShutdownHandler":
        """Register the handlers; returns self for chaining. Safe to call
        only from the main thread (Python's signal rule); callers off the
        main thread get a no-op with a warning rather than a crash."""
        if self._installed:
            return self
        try:
            self._previous = [
                (s, signal.signal(s, self._handle)) for s in self.signals
            ]
        except ValueError:  # not the main thread
            warnings.warn(
                "ShutdownHandler.install() outside the main thread: signal "
                "handlers cannot be registered; preemption-safe shutdown "
                "is disabled for this run.",
                stacklevel=2,
            )
            self._previous = []
            return self
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the original dispositions (idempotent)."""
        for s, prev in self._previous:
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._previous = []
        self._installed = False

    def _handle(self, signum, frame) -> None:
        if self.requested:
            # second delivery: the cooperative window is over — restore the
            # original disposition and re-deliver so the default action
            # (terminate) or the operator's own handler runs
            self.uninstall()
            signal.raise_signal(signum)
            return
        self.requested = True
        self.signum = signum

    # ------------------------------------------------------- stop checks
    def make_stop_check(
        self, process_count: int = 1, agree_every: int = 16
    ) -> Callable[[int], bool]:
        """A `stop_check(step) -> bool` for the trainers.

        Single-process: a flag read, every step. Multi-process: the flag is
        resolved through a global max at step boundaries where
        `step % agree_every == 0` — every process calls the collective at
        the same boundaries (step counters advance in lockstep), so nobody
        enters it alone; between boundaries the check returns False even on
        the process that caught the signal, because stopping unilaterally
        would strand the others in the next collective step."""
        if process_count <= 1:
            return lambda step: self.requested

        from ..parallel.multihost import global_agree_max

        every = max(1, int(agree_every))

        def check(step: int) -> bool:
            if step % every != 0:
                return False
            return global_agree_max(int(self.requested)) > 0

        return check


def install_usr1_dump(metrics_dir: str, flight=None) -> Callable[[], None]:
    """On-demand diagnostics WITHOUT stopping the run: SIGUSR1 dumps the
    flight recorder (`flight_usr1.json`) and an all-thread stack dump
    (`stacks_usr1.txt`) into `metrics_dir`, then returns to the interrupted
    code (resilience/watchdog.dump_all_stacks: signal-safe formatting).

    `flight` defaults to the process-wide active recorder
    (obs/flight.activate). Returns an uninstall callable; a no-op on
    platforms without SIGUSR1 or off the main thread (Python's signal
    rule), mirroring ShutdownHandler.install's degrade.
    """
    usr1 = getattr(signal, "SIGUSR1", None)
    if usr1 is None:
        return lambda: None

    def _handle(signum, frame) -> None:
        try:
            from ..obs import flight as flight_mod
            from .watchdog import dump_all_stacks

            os.makedirs(metrics_dir, exist_ok=True)
            dump_all_stacks(os.path.join(metrics_dir, "stacks_usr1.txt"))
            fl = flight if flight is not None else flight_mod.active()
            if fl is not None:
                fl.dump(metrics_dir, reason="sigusr1",
                        filename="flight_usr1.json")
        except Exception:  # noqa: BLE001 — an on-demand dump must never
            pass           # kill the run it observes

    try:
        prev = signal.signal(usr1, _handle)
    except ValueError:  # not the main thread
        return lambda: None

    def uninstall() -> None:
        try:
            signal.signal(usr1, prev)
        except (ValueError, OSError):
            pass

    return uninstall


def install_usr2_profile(
    metrics_dir: str, capture=None, ledger=None
) -> Callable[[], None]:
    """On-demand DEVICE diagnostics without stopping the run: SIGUSR2
    requests a bounded profiler window (obs/profiler.ProfilerCapture —
    armed at the next step boundary on the training thread, never from the
    handler itself) and dumps the current memory ledger (`mem_usr2.json`)
    into `metrics_dir`. The device-side mirror of the SIGUSR1 flight dump:
    USR1 answers "what is the HOST doing right now", USR2 "what is the
    DEVICE doing right now".

    `capture` is the run's ProfilerCapture (None degrades to the ledger
    dump alone); `ledger` defaults to the process-wide active one
    (obs/devmem.activate — the one cli.py installs). Returns an uninstall
    callable; a no-op on platforms without SIGUSR2 or off the main
    thread, mirroring install_usr1_dump's degrade."""
    usr2 = getattr(signal, "SIGUSR2", None)
    if usr2 is None:
        return lambda: None

    def _handle(signum, frame) -> None:
        try:
            from ..obs import devmem as devmem_mod

            if capture is not None:
                # a flag write — arming happens at the next step boundary
                capture.request("sigusr2")
            led = ledger if ledger is not None else devmem_mod.active()
            if led is not None:
                led.sample("sigusr2")
                led.dump(
                    os.path.join(metrics_dir, "mem_usr2.json"),
                    reason="sigusr2",
                )
        except Exception:  # noqa: BLE001 — an on-demand dump must never
            pass           # kill the run it observes

    try:
        prev = signal.signal(usr2, _handle)
    except ValueError:  # not the main thread
        return lambda: None

    def uninstall() -> None:
        try:
            signal.signal(usr2, prev)
        except (ValueError, OSError):
            pass

    return uninstall
