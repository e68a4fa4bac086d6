"""Two names of word2vec_tpu/resilience/watchdog.py for the PyTorch port.

`SyncTimeout` (the error the `sync_timeout` fault kind raises,
resilience/faults.py) and `dump_all_stacks` (the all-thread stack dump
behind the SIGUSR1 on-demand dump, resilience/shutdown.install_usr1_dump).
The rest of the watchdog (StepWatchdog, bounded_call, PeerAgreement, the
peer-failure classifier) is not ported yet: it rides on the trainer's
step loop and the multi-process layer, which the port has not reached.
"""

from __future__ import annotations

import sys
from typing import Optional


class SyncTimeout(RuntimeError):
    """A deadline-bounded collective did not complete: a peer is dead or
    wedged. Carries `.what` (which collective) and `.deadline` (seconds)."""

    def __init__(self, what: str, deadline: float):
        self.what = what
        self.deadline = float(deadline)
        super().__init__(
            f"{what} did not complete within the {deadline:g}s sync "
            "deadline: a peer process is dead or wedged; aborting for "
            "requeue instead of hanging"
        )


def dump_all_stacks(path: Optional[str]) -> None:
    """All-thread stack dump via faulthandler — signal-safe C-level
    formatting that works even when a wedged thread holds arbitrary
    Python-level locks (a traceback.format_stack walk could block on the
    very lock the hang is about). None writes to stderr."""
    import faulthandler

    try:
        if path is None:
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        else:
            with open(path, "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
    except Exception:
        pass
