"""Store shepherd: keep an elastic generation's store alive through rank 0's
death or exec.

`init_process_group("gloo", init_method="tcp://...")` hosts the TCPStore
INSIDE rank 0's process, so the store dies with rank 0: a SIGKILL of rank 0
takes the endpoint with it, and rank 0's exec into the next generation
pulls it from under members that may still be using it. On an ELASTIC
fleet the store therefore moves out of the training process: rank 0 spawns
this module as a small subprocess that hosts ONLY the generation's
`torch.distributed.TCPStore`, and every rank (rank 0 included) joins it as
a client (parallel/multihost._join_elastic). Rank 0's death then breaks
only the gloo pairs (the bounded collectives turn that into SyncTimeout,
the detection path) while the store stays reachable. The shepherd holds
the spawning process's stdin pipe as a liveness leash (rank 0's exec or
death closes it: Popen pipes do not survive an exec) and then lingers a
bounded grace before it releases the port.

    python -m word2vec_tpu_torch.parallel.coordservice --port P --procs N \\
        [--gen G] [--linger SECS]

Prints one `ready` line to stdout once the store is bound and stamped with
its generation G (multihost.GEN_KEY; the spawning rank blocks on the line
before it joins, and every rank checks the stamp).
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time

#: seconds the shepherd keeps serving after its leash (stdin) closes: must
#: cover a full shrink recovery (detection + election + round + exec) of
#: the generation it serves
LINGER_DEFAULT = 240.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m word2vec_tpu_torch.parallel.coordservice"
    )
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--gen", type=int, default=0)
    ap.add_argument("--linger", type=float, default=LINGER_DEFAULT)
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from .multihost import GEN_KEY, INIT_TIMEOUT_S

    store = dist.TCPStore(
        "0.0.0.0", args.port, args.procs, True,
        datetime.timedelta(seconds=INIT_TIMEOUT_S), wait_for_workers=False,
    )
    store.set(GEN_KEY, str(args.gen))
    print("ready", flush=True)
    # leash: block until the parent's pipe end closes (clean exit, SIGKILL,
    # or the close-on-exec at a generation exec); read() returns b'' then
    try:
        while os.read(0, 4096):
            pass
    except OSError:
        pass
    time.sleep(args.linger)
    return 0


if __name__ == "__main__":
    sys.exit(main())
