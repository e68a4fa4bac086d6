"""The device's idle share of the traced window that no change to the
trainer's host loop can remove, in %: the traced idle (window - busy, the
device trace's union) less the gaps between the traced part's dispatches
as the card's own clock saw them (the trainer's dispatch timeline, read
from word2vec_tpu_torch.obs.flight.last(), the recorder the window's
Trainer.train call left), over the window. What is left is the gaps
between a graph's nodes and between its replays inside the dispatches,
and the window's two edges: before its first dispatch starts and after
its last one ends.

The traced part's dispatches are the newest rows whose steps sum to the
traced steps. The gap before the first of them begins before the traced
window (the benchmark's device sync and profiler start) and is not taken
off. None where the program keeps no dispatch rows (no card, or a program
without the timeline)."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("steps") or not rec.get("window_s"):
        return None
    from word2vec_tpu_torch.obs import flight

    fr = flight.last() if hasattr(flight, "last") else None
    if fr is None or not hasattr(fr, "dispatch_rows"):
        return None
    rows = fr.dispatch_rows()
    n, i = 0, len(rows)
    while i > 0 and n < rec["steps"]:
        i -= 1
        n += rows[i]["steps"]
    if n != rec["steps"]:
        return None
    gaps = sum(r["gap_s"] for r in rows[i + 1:])
    return 100.0 * (rec["window_s"] - rec["busy_s"] - gaps) / rec["window_s"]
