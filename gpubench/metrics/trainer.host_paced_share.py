"""The share of the window call's device span in which the card sat idle
because the host had not yet begun the next dispatch, in %: the starved
gaps of the trainer's dispatch timeline over the span from the call's
first dispatch's start to its last one's end, both on the card's clock,
over the whole window, not only its traced part. Read from the program's
own counters: the recorder the window's Trainer.train call left as
word2vec_tpu_torch.obs.flight.last(), its totals and its newest rows.

The traced part's first dispatch is the first of the newest rows whose
steps sum to the traced steps. The one gap before it is left out of both
sums: it holds the benchmark's own device sync and profiler start at that
boundary, not the trainer's doing. None where the program keeps no
dispatch rows (no card, or a program without the timeline)."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("steps"):
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
    tot = fr.dispatch_totals()
    cut = rows[i]["gap_s"]
    span = tot["device_s"] + tot["gap_s"] - cut
    starved = tot["starved_s"] - (cut if rows[i]["starved"] else 0.0)
    return 100.0 * starved / span if span > 0 else None
