"""A traced window, reduced to what the per-layer readers take.

From the profiler's events of the window: the device's busy time (the
union of its intervals: overlapping kernels count once), the time and the
count of every device operation by name, and the idle gaps between device
intervals, each named by the innermost host operation running when the
gap began.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

Span = Tuple[float, float]
#: the longest gaps that are named; the rest are summed as one
NAMED_GAPS = 4000
#: the host ranges the benchmark marks its traced window with, WINDOW +
#: ".start" and WINDOW + ".end"
WINDOW = "gpubench.window"


def union(spans: List[Span]) -> Tuple[float, List[Span]]:
    """(busy length, the merged intervals in order)."""
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def digest(device: List[Tuple[str, float, float]], host: List[Tuple[str, float, float]],
           window: Span) -> Dict:
    """device / host: (name, start, end) in seconds on one clock; window:
    (start, end) on that clock. Returns busy_s, window_s, ops {name:
    seconds}, calls {name: count}, gaps {host op: seconds}."""
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy, merged = union([(s, e) for _, s, e in dev])
    ops: Dict[str, float] = {}
    calls: Dict[str, int] = {}
    for n, s, e in dev:
        ops[n] = ops.get(n, 0.0) + (e - s)
        calls[n] = calls.get(n, 0) + 1
    edges = [w0] + [x for se in merged for x in se] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    hs = sorted(host, key=lambda t: t[1])
    starts = [s for _, s, _ in hs]
    named: Dict[str, float] = {}
    gaps.sort(key=lambda g: g[0] - g[1])
    for n_gap, (g0, g1) in enumerate(gaps):
        key = "(shorter gaps)"
        if n_gap < NAMED_GAPS:
            mid = 0.5 * (g0 + g1)
            i = bisect.bisect_right(starts, mid)
            best = None
            for j in range(i - 1, max(-1, i - 64), -1):  # host ops open at mid
                n, s, e = hs[j]
                if e >= mid and (best is None or e - s < best[2] - best[1]):
                    best = (n, s, e)
            key = best[0] if best is not None else "host (no traced op)"
        named[key] = named.get(key, 0.0) + (g1 - g0)
    return {"busy_s": busy, "window_s": w1 - w0, "ops": ops, "calls": calls, "gaps": named}


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k[:200], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def from_profiler(prof) -> Dict:
    """digest() of a torch.profiler run over its window, from the start of
    the WINDOW.start range to the end of the WINDOW.end range, read on the
    profiler's own clock."""
    import torch

    dev, host = [], []
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            s = e.start_ns()
            t = (e.name(), s * 1e-9, (s + e.duration_ns()) * 1e-9)
            (dev if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(t)
    else:
        for e in prof.events():
            t = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            (dev if e.device_type == torch.autograd.DeviceType.CUDA else host).append(t)
    marks = {n: (s, e) for n, s, e in host if n.startswith(WINDOW + ".")}
    if set(marks) != {WINDOW + ".start", WINDOW + ".end"}:
        raise RuntimeError(f"the trace lacks its {WINDOW} marks")
    # a host range (record_function) is mirrored on the device's timeline
    # as an annotation: not device work
    ranges = {n for n, _, _ in host}
    dev = [t for t in dev if t[0] not in ranges]
    host = [t for t in host if t[0] not in marks]
    return digest(dev, host, (marks[WINDOW + ".start"][0], marks[WINDOW + ".end"][1]))
