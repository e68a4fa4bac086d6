"""The step's mesh plumbing: the shard-order sum over the model axis, the
sequence halo and the center ownership.

Port of the cross-device parts of the JAX step (word2vec_tpu/ops/
band_step.py:96-119 `_halo_exchange`, the `psum(x, tp_axis)` sites of the
band, hs and pair steps, and the `center_zone` of every route), in one
process.

Tensor parallelism: a replica's tables are split on their last (dim) axis
into tp shards, shard t its own [V, d/tp] tensor (parallel/trainer.py).
Each step route writes its body once, as a generator (`body`): at every
site where the JAX step calls psum over the model axis it yields its
float32 partial and continues with what it is sent back. `solo` runs one
body alone (tp = 1: each site gets its own operand back, so the step is
the single-device step, bitwise); `lockstep` runs a replica's tp shard
bodies side by side, each up to its next site in shard order, and sends
every shard the partials summed in shard order (t = 0, 1, ...) in float32
on shard 0's device: bitwise XLA's CPU psum of the same partials (pinned
by tests/test_torch_tp_sp.py at tp = 2 and 4). The bodies are coroutines
on one thread: no thread waits on another, and a replica whose shards
share a card is captured as one CUDA graph (ops/graphs.StepGraph).

Sequence parallelism: a replica of the seq axis trains the column slice
[s*Lloc, (s+1)*Lloc) of its rows plus W halo tokens on each side
(`halo_exchange`, what the JAX step's two ppermutes deliver), and trains
as centers only the positions it owns (`center_zone`).
"""

from __future__ import annotations

from typing import Generator, List, Sequence

import torch
import torch.nn.functional as F

#: a step body: yields float32 partials at the model-axis psum sites and
#: returns its metrics
Body = Generator[torch.Tensor, torch.Tensor, object]


def solo(body: Body):
    """Run a step body alone: every psum site gets its own operand back
    (one shard: the psum of one partial is the partial)."""
    try:
        x = next(body)
        while True:
            x = body.send(x)
    except StopIteration as stop:
        return stop.value


def shard_sum(parts: Sequence[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The partials of the tp shards summed in shard order, in float32, on
    `home` (shard 0's device): ((p0 + p1) + p2) + ..., a new tensor."""
    for p in parts:
        if p.dtype != torch.float32:
            raise TypeError(f"a psum partial must be float32, got {p.dtype}")
    acc = parts[0].to(home) + parts[1].to(home)
    for p in parts[2:]:
        acc.add_(p.to(home))
    return acc


def lockstep(bodies: List[Body], home: torch.device) -> list:
    """Run a replica's tp shard bodies in lockstep and return their
    results, in shard order. At each psum site every body hands in its
    partial (shard 0 runs up to the site, then shard 1, ...), and every
    body continues with the shard-order sum (shard_sum), copied to its own
    device when that is not `home`. The bodies are one step's code on
    equal inputs, so they reach the same sites in the same order; a body
    that ends while another still yields is an error. Takes two bodies or
    more (one runs alone: solo)."""
    sent: list = [None] * len(bodies)
    while True:
        parts, done = [], []
        for body, x in zip(bodies, sent):
            try:
                parts.append(body.send(x))
            except StopIteration as stop:
                done.append(stop.value)
        if done:
            if parts:
                raise RuntimeError(
                    "the tp shard bodies of one replica left the lockstep: "
                    f"{len(done)} ended while {len(parts)} reached a psum"
                )
            return done
        total = shard_sum(parts, home)
        sent = [total if p.device == total.device else total.to(p.device)
                for p in parts]


def halo_exchange(tokens: torch.Tensor, s: int, sp: int, w: int) -> torch.Tensor:
    """[..., L] rows -> sequence shard s's haloed slice [..., Lloc + 2w]:
    columns [s*Lloc - w, (s+1)*Lloc + w), -1 outside [0, L).

    This is what _halo_exchange of the JAX step delivers (word2vec_tpu/
    ops/band_step.py:96-119): shard s's own [B, Lloc] slice between the
    last w tokens of shard s-1 and the first w of shard s+1, and -1 (an
    invalid token) where the outermost shards have no neighbour. It
    refuses, as JAX does, a slice shorter than the window (the exchange is
    one hop)."""
    L = tokens.shape[-1]
    if L % sp:
        raise ValueError(f"row length {L} not divisible by sp={sp}")
    lloc = L // sp
    if lloc < w:
        raise ValueError(f"per-shard slice length {lloc} < window {w}")
    padded = F.pad(tokens, (w, w), value=-1)
    return padded[..., s * lloc:s * lloc + lloc + 2 * w]


def center_zone(L: int, w: int, device) -> torch.Tensor:
    """[L] bool over a haloed row of length L = Lloc + 2w: True on the
    positions the shard owns, [w, L - w). The halo positions are context
    only: their center direction is owned (and trained) by the
    neighbouring shard, so every directed (center, context) pair is
    trained once across the seq axis."""
    pos = torch.arange(L, dtype=torch.int32, device=device)
    return (pos >= w) & (pos < L - w)
