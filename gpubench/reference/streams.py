"""The inputs of a training step, worked out again from the seed.

Plain PyTorch and NumPy; imports nothing of the program. The program under
test draws every random number of a step from its own generator; what a
step consumes is a pure function of the run seed and the step index, by
the stream contract the program documents and this module restates:

  * the rows: sentences of `sentence_len` tokens, each cut into rows of
    at most L tokens; epoch e visits the rows in the order of a NumPy
    shuffle seeded (seed, e); optimizer step t of an epoch takes rows
    order[t*B : (t+1)*B] into a [B, L] batch padded with -1;
  * the draws of step s: a generator on the step's device seeded with a
    splitmix64 mix of (seed ^ 0x5EED, s), from which, in this order, the
    subsample uniforms [B, L], the window shrink W - randint(0, W) [B, L],
    and with negative sampling the alias buckets randint(0, V) [B, KP] and
    coins [B, KP];
  * the learning rate of a step: init_alpha * (1 - words_done / (iters *
    corpus words)), floored at min_alpha and rounded to float32, where
    words_done counts the real tokens of the steps before it.

Both sides get the same corpus tokens and the same seed; the reference
derives the rest here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

U64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & U64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & U64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & U64
    return x ^ (x >> 31)


def step_seed(run_seed: int, step: int) -> int:
    base = splitmix64((int(run_seed) ^ 0x5EED) & U64)
    return splitmix64(base ^ (int(step) & U64))


def epoch_order(seed: int, epoch: int, num_rows: int) -> np.ndarray:
    order = np.arange(num_rows, dtype=np.int64)
    np.random.default_rng((int(seed), int(epoch))).shuffle(order)
    return order


def sentence_rows(num_tokens: int, sentence_len: int, L: int) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, lens) of the rows: each sentence of the flat stream cut
    into rows of at most L tokens, in stream order."""
    s_starts = np.arange(0, num_tokens, sentence_len, dtype=np.int64)
    s_lens = np.minimum(num_tokens - s_starts, sentence_len)
    per = -(-s_lens // L)
    first = np.repeat(s_starts, per)
    ofs = np.arange(int(per.sum()), dtype=np.int64) - np.repeat(np.cumsum(per) - per, per)
    starts = first + ofs * L
    lens = np.minimum(np.repeat(s_starts + s_lens, per) - starts, L)
    return starts, lens.astype(np.int64)


class Rows:
    """The corpus's rows and the batches of every optimizer step."""

    def __init__(self, flat: torch.Tensor, sentence_len: int, L: int, B: int, seed: int):
        self.flat = flat  # [N] int32, on the reference's device
        self.L, self.B, self.seed = L, B, int(seed)
        starts, lens = sentence_rows(flat.numel(), sentence_len, L)
        self.starts, self.lens = starts, lens
        self.steps_per_epoch = -(-len(starts) // B)
        self._orders = {}

    def order(self, epoch: int) -> np.ndarray:
        if epoch not in self._orders:
            self._orders = {epoch: epoch_order(self.seed, epoch, len(self.starts))}
        return self._orders[epoch]

    def step_rows(self, step: int) -> np.ndarray:
        e, t = divmod(int(step), self.steps_per_epoch)
        return self.order(e)[t * self.B:(t + 1) * self.B]

    def words(self, step: int) -> int:
        return int(self.lens[self.step_rows(step)].sum())

    def batch(self, step: int) -> torch.Tensor:
        """[B, L] int32 tokens of optimizer step `step`, -1 past a row."""
        return self.batches([step])

    def batches(self, steps) -> torch.Tensor:
        """[len(steps) B, L] int32: the batches of `steps`, one after another."""
        starts = np.zeros(len(steps) * self.B, np.int64)
        lens = np.zeros(len(steps) * self.B, np.int64)
        for n, st in enumerate(steps):
            rows = self.step_rows(st)
            starts[n * self.B:n * self.B + len(rows)] = self.starts[rows]
            lens[n * self.B:n * self.B + len(rows)] = self.lens[rows]
        dev = self.flat.device
        st = torch.as_tensor(starts, device=dev)
        ln = torch.as_tensor(lens, device=dev)
        cols = torch.arange(self.L, device=dev)
        idx = (st[:, None] + cols[None, :]).clamp_max(self.flat.numel() - 1)
        return torch.where(cols[None, :] < ln[:, None], self.flat[idx], -1).to(torch.int32)


def alpha_at(init_alpha: float, min_alpha: Optional[float], words_done: int,
             iters: int, total_words: int) -> float:
    lo = init_alpha * 1e-4 if min_alpha is None else min_alpha
    a = max(lo, init_alpha * (1.0 - words_done / max(1, iters * total_words)))
    return float(np.float32(a))


def draws(device, run_seed: int, step: int, B: int, L: int, W: int,
          V: int = 0, KP: int = 0):
    """(u_sub [B, L], w_eff [B, L] int32, buckets [B, KP] int32 or None,
    coins [B, KP] or None) of optimizer step `step`."""
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(run_seed, step))
    u_sub = torch.rand((B, L), generator=g, device=device)
    w_eff = W - torch.randint(0, W, (B, L), generator=g, device=device, dtype=torch.int32)
    if not KP:
        return u_sub, w_eff, None, None
    bucket = torch.randint(0, V, (B, KP), generator=g, device=device, dtype=torch.int32)
    coin = torch.rand((B, KP), generator=g, device=device)
    return u_sub, w_eff, bucket, coin


def keep_probs(counts: np.ndarray, threshold: float) -> np.ndarray:
    """word2vec's subsample keep probability, min((sqrt(c/t) + 1) t/c, 1)
    with t = threshold * the vocabulary's total count."""
    c = np.asarray(counts, np.float64)
    if threshold <= 0:
        return np.ones(len(c), np.float32)
    tc = threshold * c.sum()
    return np.minimum((np.sqrt(c / tc) + 1.0) * tc / c, 1.0).astype(np.float32)
