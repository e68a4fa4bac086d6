"""The `train` kind: a Trainer on a Zipf corpus at text8's scale.

Traffic parameters (gpubench/traffic/<name>.json): `vocab` words with
Zipf(`zipf_s`) counts scaled to `vocab_total_words`, a stream of `tokens`
tokens drawn from them, cut into sentences of `sentence_len` tokens, and
`first_steps` steps that the reference follows. The configuration file's
`trainer` object is the program's Word2VecConfig; its `init_std` is the
standard deviation of the tables the benchmark draws.

A run:
  set-up   the corpus and the tables from the seed on the card, the
           Trainer, then the first steps one call of Trainer.train each
           (the window's own call and resident feed; the first captures
           the step's CUDA graph and builds or loads the kernels), then
           one warm chunk;
  window   one Trainer.train call on that same trainer and state, stopped
           at the first chunk boundary past `seconds` (its cooperative
           stop check), synchronized at its end by train() itself;
  check    the tables and losses of the first steps against the plain
           reference (gpubench/reference), after the trainer is freed, and
           the program's alias table or Huffman code against the
           reference's own.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import numpy as np
import torch

from ..counts import trace as trace_mod
from ..run import TRACE_SECONDS
from ..counts.work import hs_counts, sgns_counts
from ..reference import hs as ref_hs
from ..reference import sgns as ref_sgns
from ..reference import streams, tables
from .zipf import sub_seed, zipf_counts, zipf_tokens


class Setup:
    """One cell's corpus, tables and trainer, built from the seed."""

    def __init__(self, cell, device):
        from word2vec_tpu_torch import PackedCorpus, Trainer, Vocab, Word2VecConfig

        cell.note("program imported")
        tr, cf = cell.traffic, cell.config
        self.cell, self.dev = cell, torch.device(device)
        self.counts = zipf_counts(tr["vocab"], tr["vocab_total_words"], tr.get("zipf_s", 1.0))
        self.flat = zipf_tokens(self.counts, tr["tokens"], sub_seed(cell.seed, 1), self.dev)
        flat = self.flat.cpu().numpy()
        cell.note("corpus drawn")
        sl = tr["sentence_len"]
        vocab = Vocab([f"w{i}" for i in range(len(self.counts))], self.counts)
        self.run_seed = int(cell.seed) & ((1 << 63) - 1)
        self.cfg = Word2VecConfig(**cf["trainer"], seed=self.run_seed)
        c = self.cfg
        corpus = PackedCorpus.pack((flat[i:i + sl] for i in range(0, len(flat), sl)), c.max_sentence_len)
        self.trainer = Trainer(c, vocab, corpus, device=self.dev)
        cell.note("trainer built")
        self.hs = c.train_method == "hs"
        V, d = len(self.counts), c.word_dim
        g = torch.Generator(device=self.dev)
        g.manual_seed(sub_seed(cell.seed, 2))
        std = float(cf["init_std"])
        out_rows = V - 1 if self.hs else V
        emb_in = torch.randn((V, d), generator=g, device=self.dev) * std
        emb_out = torch.randn((out_rows, d), generator=g, device=self.dev) * std
        self.leaf_names = ("emb_in", "emb_out_hs" if self.hs else "emb_out_ns")
        self.params0 = {self.leaf_names[0]: emb_in, self.leaf_names[1]: emb_out}
        self.rows = streams.Rows(self.flat, sl, c.max_sentence_len, c.batch_rows, self.run_seed)
        self.total_words = corpus.num_tokens
        tb = self.trainer.tables
        # the program's derived tables, kept (on the host) for the checks
        self.prog_tables = ((tb.hs_codes, tb.hs_points, tb.hs_len) if self.hs
                            else (tb.alias_accept, tb.alias_idx))
        self.prog_tables = tuple(a.cpu().numpy() for a in self.prog_tables)
        self._ref_tables = None
        self.chunk_len = c.chunk_geometry(self.rows.steps_per_epoch, cap=c.chunk_cap)[0]

    def ref_tables(self):
        """The reference's own alias table or Huffman code (reference/tables),
        on the device; built after the window, on first use."""
        if self._ref_tables is None:
            built = (tables.huffman_code(self.counts) if self.hs
                     else tables.alias_table(self.counts, self.cfg.ns_power))
            self._ref_tables = (built, tuple(torch.as_tensor(a, device=self.dev) for a in built))
        return self._ref_tables


def leaves(params: Dict[str, torch.Tensor], names) -> Dict[str, torch.Tensor]:
    """The tables as [rows, d] leaves, whatever the program's layout."""
    from word2vec_tpu_torch.models.params import logical_table

    return {n: logical_table(params, n).detach().to("cpu", torch.float32, copy=True) for n in names}


def first_steps(s: Setup) -> Dict:
    """Steps 1..n through Trainer.train, one call each; the losses and the
    tables after step 1 and after step n."""
    from word2vec_tpu_torch import TrainState

    n = int(s.cell.traffic["first_steps"])
    state = TrainState(params=s.params0)
    losses, snaps = [], {}
    for i in range(1, n + 1):
        state, rep = s.trainer.train(state=state, log_every=0, max_steps=i)
        losses.append(float(rep.final_loss))
        if i in (1, n):
            snaps[i] = leaves(state.params, s.leaf_names)
    s.params0 = {k: v.to("cpu") for k, v in s.params0.items()}
    return {"state": state, "losses": losses, "after_1": snaps[1], "after_n": snaps[n]}


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Operands rounded to float8 e4m3 with one scale a tensor (amax to
    448): the precision control."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


QUANT = {"float32": ref_sgns.identity, "fp8": _fp8}


def reference_steps(s: Setup, n: int, quant: str = "float32", half_batch: bool = False) -> Dict:
    """The reference's first n steps from the benchmark's tables: the
    losses and the tables after step 1 and after step n (float32, host).
    `half_batch` leaves out every row past the first half (a fault)."""
    c, dev = s.cfg, s.dev
    q = QUANT[quant]
    E_in = s.params0[s.leaf_names[0]].to(dev, torch.float32, copy=True)
    E_out = s.params0[s.leaf_names[1]].to(dev, torch.float32, copy=True)
    keepp = torch.as_tensor(streams.keep_probs(s.counts, c.subsample_threshold), device=dev)
    V = len(s.counts)
    if s.hs:
        codes, points, lens = s.ref_tables()[1]
    else:
        accept, alias = s.ref_tables()[1]
    losses, snaps, words = [], {}, 0
    for st in range(n):
        tokens = s.rows.batch(st)
        if half_batch:
            tokens[tokens.shape[0] // 2:] = -1
        u, w_eff, bucket, coin = streams.draws(
            dev, s.run_seed, st, c.batch_rows, c.max_sentence_len, c.window,
            V, 0 if s.hs else c.shared_negatives)
        keep = (tokens >= 0) & (u < keepp[tokens.clamp_min(0).long()])
        alpha = streams.alpha_at(c.init_alpha, c.min_alpha, words, c.iters, s.total_words)
        if s.hs:
            ls, pr = ref_hs.step(E_in, E_out, tokens, keep, w_eff, codes, points, lens,
                                 alpha, c.window, c.hs_dense_top, c.clip_row_update, q)
        else:
            negs = torch.where(coin < accept[bucket.long()], bucket, alias[bucket.long()])
            ls, pr = ref_sgns.step(E_in, E_out, tokens, keep, w_eff, negs, alpha,
                                   c.negative, c.window, c.clip_row_update, q)
        losses.append(ls / pr)
        words += s.rows.words(st)
        if st + 1 in (1, n):
            snaps[st + 1] = {s.leaf_names[0]: E_in.to("cpu", copy=True),
                             s.leaf_names[1]: E_out.to("cpu", copy=True)}
    return {"losses": losses, "after_1": snaps[1], "after_n": snaps[n]}


def compare(s: Setup, prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers `correct` is decided on (see PERF.md): the widest
    relative gap of a step's loss; by the worst leaf, the gap between the
    norms of the first update (the first gradient as SGD applies it, over
    alpha) and of the change after the n steps, each against the larger of
    that leaf's reference norm and the median leaf's."""
    c = s.cfg
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    alpha0 = streams.alpha_at(c.init_alpha, c.min_alpha, 0, c.iters, s.total_words)
    p0 = {k: v.to("cpu") for k, v in s.params0.items()}

    def gap(key, scale):
        rn = {k: float(torch.linalg.vector_norm(p0[k].float() - ref[key][k])) / scale for k in p0}
        pn = {k: float(torch.linalg.vector_norm(p0[k].float() - prog[key][k])) / scale for k in p0}
        med = float(np.median(list(rn.values())))
        return rn, {k: abs(pn[k] - rn[k]) / max(rn[k], med) for k in p0}

    g_ref, g_gap = gap("after_1", alpha0)
    med = float(np.median(list(g_ref.values())))
    moving = [k for k in p0 if g_ref[k] >= 1e-3 * med]
    _, c_gap = gap("after_n", 1.0)
    return {
        "loss_gap": loss_gap,
        "grad_gap": max(g_gap.values()),
        "change_gap": max(c_gap[k] for k in moving),
    }


def table_checks(s: Setup) -> Dict[str, float]:
    """The entries where the program's derived table differs from the
    reference's own."""
    ref = s.ref_tables()[0]
    if s.hs:
        return {"huffman_mismatch": float(tables.huffman_mismatch(*s.prog_tables, ref))}
    return {"alias_mismatch": float(tables.alias_mismatch(*s.prog_tables, ref))}


def window_counts(s: Setup, step0: int, step1: int, group: int = 32) -> Dict[str, float]:
    """The work of the window's steps, from their inputs worked out again
    (reference/streams), `group` steps at a time."""
    c, dev = s.cfg, s.dev
    V, B = len(s.counts), c.batch_rows
    keepp = torch.as_tensor(streams.keep_probs(s.counts, c.subsample_threshold), device=dev)
    tot: Dict[str, float] = {}
    if s.hs:
        codes, points, lens = s.ref_tables()[1]
    else:
        accept, alias = s.ref_tables()[1]
    for g0 in range(step0, step1, group):
        steps = list(range(g0, min(step1, g0 + group)))
        tokens = s.rows.batches(steps)
        drawn = [streams.draws(dev, s.run_seed, st, B, c.max_sentence_len, c.window,
                               V, 0 if s.hs else c.shared_negatives) for st in steps]
        u = torch.cat([x[0] for x in drawn])
        w_eff = torch.cat([x[1] for x in drawn])
        keep = (tokens >= 0) & (u < keepp[tokens.clamp_min(0).long()])
        if s.hs:
            r = hs_counts(tokens, keep, w_eff, lens, points, c.word_dim, c.window,
                          c.hs_dense_top, B)
        else:
            bucket = torch.cat([x[2] for x in drawn]).long()
            coin = torch.cat([x[3] for x in drawn])
            negs = torch.where(coin < accept[bucket], bucket, alias[bucket].long())
            r = sgns_counts(tokens, keep, w_eff, negs, c.word_dim, c.negative, c.window, V, B)
        for k, v in r.items():
            tot[k] = tot.get(k, 0.0) + v
    return tot


def run(cell) -> Dict:
    s = Setup(cell, cell.device)
    fs = first_steps(s)
    cell.note("first steps done (the graph captured)")
    state, _ = s.trainer.train(state=fs.pop("state"), log_every=0,
                               max_steps=int(cell.traffic["first_steps"]) + s.chunk_len)
    cell.note("warm chunk done")
    tracer = cell.tracer()
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    trace_from = deadline - TRACE_SECONDS
    step0, words0 = state.step, state.words_done
    traced = [step0, words0]  # the traced part's first step and words before it
    if trace_from <= t0:
        tracer.begin()

    def stop_check(step):
        now = time.perf_counter()
        if now >= trace_from and not tracer.on and cell.trace:
            # at a dispatch boundary, with the device drained, so that the
            # traced part holds the device work of whole dispatches
            cell.sync()
            live = s.trainer.last_state
            traced[:] = [live.step, live.words_done]
            tracer.begin()
        return now >= deadline

    s.trainer.stop_check = stop_check
    state, rep = s.trainer.train(state=state, log_every=0)
    t1 = time.perf_counter()
    prof = tracer.end()
    step1, words = state.step, state.words_done - words0
    state_words = state.words_done
    failed = int((rep.health or {}).get("nonfinite_loss_steps", 0))
    peak = cell.memory_peak()
    cell.note("window closed")
    s.trainer = state = rep = None
    gc.collect()
    cell.release()
    out: Dict = {
        "e2e": {"train_words_per_s": words / (t1 - t0), "setup_s": t0 - cell.t_start},
        "attempted": step1 - step0,
        "failed": failed,
        "memory_peak_bytes": peak,
    }
    if prof is not None:
        dig = trace_mod.from_profiler(prof)
        cell.note("trace read")
        out["trace"] = {
            **dig, "steps": step1 - traced[0], "words": state_words - traced[1],
            "work": window_counts(s, traced[0], step1),
            "compute_dtype": s.cfg.compute_dtype,
        }
        cell.note("window's work counted")
    ref = reference_steps(s, len(fs["losses"]))
    out["numbers"] = {**compare(s, fs, ref), **table_checks(s)}
    cell.note("reference done")
    return out
