"""The reference-faithful pair step in torch: PairStep, the port of
make_pair_train_step (word2vec_tpu/ops/train_step.py:168-237 and
339-616).

Every table update is the JAX step's unsorted `.at[].add`, here a stable
argsort and the ordered scatter (ops/train_step.sorted_scatter), so each
row adds its terms in update order, as XLA does on the CPU.

Mesh axes, as in ops/band_step.BandStep: with tp > 1 the step is a body
(ops/shards.py) with psum sites at every objective's logits
(train_step.py:205-206) and trust region; with sp > 1 the tokens are a
sequence shard's haloed slice and only the owned positions train as
centers (train_step.py:396-419).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Word2VecConfig
from ..device import torch_dtype
from .shards import center_zone, solo
from .train_step import (
    Draws, Metrics, _draw_negatives, _rc, finish_metrics, gate, scatter_update,
)


def _score_and_update(
    h: torch.Tensor,        # [P, d] projection rows
    out: torch.Tensor,      # [Vout, d] target-side table, updated in place
    targets: torch.Tensor,  # [P, T] int rows of `out`
    labels: torch.Tensor,   # [P, T] f32 in {0, 1}
    tmask: torch.Tensor,    # [P, T] f32 validity
    alpha,
    cdt: torch.dtype,
    scatter_mean: bool,
    clip_tau: float = 0.0,
    u: Optional[torch.Tensor] = None,
):
    """One sigmoid-SGD objective (train_step.py:168-237): f =
    sigmoid(out[target] . h); g = (label - f) * alpha; grad_h += g *
    out[target]; out[target] += g * h, batched over all P*T pairs. The
    table update is the unsorted `.at[targets].add` of the JAX step, here
    a stable argsort and the ordered scatter (sorted_scatter), so each
    row adds its terms in update order, as XLA does. `u` are the SR
    uniforms [P*T, d] in update order. A step body (ops/shards.py): the
    logits and the trust region are psum sites. Returns (grad_h,
    loss_sum, pair_count, clip_count)."""
    d = h.shape[-1]
    t = out[targets.long()]  # [P, T, d], gathered before the update
    tc, hc = _rc(t, cdt), _rc(h, cdt)
    logits = yield torch.einsum("pd,ptd->pt", hc, tc)
    g = (labels - torch.sigmoid(logits)) * tmask * alpha  # [P, T]
    grad_h = torch.einsum("pt,ptd->pd", _rc(g, cdt), tc)
    del tc
    grad_t = g[:, :, None] * h.float()[:, None, :]  # [P, T, d]
    clip = yield from scatter_update(
        out, targets.reshape(-1), grad_t.reshape(-1, d), tmask.reshape(-1),
        scatter_mean=scatter_mean, clip_tau=clip_tau, u=u, u_sorted=False,
    )
    # masked binary cross-entropy, for metrics only
    ls = F.logsigmoid(logits)
    loss = -torch.sum(tmask * torch.where(labels > 0.5, ls, ls - logits))
    return grad_h, loss, torch.sum(tmask), clip



class PairStep:
    """The reference-faithful pair step (make_pair_train_step,
    train_step.py:339-616) with the draw / apply contract of
    ops/band_step.BandStep:

      draw(gen, tokens)                   -> Draws (subsample uniforms,
                                             w_eff, per-pair negatives
                                             [P, K] under ns, SR uniforms)
      apply(params, tokens, draws, alpha) -> metrics; params updated in place

    Every (center, context) pair of the window is enumerated explicitly
    (P = B*L*2W for sg, B*L for cbow) and scored against its own targets:
    the positive and K negatives drawn per pair (ns, the alias draw of
    _draw_negatives) or the context word's Huffman path (hs). Split
    tables only (the config refuses the unified slab for pair). Tensor,
    data and sequence parallelism come with the multi-GPU slice.

    SR sites (Draws.sr, each in update order): 0 = the emb_in update
    ([B*L, d] for sg, [B*L*2W, d] for cbow), 1 = the ns table's
    [P*(1+K), d], 2 = the hs table's [P*C, d] (C = max code length).
    Under tp > 1 each is [n, d/tp] (`dim`)."""

    def __init__(self, config: Word2VecConfig, tables, tp: int = 1, sp: int = 1):
        torch_dtype(config.dtype)
        self.config = config
        self.tables = tables
        self.cdt = torch_dtype(config.compute_dtype)
        self.sp = sp
        #: the width of the tables this step updates (a tp shard's d/tp)
        self.dim = config.word_dim // tp

    def pairs(self, B: int, L: int) -> int:
        W = self.config.window
        return B * L * (2 * W if self.config.model == "sg" else 1)

    def sr_rows(self, B: int, L: int) -> Tuple[int, int, int]:
        """Rows of the three SR uniform sets for [B, L] tokens (0: none)."""
        cfg = self.config
        P = self.pairs(B, L)
        n_in = B * L if cfg.model == "sg" else B * L * 2 * cfg.window
        n_ns = P * (1 + cfg.negative) if cfg.use_ns else 0
        n_hs = P * self.tables.max_code_len if cfg.use_hs else 0
        return n_in, n_ns, n_hs

    def draw(self, gen: torch.Generator, tokens: torch.Tensor) -> Draws:
        cfg = self.config
        B, L = tokens.shape
        W, dev = cfg.window, tokens.device
        u_sub = torch.rand((B, L), generator=gen, device=dev)
        w_eff = W - torch.randint(
            0, W, (B, L), generator=gen, device=dev, dtype=torch.int32
        )
        negs = None
        if cfg.use_ns:
            shape = (self.pairs(B, L), cfg.negative)
            V = self.tables.alias_accept.shape[0]
            bucket = torch.randint(
                0, V, shape, generator=gen, device=dev, dtype=torch.int32
            )
            coin = torch.rand(shape, generator=gen, device=dev)
            negs = _draw_negatives(
                bucket, coin, self.tables.alias_accept, self.tables.alias_idx
            )
        sr = None
        if cfg.stochastic_rounding:
            sr = tuple(
                torch.rand((n, self.dim), generator=gen, device=dev) if n else None
                for n in self.sr_rows(B, L)
            )
        return Draws(u_sub, w_eff, negs, sr)

    def __call__(self, params, tokens, gen, alpha) -> Metrics:
        return self.apply(params, tokens, self.draw(gen, tokens), alpha)

    def _objectives(self, params, h, pred, mask, draws, alpha):
        """The ns and hs objectives on projections h [P, d] predicting
        pred [P] under mask [P]: (grad_h, loss, pairs, clip)."""
        cfg, tb = self.config, self.tables
        P = h.shape[0]
        sr = draws.sr if cfg.stochastic_rounding else None
        kw = dict(cdt=self.cdt, scatter_mean=cfg.scatter_mean,
                  clip_tau=cfg.clip_row_update)
        grad_h = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        loss = pairs = clip = torch.zeros((), dtype=torch.float32, device=h.device)
        if cfg.use_ns:
            negs = draws.negs
            targets = torch.cat([pred[:, None].to(negs.dtype), negs], dim=1)
            labels = torch.zeros(targets.shape, dtype=torch.float32, device=h.device)
            labels[:, 0] = 1.0
            # a drawn negative equal to the positive is skipped (word2vec.c)
            ok = torch.cat(
                [torch.ones((P, 1), dtype=torch.bool, device=h.device),
                 negs != pred[:, None]], dim=1)
            tmask = (mask[:, None] & ok).float()
            gh, ls, pc, cc = yield from _score_and_update(
                h, params["emb_out_ns"], targets, labels, tmask, alpha,
                u=sr[1] if sr else None, **kw)
        else:
            pl = pred.long()
            targets = tb.hs_points[pl]  # [P, Lc]
            labels = (1 - tb.hs_codes[pl]).float()  # :242
            Lc = targets.shape[1]
            lane = torch.arange(Lc, dtype=torch.int32, device=h.device)
            tmask = (mask[:, None] & (lane[None, :] < tb.hs_len[pl][:, None])).float()
            gh, ls, pc, cc = yield from _score_and_update(
                h, params["emb_out_hs"], targets, labels, tmask, alpha,
                u=sr[2] if sr else None, **kw)
        return grad_h + gh, loss + ls, pairs + pc, clip + cc

    def apply(self, params, tokens, draws: Draws, alpha) -> Metrics:
        """One step on [B, L] int32 tokens (pad -1); see BandStep.apply."""
        return solo(self.body(params, tokens, draws, alpha))

    def body(self, params, tokens, draws: Draws, alpha):
        """`apply` as a step body (ops/shards.py, BandStep.body)."""
        cfg = self.config
        W = cfg.window
        B, L = tokens.shape
        dev = tokens.device
        if cfg.stochastic_rounding and draws.sr is None:
            raise ValueError("stochastic_rounding needs the SR uniforms")
        valid, tok, keep = gate(tokens, draws.u_sub, self.tables.keep_probs)
        if self.sp > 1:
            keep = keep & center_zone(L, W, dev)[None, :]
        # ctx[b, i, k] = tokens[b, i + offsets[k]] via a padded gather (the
        # unrolled j-loop of Word2Vec.cpp:339, j != i excluded)
        offsets = torch.cat([torch.arange(-W, 0, device=dev),
                             torch.arange(1, W + 1, device=dev)])
        tok_pad = F.pad(tokens, (W, W), value=-1)
        gidx = torch.arange(L, device=dev)[:, None] + offsets[None, :] + W
        ctx = tok_pad[:, gidx]  # [B, L, 2W]
        pair_mask = (
            keep[:, :, None] & (ctx >= 0)
            & (offsets.abs()[None, None, :] <= draws.w_eff[:, :, None])
        )
        ctx = torch.where(pair_mask, ctx, 0)
        emb_in = params["emb_in"]
        d = emb_in.shape[1]
        u_in = draws.sr[0] if cfg.stochastic_rounding else None
        upd = dict(scatter_mean=cfg.scatter_mean, clip_tau=cfg.clip_row_update,
                   u=u_in, u_sorted=False)
        if cfg.model == "sg":
            # input = the center row of emb_in, predicted = each context
            # word (Word2Vec.cpp:319-353)
            P = B * L * 2 * W
            centers = tok[:, :, None].expand(B, L, 2 * W).reshape(P)
            h = emb_in[centers.long()]  # [P, d]
            grad_h, loss, pairs, clip = yield from self._objectives(
                params, h, ctx.reshape(P), pair_mask.reshape(P), draws, alpha)
            # W.row(center) += the grad summed over the center's window
            # (:351), the window's terms added in offset order
            g4 = grad_h.reshape(B, L, 2 * W, d)
            gh_pos = g4[:, :, 0]
            for k in range(1, 2 * W):
                gh_pos = gh_pos + g4[:, :, k]
            clip = clip + (yield from scatter_update(
                emb_in, tok.reshape(-1), gh_pos.reshape(B * L, d),
                pair_mask.any(dim=2).reshape(-1).float(), **upd))
        else:
            # projection = (mean of) the context rows (Word2Vec.cpp:273-317);
            # duplicate context words count with multiplicity
            ctx_rows = emb_in[ctx.long()]  # [B, L, 2W, d]
            fmask = pair_mask.to(ctx_rows.dtype)[..., None]
            masked = ctx_rows * fmask
            h_bl = masked[:, :, 0]
            for k in range(1, 2 * W):
                h_bl = h_bl + masked[:, :, k]
            n_ctx = pair_mask.sum(dim=2).float()  # neu1_num, :288
            center_ok = keep & (n_ctx > 0)  # skip if no context, :289
            if cfg.cbow_mean:
                h_bl = h_bl / torch.clamp_min(n_ctx, 1.0)[:, :, None]
            grad_h, loss, pairs, clip = yield from self._objectives(
                params, h_bl.reshape(B * L, d), tok.reshape(-1),
                center_ok.reshape(-1), draws, alpha)
            # fan the projection grad back to every contributing context
            # row (:313-315), the second /neu1_num under cbow_mean
            g_bl = grad_h.reshape(B, L, d)
            if cfg.cbow_mean:
                g_bl = g_bl / torch.clamp_min(n_ctx, 1.0)[:, :, None]
            g_ctx = (g_bl[:, :, None, :] * fmask).reshape(-1, d)
            clip = clip + (yield from scatter_update(
                emb_in, ctx.reshape(-1), g_ctx,
                pair_mask.reshape(-1).float(), **upd))
        return finish_metrics(
            {"loss_sum": loss, "pairs": pairs, "clip_engaged": clip}
        )
