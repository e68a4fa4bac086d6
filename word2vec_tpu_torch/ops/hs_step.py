"""Positional hierarchical-softmax training step, in torch.

Port of word2vec_tpu/ops/hs_step.py (`resolve_tail_slots`,
`make_hs_train_step`), with the draw / apply contract of
ops/band_step.BandStep:

  draw(gen, tokens)                   -> Draws (subsample uniforms, w_eff,
                                         SR uniforms; hs draws no negatives)
  apply(params, tokens, draws, alpha) -> metrics; params updated in place

A position's Huffman path is the same for every center that predicts it,
so each position's path rows are gathered ONCE and the window is swept by
2W static shifted slices (sg); cbow scores the center's own path against
the banded context projection (ops/banded.py). With config.hs_dense_top
= P > 0 the top-P node ids — a prefix of every path and the contiguous
top slice of the [V-1, d] table — collapse into dense matmuls over the
per-word signed multi-hot tables.hs_msig (the dense tier, one slice add),
and only the short path remainders (the tail tier) go through the
positional sweep and scatter, optionally compacted to the slots that got
a gradient (config.hs_tail_slots; overflow drops updates and counts them
in the hs_tail_dropped metric). The JAX module's docstring has the full
derivation.

Every scattered table update goes through ops/train_step.sorted_scatter: a stable
argsort, the ordered row sums of scatter_mean and the trust region, and
the ordered scatter of ops/fused_step, so per-row order is the JAX
step's on the CPU and on the card. The dense tier's slice add is a plain
add onto the top P rows, which are distinct. Padded path slots keep the
JAX mapping to node 0 (their values are exact zeros), so node 0 collects
one long run of sorted ids.

SR sites (Draws.sr, each [n, d] in sorted order): 0 = the emb_in update
(B*L rows; cbow with slab_scatter: B*C*(S+2W)), 1 = the path scatter
(after tail compaction), 2 = the dense tier's [P, d] slice; see sr_rows.

Mesh axes, as in ops/band_step.BandStep: with tp > 1 the params are one
tensor-parallel shard's tables ([V, d/tp] and [V-1, d/tp]) and the step is
a body (ops/shards.py) with psum sites at the dense tier's logits and
clip norms (hs_step.py:179, :221-222), the path logits (:266, :315) and
every trust region; with sp > 1 the tokens are a sequence shard's haloed
slice and only the owned positions train as centers (:435-452).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Word2VecConfig
from ..device import torch_dtype
from . import banded
from .tables import DeviceTables
from .shards import center_zone, solo
from .train_step import (
    Draws, Metrics, _cast_update, _rc, finish_metrics, gate, scatter_update,
)


def resolve_tail_slots(
    config: Word2VecConfig, tables: DeviceTables, L: int, slots: int
) -> int:
    """Compacted tail-scatter bound T for a batch row of L positions with
    `slots` padded tail slots; 0 = compaction off (scatter every slot).
    Host-side, from the config and the vocabulary's tail statistics
    (hs_step.py:96-127): auto (-1) is E[touched slots] + 6 sigma under
    the unigram tail-length stats (independence approximation) plus Ct
    of headroom; a bound covering every slot is 0 (nothing to compact)."""
    if config.hs_tail_slots == 0 or slots == 0:
        return 0
    if config.hs_tail_slots > 0:
        return 0 if config.hs_tail_slots >= slots else config.hs_tail_slots
    Ct = tables.hs_tail_codes.shape[1]
    exp = L * tables.hs_tail_mean
    sd = math.sqrt(max(L * tables.hs_tail_var, 0.0))
    T = int(math.ceil(exp + 6.0 * sd)) + Ct
    return 0 if T >= slots else T


class HsStep:
    """The positional hs step for one config and its device tables (split
    tables: the config refuses the unified slab for hs)."""

    def __init__(
        self, config: Word2VecConfig, tables: DeviceTables, tp: int = 1, sp: int = 1
    ):
        if not config.use_hs or config.use_ns:
            raise ValueError("hs kernel supports hierarchical softmax only")
        if config.table_layout == "unified":
            raise ValueError(
                "table_layout='unified' applies to the ns band kernel only; "
                "hs params have no [V, 2, d] form (models/params.py)"
            )
        torch_dtype(config.dtype)
        self.config = config
        self.tables = tables
        self.cdt = torch_dtype(config.compute_dtype)
        self.two_tier = tables.hs_msig is not None
        self.P = tables.hs_msig.shape[1] if self.two_tier else 0
        self.Ct = tables.hs_tail_codes.shape[1] if self.two_tier else 0
        self.sp = sp
        #: the width of the tables this step updates (a tp shard's d/tp)
        self.dim = config.word_dim // tp

    # ---------------------------------------------------------------- draws
    def _path_slots(self, L: int) -> Tuple[int, int]:
        """(padded path slots per batch row, compaction bound T)."""
        cfg = self.config
        span = L + 2 * cfg.window if cfg.model == "sg" else L
        if not self.two_tier:
            return span * self.tables.max_code_len, 0
        slots = span * self.Ct
        return slots, resolve_tail_slots(cfg, self.tables, L, slots)

    def sr_rows(self, B: int, L: int) -> Tuple[int, int, int]:
        """Rows of the three SR uniform sets for [B, L] tokens (0: none)."""
        cfg = self.config
        W = cfg.window
        n_in = B * L
        if cfg.model == "cbow" and cfg.slab_scatter:
            S = banded.resolve_chunk(L, W, cfg.band_chunk)
            if S > 0:
                C, _ = banded._geom(L, W, S)
                n_in = B * C * (S + 2 * W)
        slots, T = self._path_slots(L)
        return n_in, B * (T or slots), self.P

    def draw(self, gen: torch.Generator, tokens: torch.Tensor) -> Draws:
        cfg = self.config
        B, L = tokens.shape
        W, dev = cfg.window, tokens.device
        u_sub = torch.rand((B, L), generator=gen, device=dev)
        w_eff = W - torch.randint(
            0, W, (B, L), generator=gen, device=dev, dtype=torch.int32
        )
        sr = None
        if cfg.stochastic_rounding:
            sr = tuple(
                torch.rand((n, self.dim), generator=gen, device=dev) if n else None
                for n in self.sr_rows(B, L)
            )
        return Draws(u_sub, w_eff, None, sr)

    def __call__(self, params, tokens, gen, alpha) -> Metrics:
        return self.apply(params, tokens, self.draw(gen, tokens), alpha)

    # -------------------------------------------------------------- pieces
    def _update(self, table, idx, vals, weights, u):
        """scatter_update under this config (hs_step.py:295-326)."""
        cfg = self.config
        return scatter_update(
            table, idx, vals, weights if cfg.scatter_mean else None,
            scatter_mean=cfg.scatter_mean, clip_tau=cfg.clip_row_update, u=u,
        )

    def _dense_tier(self, h, A, N, syn1, alpha):
        """The top-slice tier, all matmuls (hs_step.py:164-236): h [B,L,d];
        A / N [B,L,P] the summed positive-label / any activation counts of
        each top node over h's training pairs. Returns (d_h [B,L,d], d_top
        [P,d] scaled by scatter_mean and the clip, loss, pairs, clip)."""
        cfg, cdt, P = self.config, self.cdt, self.P
        top = syn1[syn1.shape[0] - P:]  # read before any update lands
        hc, tc = _rc(h, cdt), _rc(top, cdt)
        Fl = yield torch.einsum("bid,pd->bip", hc, tc)
        sigF = torch.sigmoid(Fl)
        G = (A - sigF * N) * alpha
        Gc = _rc(G, cdt)
        d_h = torch.einsum("bip,pd->bid", Gc, tc)
        d_top = torch.einsum("bip,bid->pd", Gc, hc)
        lsF = F.logsigmoid(Fl)
        loss = -(torch.sum(A * lsF) + torch.sum((N - A) * (lsF - Fl)))
        pairs = torch.sum(N)
        clip = torch.zeros((), dtype=torch.float32, device=h.device)
        mean_inv = None
        if cfg.scatter_mean:  # mean before clip, as on the scatter paths
            mean_inv = 1.0 / torch.clamp_min(N.sum(dim=(0, 1)), 1.0)
            d_top = d_top * mean_inv[:, None]
        tau = cfg.clip_row_update
        if tau > 0.0:
            # triangle bound per pair entry: S_p = sum |g| * ||h_i||
            hsq = yield torch.sum(h.float() ** 2, dim=-1)
            absg = (A * (1.0 - sigF) + (N - A) * sigF) * alpha
            s_p = torch.einsum("bip,bi->p", absg, torch.sqrt(hsq))
            if mean_inv is not None:
                s_p = s_p * mean_inv
            scale = tau / torch.clamp_min(s_p, tau)
            clip = torch.sum((scale < 1.0).float())
            d_top = d_top * scale[:, None]
        return d_h, d_top, loss, pairs, clip

    def _sg_sweep(self, h, tokens, keep, w_eff, syn1, alpha, pts, cds, lens,
                  want_touched):
        """The sg offset sweep over one set of path tables (hs_step.py:
        238-293): per offset o, every active (center i, context i+o) pair
        against the context's path entries. Returns (paths [B,Q,Cx],
        d_rows [B,Q,Cx,d], touched or None, out_touch or None, d_h, loss,
        pairs, ctx_hit [B,L])."""
        cfg, cdt = self.config, self.cdt
        W = cfg.window
        B, L = tokens.shape
        dev = tokens.device
        Cx = pts.shape[1]
        tok_pad = F.pad(tokens, (W, W), value=-1)
        vpad = tok_pad >= 0
        tpad = torch.where(vpad, tok_pad, 0).long()
        paths = pts[tpad]  # [B, Q, Cx]
        codes = cds[tpad]
        lane = torch.arange(Cx, dtype=torch.int32, device=dev)
        cmask = (lane[None, None, :] < lens[tpad][:, :, None]) & vpad[:, :, None]
        rows = _rc(syn1[paths.long()], cdt)  # [B, Q, Cx, d]: ONE gather
        hc = _rc(h, cdt)

        d_h = torch.zeros(h.shape, dtype=torch.float32, device=dev)
        d_rows = torch.zeros(rows.shape, dtype=torch.float32, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        loss, pairs = zero, zero
        ctx_hit = torch.zeros((B, L), dtype=torch.bool, device=dev)
        touched = torch.zeros(paths.shape, dtype=torch.bool, device=dev) if want_touched else None
        out_touch = (torch.zeros(paths.shape, dtype=torch.float32, device=dev)
                     if cfg.scatter_mean else None)
        for o in [o for o in range(-W, W + 1) if o != 0]:
            sl = slice(W + o, W + o + L)  # context j = i + o, padded coords
            pair_ok = keep & vpad[:, sl] & (abs(o) <= w_eff)  # [B, L]
            m = (pair_ok[:, :, None] & cmask[:, sl]).float()
            r = rows[:, sl]
            logit = yield torch.einsum("bid,bicd->bic", hc, r)  # [B, L, Cx]
            # g = (1 - code - f) * alpha (Word2Vec.cpp:241-242)
            label = 1.0 - codes[:, sl].float()
            g = (label - torch.sigmoid(logit)) * m * alpha
            gc = _rc(g, cdt)
            d_h = d_h + torch.einsum("bic,bicd->bid", gc, r)
            d_rows[:, sl] = d_rows[:, sl] + gc[..., None] * hc[:, :, None, :]
            ls = F.logsigmoid(logit)
            loss = loss + -torch.sum(m * torch.where(label > 0.5, ls, ls - logit))
            pairs = pairs + torch.sum(m)
            ctx_hit = ctx_hit | pair_ok
            if touched is not None:
                touched[:, sl] = touched[:, sl] | (m > 0)
            if out_touch is not None:
                out_touch[:, sl] = out_touch[:, sl] + m
        return paths, d_rows, touched, out_touch, d_h, loss, pairs, ctx_hit

    def _cbow_path_block(self, h, tok, gate_, syn1, alpha, pts, cds, lens):
        """One cbow block against one set of path tables (hs_step.py:
        295-330 before the scatter): targets are the center's own path.
        Returns (paths [B,L,Cx], d_rows, m, d_h_add, loss, pairs)."""
        cdt = self.cdt
        Cx = pts.shape[1]
        tl = tok.long()
        paths = pts[tl]  # [B, L, Cx]
        codes = cds[tl]
        lane = torch.arange(Cx, dtype=torch.int32, device=tok.device)
        cmask = (lane[None, None, :] < lens[tl][:, :, None]) & gate_[:, :, None]
        rows = _rc(syn1[paths.long()], cdt)  # [B, L, Cx, d]
        hc = _rc(h, cdt)
        logit = yield torch.einsum("bid,bicd->bic", hc, rows)
        m = cmask.float()
        label = 1.0 - codes.float()
        g = (label - torch.sigmoid(logit)) * m * alpha
        gc = _rc(g, cdt)
        d_h_add = torch.einsum("bic,bicd->bid", gc, rows)
        d_rows = gc[..., None] * hc[:, :, None, :]
        ls = F.logsigmoid(logit)
        loss = -torch.sum(m * torch.where(label > 0.5, ls, ls - logit))
        return paths, d_rows, m, d_h_add, loss, torch.sum(m)

    def _path_scatter(self, syn1, flat_p, vals, weights, touched, T, u):
        """The path-row scatter (hs_step.py:332-366): flat_p / weights /
        touched [B, Sl], vals [B, Sl, d]. T = 0 scatters every slot; T > 0
        keeps each batch row's first T touched slots (a stable argsort keeps
        slot order) and counts the overflow it drops. Returns (clip,
        dropped)."""
        B, _, d = vals.shape
        dropped = torch.zeros((), dtype=torch.float32, device=vals.device)
        if T > 0:
            key = (~touched).to(torch.uint8)
            order = torch.argsort(key, dim=1, stable=True)[:, :T]
            flat_p = flat_p.gather(1, order)
            vals = vals.gather(1, order[:, :, None].expand(B, T, d))
            if weights is not None:
                weights = weights.gather(1, order)
            n_touched = touched.sum(dim=1)
            dropped = torch.clamp_min(n_touched - T, 0).float().sum()
        clip = yield from self._update(
            syn1, flat_p.reshape(-1), vals.reshape(-1, d),
            weights.reshape(-1) if weights is not None else None, u,
        )
        return clip, dropped

    def _dense_slice_add(self, syn1, d_top, u) -> None:
        """The dense tier's update (hs_step.py:405-415): one contiguous add
        onto the top-P rows, after the tail scatter has landed (the SR grid
        reads the latest rows). The rows are distinct, so no ordered sum is
        needed; each row rounds once, as in the scatter."""
        top = syn1[-self.P:]
        v = _cast_update(d_top, syn1.dtype, u, top if u is not None else None)
        top.copy_((top.float() + v.float()).to(syn1.dtype))

    # ---------------------------------------------------------------- apply
    def apply(self, params, tokens: torch.Tensor, draws: Draws, alpha) -> Metrics:
        """One step on [B, L] int32 tokens (pad -1). Updates params
        ({emb_in, emb_out_hs}) in place; metrics loss_sum, pairs,
        clip_engaged, hs_tail_dropped, nonfinite_loss (see BandStep.apply)."""
        return solo(self.body(params, tokens, draws, alpha))

    def body(self, params, tokens: torch.Tensor, draws: Draws, alpha):
        """`apply` as a step body (ops/shards.py, BandStep.body)."""
        cfg, tb = self.config, self.tables
        W, cdt = cfg.window, self.cdt
        if cfg.stochastic_rounding and draws.sr is None:
            raise ValueError("stochastic_rounding needs the SR uniforms")
        u_in, u_path, u_top = draws.sr if cfg.stochastic_rounding else (None,) * 3
        B, L = tokens.shape
        valid, tok, keep = gate(tokens, draws.u_sub, tb.keep_probs)
        if self.sp > 1:
            keep = keep & center_zone(L, W, tokens.device)[None, :]
        w_eff = draws.w_eff
        emb_in, syn1 = params["emb_in"], params["emb_out_hs"]
        d = emb_in.shape[1]
        slots, T = self._path_slots(L)
        dropped: Optional[torch.Tensor] = None
        clip = torch.zeros((), dtype=torch.float32, device=tokens.device)

        if cfg.model == "sg":
            # h = center row; targets = each context's path
            h = emb_in[tok.long()]  # [B, L, d]
            if self.two_tier:
                S = banded.resolve_chunk(L, W, cfg.band_chunk)
                # keep_i & valid_j & 0 < |i-j| <= w_eff_i: the sweep's pair_ok
                band_f = banded.band_mask(keep, valid, w_eff, W, S).float()
                M = tb.hs_msig[tok.long()]  # [B, L, P] i8
                A = banded.band_sv(band_f, (M > 0).float(), W, S, cdt)
                N = banded.band_sv(band_f, (M != 0).float(), W, S, cdt)
                d_h, d_top, loss, pairs, c = yield from self._dense_tier(h, A, N, syn1, alpha)
                clip = clip + c
                if self.Ct:
                    (paths, d_rows, touched, out_touch, d_h_t, t_loss, t_pairs,
                     ctx_hit) = yield from self._sg_sweep(
                        h, tokens, keep, w_eff, syn1, alpha, tb.hs_tail_points,
                        tb.hs_tail_codes, tb.hs_tail_len, want_touched=T > 0)
                    d_h = d_h + d_h_t
                    loss = loss + t_loss
                    pairs = pairs + t_pairs
                    c, dropped = yield from self._path_scatter(
                        syn1, paths.reshape(B, slots), d_rows.reshape(B, slots, d),
                        out_touch.reshape(B, slots) if out_touch is not None else None,
                        touched.reshape(B, slots) if touched is not None else None,
                        T, u_path)
                    clip = clip + c
                else:
                    # no tail tier: the center-activity mask from the band
                    ctx_hit = banded.band_row_sum(band_f, L) > 0
                self._dense_slice_add(syn1, d_top, u_top)
            else:
                (paths, d_rows, _, out_touch, d_h, loss, pairs,
                 ctx_hit) = yield from self._sg_sweep(
                    h, tokens, keep, w_eff, syn1, alpha, tb.hs_points,
                    tb.hs_codes, tb.hs_len, want_touched=False)
                c, _ = yield from self._path_scatter(
                    syn1, paths.reshape(B, slots), d_rows.reshape(B, slots, d),
                    out_touch.reshape(B, slots) if out_touch is not None else None,
                    None, 0, u_path)
                clip = clip + c
            # W.row(center) += accumulated grad (:351)
            clip = clip + (yield from self._update(
                emb_in, tok.reshape(-1), d_h.reshape(B * L, d),
                ctx_hit.float().reshape(-1), u_in))
        else:
            # h = (mean of) the banded context rows; targets = the
            # center's own path
            S = banded.resolve_chunk(L, W, cfg.band_chunk)
            band_f = banded.band_mask(keep, valid, w_eff, W, S).float()
            n_ctx = banded.band_row_sum(band_f, L)
            ein = emb_in[tok.long()]  # [B, L, d]
            h = banded.band_sv(band_f, ein, W, S, cdt)
            if cfg.cbow_mean:
                h = h / torch.clamp_min(n_ctx, 1.0)[:, :, None]
            active = keep & (n_ctx > 0)  # skip centers without context, :289
            if self.two_tier:
                M = tb.hs_msig[tok.long()]  # [B, L, P] i8
                act = active[:, :, None].float()
                A = (M > 0).float() * act
                N = (M != 0).float() * act
                d_h, d_top, loss, pairs, c = yield from self._dense_tier(h, A, N, syn1, alpha)
                clip = clip + c
                if self.Ct:
                    paths, d_rows, m, d_h_add, t_loss, t_pairs = yield from self._cbow_path_block(
                        h, tok, active, syn1, alpha, tb.hs_tail_points,
                        tb.hs_tail_codes, tb.hs_tail_len)
                    d_h = d_h + d_h_add
                    loss = loss + t_loss
                    pairs = pairs + t_pairs
                    c, dropped = yield from self._path_scatter(
                        syn1, paths.reshape(B, slots), d_rows.reshape(B, slots, d),
                        m.reshape(B, slots), (m > 0).reshape(B, slots), T, u_path)
                    clip = clip + c
                self._dense_slice_add(syn1, d_top, u_top)
            else:
                paths, d_rows, m, d_h, loss, pairs = yield from self._cbow_path_block(
                    h, tok, active, syn1, alpha, tb.hs_points, tb.hs_codes,
                    tb.hs_len)
                c, _ = yield from self._path_scatter(
                    syn1, paths.reshape(B, slots), d_rows.reshape(B, slots, d),
                    m.reshape(B, slots), None, 0, u_path)
                clip = clip + c
            # fan d_h to the context rows (second /n under cbow_mean, :313-315)
            if cfg.cbow_mean:
                d_h = d_h / torch.clamp_min(n_ctx, 1.0)[:, :, None]
            if cfg.slab_scatter and S > 0:
                # slab-space scatter: the table scatter's duplicate summing
                # performs the overlap-add
                d_in_slab = banded.band_vs_slab(band_f, d_h, W, S, cdt)
                slab_ids = banded.slab_token_ids(tok, W, S)
                ok = slab_ids >= 0
                clip = clip + (yield from self._update(
                    emb_in, torch.where(ok, slab_ids, 0).reshape(-1),
                    torch.where(ok[..., None], d_in_slab, 0.0).reshape(-1, d),
                    torch.where(ok, banded.band_col_sum_slab(band_f), 0.0).reshape(-1),
                    u_in))
            else:
                d_in_pos = banded.band_vs(band_f, d_h, W, S, cdt)
                clip = clip + (yield from self._update(
                    emb_in, tok.reshape(-1), d_in_pos.reshape(-1, d),
                    banded.band_col_sum(band_f, L, W, S).reshape(-1), u_in))

        m = {"loss_sum": loss, "pairs": pairs, "clip_engaged": clip}
        if dropped is not None:
            m["hs_tail_dropped"] = dropped
        return finish_metrics(m)
