"""The band train step, in torch, on every single-device route.

Port of word2vec_tpu/ops/band_step.py (`make_band_train_step` and
`_make_pallas_fused_step`). One `BandStep` per config; the step is split
in two so that the random draws are inputs:

  draw(gen, tokens)                   -> Draws (subsample uniforms, w_eff,
                                         the shared negatives, SR uniforms)
  apply(params, tokens, draws, alpha) -> metrics; params updated in place

Routes, by config.band_backend (the JAX package's names):
  * 'xla' (the default): the band chain in torch ops (band_step.py:242-589)
    on split [V, d] tables, or on the unified [V, 2, d] slab (the JAX
    step's fused=True branch); dense rows (S == 0) or chunked slabs;
    slab_scatter (context grads scattered from slab space through a second
    stable argsort).
  * 'pallas_oa': the same chain with its context-side overlap-add done by
    the kernel of ops/overlap.py (chunked rows only).
  * 'pallas': everything between the gathers and the scatters in the
    kernel of ops/band_core.py, split tables, the slab-space scatter tail
    (band_step.py:596-781).
  * 'pallas_fused': the two kernels of ops/fused_step.py on the unified
    slab (band_step.py:784-961).
Every route covers sg/cbow, negative_scope row and batch (pallas_fused:
row), scatter_mean, clip_row_update, float32/bfloat16 tables ±
stochastic rounding and bfloat16/float32 compute.

The tails share one discipline (`_update`): STABLE argsorts (jnp.argsort
is stable, torch.argsort is not by default); every per-row sum through
ops/train_step.ordered_row_sum, one call per `.at[].add` of the JAX chain,
in its order; every table update through the ordered sorted scatter of
ops/fused_step (split tables are [V, d] slabs of one plane). The
negative-row scatter, unsorted in JAX, runs on the stably sorted negative
ids with its values, weights and SR uniforms permuted alike, which keeps
each row's terms in the JAX order. So per-row order holds on the card as
it does in the JAX package, and split and unified tables give bitwise the
same trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import Word2VecConfig
from ..device import torch_dtype
from ..models.params import FUSED_KEY, Params
from . import banded
from .band_core import band_core
from .fused_step import fused_grad_core, fused_slab_scatter
from .overlap import overlap_add_tokens
from .runs import find_runs
from .tables import DeviceTables
from .train_step import (
    _cast_update, _draw_negatives, _dup_mean_scale, _row_clip_scale,
    ordered_row_sum,
)

Metrics = Dict[str, torch.Tensor]
# (sorted ids [N] int32, values [N, d] f32, scatter_mean weights [N] f32)
Side = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@dataclass
class Draws:
    """Every random draw of one step."""

    u_sub: torch.Tensor   # [B, L] f32 subsample uniforms
    w_eff: torch.Tensor   # [B, L] int32 shrunk window per center
    negs: torch.Tensor    # [B, KP] (row scope) or [KP] (batch) int32
    # SR uniforms per update site, None unless config.stochastic_rounding:
    # 0 = the emb_in update [n_in, d] and 1 = the emb_out update
    # [n_out, d], each in sorted order, n = B*L rows for a side scattered
    # in token order and B*C*(S+2W) for one scattered from slab space
    # (BandStep.sr_rows); 2 = the negative rows [negs.numel(), d] in draw
    # order
    sr: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def check_route(config: Word2VecConfig) -> None:
    """Raise NotImplementedError for any route the port does not run yet."""
    if config.use_hs:
        raise NotImplementedError(
            "hierarchical softmax is a later slice of the PyTorch port "
            "(ops/hs_step.py)"
        )
    if config.resolved_kernel != "band":
        raise NotImplementedError(
            f"kernel={config.kernel!r} (the pair step, ops/train_step.py) "
            "is a later slice of the PyTorch port"
        )
    if config.fused_tables:
        raise NotImplementedError(
            "fused_tables (the chunk runners' transient [V, 2, d] restack, "
            "ops/train_step.py make_chunk_runner) comes with the chunked "
            "dispatch, a later slice of the PyTorch port; "
            "table_layout='unified' stores the slab for every step"
        )
    torch_dtype(config.dtype)
    torch_dtype(config.compute_dtype)


class BandStep:
    """The band step for one config and its device tables. Tensor-parallel,
    data-parallel and sequence-parallel mesh axes (the JAX step's tp/dp/sp
    arguments, `_halo_exchange`) come with the multi-GPU slice."""

    def __init__(self, config: Word2VecConfig, tables: DeviceTables):
        check_route(config)
        self.config = config
        self.tables = tables
        self.cdt = torch_dtype(config.compute_dtype)
        self.route = config.band_backend
        self.unified = config.table_layout == "unified"

    # ---------------------------------------------------------------- draws
    def sr_rows(self, B: int, L: int) -> Tuple[int, int, int]:
        """Rows of the three SR uniform sets (Draws.sr) for [B, L] tokens."""
        cfg = self.config
        W = cfg.window
        S = banded.resolve_chunk(L, W, cfg.band_chunk)
        slab = 0
        if S > 0:
            C, _ = banded._geom(L, W, S)
            slab = B * C * (S + 2 * W)
        tok = B * L
        if self.route == "pallas" or (cfg.slab_scatter and S > 0):
            # the context side scatters from slab space
            n_in, n_out = (slab, tok) if cfg.model == "cbow" else (tok, slab)
        else:
            n_in, n_out = tok, tok
        n_neg = cfg.shared_negatives * (B if cfg.negative_scope == "row" else 1)
        return n_in, n_out, n_neg

    def draw(self, gen: torch.Generator, tokens: torch.Tensor) -> Draws:
        """The step's draws from `gen` (on the tokens' device)."""
        cfg = self.config
        B, L = tokens.shape
        W, KP = cfg.window, cfg.shared_negatives
        dev = tokens.device
        V = self.tables.alias_accept.shape[0]
        u_sub = torch.rand((B, L), generator=gen, device=dev)
        w_eff = W - torch.randint(
            0, W, (B, L), generator=gen, device=dev, dtype=torch.int32
        )
        shape = (B, KP) if cfg.negative_scope == "row" else (KP,)
        bucket = torch.randint(
            0, V, shape, generator=gen, device=dev, dtype=torch.int32
        )
        coin = torch.rand(shape, generator=gen, device=dev)
        negs = _draw_negatives(
            bucket, coin, self.tables.alias_accept, self.tables.alias_idx
        )
        sr = None
        if cfg.stochastic_rounding:
            d = cfg.word_dim
            sr = tuple(
                torch.rand((n, d), generator=gen, device=dev)
                for n in self.sr_rows(B, L)
            )
        return Draws(u_sub, w_eff, negs, sr)

    # ---------------------------------------------------------------- apply
    def apply(
        self,
        params: Params,
        tokens: torch.Tensor,
        draws: Draws,
        alpha: float,
    ) -> Metrics:
        """One step on [B, L] int32 tokens (pad -1). Updates the tables of
        `params` in place and returns the metrics (device scalars:
        loss_sum, pairs, clip_engaged)."""
        if not self.config.stochastic_rounding:
            draws = Draws(draws.u_sub, draws.w_eff, draws.negs)
        elif draws.sr is None:
            raise ValueError("stochastic_rounding needs the SR uniforms")
        if self.route == "pallas_fused":
            return self._apply_fused(params, tokens, draws, alpha)
        if self.route == "pallas":
            return self._apply_pallas(params, tokens, draws, alpha)
        return self._apply_xla(params, tokens, draws, alpha)

    def __call__(
        self,
        params: Params,
        tokens: torch.Tensor,
        gen: torch.Generator,
        alpha: float,
    ) -> Metrics:
        return self.apply(params, tokens, self.draw(gen, tokens), alpha)

    def _gate(self, tokens: torch.Tensor, draws: Draws):
        """(valid, clamped ids, keep): the center-word subsample gate
        (Word2Vec.cpp:282,332)."""
        valid = tokens >= 0
        tok = torch.where(valid, tokens, 0)
        keep = valid & (draws.u_sub < self.tables.keep_probs[tok.long()])
        return valid, tok, keep

    def _chunked(self, L: int) -> int:
        """The chunk size S of a kernel route; raises for rows that resolve
        dense (no overlap-add or slab tile to hand a kernel)."""
        W, chunk = self.config.window, self.config.band_chunk
        S = banded.resolve_chunk(L, W, chunk)
        if S == 0:
            raise ValueError(
                f"band_backend={self.route!r} needs the chunked band "
                f"representation, but rows of length {L} resolved to the "
                f"dense path (band_chunk={chunk}, window={W}). Set "
                f"band_chunk to 2*window <= S < {L}, or use "
                f"band_backend='xla' for short rows"
            )
        return S

    # ------------------------------------------------------------ xla chain
    def _apply_xla(self, params, tokens, draws, alpha) -> Metrics:
        """band_step.py:242-589: the chain in torch ops ('xla'), with the
        overlap-add kernel on 'pallas_oa'."""
        cfg = self.config
        W, K, KP, cdt = cfg.window, cfg.negative, cfg.shared_negatives, self.cdt
        per_row = cfg.negative_scope == "row"
        is_cbow = cfg.model == "cbow"
        B, L = tokens.shape
        valid, tok, keep = self._gate(tokens, draws)
        S = banded.resolve_chunk(L, W, cfg.band_chunk)
        if self.route == "pallas_oa":
            S = self._chunked(L)

        def ctx_fan(scores, u):
            # band_vs, the context-side fan-out; on pallas_oa its
            # overlap-add is the kernel
            if self.route == "pallas_oa":
                return overlap_add_tokens(
                    banded.band_vs_slab(scores, u, W, S, cdt), W, S, L
                )
            return banded.band_vs(scores, u, W, S, cdt)

        band_f = banded.band_mask(keep, valid, draws.w_eff, W, S).float()
        n_ctx = banded.band_row_sum(band_f, L)  # [B, L] contexts per center
        use_slab = cfg.slab_scatter and S > 0
        tok_l = tok.long()
        if self.unified:
            emb = params[FUSED_KEY]  # [V, 2, d]
            V_in = V_out = emb.shape[0]
            g2 = emb[tok_l]  # one gather for both planes: [B, L, 2, d]
            ein, eout = g2[:, :, 0].contiguous(), g2[:, :, 1].contiguous()
        else:
            emb_in, emb_out = params["emb_in"], params["emb_out_ns"]
            V_in, V_out = emb_in.shape[0], emb_out.shape[0]
            ein, eout = emb_in[tok_l], emb_out[tok_l]

        # shared negatives and the collision mask vs each row's centers and
        # active contexts (0/1 operands: exact in cdt under "> 0")
        negs = draws.negs
        negs_l = negs.long()
        en = emb[negs_l, 1] if self.unified else emb_out[negs_l]
        if per_row:
            center_hit = tok[:, :, None] == negs[:, None, :]  # [B, L, KP]
        else:
            center_hit = tok[:, :, None] == negs[None, None, :]
        ctx_hit = banded.band_sv(band_f, center_hit.float(), W, S, cdt) > 0.0
        neg_ok = ~(center_hit | ctx_hit)

        if not is_cbow:
            h = ein                       # projection = center row (W), :330
            k_i = n_ctx * K               # reference draws per center
        else:
            h = banded.band_sv(band_f, ein, W, S, cdt)
            if cfg.cbow_mean:
                h = h / torch.clamp_min(n_ctx, 1.0)[:, :, None]
            k_i = torch.where(n_ctx > 0, float(K), 0.0)

        # ---- negative side: dense contractions against the shared draws
        en_spec = "bnd" if per_row else "nd"
        nlog = banded.cdot(f"bid,{en_spec}->bin", h, en, cdt)  # [B, L, KP]
        w_neg = (k_i / KP)[:, :, None] * neg_ok
        gn = (0.0 - torch.sigmoid(nlog)) * w_neg * alpha
        d_h = banded.cdot(f"bin,{en_spec}->bid", gn, en, cdt)  # [B, L, d]
        d_neg = banded.cdot(f"bin,bid->{en_spec}", gn, h, cdt)

        # ---- positive side
        if not is_cbow:
            plog = banded.band_qk(ein, eout, W, S, cdt)
            gp = (1.0 - torch.sigmoid(plog)) * band_f * alpha  # label 1
            d_h = d_h + banded.band_sv(gp, eout, W, S, cdt)
            if use_slab:
                d_ctx_slab = banded.band_vs_slab(gp, ein, W, S, cdt)
                ctx_w_slab = banded.band_col_sum_slab(band_f)
                d_out_pos = out_weight = None
            else:
                d_out_pos = ctx_fan(gp, ein)
                out_weight = banded.band_col_sum(band_f, L, W, S)
            d_in_pos = d_h
            pos_loss = -banded.band_loss_sum(band_f * F.logsigmoid(plog))
            pos_pairs = banded.band_loss_sum(band_f)
            in_weight = (keep & (n_ctx > 0)).float()
        else:
            plog = banded.cdot("bid,bid->bi", h, eout, cdt)  # [B, L]
            active = (keep & (n_ctx > 0)).float()
            gp = (1.0 - torch.sigmoid(plog)) * active * alpha
            d_h = d_h + gp[:, :, None] * eout
            d_out_pos = gp[:, :, None] * h  # on the center position
            # fan d_h back to the contributing context rows
            if cfg.cbow_mean:
                d_h = d_h / torch.clamp_min(n_ctx, 1.0)[:, :, None]
            if use_slab:
                d_ctx_slab = banded.band_vs_slab(band_f, d_h, W, S, cdt)
                ctx_w_slab = banded.band_col_sum_slab(band_f)
                d_in_pos = in_weight = None
            else:
                d_in_pos = ctx_fan(band_f, d_h)
                in_weight = banded.band_col_sum(band_f, L, W, S)
            pos_loss = -torch.sum(active * F.logsigmoid(plog))
            pos_pairs = torch.sum(active)
            out_weight = active

        # ---- the sides: one shared stable sort of the row token ids; with
        # use_slab the context side scatters slab-space values over the
        # slab token ids (their duplicate summing is the overlap-add)
        d = h.shape[-1]
        flat = tok.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sorted_idx = flat[order].contiguous()
        if use_slab:
            slab_ids = banded.slab_token_ids(tok, W, S)  # [B, C, S+2W]
            slab_ok = slab_ids >= 0
            slab_flat = torch.where(slab_ok, slab_ids, 0).reshape(-1)
            slab_order = torch.argsort(slab_flat, stable=True)
            slab_side = (
                slab_flat[slab_order].contiguous(),
                torch.where(slab_ok[..., None], d_ctx_slab, 0.0)
                .reshape(-1, d)[slab_order],
                torch.where(slab_ok, ctx_w_slab, 0.0).reshape(-1)[slab_order],
            )

        def token_side(vals, weight):
            return sorted_idx, vals.reshape(-1, d)[order], weight.reshape(-1)[order]

        in_side = token_side(d_in_pos, in_weight) if d_in_pos is not None else slab_side
        out_side = token_side(d_out_pos, out_weight) if d_out_pos is not None else slab_side
        w_neg_flat = w_neg.sum(dim=1).reshape(-1) if per_row else w_neg.sum(dim=(0, 1))
        clip_count = self._update(
            params, (V_in, V_out), in_side, out_side,
            (negs.reshape(-1), d_neg.reshape(-1, d), w_neg_flat), draws.sr,
        )
        # masked BCE for metrics: negatives with their expectation weights
        neg_loss = -torch.sum(w_neg * (F.logsigmoid(nlog) - nlog))
        return {
            "loss_sum": pos_loss + neg_loss,
            "pairs": pos_pairs + torch.sum(w_neg),
            "clip_engaged": clip_count,
        }

    # ------------------------------------------------------- pallas (B4)
    def _apply_pallas(self, params, tokens, draws, alpha) -> Metrics:
        """band_step.py:596-781: the gathers, the band-core kernel, and the
        slab-space scatter tail (split tables)."""
        cfg = self.config
        W, K = cfg.window, cfg.negative
        per_row = cfg.negative_scope == "row"
        is_cbow = cfg.model == "cbow"
        B, L = tokens.shape
        _, tok, keep = self._gate(tokens, draws)
        S = self._chunked(L)
        C, P = banded._geom(L, W, S)
        emb_in, emb_out = params["emb_in"], params["emb_out_ns"]
        d = emb_in.shape[1]
        negs = draws.negs
        en = emb_out[negs.long()]  # [B, KP, d] | [KP, d]

        # matrix roles (Word2Vec.cpp:300-315 vs :330-351): sg scores emb_in
        # centers against emb_out context slabs; cbow the reverse
        center_tbl, ctx_tbl = (emb_out, emb_in) if is_cbow else (emb_in, emb_out)
        tok_l = tok.long()
        pad_c = C * S - L
        a_c = banded._pad_rows(center_tbl[tok_l], C * S).reshape(B, C, S, d)
        bk = banded._slabs(banded._pad_ctx(ctx_tbl[tok_l], W, P), C, S, 2 * W)
        # raw ids with -1 kept: the kernel derives validity from them, and
        # center_hit compares the raw ids
        tok_c = F.pad(tokens, (0, pad_c), value=-1).reshape(B, C, S)
        tok_k = banded.slab_token_ids(tokens, W, S)
        keep_c = F.pad(keep.float(), (0, pad_c)).reshape(B, C, S)
        w_c = F.pad(draws.w_eff.float(), (0, pad_c)).reshape(B, C, S)
        negs2 = (negs if per_row else negs[None]).to(torch.int32)
        d_h4, d_ctx_slab, d_neg_k, nctx_c, ctx_w_slab, wns, losses = band_core(
            a_c.contiguous(), bk.contiguous(),
            (en if per_row else en[None]).contiguous(),
            tok_c.contiguous(), tok_k.contiguous(), keep_c.contiguous(),
            w_c.contiguous(), negs2.contiguous(), alpha,
            W=W, K=K, cdt=self.cdt, is_cbow=is_cbow, cbow_mean=cfg.cbow_mean,
        )
        d_h = d_h4.reshape(B, C * S, d)[:, :L]
        n_ctx = nctx_c.reshape(B, C * S)[:, :L]

        # the sides: centers by token id, contexts in slab space; the
        # kernel already zeroes values and weights at invalid slots
        flat = tok.reshape(-1)
        order = torch.argsort(flat, stable=True)
        slab_ok = tok_k >= 0
        slab_flat = torch.where(slab_ok, tok_k, 0).reshape(-1)
        slab_order = torch.argsort(slab_flat, stable=True)
        active_flat = (n_ctx > 0).float().reshape(-1)
        center_side = (
            flat[order].contiguous(), d_h.reshape(-1, d)[order], active_flat[order]
        )
        slab_side = (
            slab_flat[slab_order].contiguous(),
            d_ctx_slab.reshape(-1, d)[slab_order],
            ctx_w_slab.reshape(-1)[slab_order],
        )
        if not is_cbow:
            in_side, out_side = center_side, slab_side
            pos_pairs = torch.sum(n_ctx)
        else:
            in_side, out_side = slab_side, center_side
            pos_pairs = torch.sum(active_flat)
        w_neg_flat = (wns if per_row else wns[0]).reshape(-1)
        d_neg_flat = (d_neg_k if per_row else d_neg_k[0]).reshape(-1, d)
        clip_count = self._update(
            params, (emb_in.shape[0], emb_out.shape[0]), in_side, out_side,
            (negs.reshape(-1), d_neg_flat, w_neg_flat), draws.sr,
        )
        return {
            "loss_sum": losses[0, 0] + losses[0, 1],
            "pairs": pos_pairs + torch.sum(w_neg_flat),
            "clip_engaged": clip_count,
        }

    # ------------------------------------------------- pallas_fused (B1, B2)
    def _apply_fused(self, params, tokens, draws, alpha) -> Metrics:
        """band_step.py:784-961: the fused grad core on the unified slab,
        then the shared tail."""
        cfg = self.config
        W, K = cfg.window, cfg.negative
        is_cbow = cfg.model == "cbow"
        B, L = tokens.shape
        emb = params[FUSED_KEY]  # [V, 2, d]
        V, _, d = emb.shape
        _, tok, keep = self._gate(tokens, draws)
        S = self._chunked(L)
        C, _ = banded._geom(L, W, S)
        pad_c = C * S - L
        tok_c = F.pad(tok, (0, pad_c)).reshape(B, C, S).contiguous()
        tok_k = banded.slab_token_ids(tokens, W, S).contiguous()
        keep_c = F.pad(keep.float(), (0, pad_c)).reshape(B, C, S).contiguous()
        w_c = F.pad(draws.w_eff.float(), (0, pad_c)).reshape(B, C, S).contiguous()
        negs = draws.negs.to(torch.int32).contiguous()

        d_ctr, d_ctx, nctx_c, ctxw_c, d_neg, wns, losses = fused_grad_core(
            emb, tok_c, tok_k, keep_c, w_c, negs, alpha,
            W=W, K=K, L=L, cdt=self.cdt, is_cbow=is_cbow,
            cbow_mean=cfg.cbow_mean,
        )
        d_ctr = d_ctr.reshape(B, C * S, d)[:, :L]
        d_ctx = d_ctx.reshape(B, C * S, d)[:, :L]
        n_ctx = nctx_c.reshape(B, C * S)[:, :L]
        ctx_w = ctxw_c.reshape(B, C * S)[:, :L]

        active = (keep & (n_ctx > 0)).float()
        if not is_cbow:
            d_in_pos, d_out_pos = d_ctr, d_ctx
            in_weight, out_weight = active, ctx_w
            pos_pairs = torch.sum(n_ctx)
        else:
            d_in_pos, d_out_pos = d_ctx, d_ctr
            in_weight, out_weight = ctx_w, active
            pos_pairs = torch.sum(active)
        flat = tok.reshape(-1)
        order = torch.argsort(flat, stable=True)
        sorted_idx = flat[order].contiguous()
        clip_count = self._update(
            params, (V, V),
            (sorted_idx, d_in_pos.reshape(-1, d)[order], in_weight.reshape(-1)[order]),
            (sorted_idx, d_out_pos.reshape(-1, d)[order], out_weight.reshape(-1)[order]),
            (negs.reshape(-1), d_neg.reshape(-1, d), wns.reshape(-1)), draws.sr,
        )
        return {
            "loss_sum": losses[0, 0] + losses[0, 1],
            "pairs": pos_pairs + torch.sum(wns),
            "clip_engaged": clip_count,
        }

    # ------------------------------------------------------------- the tail
    def _update(
        self,
        params: Params,
        rows: Tuple[int, int],
        in_side: Side,
        out_side: Side,
        neg: Side,
        sr: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    ) -> torch.Tensor:
        """scatter_mean, the row clip, the casts and the table updates
        (band_step.py:454-579), in place. The sides carry their ids sorted;
        `neg` carries the negative ids in draw order and is stably sorted
        here. Returns the clip count."""
        cfg = self.config
        V_in, V_out = rows
        in_idx, in_vals, in_w = in_side
        out_idx, out_vals, out_w = out_side
        flat_negs, neg_vals, neg_w = neg
        order_n = torch.argsort(flat_negs, stable=True)
        neg_idx = flat_negs[order_n].to(torch.int32).contiguous()
        neg_vals, neg_w = neg_vals[order_n], neg_w[order_n]
        in_l, out_l, neg_l = in_idx.long(), out_idx.long(), neg_idx.long()
        # the run list of each sorted id array, built once on the card and
        # shared by its row sums and its scatter (the token-order sides
        # share one array); the CPU's plain versions need none
        in_runs = out_runs = neg_runs = None
        if in_idx.is_cuda:
            in_runs = find_runs(in_idx)
            out_runs = in_runs if out_idx is in_idx else find_runs(out_idx)
            neg_runs = find_runs(neg_idx)

        if cfg.scatter_mean:
            # per-contribution counts; the out table's count is joint over
            # its positive targets and the negative draws
            in_vals = in_vals * _dup_mean_scale(
                V_in, in_idx, in_w, presorted=True, runs=in_runs
            )[:, None]
            cnt = ordered_row_sum(
                V_out, out_idx, out_w, presorted=True, runs=out_runs
            )
            cnt = ordered_row_sum(
                V_out, neg_idx, neg_w, cnt, presorted=True, runs=neg_runs
            )
            inv = 1.0 / torch.clamp_min(cnt, 1.0)
            out_vals = out_vals * inv[out_l][:, None]
            neg_vals = neg_vals * inv[neg_l][:, None]

        clip_count = torch.zeros((), dtype=torch.float32, device=in_vals.device)
        if cfg.clip_row_update > 0.0:
            # the out table's positive and negative contributions share rows,
            # so they share one budget
            tau = cfg.clip_row_update
            in_scale = _row_clip_scale(
                V_in, tau, (in_idx, in_vals), presorted=True, runs=(in_runs,)
            )
            out_scale = _row_clip_scale(
                V_out, tau, (out_idx, out_vals), (neg_idx, neg_vals),
                presorted=True, runs=(out_runs, neg_runs),
            )
            clip_count = torch.sum((in_scale < 1.0).float()) + torch.sum(
                (out_scale < 1.0).float()
            )
            in_vals = in_vals * in_scale[in_l][:, None]
            out_vals = out_vals * out_scale[out_l][:, None]
            neg_vals = neg_vals * out_scale[neg_l][:, None]

        # SR quantizes each delta to its destination row's grid; the
        # negative rows' dest rows are read AFTER the positive scatters
        # have landed in place (band_step.py:543-553, 570-577)
        u_in, u_out, u_neg = sr if sr is not None else (None, None, None)
        if u_neg is not None:
            u_neg = u_neg[order_n]
        if self.unified:
            emb = params[FUSED_KEY]
            T = emb.dtype
            vals2 = torch.stack(
                [
                    _cast_update(in_vals, T, u_in, emb[in_l, 0] if sr else None),
                    _cast_update(out_vals, T, u_out, emb[in_l, 1] if sr else None),
                ],
                dim=1,
            ).contiguous()
            # one doubled-width scatter: both planes share the sorted ids
            fused_slab_scatter(emb, in_idx, vals2, runs=in_runs)
            vneg = _cast_update(neg_vals, T, u_neg, emb[neg_l, 1] if sr else None)
            fused_slab_scatter(emb, neg_idx, vneg.contiguous(), plane=1, runs=neg_runs)
        else:
            emb_in, emb_out = params["emb_in"], params["emb_out_ns"]
            T = emb_in.dtype
            vin = _cast_update(in_vals, T, u_in, emb_in[in_l] if sr else None)
            vout = _cast_update(out_vals, T, u_out, emb_out[out_l] if sr else None)
            fused_slab_scatter(emb_in, in_idx, vin.contiguous(), runs=in_runs)
            fused_slab_scatter(emb_out, out_idx, vout.contiguous(), runs=out_runs)
            vneg = _cast_update(neg_vals, T, u_neg, emb_out[neg_l] if sr else None)
            fused_slab_scatter(emb_out, neg_idx, vneg.contiguous(), runs=neg_runs)
        return clip_count
