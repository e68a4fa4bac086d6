"""The split-table fused band core: wrapper, plain version, count.

Port of word2vec_tpu/ops/pallas_band.py. The TPU kernel becomes the
hand-written CUDA kernel of csrc/band_core.cu (its header note says what
bounds it on the H100 and how the design answers it). It carries
band_backend='pallas': everything between the step's gathers and its
sorted scatters, over rows the caller gathered from the two [V, d] tables.

Layout contract (pallas_band.py:31-55; pre-chunked with ops/banded):
  a      [B, C, S, d]     center rows (emb_in for sg, emb_out for cbow;
                          zero rows past L), table dtype
  bk     [B, C, S+2W, d]  context slabs (emb_out for sg, emb_in for cbow;
                          zero rows outside the row), table dtype
  en     [B|1, KP, d]     shared negative rows ([1, KP, d] batch scope)
  tok_c  [B, C, S]        int32 center ids, -1 past the row end (raw)
  tok_k  [B, C, S+2W]     int32 slab ids, -1 outside (banded.slab_token_ids)
  keep_c, w_c [B, C, S]   float32 center gate and shrunk window
  negs   [B|1, KP]        int32 negative ids
Outputs, all float32:
  d_h        [B, C, S, d]     center-row gradient
  d_ctx      [B, C, S+2W, d]  context-row gradient, SLAB space
  d_neg      [B|1, KP, d]     negative-row gradient, summed over C (and B)
  n_ctx      [B, C, S]        active contexts per center
  ctx_w      [B, C, S+2W]     contribution weight per slab slot
  w_neg_sum  [B|1, KP]        per-draw expectation weight, summed likewise
  losses     [1, 2]           (pos_loss, neg_loss)

The wrapper takes the plain version (below) for tensors on the CPU and
launches the kernel for tensors on a CUDA device, or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build
from .banded import band_dist
from .launch import (
    check, check_smem, core_smem_bytes, core_workspaces, count, on_cuda,
    phase_record, scalar_arg, stream,
)

CoreOutputs = Tuple[torch.Tensor, ...]


def band_core_plain(
    a: torch.Tensor,
    bk: torch.Tensor,
    en: torch.Tensor,
    tok_c: torch.Tensor,
    tok_k: torch.Tensor,
    keep_c: torch.Tensor,
    w_c: torch.Tensor,
    negs: torch.Tensor,
    alpha,
    *,
    W: int,
    K: int,
    cdt: torch.dtype = torch.bfloat16,
    is_cbow: bool = False,
    cbow_mean: bool = True,
) -> CoreOutputs:
    """The band core in plain torch ops, over all (row, chunk) tiles at
    once, with the TPU kernel's arithmetic: every contraction rounds both
    operands to `cdt` and accumulates in f32 (a float32 matmul; TF32 must
    be off on the card); d_neg, w_neg_sum and the losses are per-tile sums
    added tile by tile in the TPU grid's order (c within b)."""
    B, C, S, d = a.shape
    SK = bk.shape[2]
    NB, KP = negs.shape
    f32 = torch.float32

    def r(x):  # operand rounding of the Pallas `dot`
        return x.to(cdt).to(f32)

    def dot(x, y):  # [..., m, n] @ [..., n, p] with cdt operands
        return torch.matmul(r(x), r(y))

    a32, bk32 = a.to(f32), bk.to(f32)
    dist = torch.as_tensor(band_dist(C * S, W, S), device=a.device).to(f32)
    valid_k = (tok_k >= 0).to(f32)
    mask = (
        keep_c.to(f32)[..., None]
        * valid_k[:, :, None, :]
        * (dist <= w_c.to(f32)[..., None]).to(f32)
        * (dist > 0.0).to(f32)
    )                                                         # [B, C, S, SK]
    n_ctx = mask.sum(-1)                                      # [B, C, S]
    ctx_w = mask.sum(-2)                                      # [B, C, SK]

    if not is_cbow:
        h = a32
        k_i = n_ctx * float(K)
    else:
        h = dot(mask, bk32)
        if cbow_mean:
            h = h / torch.clamp_min(n_ctx, 1.0)[..., None]
        k_i = torch.where(n_ctx > 0.0, float(K), 0.0)

    negs_b = negs[:, None, None, :]                           # [NB, 1, 1, KP]
    center_hit = (tok_c[..., None] == negs_b).to(f32)         # [B, C, S, KP]
    hit_k = (tok_k[..., None] == negs_b).to(f32)              # [B, C, SK, KP]
    ctx_hit = dot(mask, hit_k)
    neg_ok = 1.0 - torch.clamp(center_hit + ctx_hit, 0.0, 1.0)
    w_neg = (k_i / float(KP))[..., None] * neg_ok             # [B, C, S, KP]
    en_t = en.to(f32)[:, None]                                # [NB, 1, KP, d]
    nlog = dot(h, en_t.transpose(-1, -2))                     # [B, C, S, KP]
    gn = (0.0 - torch.sigmoid(nlog)) * w_neg * alpha
    d_hid = dot(gn, en_t)                                     # [B, C, S, d]
    d_neg_c = dot(gn.transpose(-1, -2), h)                    # [B, C, KP, d]
    neg_loss_t = -torch.sum(w_neg * (F.logsigmoid(nlog) - nlog), dim=(2, 3))

    if not is_cbow:
        plog = dot(a32, bk32.transpose(-1, -2))               # [B, C, S, SK]
        gp = (1.0 - torch.sigmoid(plog)) * mask * alpha
        d_h = d_hid + dot(gp, bk32)
        d_ctx = dot(gp.transpose(-1, -2), a32)                # [B, C, SK, d]
        pos_loss_t = -torch.sum(mask * F.logsigmoid(plog), dim=(2, 3))
    else:
        plog_c = torch.sum(r(h) * r(a32), dim=-1)             # [B, C, S]
        active = (n_ctx > 0.0).to(f32)
        gp = (1.0 - torch.sigmoid(plog_c)) * active * alpha
        d_h = gp[..., None] * h
        d_hid = d_hid + gp[..., None] * a32
        if cbow_mean:
            d_hid = d_hid / torch.clamp_min(n_ctx, 1.0)[..., None]
        d_ctx = dot(mask.transpose(-1, -2), d_hid)
        pos_loss_t = -torch.sum(active * F.logsigmoid(plog_c), dim=-1)

    # the grid's accumulations, tile by tile in (b, c) order: per row over
    # c, or over every tile under batch scope
    wns_t = w_neg.sum(dim=2)                                  # [B, C, KP]
    d_neg = torch.zeros((NB, KP, d), dtype=f32, device=a.device)
    w_neg_sum = torch.zeros((NB, KP), dtype=f32, device=a.device)
    if NB == 1:
        for b in range(B):
            for c in range(C):
                d_neg = d_neg + d_neg_c[b, c]
                w_neg_sum = w_neg_sum + wns_t[b, c]
    else:
        for c in range(C):
            d_neg = d_neg + d_neg_c[:, c]
            w_neg_sum = w_neg_sum + wns_t[:, c]
    loss = torch.zeros((2,), dtype=f32, device=a.device)
    tiles = torch.stack([pos_loss_t, neg_loss_t], dim=-1).reshape(B * C, 2)
    for t in range(B * C):
        loss = loss + tiles[t]
    return (
        d_h.contiguous(), d_ctx.contiguous(), d_neg,
        n_ctx, ctx_w, w_neg_sum, loss.reshape(1, 2),
    )


def band_core(
    a: torch.Tensor,
    bk: torch.Tensor,
    en: torch.Tensor,
    tok_c: torch.Tensor,
    tok_k: torch.Tensor,
    keep_c: torch.Tensor,
    w_c: torch.Tensor,
    negs: torch.Tensor,
    alpha,                # float, or a 0-d float32 tensor on the device
    *,
    W: int,
    K: int,
    cdt: torch.dtype = torch.bfloat16,
    is_cbow: bool = False,
    cbow_mean: bool = True,
    phase_cycles: Optional[torch.Tensor] = None,
) -> CoreOutputs:
    """One fused pass over the band (module docstring contract). Returns
    (d_h, d_ctx, d_neg, n_ctx, ctx_w, w_neg_sum, losses). `phase_cycles`,
    an int64 [B, len(launch.CORE_PHASES)] tensor on the card, receives the
    kernel's per-phase cycle counts for each row (CUDA only)."""
    kw = dict(W=W, K=K, cdt=cdt, is_cbow=is_cbow, cbow_mean=cbow_mean)
    ins = (a, bk, en, tok_c, tok_k, keep_c, w_c, negs)
    if not on_cuda("band_core", *ins):
        if phase_cycles is not None:
            raise ValueError("band_core: phase_cycles needs the CUDA kernel")
        return band_core_plain(*ins, alpha, **kw)
    B, C, S, d = a.shape
    SK = bk.shape[2]
    NB, KP = negs.shape
    T = a.dtype
    if T not in (torch.float32, torch.bfloat16):
        raise ValueError(f"band_core: table dtype {T} unsupported")
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"band_core: compute dtype {cdt} unsupported")
    if SK != S + 2 * W or S < 2 * W or NB not in (1, B):
        raise ValueError(
            f"band_core: geometry S={S} SK={SK} W={W} NB={NB} B={B} is not "
            "a chunked band (SK = S + 2W, S >= 2W, negatives per row or one "
            "shared pool)"
        )
    check("a", a, (B, C, S, d), T)
    check("bk", bk, (B, C, SK, d), T)
    check("en", en, (NB, KP, d), T)
    check("tok_c", tok_c, (B, C, S), torch.int32)
    check("tok_k", tok_k, (B, C, SK), torch.int32)
    check("keep_c", keep_c, (B, C, S), torch.float32)
    check("w_c", w_c, (B, C, S), torch.float32)
    check("negs", negs, (NB, KP), torch.int32)

    dev = a.device
    check_smem(
        "band_core",
        core_smem_bytes("band_core", S, SK, KP, d, W, cdt == torch.bfloat16),
        dev,
    )
    rec = phase_record("band_core", phase_cycles, B, dev)
    alpha_t = scalar_arg("band_core alpha", alpha, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    d_h = torch.empty((B, C, S, d), **f32)
    d_ctx = torch.empty((B, C, SK, d), **f32)
    n_ctx = torch.empty((B, C, S), **f32)
    ctx_w = torch.empty((B, C, SK), **f32)
    d_neg = torch.empty((NB, KP, d), **f32)
    w_neg_sum = torch.empty((NB, KP), **f32)
    # batch scope: per-row partials, reduced in row order by the library
    shared = NB == 1 and B > 1
    dneg_row = torch.empty((B, KP, d), **f32) if shared else d_neg
    wsum_row = torch.empty((B, KP), **f32) if shared else w_neg_sum
    loss_part = torch.empty((B, 2), **f32)
    losses = torch.empty((1, 2), **f32)
    # cbow workspaces: the f32 projection, and d_hid (the f32-compute
    # body's d_hid2; the tensor-core body's running sum over negative
    # pieces, which keeps d_hid2 itself in shared memory)
    ws_shape = (B, S, d) if is_cbow else (0,)
    h_ws = torch.empty(ws_shape, **f32)
    dh_ws = torch.empty(ws_shape, **f32)
    # what a chunk past one center piece hands from piece to piece
    dneg_ws, wsum_ws = core_workspaces(
        "band_core", B, S, KP, d, W, cdt == torch.bfloat16, dev)

    lib = _build.library("band_core")
    with torch.cuda.device(dev):
        err = lib.w2v_band_core(
            a.data_ptr(), bk.data_ptr(), en.data_ptr(),
            int(T == torch.bfloat16),
            tok_c.data_ptr(), tok_k.data_ptr(), keep_c.data_ptr(),
            w_c.data_ptr(), negs.data_ptr(), alpha_t.data_ptr(),
            d_h.data_ptr(), d_ctx.data_ptr(), n_ctx.data_ptr(),
            ctx_w.data_ptr(), dneg_row.data_ptr(), wsum_row.data_ptr(),
            d_neg.data_ptr(), w_neg_sum.data_ptr(), loss_part.data_ptr(),
            losses.data_ptr(), h_ws.data_ptr(), dh_ws.data_ptr(),
            dneg_ws.data_ptr(), wsum_ws.data_ptr(),
            B, C, S, SK, KP, d, W, K, int(shared),
            int(cdt == torch.bfloat16), int(is_cbow), int(cbow_mean), rec,
            stream(dev),
        )
    if err != 0:
        smem = lib.w2v_band_core_smem_bytes(S, SK, KP, d, W, int(cdt == torch.bfloat16))
        _build.check(lib, err, f"band_core launch ({smem} B shared memory)")
    count("band_core")
    return d_h, d_ctx, d_neg, n_ctx, ctx_w, w_neg_sum, losses
