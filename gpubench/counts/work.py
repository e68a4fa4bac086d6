"""The work a training step needs: operations and bytes, from its inputs.

Counted as the algorithm needs them, not as a kernel happens to do them:
each input row read once, each output written once, only the pairs and
positions that the data makes live (a position no pair touches needs
nothing). So a kernel's share of its bound can only reach 100% by doing
no more than the work itself; a count above what the inputs need would
let a share pass 100%, which the benchmark treats as a fault.

Per step (sg, per [B, L] batch with its subsample gate and window draws):

  sgns_counts      the pairs, the model FLOPs of the published algorithm
                   (6 d (1 + K) a pair: (1 + K) dots, each with its two
                   gradient products), and the bytes and operations of the
                   two kernels the band route runs: the gradient core
                   (gathers, band and pool logits, gradients, overlap-add)
                   and the table scatter;
  hs_counts        the (pair, node) terms, the model FLOPs (6 d a term) and
                   the table scatter's bytes and operations (the input
                   table's centers and the tail nodes' (context position,
                   slot) sums; the top tier is a dense slice add, no scatter).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..reference.sgns import band


def _distinct(ids: torch.Tensor, step_of: torch.Tensor, V: int) -> int:
    """Distinct ids within each step, summed over the steps."""
    return int(torch.unique(step_of * V + ids).numel())


def _live(tokens, keep, w_eff, W):
    m, jc = band(keep, tokens >= 0, w_eff, W)
    n_ctx = m.sum(-1)
    centers = keep & (n_ctx > 0)
    B, L = tokens.shape
    ctx_pos = torch.zeros(B, L, dtype=torch.int32, device=tokens.device)
    ctx_pos.scatter_reduce_(1, jc.reshape(1, -1).expand(B, -1), m.reshape(B, -1).int(), "amax")
    return m, jc, centers, ctx_pos > 0


def sgns_counts(tokens, keep, w_eff, negs, d: int, K: int, W: int, V: int,
                B: int, table_bytes: int = 4) -> Dict[str, float]:
    """Summed over the steps of the batch: tokens, keep, w_eff [n B, L]
    (n steps of B rows), negs [n B, KP]."""
    tok = tokens.clamp_min(0).long()
    m, _, centers, ctx_pos = _live(tokens, keep, w_eff, W)
    R, L = tokens.shape
    KP = negs.shape[1]
    st = (torch.arange(R, device=tokens.device) // B)[:, None]
    st_l, st_n = st.expand(R, L), st.expand(R, KP)
    pairs = int(m.sum())
    n_c = int(centers.sum())
    n_x = int(ctx_pos.sum())
    u_ctr = _distinct(tok[centers], st_l[centers], V)
    u_ctx = _distinct(tok[ctx_pos], st_l[ctx_pos], V)
    u_neg = _distinct(negs.long().reshape(-1), st_n.reshape(-1), V)
    u_out = _distinct(torch.cat([tok[ctx_pos], negs.reshape(-1).long()]),
                      torch.cat([st_l[ctx_pos], st_n.reshape(-1)]), V)
    n_steps = R // B
    n_pool = KP * int(centers.any(dim=1).sum())   # the pools of rows with a center
    # gradient core: center in-rows, context and pool out-rows read once;
    # tokens (4 B), gate and window (1 B each) of every position, the pool
    # ids; an f32 update row and its count written for each live center
    # and each live context position (the kernel's dense [B, L] layout
    # writes the others too: not counted), the pool updates and weights of
    # the rows with a center, two loss sums
    core_bytes = (
        (u_ctr + u_ctx + u_neg) * d * table_bytes
        + R * L * 6 + R * KP * 4
        + 4 * ((d + 1) * (n_c + n_x + n_pool) + 2 * n_steps)
    )
    # pool logits and the center and pool gradient products at KP columns
    # a live center; the band logits and both band gradient products a pair
    core_flops = 2 * d * (3 * n_c * KP + 3 * pairs)
    # scatter: each live contribution row (f32 values + int32 id) read once,
    # each destination row read and written once
    scatter_bytes = 4 * (d + 1) * (n_c + n_x + n_pool) + 2 * d * table_bytes * (u_ctr + u_out)
    scatter_flops = d * (n_c + n_x + n_pool)
    return {
        "pairs": pairs,
        "model_flops": 6 * d * (1 + K) * pairs,
        "core_bytes": core_bytes, "core_flops": core_flops,
        "scatter_bytes": scatter_bytes, "scatter_flops": scatter_flops,
    }


def hs_counts(tokens, keep, w_eff, lens, points, d: int, W: int, top_p: int,
              B: int, table_bytes: int = 4) -> Dict[str, float]:
    """Summed over the steps of the batch, as sgns_counts; lens [V],
    points [V, C] the Huffman code's lengths and node ids."""
    tok = tokens.clamp_min(0).long()
    m, jc, centers, ctx_pos = _live(tokens, keep, w_eff, W)
    R, L = tokens.shape
    V = lens.shape[0]
    n_nodes = V - 1
    st = (torch.arange(R, device=tokens.device) // B)[:, None]
    ctx = tok[:, jc]                               # [B, L, 2W]
    terms = int((lens[ctx].long() * m).sum())
    # tail (context position, slot) entries that some pair touches
    thresh = n_nodes - top_p
    C = points.shape[1]
    lane = torch.arange(C, device=tokens.device)
    tail_slot = (lane[None, :] < lens[:, None]) & (points < thresh)   # [V, C]
    slots = tail_slot[tok] & ctx_pos[..., None]      # [R, L, C]
    n_tail = int(slots.sum())
    u_tail = _distinct(points[tok][slots].long(), st[:, :, None].expand(R, L, C)[slots], n_nodes)
    n_c = int(centers.sum())
    u_ctr = _distinct(tok[centers], st.expand(R, L)[centers], V)
    return {
        "pairs": int(m.sum()),
        "terms": terms,
        "model_flops": 6 * d * terms,
        "scatter_bytes": 4 * (d + 1) * (n_c + n_tail) + 2 * d * table_bytes * (u_ctr + u_tail),
        "scatter_flops": d * (n_c + n_tail),
    }

