"""Skip-gram with hierarchical softmax, one optimizer step, in plain PyTorch.

The semantics the configuration states (Mikolov et al. 2013, arXiv
1301.3781; the word2vec tool's `-hs 1 -negative 0`, in the form the
program trains):

  * centers and contexts as in reference/sgns.py (subsample gate on the
    center, 0 < |i - j| <= w_eff[i], real tokens only);
  * each (center i, context j) pair scores in[center] against the output
    row of every internal node on the Huffman path of the context's word,
    with label 1 - code bit: g = (label - sigmoid(logit)) * alpha;
  * the loss of a step is the summed cross-entropy over (pair, node) terms
    over their count;
  * SGD with every gradient taken at the step's starting tables, then the
    per-row trust region tau / max(S, tau), S the summed norms of a row's
    contributions. The configuration's two tiers (hs_dense_top P) state
    what a contribution is: one (pair, node) term for the P internal nodes
    nearest the root (the highest node ids), one (context position, path
    slot) sum for the other nodes, one center position for the input table.

The Huffman code (codes, points, lengths) is a table the program builds;
the reference takes it only after reference/tables.check_huffman has
shown it to be a full binary tree of the vocabulary with optimal cost.
Contractions are float32 with TF32 off unless `q` rounds their operands.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .sgns import Quant, band, identity


def step_grads(
    E_in: torch.Tensor, E_out: torch.Tensor, tokens: torch.Tensor,
    keep: torch.Tensor, w_eff: torch.Tensor, codes: torch.Tensor,
    points: torch.Tensor, lens: torch.Tensor, alpha: float, W: int, top_p: int,
    q: Quant = identity, block: int = 16,
) -> Dict[str, torch.Tensor]:
    """The step's updates per contribution, already times alpha:
    d_in [B, L, d]; the tail nodes' (context position, slot) sums as
    (node ids [n], values [n, d]); the top nodes' summed update [P, d]
    and their summed per-term norms [P]; loss_sum and pairs (float64)."""
    B, L = tokens.shape
    d = E_in.shape[1]
    dev = E_in.device
    n_nodes = E_out.shape[0]
    thresh = n_nodes - top_p  # node ids >= thresh are the top tier
    valid = tokens >= 0
    tok = tokens.clamp_min(0).long()
    Cx = codes.shape[1]
    lane = torch.arange(Cx, device=dev)
    d_in = torch.zeros(B, L, d, device=dev)
    top_sum = torch.zeros(top_p, d, device=dev)
    top_norm = torch.zeros(top_p, device=dev)
    tail_ids, tail_vals = [], []
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    pairs = torch.zeros((), dtype=torch.float64, device=dev)
    m_all, jc = band(keep, valid, w_eff, W)
    for b0 in range(0, B, block):
        sl = slice(b0, b0 + block)
        tk = tok[sl]
        m = m_all[sl]                                  # [b, L, 2W]
        ctx = tk[:, jc]                                # [b, L, 2W]
        pts = points[ctx].long()                       # [b, L, 2W, C]
        lab = 1.0 - codes[ctx].float()
        on = (lane < lens[ctx][..., None]) & m[..., None]
        onf = on.float()
        h = E_in[tk]                                   # [b, L, d]
        rows = E_out[pts]                              # [b, L, 2W, C, d]
        hq = q(h)
        logit = torch.einsum("bid,bikcd->bikc", hq, q(rows))
        g = (lab - torch.sigmoid(logit)) * onf * alpha
        gq = q(g)
        d_in[sl] = torch.einsum("bikc,bikcd->bid", gq, q(rows))
        ls = F.logsigmoid(logit)
        loss += (-(onf * torch.where(lab > 0.5, ls, ls - logit)).sum()).double()
        pairs += onf.sum().double()
        is_top = (pts >= thresh) & on
        # top tier: one contribution a (pair, node) term
        hn = torch.linalg.vector_norm(h, dim=-1)       # [b, L]
        t_idx = (pts - thresh).clamp_min(0)[is_top]
        t_h = hq[:, :, None, None, :].expand(-1, -1, 2 * W, Cx, -1)[is_top]
        top_sum.index_add_(0, t_idx, gq[is_top][:, None] * t_h)
        top_norm.index_add_(0, t_idx, g[is_top].abs() * hn[:, :, None, None].expand_as(g)[is_top])
        # tail: one contribution a (context position, path slot) sum
        tail = (~(pts >= thresh)) & on
        gt = torch.where(tail, gq, 0.0)
        per = torch.einsum("bikc,bid->bikcd", gt, hq)  # to (jc[i, k], slot c)
        nb = per.shape[0]
        acc = torch.zeros(nb, L, Cx, d, device=dev)
        acc.index_add_(1, jc.reshape(-1), per.reshape(nb, L * 2 * W, Cx, d))
        node = torch.full((nb, L, Cx), -1, dtype=torch.long, device=dev)
        node_src = torch.where(tail, pts, -1).reshape(nb, L * 2 * W, Cx)
        node.scatter_reduce_(1, jc.reshape(1, -1, 1).expand(nb, -1, Cx), node_src, "amax")
        hit = node >= 0
        tail_ids.append(node[hit])
        tail_vals.append(acc[hit])
    return {
        "d_in": d_in, "top_sum": top_sum, "top_norm": top_norm,
        "tail_ids": torch.cat(tail_ids), "tail_vals": torch.cat(tail_vals),
        "loss_sum": loss, "pairs": pairs,
    }


def step(
    E_in: torch.Tensor, E_out: torch.Tensor, tokens, keep, w_eff,
    codes, points, lens, alpha: float, W: int, top_p: int, tau: float,
    q: Quant = identity,
) -> Tuple[float, float]:
    """One step in place on the float32 tables; returns (loss_sum, pairs)."""
    g = step_grads(E_in, E_out, tokens, keep, w_eff, codes, points, lens,
                   alpha, W, top_p, q)
    V, d = E_in.shape
    n_nodes = E_out.shape[0]
    tok = tokens.clamp_min(0).long().reshape(-1)
    din = g["d_in"].reshape(-1, d)
    tid, tval = g["tail_ids"], g["tail_vals"]
    top, top_norm = g["top_sum"], g["top_norm"]
    if tau > 0:
        s_in = torch.zeros(V, device=din.device).index_add_(0, tok, torch.linalg.vector_norm(din, dim=-1))
        din = din * (tau / s_in.clamp_min(tau))[tok, None]
        s_t = torch.zeros(n_nodes, device=din.device).index_add_(0, tid, torch.linalg.vector_norm(tval, dim=-1))
        tval = tval * (tau / s_t.clamp_min(tau))[tid, None]
        top = top * (tau / top_norm.clamp_min(tau))[:, None]
    E_in.index_add_(0, tok, din)
    E_out.index_add_(0, tid, tval)
    E_out[n_nodes - top.shape[0]:] += top
    return float(g["loss_sum"]), float(g["pairs"])
