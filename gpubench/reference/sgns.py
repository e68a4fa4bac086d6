"""Skip-gram with negative sampling, one optimizer step, in plain PyTorch.

The semantics the configuration states (Mikolov et al. 2013, arXiv
1310.4546, and the word2vec tool, in the form the program trains):

  * a position i of a row trains as a center when its token is real and
    its subsample uniform is below the word's keep probability; its
    contexts are the real tokens j with 0 < |i - j| <= w_eff[i];
  * each (center, context) pair is a positive with label 1: the logit is
    in[center] . out[context];
  * the negatives are a pool of KP draws a row, shared by the row's
    centers: each center scores every pool entry with the weight
    n_ctx * K / KP (K negatives per pair in expectation), except entries
    equal to its own token or to one of its contexts' tokens;
  * the loss of a step is the sum of the pairs' binary cross-entropies,
    each weighted, over the sum of the weights;
  * the update is SGD at the step's learning rate alpha with every
    gradient taken at the step's starting tables, then, per table row, a
    trust region: the row's summed update is scaled by tau / max(S, tau),
    S the sum of the norms of its contributions (one contribution a
    center position to the input table; one a context position and one a
    pool entry to the output table).

Every contraction is float32 with TF32 off, unless `q` rounds its
operands first (the precision control). Gradients are worked out in blocks
of rows; the tables are float32 copies.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

Quant = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def band(keep, valid, w_eff, W: int):
    """([B, L, 2W] bool pair mask, [L, 2W] context positions)."""
    B, L = keep.shape
    dev = keep.device
    offs = torch.tensor([o for o in range(-W, W + 1) if o != 0], device=dev)
    i = torch.arange(L, device=dev)
    j = i[:, None] + offs[None, :]
    inb = (j >= 0) & (j < L)
    jc = j.clamp(0, L - 1)
    m = (
        keep[:, :, None]
        & valid[:, jc]
        & inb[None]
        & (offs.abs()[None, None, :] <= w_eff[:, :, None])
    )
    return m, jc


def step_grads(
    E_in: torch.Tensor, E_out: torch.Tensor, tokens: torch.Tensor,
    keep: torch.Tensor, w_eff: torch.Tensor, negs: torch.Tensor, alpha: float,
    K: int, W: int, q: Quant = identity, block: int = 32,
) -> Dict[str, torch.Tensor]:
    """The step's per-contribution updates (already times alpha) and its
    loss: d_in [B, L, d], d_out [B, L, d], d_neg [B, KP, d], loss_sum and
    pairs (float64)."""
    B, L = tokens.shape
    KP = negs.shape[1]
    d = E_in.shape[1]
    dev = E_in.device
    valid = tokens >= 0
    tok = tokens.clamp_min(0).long()
    d_in = torch.zeros(B, L, d, device=dev)
    d_out = torch.zeros(B, L, d, device=dev)
    d_neg = torch.zeros(B, KP, d, device=dev)
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    pairs = torch.zeros((), dtype=torch.float64, device=dev)
    m_all, jc = band(keep, valid, w_eff, W)
    for b0 in range(0, B, block):
        sl = slice(b0, b0 + block)
        tk, ng = tok[sl], negs[sl].long()
        m = m_all[sl]
        mf = m.float()
        h = E_in[tk]                      # [b, L, d]
        ec = E_out[tk][:, jc]             # [b, L, 2W, d]
        en = E_out[ng]                    # [b, KP, d]
        hq, ecq, enq = q(h), q(ec), q(en)
        plog = torch.einsum("bid,bikd->bik", hq, ecq)
        gp = (1.0 - torch.sigmoid(plog)) * mf * alpha
        n_ctx = mf.sum(-1)
        center_hit = tk[:, :, None] == ng[:, None, :]
        ctx_hit = ((tk[:, jc][..., None] == ng[:, None, None, :]) & m[..., None]).any(2)
        w_neg = (n_ctx * (K / KP))[..., None] * (~(center_hit | ctx_hit)).float()
        nlog = torch.einsum("bid,bnd->bin", hq, enq)
        gn = -torch.sigmoid(nlog) * w_neg * alpha
        gpq, gnq = q(gp), q(gn)
        d_in[sl] = torch.einsum("bik,bikd->bid", gpq, ecq) + torch.einsum("bin,bnd->bid", gnq, enq)
        contrib = torch.einsum("bik,bid->bikd", gpq, hq)  # to context jc[i, k]
        d_out[sl].index_add_(1, jc.reshape(-1), contrib.reshape(contrib.shape[0], -1, d))
        d_neg[sl] = torch.einsum("bin,bid->bnd", gnq, hq)
        loss += (-(mf * F.logsigmoid(plog)).sum() + (w_neg * F.softplus(nlog)).sum()).double()
        pairs += (mf.sum() + w_neg.sum()).double()
    return {"d_in": d_in, "d_out": d_out, "d_neg": d_neg, "loss_sum": loss, "pairs": pairs}


def clip_scale(rows: int, tau: float, *contribs: Tuple[torch.Tensor, torch.Tensor]):
    """tau / max(S_r, tau) per row, S_r the summed norms of its contributions."""
    s = None
    for idx, vals in contribs:
        n = torch.linalg.vector_norm(vals, dim=-1)
        s = torch.zeros(rows, device=vals.device).index_add_(0, idx, n) if s is None else s.index_add_(0, idx, n)
    return tau / torch.clamp_min(s, tau)


def step(
    E_in: torch.Tensor, E_out: torch.Tensor, tokens, keep, w_eff, negs, alpha: float,
    K: int, W: int, tau: float, q: Quant = identity,
) -> Tuple[float, float]:
    """One step in place on the float32 tables; returns (loss_sum, pairs)."""
    g = step_grads(E_in, E_out, tokens, keep, w_eff, negs, alpha, K, W, q)
    V, d = E_in.shape
    tok = tokens.clamp_min(0).long().reshape(-1)
    neg = negs.long().reshape(-1)
    din, dout, dneg = (g[k].reshape(-1, d) for k in ("d_in", "d_out", "d_neg"))
    if tau > 0:
        s_in = clip_scale(V, tau, (tok, din))
        s_out = clip_scale(V, tau, (tok, dout), (neg, dneg))
        din, dout, dneg = din * s_in[tok, None], dout * s_out[tok, None], dneg * s_out[neg, None]
    E_in.index_add_(0, tok, din)
    E_out.index_add_(0, tok, dout)
    E_out.index_add_(0, neg, dneg)
    return float(g["loss_sum"]), float(g["pairs"])
