"""Window-blocked (chunked) band matmul primitives, in torch.

Port of word2vec_tpu/ops/banded.py. Rows of length L are split into C
chunks of S positions; chunk c's contexts all lie in the S + 2W wide slab
[c*S - W, c*S + S + W), so a row at local offset s sees slab slot k at
distance |s + W - k|. At the flagship (L=192, W=5) resolve_chunk gives
S=118, C=2 and a 128-wide slab, with C*S = 236 > L. S == 0 selects the
dense representation (one [L, L] plane per row) for short rows.

"Scores" means the band-plane representation: dense [B, L, L] when
S == 0, chunked [B, C, S, S+2W] otherwise. Every contraction rounds both
operands to the compute dtype `cdt` and multiplies and accumulates in
float32 (`cdot`), which is what the JAX package's
einsum(..., preferred_element_type=float32) on cdt operands computes; the
sum order differs, so results agree to rounding. TF32 must be off on the
card (torch.backends.cuda.matmul.allow_tf32 = False, the default).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resolve_chunk(L: int, W: int, requested: int = 0) -> int:
    """Chunk size S for row length L, window W. 0 = dense.

    Auto rule: stay dense while the whole row fits one 128-wide slab;
    otherwise size the slab S + 2W to 128. An explicit `requested` must keep
    the slab-overlap decomposition valid (S >= 2W).
    """
    if requested:
        if requested < 2 * W:
            raise ValueError(
                f"band_chunk={requested} < 2*window={2 * W}: slab overlap-add "
                "requires S >= 2W"
            )
        return 0 if requested >= L else requested
    if L + 2 * W <= 128:
        return 0
    S = 128 - 2 * W
    if S < 2 * W:  # very wide windows: keep the slab two windows wide
        S = 2 * W
    return 0 if S >= L else S


def _geom(L: int, W: int, S: int):
    C = -(-L // S)  # ceil
    P = C * S + 2 * W  # padded position-axis length
    return C, P


def _pad_rows(x: torch.Tensor, L_pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (rows) from L to L_pad."""
    pad = [0, 0] * (x.dim() - 2) + [0, L_pad - x.shape[1]]
    return F.pad(x, pad)


def _pad_ctx(x: torch.Tensor, W: int, P: int) -> torch.Tensor:
    """Pad axis 1 (contexts) with W on the left, to total length P."""
    pad = [0, 0] * (x.dim() - 2) + [W, P - x.shape[1] - W]
    return F.pad(x, pad)


def cdot(eq: str, x: torch.Tensor, y: torch.Tensor, cdt) -> torch.Tensor:
    """einsum(eq, x, y) on operands rounded to `cdt`, products and sums in
    float32 (never a cdt-output matmul)."""
    f32 = torch.float32
    return torch.einsum(eq, x.to(cdt).to(f32), y.to(cdt).to(f32))


def band_dist(L: int, W: int, S: int) -> np.ndarray:
    """|i - j| over the scores representation, as a static int32 array:
    dense [L, L] or chunked [S, S+2W] (identical for every chunk)."""
    if S == 0:
        i = np.arange(L, dtype=np.int32)
        return np.abs(i[:, None] - i[None, :])
    s = np.arange(S, dtype=np.int32)
    k = np.arange(S + 2 * W, dtype=np.int32)
    return np.abs(s[:, None] + W - k[None, :])


def _slabs(x_pad: torch.Tensor, C: int, S: int, F_: int) -> torch.Tensor:
    """[B, P, ...] -> [B, C, S+F, ...]: chunk c = x_pad[:, c*S : c*S+S+F]."""
    need = S + C * S
    if x_pad.shape[1] < need:
        pad = [0, 0] * (x_pad.dim() - 2) + [0, need - x_pad.shape[1]]
        x_pad = F.pad(x_pad, pad)
    rest = x_pad.shape[2:]
    body = x_pad[:, : C * S].reshape(x_pad.shape[0], C, S, *rest)
    tail = x_pad[:, S : S + C * S].reshape(x_pad.shape[0], C, S, *rest)[
        :, :, :F_
    ]
    return torch.cat([body, tail], dim=2)


def slab_token_ids(tok: torch.Tensor, W: int, S: int) -> torch.Tensor:
    """[B, L] token ids -> [B, C, S+2W] id per slab slot; -1 where the slot
    falls outside the row. A position aliased by two adjacent chunks' slabs
    gets the same id in both slots."""
    L = tok.shape[1]
    C, P = _geom(L, W, S)
    tok_pad = F.pad(tok, (W, P - L - W), value=-1)
    return _slabs(tok_pad, C, S, 2 * W)


def band_mask(
    keep: torch.Tensor,
    valid: torch.Tensor,
    w_eff: torch.Tensor,
    W: int,
    S: int,
) -> torch.Tensor:
    """The training-pair mask in scores representation (bool): keep_i &
    valid_j & 0 < |i-j| <= w_eff_i (Word2Vec.cpp:282,285-287,332,335-337);
    keep/valid/w_eff are [B, L]."""
    L = keep.shape[1]
    dist = torch.as_tensor(band_dist(L, W, S), device=keep.device)
    if S == 0:
        return (
            keep[:, :, None]
            & valid[:, None, :]
            & (dist[None] <= w_eff[:, :, None])
            & (dist[None] > 0)
        )
    C, P = _geom(L, W, S)
    keep_c = F.pad(keep, (0, C * S - L)).reshape(-1, C, S)
    w_c = F.pad(w_eff, (0, C * S - L)).reshape(-1, C, S)
    valid_k = _slabs(F.pad(valid, (W, P - L - W)), C, S, 2 * W)
    return (
        keep_c[:, :, :, None]
        & valid_k[:, :, None, :]
        & (dist[None, None] <= w_c[:, :, :, None])
        & (dist[None, None] > 0)
    )


def _overlap_add(y: torch.Tensor, S: int, F_: int) -> torch.Tensor:
    """[B, C, S+F, ...] -> [B, C*S+F, ...]: transpose of _slabs - slab slots
    that alias the same padded position sum (<= 2 operands each)."""
    B, C = y.shape[0], y.shape[1]
    rest = y.shape[3:]
    nr = [0, 0] * len(rest)
    body = y[:, :, :S].reshape(B, C * S, *rest)
    tail = F.pad(y[:, :, S:], nr + [0, S - F_]).reshape(B, C * S, *rest)
    return F.pad(body, nr + [0, F_]) + F.pad(tail, nr + [S, 0])[:, : C * S + F_]


def band_qk(a: torch.Tensor, b: torch.Tensor, W: int, S: int, cdt) -> torch.Tensor:
    """scores[i, j] = a_i . b_j over the band: [B,L,d] x [B,L,d] -> scores."""
    if S == 0:
        return cdot("bid,bjd->bij", a, b, cdt)
    L = a.shape[1]
    C, P = _geom(L, W, S)
    a_c = _pad_rows(a, C * S).reshape(a.shape[0], C, S, a.shape[2])
    b_k = _slabs(_pad_ctx(b, W, P), C, S, 2 * W)  # [B, C, S+2W, d]
    return cdot("bcsd,bckd->bcsk", a_c, b_k, cdt)


def band_sv(scores: torch.Tensor, v: torch.Tensor, W: int, S: int, cdt) -> torch.Tensor:
    """out_i = sum_j scores[i, j] * v_j : scores x [B,L,n] -> [B,L,n]."""
    if S == 0:
        return cdot("bij,bjn->bin", scores, v, cdt)
    L = v.shape[1]
    C, P = _geom(L, W, S)
    v_k = _slabs(_pad_ctx(v, W, P), C, S, 2 * W)
    out = cdot("bcsk,bckn->bcsn", scores, v_k, cdt)
    return out.reshape(out.shape[0], C * S, out.shape[3])[:, :L]


def band_vs_slab(scores: torch.Tensor, u: torch.Tensor, W: int, S: int, cdt) -> torch.Tensor:
    """band_vs WITHOUT the overlap-add: slab-space [B, C, S+2W, d] (chunked
    representation only)."""
    if S == 0:
        raise ValueError("band_vs_slab requires the chunked representation")
    L = u.shape[1]
    C, _ = _geom(L, W, S)
    u_c = _pad_rows(u, C * S).reshape(u.shape[0], C, S, u.shape[2])
    return cdot("bcsk,bcsd->bckd", scores, u_c, cdt)


def band_vs(scores: torch.Tensor, u: torch.Tensor, W: int, S: int, cdt) -> torch.Tensor:
    """out_j = sum_i scores[i, j] * u_i : the transposed contraction
    (center-side values fan out to context positions), [B,L,d] -> [B,L,d]."""
    if S == 0:
        return cdot("bij,bid->bjd", scores, u, cdt)
    L = u.shape[1]
    y = band_vs_slab(scores, u, W, S, cdt)
    return _overlap_add(y, S, 2 * W)[:, W : W + L]


def band_col_sum_slab(scores: torch.Tensor) -> torch.Tensor:
    """Per-slab-slot column sum [B, C, S+2W]."""
    return scores.sum(dim=2)


def band_row_sum(scores: torch.Tensor, L: int) -> torch.Tensor:
    """sum_j scores[i, j] -> [B, L] (e.g. contexts per center)."""
    if scores.dim() == 3:
        return scores.sum(dim=2)
    out = scores.sum(dim=3)  # [B, C, S]
    return out.reshape(out.shape[0], -1)[:, :L]


def band_col_sum(scores: torch.Tensor, L: int, W: int, S: int) -> torch.Tensor:
    """sum_i scores[i, j] -> [B, L] (e.g. centers per context position)."""
    if scores.dim() == 3:
        return scores.sum(dim=1)
    y = scores.sum(dim=2)  # [B, C, S+2W]
    return _overlap_add(y[..., None], S, 2 * W)[:, W : W + L, 0]


def band_loss_sum(masked_vals: torch.Tensor) -> torch.Tensor:
    """Global sum over the band plane (each pair appears exactly once)."""
    return torch.sum(masked_vals)
