"""The two kernels of the fused band step: wrappers, plain versions, counts.

Port of word2vec_tpu/ops/pallas_step.py. The TPU kernels become the
hand-written CUDA kernels of csrc/fused_step.cu (its header note says what
bounds them on the H100 and how the design answers it):

  * `fused_grad_core` — per batch row: gather the center rows (both
    planes), the context slab rows and the KP negative rows from the
    [V, 2, d] slab; band mask; positive and negative logits, sigmoid and
    every gradient; the context-gradient overlap-add into token order;
    d_neg and w_neg_sum over the row's L positions; the losses.
  * `fused_slab_scatter` — the sorted in-place scatter into the slab:
    duplicates add one by one in sorted order, rounding to the table dtype
    after each add; ids of -1 are skipped. With `plane=` it updates one
    [d] plane (the negative-row tail scatter). Its work is handed out per
    run of equal ids, from the run list of ops/runs.py.
    `gathered_slab_scatter` is the same kernel fed the f32 gradient rows
    where their producer wrote them, through the sort order, each scaled
    by its id's row-clip factor and cast at the add (the update tail of
    ops/band_step).
  * `row_sq_norms` — the f32 squared norm of each live gradient row, read
    once where it lies (the row clip's norms, ops/train_step.row_clip_scale).

Each wrapper takes the plain PyTorch version (below, same module) for
tensors on the CPU and launches its kernel for tensors on a CUDA device,
or raises; there is no fallback (ops/launch.py: the rule and LAUNCHES,
the per-wrapper launch counts shared by every kernel of the port).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from .banded import _overlap_add, band_dist
from .launch import (
    check, check_smem, core_smem_bytes, core_workspaces, count, on_cuda,
    phase_record, scalar_arg, stream,
)
from .runs import check_runs, find_runs, ordered_add_plain

GradOutputs = Tuple[torch.Tensor, ...]


# --------------------------------------------------------------- grad core
def fused_grad_core_plain(
    emb: torch.Tensor,
    tok_c: torch.Tensor,
    tok_k: torch.Tensor,
    keep_c: torch.Tensor,
    w_c: torch.Tensor,
    negs: torch.Tensor,
    alpha,
    *,
    W: int,
    K: int,
    L: int,
    cdt: torch.dtype = torch.bfloat16,
    is_cbow: bool = False,
    cbow_mean: bool = True,
) -> GradOutputs:
    """The grad core in plain torch ops, over all (row, chunk) at once.

    Same arithmetic as the kernel: every contraction rounds both operands
    to `cdt` and accumulates in f32 (a float32 matmul; TF32 must be off on
    the card). Returns the kernel's outputs (see fused_grad_core).
    """
    B, C, S = tok_c.shape
    SK = tok_k.shape[2]
    KP = negs.shape[1]
    f32 = torch.float32

    def r(x):  # operand rounding of the Pallas `dot`
        return x.to(cdt).to(f32)

    def dot(x, y):  # [..., m, n] @ [..., n, p] with cdt operands
        return torch.matmul(r(x), r(y))

    ctr_plane = 1 if is_cbow else 0
    ctx_plane = 0 if is_cbow else 1
    tok_c_l = tok_c.long()
    a = emb[tok_c_l, ctr_plane].to(f32)                       # [B, C, S, d]
    valid_k = tok_k >= 0
    bk = emb[tok_k.clamp_min(0).long(), ctx_plane].to(f32)    # [B, C, SK, d]
    bk_rows = torch.where(valid_k[..., None], bk, torch.zeros((), dtype=f32))
    en = emb[negs.long(), 1].to(f32)                          # [B, KP, d]

    dist = torch.as_tensor(band_dist(L, W, S), device=emb.device).to(f32)
    mask = (
        keep_c.to(f32)[..., None]
        * valid_k.to(f32)[:, :, None, :]
        * (dist <= w_c.to(f32)[..., None]).to(f32)
        * (dist > 0.0).to(f32)
    )                                                         # [B, C, S, SK]
    n_ctx = mask.sum(-1)                                      # [B, C, S]
    cwy = mask.sum(-2)                                        # [B, C, SK]

    if not is_cbow:
        h = a
        k_i = n_ctx * float(K)
    else:
        h = dot(mask, bk_rows)
        if cbow_mean:
            h = h / torch.clamp_min(n_ctx, 1.0)[..., None]
        k_i = torch.where(n_ctx > 0.0, float(K), 0.0)

    negs_b = negs[:, None, None, :]                           # [B, 1, 1, KP]
    center_hit = (tok_c[..., None] == negs_b).to(f32)         # [B, C, S, KP]
    hit_k = (tok_k[..., None] == negs_b).to(f32)              # [B, C, SK, KP]
    ctx_hit = dot(mask, hit_k)
    neg_ok = 1.0 - torch.clamp(center_hit + ctx_hit, 0.0, 1.0)
    w_neg = (k_i / float(KP))[..., None] * neg_ok             # [B, C, S, KP]
    en_t = en[:, None]                                        # [B, 1, KP, d]
    nlog = dot(h, en_t.transpose(-1, -2))                     # [B, C, S, KP]
    gn = (0.0 - torch.sigmoid(nlog)) * w_neg * alpha
    d_hid = dot(gn, en_t)                                     # [B, C, S, d]
    neg_loss = -torch.sum(w_neg * (torch.nn.functional.logsigmoid(nlog) - nlog))

    if not is_cbow:
        plog = dot(a, bk_rows.transpose(-1, -2))              # [B, C, S, SK]
        gp = (1.0 - torch.sigmoid(plog)) * mask * alpha
        d_ctr = d_hid + dot(gp, bk_rows)
        y = dot(gp.transpose(-1, -2), a)                      # [B, C, SK, d]
        pos_loss = -torch.sum(mask * torch.nn.functional.logsigmoid(plog))
    else:
        plog_c = torch.sum(r(h) * r(a), dim=-1)               # [B, C, S]
        active = (n_ctx > 0.0).to(f32)
        gp = (1.0 - torch.sigmoid(plog_c)) * active * alpha
        d_ctr = gp[..., None] * h
        d_hid2 = d_hid + gp[..., None] * a
        if cbow_mean:
            d_hid2 = d_hid2 / torch.clamp_min(n_ctx, 1.0)[..., None]
        y = dot(mask.transpose(-1, -2), d_hid2)
        pos_loss = -torch.sum(active * torch.nn.functional.logsigmoid(plog_c))

    # token order: each position sums its <= 2 slab slots
    d = emb.shape[-1]
    d_ctx = _overlap_add(y, S, 2 * W)[:, W : W + C * S].reshape(B, C, S, d)
    ctx_w = _overlap_add(cwy[..., None], S, 2 * W)[:, W : W + C * S, 0]
    # per-row reductions over exactly the row's first L positions
    gn_full = gn.reshape(B, C * S, KP)[:, :L]
    h_full = h.reshape(B, C * S, d)[:, :L]
    d_neg = dot(gn_full.transpose(-1, -2), h_full)            # [B, KP, d]
    w_neg_sum = w_neg.reshape(B, C * S, KP)[:, :L].sum(1)     # [B, KP]
    losses = torch.stack([pos_loss, neg_loss]).reshape(1, 2)
    return (
        d_ctr.contiguous(), d_ctx.contiguous(), n_ctx,
        ctx_w.reshape(B, C, S), d_neg, w_neg_sum, losses,
    )


def fused_grad_core(
    emb: torch.Tensor,    # [V, 2, d] slab, float32 or bfloat16
    tok_c: torch.Tensor,  # [B, C, S] int32, clamped to [0, V)
    tok_k: torch.Tensor,  # [B, C, SK] int32, -1 outside the row
    keep_c: torch.Tensor,  # [B, C, S] float32
    w_c: torch.Tensor,    # [B, C, S] float32
    negs: torch.Tensor,   # [B, KP] int32
    alpha,                # float, or a 0-d float32 tensor on the device
    *,
    W: int,
    K: int,
    L: int,
    cdt: torch.dtype = torch.bfloat16,
    is_cbow: bool = False,
    cbow_mean: bool = True,
    phase_cycles: Optional[torch.Tensor] = None,
) -> GradOutputs:
    """One fused gather -> dot -> grad -> overlap-add pass.

    Returns (d_ctr, d_ctx, n_ctx, ctx_w, d_neg, w_neg_sum, losses), all
    float32:
      d_ctr  [B, C, S, d]  center-side gradient, token order
      d_ctx  [B, C, S, d]  context-side gradient, token order (overlap-added)
      n_ctx  [B, C, S]     active contexts per center
      ctx_w  [B, C, S]     per-token context contribution counts
      d_neg  [B, KP, d]    negative-row gradient (reduced over the row's L)
      w_neg_sum [B, KP]    per-draw expectation weight, summed over the row
      losses [1, 2]        (pos_loss, neg_loss)
    Rows past L are the caller's to slice off. `phase_cycles`, an int64
    [B, len(launch.CORE_PHASES)] tensor on the card, receives the kernel's
    per-phase cycle counts for each row (a measurement; CUDA only).
    """
    kw = dict(W=W, K=K, L=L, cdt=cdt, is_cbow=is_cbow, cbow_mean=cbow_mean)
    if not on_cuda("fused_grad_core", emb, tok_c, tok_k, keep_c, w_c, negs):
        if phase_cycles is not None:
            raise ValueError("fused_grad_core: phase_cycles needs the CUDA kernel")
        return fused_grad_core_plain(
            emb, tok_c, tok_k, keep_c, w_c, negs, alpha, **kw
        )
    B, C, S = tok_c.shape
    SK = tok_k.shape[2]
    KP = negs.shape[1]
    V, planes, d = emb.shape
    if planes != 2 or emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"fused_grad_core: emb must be a [V, 2, d] float32/bfloat16 "
            f"slab, got {tuple(emb.shape)} {emb.dtype}"
        )
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_grad_core: compute dtype {cdt} unsupported")
    if SK != S + 2 * W or S < 2 * W or not (C - 1) * S < L <= C * S:
        raise ValueError(
            f"fused_grad_core: geometry S={S} SK={SK} C={C} W={W} L={L} "
            "is not a chunked band (SK = S + 2W, S >= 2W, C = ceil(L/S))"
        )
    check("emb", emb, (V, 2, d), emb.dtype)
    check("tok_c", tok_c, (B, C, S), torch.int32)
    check("tok_k", tok_k, (B, C, SK), torch.int32)
    check("keep_c", keep_c, (B, C, S), torch.float32)
    check("w_c", w_c, (B, C, S), torch.float32)
    check("negs", negs, (B, KP), torch.int32)

    dev = emb.device
    check_smem(
        "fused_grad_core",
        core_smem_bytes(
            "fused_grad_core", S, SK, KP, d, W, cdt == torch.bfloat16
        ),
        dev,
    )
    rec = phase_record("fused_grad_core", phase_cycles, B, dev)
    alpha_t = scalar_arg("fused_grad_core alpha", alpha, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    d_ctr = torch.empty((B, C, S, d), **f32)
    d_ctx = torch.empty((B, C, S, d), **f32)
    n_ctx = torch.empty((B, C, S), **f32)
    ctx_w = torch.empty((B, C, S), **f32)
    d_neg = torch.empty((B, KP, d), **f32)
    w_neg_sum = torch.empty((B, KP), **f32)
    loss_part = torch.empty((B, 2), **f32)
    losses = torch.empty((1, 2), **f32)
    # cbow workspaces: the f32 projection, and d_hid (the f32-compute
    # body's d_hid2; the tensor-core body's running sum over negative
    # pieces, which keeps d_hid2 itself in shared memory)
    ws_shape = (B, S, d) if is_cbow else (0,)
    h_ws = torch.empty(ws_shape, **f32)
    dh_ws = torch.empty(ws_shape, **f32)
    # what a chunk past one center piece hands from piece to piece
    dneg_ws, ctx_ws = core_workspaces(
        "fused_grad_core", B, S, KP, d, W, cdt == torch.bfloat16, dev)

    lib = _build.library("fused_step")
    with torch.cuda.device(dev):
        err = lib.w2v_fused_grad_core(
            emb.data_ptr(), int(emb.dtype == torch.bfloat16),
            tok_c.data_ptr(), tok_k.data_ptr(), keep_c.data_ptr(),
            w_c.data_ptr(), negs.data_ptr(), alpha_t.data_ptr(),
            d_ctr.data_ptr(), d_ctx.data_ptr(), n_ctx.data_ptr(),
            ctx_w.data_ptr(), d_neg.data_ptr(), w_neg_sum.data_ptr(),
            loss_part.data_ptr(), losses.data_ptr(),
            h_ws.data_ptr(), dh_ws.data_ptr(), dneg_ws.data_ptr(),
            ctx_ws.data_ptr(), B, C, S, SK, KP, d, W, K, L,
            int(cdt == torch.bfloat16), int(is_cbow), int(cbow_mean), rec,
            stream(dev),
        )
    if err != 0:
        smem = lib.w2v_grad_core_smem_bytes(S, SK, KP, d, W, int(cdt == torch.bfloat16))
        _build.check(lib, err, f"fused_grad_core launch ({smem} B shared memory)")
    count("fused_grad_core")
    return d_ctr, d_ctx, n_ctx, ctx_w, d_neg, w_neg_sum, losses


# ------------------------------------------------------------ slab scatter
def _scatter_view(emb, vals, plane):
    """(table rows [V, row_len], update rows [N, width], column offset)."""
    V = emb.shape[0]
    rows = emb.view(V, -1)
    N = vals.shape[0]
    if plane is None:
        if tuple(vals.shape[1:]) != tuple(emb.shape[1:]):
            raise ValueError(
                f"fused_slab_scatter: vals {tuple(vals.shape)} do not match "
                f"whole slab rows {tuple(emb.shape[1:])}"
            )
        return rows, vals.reshape(N, -1), 0
    d = emb.shape[-1]
    if emb.dim() != 3 or tuple(vals.shape[1:]) != (d,):
        raise ValueError(
            f"fused_slab_scatter: plane={plane} needs vals [N, {d}], "
            f"got {tuple(vals.shape)}"
        )
    if not 0 <= plane < emb.shape[1]:
        raise ValueError(f"fused_slab_scatter: no plane {plane}")
    return rows, vals, plane * d


def scatter_vector(emb, vals, row_len: int, col0: int) -> int:
    """Values per vector load of the scatter kernel: 4, 2 or 1, the most
    that divides the row width, the column offset and the row length, with
    both base pointers aligned to the vector (16 bytes for f32 x4, 8 for
    bf16 x4)."""
    es = emb.element_size()
    width = vals.shape[1]
    for nv in (4, 2):
        if (width % nv == 0 and col0 % nv == 0 and row_len % nv == 0
                and emb.data_ptr() % (nv * es) == 0
                and vals.data_ptr() % (nv * es) == 0):
            return nv
    return 1


def fused_slab_scatter_plain(
    emb: torch.Tensor,
    sorted_idx: torch.Tensor,
    vals: torch.Tensor,
    plane: Optional[int] = None,
) -> torch.Tensor:
    """The sorted scatter in plain torch ops, in place: each row receives
    its updates in sorted order, rounded to the table dtype after every
    add, exactly as the kernel applies them (runs.ordered_add_plain)."""
    rows, v, col0 = _scatter_view(emb, vals, plane)
    keep = sorted_idx >= 0
    idx = sorted_idx[keep].long()
    if bool((idx[1:] < idx[:-1]).any()):
        raise ValueError("fused_slab_scatter: ids must be sorted ascending")
    ordered_add_plain(rows[:, col0:col0 + v.shape[1]], idx, v[keep])
    return emb


def fused_slab_scatter(
    emb: torch.Tensor,         # [V, 2, d] slab, updated in place
    sorted_idx: torch.Tensor,  # [N] int32, ascending; -1 = skip
    vals: torch.Tensor,        # [N, 2, d] (plane=None) or [N, d], emb dtype
    plane: Optional[int] = None,
    runs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """emb.at[sorted_idx].add(vals) (or .at[sorted_idx, plane].add(vals))
    in place, duplicates in sorted order with table-dtype rounding after
    each add. `runs` is the run list of sorted_idx (ops/runs.find_runs),
    built here when None; the CPU path does not need it. Returns emb."""
    if not on_cuda("fused_slab_scatter", emb, sorted_idx, vals):
        return fused_slab_scatter_plain(emb, sorted_idx, vals, plane)
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_slab_scatter: table dtype {emb.dtype}")
    if not emb.is_contiguous():
        raise ValueError("fused_slab_scatter: emb must be contiguous")
    rows, v, col0 = _scatter_view(emb, vals, plane)
    N = sorted_idx.shape[0]
    check("sorted_idx", sorted_idx, (N,), torch.int32)
    check("vals", v, (N, v.shape[1]), emb.dtype)
    if runs is None:
        runs = find_runs(sorted_idx)
    check_runs(runs, N, sorted_idx.device)
    vec = scatter_vector(emb, v, rows.shape[1], col0)
    lib = _build.library("fused_step")
    dev = emb.device
    with torch.cuda.device(dev):
        err = lib.w2v_slab_scatter(
            emb.data_ptr(), int(emb.dtype == torch.bfloat16),
            sorted_idx.data_ptr(), v.data_ptr(), runs.data_ptr(), N,
            rows.shape[1], col0, v.shape[1], vec, stream(dev),
        )
    _build.check(lib, err, "fused_slab_scatter launch")
    count("fused_slab_scatter")
    return emb


def gathered_values(
    dtype: torch.dtype,
    sorted_idx: torch.Tensor,
    srcs: Tuple[torch.Tensor, ...],
    rows: torch.Tensor,
    scales: Tuple[Optional[torch.Tensor], ...],
) -> torch.Tensor:
    """The values gathered_slab_scatter adds, made in plain torch ops: each
    plane's terms gathered into sorted order, multiplied by their ids'
    scales, cast to the table dtype, the planes stacked ([N, d] for one
    source, [N, P, d] for P)."""
    rl, il = rows.long(), sorted_idx.long().clamp_min(0)
    parts = []
    for src, sc in zip(srcs, scales):
        v = src[rl]
        if sc is not None:
            v = v * sc[il][:, None]
        parts.append(v.to(dtype))
    return parts[0] if len(parts) == 1 else torch.stack(parts, dim=1)


def gathered_slab_scatter_plain(
    emb: torch.Tensor,
    sorted_idx: torch.Tensor,
    srcs: Tuple[torch.Tensor, ...],
    rows: torch.Tensor,
    scales: Tuple[Optional[torch.Tensor], ...],
    plane: Optional[int] = None,
) -> torch.Tensor:
    """The gathered scatter in plain torch ops: its values made
    (gathered_values), then the sorted scatter."""
    vals = gathered_values(emb.dtype, sorted_idx, srcs, rows, scales)
    return fused_slab_scatter_plain(emb, sorted_idx, vals, plane)


def gathered_slab_scatter(
    emb: torch.Tensor,                     # [V, P, d] slab or [V, d] table
    sorted_idx: torch.Tensor,              # [N] int32, ascending; -1 = skip
    srcs: Tuple[torch.Tensor, ...],        # f32 [M, d] sources, one a plane
    rows: torch.Tensor,                    # [N] int32: term q is row rows[q]
    scales: Optional[Tuple[Optional[torch.Tensor], ...]] = None,  # f32 [V]
    plane: Optional[int] = None,
    runs: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """fused_slab_scatter of the values cast(src[rows] * scale[sorted_idx])
    without making them: plane p of term q is row rows[q] of srcs[p], times
    scales[p][sorted_idx[q]] (none where that scale is None), rounded to the
    table dtype, then added in sorted order with the table-dtype rounding
    after each add. One source for a [V, d] table or with plane=, one a
    plane for a whole slab row (both planes in one launch). Bitwise the
    gather -> multiply -> cast -> stack -> fused_slab_scatter sequence of
    plain versions. Returns emb."""
    scales = (None,) * len(srcs) if scales is None else tuple(scales)
    planes = 1 if plane is not None or emb.dim() == 2 else emb.shape[1]
    if len(srcs) != planes or len(scales) != planes or planes > 2:
        raise ValueError(
            f"gathered_slab_scatter: {len(srcs)} sources and {len(scales)} "
            f"scales for {planes} plane(s) (at most 2)"
        )
    tensors = [emb, sorted_idx, rows, *srcs, *(x for x in scales if x is not None)]
    if not on_cuda("gathered_slab_scatter", *tensors):
        return gathered_slab_scatter_plain(emb, sorted_idx, srcs, rows, scales, plane)
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gathered_slab_scatter: table dtype {emb.dtype}")
    if not emb.is_contiguous():
        raise ValueError("gathered_slab_scatter: emb must be contiguous")
    V, d = emb.shape[0], emb.shape[-1]
    N = sorted_idx.shape[0]
    check("sorted_idx", sorted_idx, (N,), torch.int32)
    check("rows", rows, (N,), torch.int32)
    for i, src in enumerate(srcs):
        check(f"srcs[{i}]", src, (src.shape[0], d), torch.float32)
    for i, sc in enumerate(scales):
        if sc is not None:
            check(f"scales[{i}]", sc, (V,), torch.float32)
    row_len = emb[0].numel()
    col0, width = (0, row_len) if plane is None else (plane * d, d)
    if plane is not None and not (emb.dim() == 3 and 0 <= plane < emb.shape[1]):
        raise ValueError(f"gathered_slab_scatter: no plane {plane}")
    if runs is None:
        runs = find_runs(sorted_idx)
    check_runs(runs, N, sorted_idx.device)
    es = emb.element_size()
    vec = 1
    for nv in (4, 2):
        if (d % nv == 0 and col0 % nv == 0 and row_len % nv == 0
                and emb.data_ptr() % (nv * es) == 0
                and all(src.data_ptr() % (nv * 4) == 0 for src in srcs)):
            vec = nv
            break
    ptr = [t.data_ptr() if t is not None else None for t in (*srcs, None)][:2]
    sc = [t.data_ptr() if t is not None else None for t in (*scales, None)][:2]
    lib = _build.library("fused_step")
    dev = emb.device
    with torch.cuda.device(dev):
        err = lib.w2v_slab_scatter_gathered(
            emb.data_ptr(), int(emb.dtype == torch.bfloat16),
            sorted_idx.data_ptr(), ptr[0], ptr[1], sc[0], sc[1],
            rows.data_ptr(), d, runs.data_ptr(), N, row_len, col0, width, vec,
            stream(dev),
        )
    _build.check(lib, err, "gathered_slab_scatter launch")
    count("gathered_slab_scatter")
    return emb


# --------------------------------------------------------------- row norms
def row_sq_norms_plain(src: torch.Tensor, live: int) -> torch.Tensor:
    """row_sq_norms in plain torch ops: v * v summed over the last axis."""
    v = src[:, :live].float()
    return torch.sum(v * v, dim=-1).reshape(-1)


def row_sq_norms(src: torch.Tensor, live: int) -> torch.Tensor:
    """The f32 squared norm of each live row of src [G, R, d] float32: the
    first `live` rows of each of its G groups of R rows, in that order
    ([G * live]; a padded kernel output is read in place, its pad rows
    never). Each row is read once; the sum's order is the kernel's own, so
    it agrees with the plain version to float32 rounding, not bitwise."""
    if not on_cuda("row_sq_norms", src):
        return row_sq_norms_plain(src, live)
    G, R, d = src.shape
    if not 0 <= live <= R:
        raise ValueError(f"row_sq_norms: {live} live rows of {R}")
    check("src", src, (G, R, d), torch.float32)
    dev = src.device
    out = torch.empty(G * live, dtype=torch.float32, device=dev)
    vec = 4 if d % 4 == 0 and src.data_ptr() % 16 == 0 else 1
    lib = _build.library("fused_step")
    with torch.cuda.device(dev):
        err = lib.w2v_row_sq_norms(
            src.data_ptr(), out.data_ptr(), G, R, live, d, vec, stream(dev)
        )
    _build.check(lib, err, "row_sq_norms launch")
    count("row_sq_norms")
    return out
