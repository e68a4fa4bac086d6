"""The tensor-core tiling of the two band cores, emulated on the CPU.

With bf16 compute, `fused_grad_core` (csrc/fused_step.cu) and `band_core`
(csrc/band_core.cu) stage each chunk's dense operands in shared memory and
run their three dense products on the tensor cores, through the tile code
of csrc/band_tiles.cuh. The kernels cannot run here, so this file emulates
them in torch, chunk by chunk as one CTA walks its batch row:

  * the zero-padded bf16 tiles: the center rows or cbow projection A
    [SP x DP], the negative rows E [KPP x DP] and the negative gradient
    weights G [SP x KPP], SP / KPP / DP rounded up to the mma tile (the
    tile sizes are read from the .cuh);
  * every tile product as the mma.sync loop forms it: f32 sums of exact
    products of bf16-rounded operands, added k-slice (kMmaK) by k-slice;
  * G's columns past the row's first L positions cut from the d_neg
    product of the fused kernel (its d_neg sums exactly L positions);
  * the band side as tile products too: the band matrix of gp (sg) or
    the mask (cbow), built in the registers, against the context rows
    (the band product, added into d_hid's accumulator; the cbow
    projection) or against A (the slab-space context sums), and the sg
    band logits A bk^T; the context rows bk padded like the tiles;
  * cbow's d_ctr from the unrounded f32 projection and its d_hid2 staged
    back into A;
  * the overlap hand-off between chunks of the fused kernel (slots
    [0, W) into the previous chunk's last W rows, slots [S+W, S+2W)
    carried to the next chunk) and band_core's batch-scope row partials
    reduced in row order.

  * the pieces: the tiles hold at most kSc centers, kKPc negative rows
    and kDc columns (read from the .cuh, or cut smaller for a test), the
    chunk, the negative pool and the width walked piece by piece in the
    kernels' order (the logits summed over width pieces in one
    accumulator, d_hid carried over the negative pieces, d_neg's and the
    context sums' accumulators carried from one center piece to the next,
    the overhang of the fused kernel waiting in the next chunk's rows).

Each emulation is held against the plain version (fused_grad_core_plain,
band_core_plain) at chip_smoke.TOL for bf16 compute (gradients 2e-2 of
max|plain|, losses 1e-4, n_ctx / ctx_w exact) over odd shapes: d in
{7, 64, 300}, KP in {8, 64, 100}, W in {1, 5}, S not a multiple of 16,
L not a multiple of S, ragged rows, sg / cbow, row / batch scope; at d 48
and KP 40 in pieces of 16; at chunks of two or three center pieces of 16
or 32 (CENTER_SHAPES); and at one small shape each, in one piece and in
pieces, against the JAX package's Pallas kernel run by the Pallas
interpreter.
"""

import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from word2vec_tpu.ops.pallas_band import band_core as j_band_core  # noqa: E402
from word2vec_tpu.ops.pallas_step import fused_grad_core as j_grad_core  # noqa: E402

from chip_smoke import (  # noqa: E402
    CORE_NAMES, CORE_ORDER, GRAD_NAMES, GRAD_ORDER, ODD_SHAPES, TOL,
    small_core_inputs as core_inputs, small_grad_inputs as grad_inputs,
)
from word2vec_tpu_torch.ops import band_core as bc  # noqa: E402
from word2vec_tpu_torch.ops import fused_step as fs  # noqa: E402
from word2vec_tpu_torch.ops.launch import CORE_PHASES  # noqa: E402

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "word2vec_tpu_torch" / "csrc"
HEADER = (CSRC / "band_tiles.cuh").read_text()


def const(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", HEADER)
    assert m, f"{name} not found in csrc/band_tiles.cuh"
    return int(m.group(1))


MMA_M, MMA_N, MMA_K = const("kMmaM"), const("kMmaN"), const("kMmaK")
# the pieces the tiles hold: centers, negative rows and columns, and the
# slab slots of a center piece's band weights
SC, KPC, DC, KC = const("kSc"), const("kKPc"), const("kDc"), const("kKc")
F32, BF16 = torch.float32, torch.bfloat16


def up(x: int, m: int) -> int:
    return -(-x // m) * m


def bf(x):
    """An operand rounded to bf16, held in f32 (the staged tiles)."""
    return x.to(BF16).to(F32)


def rounding(cdt):
    """The operand rounding of a compute type: bf16 (the tensor-core
    bodies' staged operands), or none (the f32 bodies)."""
    return bf if cdt == BF16 else (lambda x: x)


def mma(a, b, kvalid=None, acc=None):
    """a [M, K] @ b [K, N] as the mma.sync loop forms it: k-slice by
    k-slice, each slice's exact bf16 products summed into the f32
    accumulator (`acc`, zero by default); depth >= kvalid contributes
    nothing. Each [16 x 16] slice of `a` is its own product (the mma
    tile), so a row's sums do not depend on how many rows `a` holds (a
    center piece's or a whole chunk's)."""
    if acc is None:
        acc = torch.zeros((a.shape[0], b.shape[1]), dtype=F32)
    out = []
    for m0 in range(0, a.shape[0], MMA_M):
        blk = acc[m0:m0 + MMA_M]
        for k0 in range(0, a.shape[1], MMA_K):
            sl = a[m0:m0 + MMA_M, k0:k0 + MMA_K].clone()
            if kvalid is not None and k0 + MMA_K > kvalid:
                sl[:, max(0, kvalid - k0):] = 0.0
            blk = blk + sl @ b[k0:k0 + MMA_K]
        out.append(blk)
    return torch.cat(out)


def pieces(n: int, piece: int):
    """(offset, length) of each piece of n cut in pieces of `piece`, the
    last ragged (band_tiles.cuh piece_len)."""
    return [(i, min(piece, n - i)) for i in range(0, n, piece)]


def ew(f, x):
    """f(x) elementwise, every value through torch's vectorized loop (the
    input padded to whole vectors): torch's CPU sigmoid and log-sigmoid
    round a value in the ragged tail of a tensor differently, so without
    the padding a center's result would depend on how many centers its
    piece holds."""
    flat = x.reshape(-1)
    n = flat.numel()
    padded = torch.zeros(up(n, 64) + 64, dtype=flat.dtype)
    padded[:n] = flat
    return f(padded)[:n].reshape(x.shape)


def chunk(ctr, bk, en, tokc, tokk, keep, w, negs, alpha, *, W, K, is_cbow,
          cbow_mean, kvalid, kpc, dc, kc=KC, cdt=BF16, dneg0=None, wsum0=None,
          y0=None):
    """One center piece of one chunk of one row, walked piece by piece of
    the pool, the width and the slab slots as the kernels walk it: ctr [S,
    d] the piece's center rows (cbow: out plane), bk [SK, d] its context
    rows (zero at invalid slots), en [KP, d] the row's negative rows; the
    tiles hold at most kpc negative rows and dc columns, the sg band
    weights kc slots. cdt bf16: the operands rounded to bf16 (the
    tensor-core bodies); f32: kept (the f32 bodies, the same walk). Returns
    the piece's outputs
    before the cross-chunk sums: y and cwy over its S + 2W slots, dneg and
    wsum continuing dneg0 / wsum0 (the chunk's sums over the earlier
    pieces), y continuing y0 (the sums the previous piece carried over its
    first rows).

    The order of the sums that cross pieces (csrc/band_tiles.cuh): the
    negative and band logits sum the width pieces in one accumulator;
    d_hid's accumulator carries over the negative pieces (through device
    memory in the kernels, exact), the last piece continued with the sg
    band product; d_neg and w_neg_sum sum the S positions inside one
    negative and width piece, the chunk's accumulator carried from one
    center piece to the next; so are the context sums of the slots two
    center pieces share; the sg band logits, band product and context sums
    walk the slot pieces (kc slots from slot k0), the band product's
    accumulator carried from one to the next (through device memory in the
    kernels, exact), each slot's context sum whole inside its slot piece."""
    bf = rounding(cdt)
    S, d = ctr.shape
    SK = bk.shape[0]
    KP = negs.numel()
    SP = up(S, MMA_M)
    dps, kps, kcs = pieces(d, dc), pieces(KP, kpc), pieces(SK, kc)
    s = torch.arange(S)[:, None]
    k = torch.arange(SK)[None, :]
    dist = (s + W - k).abs()
    on = (tokk[None, :] >= 0) & (dist.float() <= w[:, None]) & (dist > 0)
    mask = torch.where(on, keep[:, None], torch.zeros(()))        # [S, SK]
    nctx, cwy = mask.sum(1), mask.sum(0)
    hit = (tokk[:, None] == negs[None, :]).float()                # [SK, KP]
    ctx_hit = bf(mask) @ hit
    center_hit = (tokc[:, None] == negs[None, :]).float()
    k_i = torch.where(nctx > 0, float(K), 0.0) if is_cbow else nctx * K
    wn = (k_i / KP)[:, None] * (1.0 - torch.clamp(center_hit + ctx_hit, 0.0, 1.0))

    # the band side: the band matrix of slot weights [SP x SKP] and the
    # context rows, a width piece at a time [SKP x DPq], zero-padded like
    # the staged tiles
    SKP = up(SK, MMA_K)

    def band(w):
        t = torch.zeros((SP, SKP))
        t[:S, :SK] = bf(w)
        return t

    def tile(x, rows, q):
        """Width piece q of x [n, d] as a zero-padded bf16 tile [rows x DPq]."""
        o, n = dps[q]
        t = torch.zeros((rows, up(n, MMA_K)))
        t[:x.shape[0], :n] = bf(x[:, o:o + n])
        return t

    def e_tile(p, q):
        j0, m = kps[p]
        return tile(en[j0:j0 + m], up(m, 2 * MMA_N), q)

    if is_cbow:
        h = torch.cat([mma(band(mask), tile(bk, SKP, q))[:S, :n]
                       for q, (_, n) in enumerate(dps)], dim=1)
        if cbow_mean:
            h = h / torch.clamp_min(nctx, 1.0)[:, None]
        src = h
    else:
        src = ctr

    def cols(k0, n):
        """The columns (or rows) of a slot piece, padded to whole k-slices."""
        return slice(k0, k0 + up(n, MMA_K))

    # positive logits: the sg band over the width pieces, slot piece by
    # slot piece, or the cbow center
    if not is_cbow:
        gp = torch.zeros((S, SK))
        pos = torch.zeros(())
        for k0, n in kcs:
            acc = torch.zeros((SP, up(n, MMA_K)))
            for q in range(len(dps)):
                acc = mma(tile(src, SP, q), tile(bk, SKP, q)[cols(k0, n)].T, acc=acc)
            plog, m = acc[:S, :n], mask[:, k0:k0 + n]
            gp[:, k0:k0 + n] = torch.where(
                m != 0, (1.0 - ew(torch.sigmoid, plog)) * m * alpha, torch.zeros(()))
            pos = pos + torch.sum(torch.where(m != 0, m * ew(F.logsigmoid, plog),
                                              torch.zeros(())))
    else:
        plog_c = torch.sum(bf(h) * bf(ctr), dim=1)
        active = (nctx > 0).float()
        gpc = (1.0 - ew(torch.sigmoid, plog_c)) * active * alpha
        pos = torch.sum(active * ew(F.logsigmoid, plog_c))

    # the negative pool, piece by piece
    dneg = torch.zeros((KP, d)) if dneg0 is None else dneg0.clone()
    wsum = torch.zeros(KP) if wsum0 is None else wsum0.clone()
    neg = torch.zeros(())
    part = [None] * len(dps)  # d_hid's accumulator per width piece
    for p, (j0, m) in enumerate(kps):
        acc = torch.zeros((SP, up(m, 2 * MMA_N)))
        for q in range(len(dps)):
            acc = mma(tile(src, SP, q), e_tile(p, q).T, acc=acc)
        nlog = acc[:S, :m]
        wn_p = wn[:, j0:j0 + m]
        gn = (0.0 - ew(torch.sigmoid, nlog)) * wn_p * alpha
        neg = neg + torch.sum(wn_p * (ew(F.logsigmoid, nlog) - nlog))
        G = torch.zeros((SP, up(m, 2 * MMA_N)))
        G[:S, :m] = bf(gn)
        for q, (o, n) in enumerate(dps):
            acc = torch.zeros((up(m, 2 * MMA_N), up(n, MMA_K)))
            acc[:m, :n] = dneg[j0:j0 + m, o:o + n]
            dneg[j0:j0 + m, o:o + n] = mma(G.T, tile(src, SP, q), kvalid, acc)[:m, :n]
            part[q] = mma(G, e_tile(p, q), acc=part[q])
        wsum[j0:j0 + m] = wsum[j0:j0 + m] + wn_p[:kvalid].sum(0)

    # d_ctr and the context sums per width piece: the band matrix
    # [SK x SP] (slot k, center s) against A, k-slice by k-slice over s
    d_ctr = torch.zeros((S, d))
    y = torch.zeros((SK, d))
    band_t = torch.zeros((SK, SP))
    band_t[:, :S] = bf(mask).T if is_cbow else bf(gp).T
    for q, (o, n) in enumerate(dps):
        if not is_cbow:
            # the band product continues d_hid's accumulator, slot piece
            # after slot piece
            acc, bgp, tbk = part[q], band(gp), tile(bk, SKP, q)
            for k0, kn in kcs:
                acc = mma(bgp[:, cols(k0, kn)], tbk[cols(k0, kn)], acc=acc)
            d_ctr[:, o:o + n] = acc[:S, :n]
            A = tile(src, SP, q)
        else:
            d_ctr[:, o:o + n] = gpc[:, None] * h[:, o:o + n]
            dh2 = part[q][:S, :n] + gpc[:, None] * ctr[:, o:o + n]
            if cbow_mean:
                dh2 = dh2 / torch.clamp_min(nctx, 1.0)[:, None]
            A = torch.zeros((SP, up(n, MMA_K)))
            A[:S, :n] = bf(dh2)
        acc = torch.zeros((SK, up(n, MMA_K)))
        if y0 is not None:
            acc[:y0.shape[0], :n] = y0[:, o:o + n]
        # each slot's sum over the piece's centers, a slot piece's rows at
        # a time (cbow's mask weights need no slot pieces: one pass)
        for k0, kn in (kcs if not is_cbow else [(0, SK)]):
            rows = slice(k0, k0 + kn)
            y[rows, o:o + n] = mma(band_t[rows], A, acc=acc[rows])[:, :n]
    return dict(nctx=nctx, cwy=cwy, d_ctr=d_ctr, y=y, dneg=dneg, wsum=wsum,
                pos=pos, neg=neg)


def center_pieces(ctr, bk, tokc, tokk, keep, w, *, W, sc, kvalid, call):
    """One chunk walked in center pieces of at most sc centers, as both
    kernels walk it: piece i gets its Sp centers (from s0 = i sc) and the
    Sp + 2W slots their band reaches, its positions inside the row's first
    L (kvalid, the chunk's), and what the previous piece handed on: the
    chunk's d_neg and w_neg_sum so far and the context sums of the slots
    the two pieces share (the next piece's first 2W slots). `call(ctr, bk,
    tokc, tokk, keep, w, kvalid, dneg0, wsum0, y0)` runs one piece (chunk).
    Returns the chunk's outputs: n_ctx and d_ctr by center, y and cwy over
    its slab slots (each slot's sum whole), dneg, wsum and the losses."""
    S = ctr.shape[0]
    SK = S + 2 * W
    out = dict(nctx=torch.zeros(S), d_ctr=torch.zeros((S, ctr.shape[1])),
               y=torch.zeros((SK, ctr.shape[1])), cwy=torch.zeros(SK),
               pos=torch.zeros(()), neg=torch.zeros(()))
    dneg = wsum = carry = None
    for s0, Sp in pieces(S, sc):
        cen, slots = slice(s0, s0 + Sp), slice(s0, s0 + Sp + 2 * W)
        o = call(ctr[cen], bk[slots], tokc[cen], tokk[slots], keep[cen], w[cen],
                 min(Sp, max(0, kvalid - s0)), dneg, wsum, carry)
        out["nctx"][cen], out["d_ctr"][cen] = o["nctx"], o["d_ctr"]
        out["cwy"][slots] += o["cwy"]  # 0/1 column sums: exact in any order
        out["pos"], out["neg"] = out["pos"] + o["pos"], out["neg"] + o["neg"]
        dneg, wsum = o["dneg"], o["wsum"]
        # a slot the next piece reaches too leaves as its accumulator
        whole = Sp if s0 + Sp < S else Sp + 2 * W
        out["y"][s0:s0 + whole] = o["y"][:whole]
        carry = o["y"][whole:]
    out["dneg"], out["wsum"] = dneg, wsum
    return out


def emulate_grad_core(emb, tok_c, tok_k, keep_c, w_c, negs, alpha, *, W, K, L,
                      is_cbow, cbow_mean=True, sc=SC, kpc=KPC, dc=DC, kc=KC,
                      cdt=BF16):
    """csrc/fused_step.cu grad_core_tc_kernel (cdt bf16; f32: the walk of
    grad_core_f32_kernel), one row at a time, the tiles sc centers, kpc
    negative rows and dc columns wide, the band weights kc slots."""
    B, C, S = tok_c.shape
    d = emb.shape[-1]
    KP = negs.shape[1]
    ctr_p, ctx_p = (1, 0) if is_cbow else (0, 1)
    e32 = emb.float()
    d_ctr = torch.zeros((B, C, S, d))
    d_ctx = torch.zeros((B, C, S, d))
    n_ctx = torch.zeros((B, C, S))
    ctx_w = torch.zeros((B, C, S))
    d_neg = torch.zeros((B, KP, d))
    w_neg_sum = torch.zeros((B, KP))
    pos = neg = torch.zeros(())
    for b in range(B):
        en = e32[negs[b].long(), 1]
        for c in range(C):
            tokk = tok_k[b, c]
            bk = torch.where((tokk >= 0)[:, None],
                             e32[tokk.clamp_min(0).long(), ctx_p], torch.zeros(()))

            def piece(ctr, bk, tokc, tokk, keep, w, kvalid, dneg0, wsum0, y0):
                return chunk(ctr, bk, en, tokc, tokk, keep, w, negs[b], alpha,
                             W=W, K=K, is_cbow=is_cbow, cbow_mean=cbow_mean,
                             kvalid=kvalid, kpc=kpc, dc=dc, kc=kc, cdt=cdt,
                             dneg0=dneg0, wsum0=wsum0, y0=y0)

            o = center_pieces(e32[tok_c[b, c].long(), ctr_p], bk, tok_c[b, c], tokk,
                              keep_c[b, c], w_c[b, c], W=W, sc=sc,
                              kvalid=min(S, L - c * S), call=piece)
            n_ctx[b, c] = o["nctx"]
            d_ctr[b, c] = o["d_ctr"]
            d_neg[b] = o["dneg"] if c == 0 else d_neg[b] + o["dneg"]
            w_neg_sum[b] = w_neg_sum[b] + o["wsum"]
            pos, neg = pos + o["pos"], neg + o["neg"]
            # the overlap hand-off in token order: the right overhang of
            # chunk c waits in the first W rows of chunk c + 1
            y, cw = o["y"], o["cwy"]
            if c > 0:
                d_ctx[b, c - 1, S - W:] += y[:W]
                ctx_w[b, c - 1, S - W:] += cw[:W]
                left, cw_left = d_ctx[b, c, :W].clone(), ctx_w[b, c, :W].clone()
            d_ctx[b, c] = y[W:S + W]
            ctx_w[b, c] = cw[W:S + W]
            if c > 0:
                d_ctx[b, c, :W] = y[W:2 * W] + left
                ctx_w[b, c, :W] = cw[W:2 * W] + cw_left
            if c + 1 < C:
                d_ctx[b, c + 1, :W] = y[S + W:]
                ctx_w[b, c + 1, :W] = cw[S + W:]
    losses = torch.stack([-pos, -neg]).reshape(1, 2)
    return d_ctr, d_ctx, n_ctx, ctx_w, d_neg, w_neg_sum, losses


def emulate_band_core(a, bk, en, tok_c, tok_k, keep_c, w_c, negs, alpha, *, W,
                      K, is_cbow, cbow_mean=True, sc=SC, kpc=KPC, dc=DC, kc=KC,
                      cdt=BF16):
    """csrc/band_core.cu band_core_tc_kernel (cdt bf16; f32: the walk of
    band_core_f32_kernel), one row at a time, the tiles sc centers, kpc
    negative rows and dc columns wide, the band weights kc slots; under
    batch scope the per-row partials reduced in row order."""
    B, C, S, d = a.shape
    SK = bk.shape[2]
    NB, KP = negs.shape
    d_h = torch.zeros((B, C, S, d))
    d_ctx = torch.zeros((B, C, SK, d))
    n_ctx = torch.zeros((B, C, S))
    ctx_w = torch.zeros((B, C, SK))
    dneg_row = torch.zeros((B, KP, d))
    wsum_row = torch.zeros((B, KP))
    loss_row = torch.zeros((B, 2))
    for b in range(B):
        nb = b if NB == B else 0
        def piece(ctr, bk, tokc, tokk, keep, w, kvalid, dneg0, wsum0, y0):
            return chunk(ctr, bk, en[nb].float(), tokc, tokk, keep, w, negs[nb],
                         alpha, W=W, K=K, is_cbow=is_cbow, cbow_mean=cbow_mean,
                         kvalid=up(ctr.shape[0], MMA_M), kpc=kpc, dc=dc,
                         kc=kc, cdt=cdt, dneg0=dneg0, wsum0=wsum0, y0=y0)

        for c in range(C):
            o = center_pieces(a[b, c].float(), bk[b, c].float(), tok_c[b, c],
                              tok_k[b, c], keep_c[b, c], w_c[b, c], W=W, sc=sc,
                              kvalid=S, call=piece)
            n_ctx[b, c], ctx_w[b, c] = o["nctx"], o["cwy"]
            d_h[b, c], d_ctx[b, c] = o["d_ctr"], o["y"]
            dneg_row[b] = o["dneg"] if c == 0 else dneg_row[b] + o["dneg"]
            wsum_row[b] = wsum_row[b] + o["wsum"]
            loss_row[b] = loss_row[b] - torch.stack([o["pos"], o["neg"]])
    if NB == 1:
        d_neg, w_neg_sum, = torch.zeros((1, KP, d)), torch.zeros((1, KP))
        for b in range(B):  # rows_reduce_kernel: rows in order
            d_neg, w_neg_sum = d_neg + dneg_row[b], w_neg_sum + wsum_row[b]
    else:
        d_neg, w_neg_sum = dneg_row, wsum_row
    losses = torch.zeros(2)
    for b in range(B):
        losses = losses + loss_row[b]
    return d_h, d_ctx, d_neg, n_ctx, ctx_w, w_neg_sum, losses.reshape(1, 2)


def assert_close(names, got, ref, tol):
    """chip_smoke.check_outputs' rule: max|got - ref| <= tol * max|ref|
    per gradient output, losses 1e-4, the mask sums exact."""
    for name, g, r in zip(names, got, ref):
        g = torch.from_numpy(np.array(g, np.float32))
        r = torch.from_numpy(np.array(r, np.float32))
        assert g.shape == r.shape, name
        assert torch.isfinite(g).all(), name
        err = float((g.double() - r.double()).abs().max())
        if name in ("n_ctx", "ctx_w"):
            assert err == 0.0, name
        else:
            limit = 1e-4 if name == "losses" else tol
            assert err <= limit * max(float(r.abs().max()), 1e-30), (name, err)


# ------------------------------------------------------------------ cases
# chip_smoke.ODD_SHAPES (d, KP, W, S, L, B): the shapes phase 3 runs the
# kernels at on the card
@pytest.mark.parametrize("table", [F32, BF16], ids=["f32tab", "bf16tab"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(ODD_SHAPES))
def test_grad_core_tiling_matches_plain(shape, model, table):
    d, KP, W, S, L, B = ODD_SHAPES[shape]
    inp = grad_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=table)
    args = [inp[k] for k in GRAD_ORDER]
    kw = dict(W=W, K=5, L=L, is_cbow=model == "cbow")
    got = emulate_grad_core(*args, 0.03, **kw)
    ref = fs.fused_grad_core_plain(*args, 0.03, cdt=BF16, **kw)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])
    assert float(ref[4].abs().max()) > 1e-4  # d_neg is not trivially zero


@pytest.mark.parametrize("scope", ["row", "batch"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(ODD_SHAPES))
def test_band_core_tiling_matches_plain(shape, model, scope):
    d, KP, W, S, L, B = ODD_SHAPES[shape]
    table = BF16 if shape.startswith("d64") else F32
    inp = core_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=table,
                      scope=scope, model=model)
    args = [inp[k] for k in CORE_ORDER]
    kw = dict(W=W, K=5, is_cbow=model == "cbow")
    got = emulate_band_core(*args, 0.03, **kw)
    ref = bc.band_core_plain(*args, 0.03, cdt=BF16, **kw)
    assert_close(CORE_NAMES, got, ref, TOL[BF16])
    assert bool((got[1][inp["tok_k"] < 0] == 0).all())  # slab zeros


@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_grad_core_cuts_gn_past_L(model):
    """Valid slab ids and keep = 1 everywhere, so centers past L get
    non-zero negative weights: d_neg and w_neg_sum still sum exactly the
    first L positions only because the tile product cuts G there."""
    d, KP, W, S, L, B = 16, 8, 2, 13, 30, 2
    inp = grad_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32)
    rng = np.random.default_rng(4)
    inp["tok_k"] = torch.from_numpy(
        rng.integers(0, 80, size=inp["tok_k"].shape).astype(np.int32))
    inp["keep_c"] = torch.ones_like(inp["keep_c"])
    inp["w_c"] = torch.full_like(inp["w_c"], float(W))
    args = [inp[k] for k in GRAD_ORDER]
    kw = dict(W=W, K=5, L=L, is_cbow=model == "cbow")
    got = emulate_grad_core(*args, 0.03, **kw)
    ref = fs.fused_grad_core_plain(*args, 0.03, cdt=BF16, **kw)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])
    C = inp["tok_c"].shape[1]
    uncut = emulate_grad_core(*args, 0.03, W=W, K=5, L=C * S, is_cbow=model == "cbow")
    assert float((uncut[4] - ref[4]).abs().max()) > 10 * TOL[BF16] * float(
        ref[4].abs().max())


def _jax(x, dt):
    return jnp.asarray(x.float().numpy()).astype(dt)


@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_grad_core_tiling_matches_jax_kernel(model):
    d, KP, W, S, L, B = 7, 8, 3, 10, 37, 3
    inp = grad_inputs(V=60, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32, seed=5)
    got = emulate_grad_core(*[inp[k] for k in GRAD_ORDER], 0.03, W=W, K=3, L=L,
                            is_cbow=model == "cbow")
    jargs = [_jax(inp["emb"], jnp.float32)] + [
        jnp.asarray(inp[k].numpy()) for k in GRAD_ORDER[1:]]
    ref = j_grad_core(*jargs, jnp.float32(0.03), W=W, K=3, L=L, cdt=jnp.bfloat16,
                      is_cbow=model == "cbow", cbow_mean=True, interpret=True)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])


@pytest.mark.parametrize("scope", ["row", "batch"])
def test_band_core_tiling_matches_jax_kernel(scope):
    d, KP, W, S, L, B = 7, 8, 3, 10, 37, 3
    inp = core_inputs(V=60, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope=scope, model="sg", seed=6)
    got = emulate_band_core(*[inp[k] for k in CORE_ORDER], 0.03, W=W, K=3,
                            is_cbow=False)
    jargs = [_jax(inp[k], jnp.float32) for k in ("a", "bk", "en")] + [
        jnp.asarray(inp[k].numpy()) for k in CORE_ORDER[3:]]
    ref = j_band_core(*jargs, jnp.float32(0.03), W=W, K=3, cdt=jnp.bfloat16,
                      is_cbow=False, cbow_mean=True, interpret=True)
    assert_close(CORE_NAMES, got, ref, TOL[BF16])


# ------------------------------------------------------------- pieces
# d 48 and KP 40 walked in pieces of 16: three width pieces and three
# negative pieces, the last of those ragged (16, 16, 8); S not a multiple
# of 16, L not a multiple of S, ragged rows (d, KP, W, S, L, B)
PIECES = dict(kpc=16, dc=16)
PIECE_SHAPE = (48, 40, 3, 13, 30, 2)


@pytest.mark.parametrize("table", [F32, BF16], ids=["f32tab", "bf16tab"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_grad_core_pieces_match_plain(model, table):
    d, KP, W, S, L, B = PIECE_SHAPE
    inp = grad_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=table, seed=7)
    args = [inp[k] for k in GRAD_ORDER]
    kw = dict(W=W, K=5, L=L, is_cbow=model == "cbow")
    got = emulate_grad_core(*args, 0.03, **kw, **PIECES)
    ref = fs.fused_grad_core_plain(*args, 0.03, cdt=BF16, **kw)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])
    assert float(ref[4][:, 32:].abs().max()) > 1e-4  # the ragged piece's d_neg


@pytest.mark.parametrize("scope", ["row", "batch"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_band_core_pieces_match_plain(model, scope):
    d, KP, W, S, L, B = PIECE_SHAPE
    inp = core_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope=scope, model=model, seed=8)
    args = [inp[k] for k in CORE_ORDER]
    kw = dict(W=W, K=5, is_cbow=model == "cbow")
    got = emulate_band_core(*args, 0.03, **kw, **PIECES)
    ref = bc.band_core_plain(*args, 0.03, cdt=BF16, **kw)
    assert_close(CORE_NAMES, got, ref, TOL[BF16])
    assert bool((got[1][inp["tok_k"] < 0] == 0).all())  # slab zeros


@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_grad_core_pieces_match_jax_kernel(model):
    d, KP, W, S, L, B = PIECE_SHAPE
    inp = grad_inputs(V=60, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32, seed=9)
    got = emulate_grad_core(*[inp[k] for k in GRAD_ORDER], 0.03, W=W, K=3, L=L,
                            is_cbow=model == "cbow", **PIECES)
    jargs = [_jax(inp["emb"], jnp.float32)] + [
        jnp.asarray(inp[k].numpy()) for k in GRAD_ORDER[1:]]
    ref = j_grad_core(*jargs, jnp.float32(0.03), W=W, K=3, L=L, cdt=jnp.bfloat16,
                      is_cbow=model == "cbow", cbow_mean=True, interpret=True)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])


@pytest.mark.parametrize("scope", ["row", "batch"])
def test_band_core_pieces_match_jax_kernel(scope):
    d, KP, W, S, L, B = PIECE_SHAPE
    inp = core_inputs(V=60, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope=scope, model="cbow", seed=10)
    got = emulate_band_core(*[inp[k] for k in CORE_ORDER], 0.03, W=W, K=3,
                            is_cbow=True, **PIECES)
    jargs = [_jax(inp[k], jnp.float32) for k in ("a", "bk", "en")] + [
        jnp.asarray(inp[k].numpy()) for k in CORE_ORDER[3:]]
    ref = j_band_core(*jargs, jnp.float32(0.03), W=W, K=3, cdt=jnp.bfloat16,
                      is_cbow=True, cbow_mean=True, interpret=True)
    assert_close(CORE_NAMES, got, ref, TOL[BF16])


@pytest.mark.parametrize("route", [("pallas", "split"), ("pallas_fused", "unified")],
                         ids=["pallas", "pallas_fused"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
def test_step_in_pieces_matches_jax(route, model, monkeypatch):
    """Two steps of a kernel route whose KP (40) and d (48) each span three
    pieces of the emulation (pieces of 16), and whose chunks (band_chunk 27
    at L 40: two chunks, the second partial) span two center pieces of 16
    (16 and a ragged 11), the port's band core replaced
    by its emulation, against the JAX step (its Pallas kernel in interpret
    mode) from the same params and draws (tests/torch_parity.py; two steps,
    so that the zero-initialized out table has moved before the second, and
    the negative rows reach d_hid): every table's update within TOL[bf16] of max|update| (bf16 compute: a
    gradient weight on a rounding boundary may round one ulp apart), the
    loss within 1e-4, the pair count within 1e-6 (as tests/torch_parity.py)."""
    import torch_parity as tp_
    from word2vec_tpu.config import Word2VecConfig as JConfig
    from word2vec_tpu.models.params import init_params as j_init
    from word2vec_tpu_torch.ops import band_step

    calls = []

    def grad_core(*a, cdt, **k):
        calls.append("fused_grad_core")
        return emulate_grad_core(*a, **k, **CENTER_PIECES)

    def band_core(*a, cdt, **k):
        calls.append("band_core")
        return emulate_band_core(*a, **k, **CENTER_PIECES)

    monkeypatch.setattr(fs, "fused_grad_core_plain", grad_core)
    monkeypatch.setattr(bc, "band_core_plain", band_core)
    monkeypatch.setattr(band_step, "_cast_update", tp_.jax_grid_cast)
    kw = tp_.kw(model=model, band_backend=route[0], table_layout=route[1],
                word_dim=48, shared_negatives=40, band_chunk=27,
                compute_dtype="bfloat16")
    start = j_init(JConfig(**kw), tp_.V, jax.random.key(1))
    jp, jm, tp, tm = tp_.run(kw, 2)
    assert calls == 2 * ["band_core" if route[0] == "pallas" else "fused_grad_core"]
    for k in tp:
        s = np.asarray(start[k], np.float32)
        ref = np.asarray(jp[k], np.float32) - s
        got = tp[k].float().numpy() - s
        assert np.abs(got - ref).max() <= TOL[BF16] * np.abs(ref).max(), k
    np.testing.assert_allclose(float(tm["pairs"]), float(jm["pairs"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss_sum"]), float(jm["loss_sum"]),
                               rtol=1e-4)


# ------------------------------------------------------ center pieces
# chunks of three to five center pieces of 16 with their 2W-slot halo (d,
# KP, W, S, L, B): d 48 and KP 40 in pieces of 16 too (PIECES), S not a
# multiple of 16 (a ragged last piece), L not a multiple of S (a partial
# last chunk), ragged rows; W 1 and W 5, whose 10 shared slots fall in one
# [16 x 16] block of the next piece
CENTER_PIECES = dict(sc=16, **PIECES)
CENTER_SHAPES = {
    "w1-s50": (48, 40, 1, 50, 130, 3),
    "w5-s70": (48, 40, 5, 70, 150, 2),
}


def assert_unpieced_order(names, pieced, whole):
    """Every output but the losses bitwise the unpieced walk's (the
    losses' per-thread partial sums follow the pieces: band_tiles.cuh)."""
    for name, x, y in zip(names, pieced, whole):
        if name != "losses":
            assert torch.equal(x, y), name


@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(CENTER_SHAPES))
def test_grad_core_center_pieces_match_plain(shape, model):
    """The fused core with each chunk in center pieces of 16 (and the pool
    and the width in pieces of 16) holds the plain version at TOL[bf16], and
    is bitwise the same walk with the chunk in one center piece."""
    d, KP, W, S, L, B = CENTER_SHAPES[shape]
    table = BF16 if model == "cbow" else F32
    inp = grad_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=table, seed=11)
    args = [inp[k] for k in GRAD_ORDER]
    kw = dict(W=W, K=5, L=L, is_cbow=model == "cbow")
    got = emulate_grad_core(*args, 0.03, **kw, **CENTER_PIECES)
    ref = fs.fused_grad_core_plain(*args, 0.03, cdt=BF16, **kw)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])
    whole = emulate_grad_core(*args, 0.03, **kw, **dict(CENTER_PIECES, sc=up(S, MMA_M)))
    assert_unpieced_order(GRAD_NAMES, got, whole)


@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(CENTER_SHAPES))
def test_band_core_center_pieces_match_plain(shape, model):
    """band_core likewise (row scope at W 1, batch scope at W 5): the slab
    slots two center pieces share continue their sums in the output rows."""
    d, KP, W, S, L, B = CENTER_SHAPES[shape]
    scope = "row" if W == 1 else "batch"
    inp = core_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope=scope, model=model, seed=12)
    args = [inp[k] for k in CORE_ORDER]
    kw = dict(W=W, K=5, is_cbow=model == "cbow")
    got = emulate_band_core(*args, 0.03, **kw, **CENTER_PIECES)
    ref = bc.band_core_plain(*args, 0.03, cdt=BF16, **kw)
    assert_close(CORE_NAMES, got, ref, TOL[BF16])
    assert bool((got[1][inp["tok_k"] < 0] == 0).all())  # slab zeros
    whole = emulate_band_core(*args, 0.03, **kw, **dict(CENTER_PIECES, sc=up(S, MMA_M)))
    assert_unpieced_order(CORE_NAMES, got, whole)


def test_grad_core_center_pieces_match_jax_kernel():
    d, KP, W, S, L, B = CENTER_SHAPES["w1-s50"]
    inp = grad_inputs(V=60, d=d, B=2, L=L, W=W, S=S, KP=KP, table=F32, seed=14)
    got = emulate_grad_core(*[inp[k] for k in GRAD_ORDER], 0.03, W=W, K=3, L=L,
                            is_cbow=False, **CENTER_PIECES)
    jargs = [_jax(inp["emb"], jnp.float32)] + [
        jnp.asarray(inp[k].numpy()) for k in GRAD_ORDER[1:]]
    ref = j_grad_core(*jargs, jnp.float32(0.03), W=W, K=3, L=L, cdt=jnp.bfloat16,
                      is_cbow=False, cbow_mean=True, interpret=True)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])


def test_band_core_center_pieces_match_jax_kernel():
    d, KP, W, S, L, B = CENTER_SHAPES["w5-s70"]
    inp = core_inputs(V=60, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope="row", model="cbow", seed=15)
    got = emulate_band_core(*[inp[k] for k in CORE_ORDER], 0.03, W=W, K=3,
                            is_cbow=True, **CENTER_PIECES)
    jargs = [_jax(inp[k], jnp.float32) for k in ("a", "bk", "en")] + [
        jnp.asarray(inp[k].numpy()) for k in CORE_ORDER[3:]]
    ref = j_band_core(*jargs, jnp.float32(0.03), W=W, K=3, cdt=jnp.bfloat16,
                      is_cbow=True, cbow_mean=True, interpret=True)
    assert_close(CORE_NAMES, got, ref, TOL[BF16])


# ------------------------------------------------------- slot pieces
# windows past one slot piece (d, KP, W, S, L, B), walked in slot pieces of
# 16 with every other piece 16 wide too (SLOT_PIECES): W 10 and W 20, whose
# 2W exceeds a center piece (three and four center pieces share a slot);
# W 10 at S 20, L 25, where chunk 1's slots 16-31 lie wholly past every row
# (tok_k -1); and W 95 at L 192 (S 190, two chunks) in the header's pieces
# (a center piece of 128 and one of 62, two slot pieces of 160 each)
SLOT_PIECES = dict(kc=16, **CENTER_PIECES)
SLOT_SHAPES = {
    "w10-s30": ((24, 20, 10, 30, 70, 2), SLOT_PIECES),
    "w20-s45": ((24, 20, 20, 45, 100, 2), SLOT_PIECES),
    "w10-past-row": ((16, 8, 10, 20, 25, 3), SLOT_PIECES),
    "w95-l192": ((16, 8, 95, 190, 192, 2), {}),
}


def unpieced(S, W, walk):
    """The walk with the chunk in one center piece and one slot piece."""
    return dict(walk, sc=up(S, MMA_M), kc=up(S + 2 * W, MMA_K))


@pytest.mark.parametrize("cdt", [BF16, F32], ids=["bf16cdt", "f32cdt"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(SLOT_SHAPES))
def test_grad_core_slot_pieces_match_plain(shape, model, cdt):
    """The fused core with each center piece's band walked in slot pieces
    holds the plain version at phase 3's tolerance of the compute type
    (TOL: bf16 2e-2, f32 1e-5 of max|plain|, losses 1e-4, n_ctx / ctx_w
    exact), and every output but the losses is bitwise the walk in one
    center and one slot piece: the band product's and the context sums'
    k-slices keep the unpieced order."""
    (d, KP, W, S, L, B), walk = SLOT_SHAPES[shape]
    table = BF16 if model == "cbow" else F32
    inp = grad_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=table, seed=21)
    args = [inp[k] for k in GRAD_ORDER]
    kw = dict(W=W, K=5, L=L, is_cbow=model == "cbow")
    got = emulate_grad_core(*args, 0.03, **kw, **walk, cdt=cdt)
    ref = fs.fused_grad_core_plain(*args, 0.03, cdt=cdt, **kw)
    assert_close(GRAD_NAMES, got, ref, TOL[cdt])
    whole = emulate_grad_core(*args, 0.03, **kw, **unpieced(S, W, walk), cdt=cdt)
    assert_unpieced_order(GRAD_NAMES, got, whole)


@pytest.mark.parametrize("cdt", [BF16, F32], ids=["bf16cdt", "f32cdt"])
@pytest.mark.parametrize("scope", ["row", "batch"])
@pytest.mark.parametrize("model", ["sg", "cbow"])
@pytest.mark.parametrize("shape", list(SLOT_SHAPES))
def test_band_core_slot_pieces_match_plain(shape, model, scope, cdt):
    """band_core likewise: the slab-space context sums of each slot piece
    continue the slots earlier center pieces reached in the output rows."""
    (d, KP, W, S, L, B), walk = SLOT_SHAPES[shape]
    inp = core_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope=scope, model=model, seed=22)
    args = [inp[k] for k in CORE_ORDER]
    kw = dict(W=W, K=5, is_cbow=model == "cbow")
    got = emulate_band_core(*args, 0.03, **kw, **walk, cdt=cdt)
    ref = bc.band_core_plain(*args, 0.03, cdt=cdt, **kw)
    assert_close(CORE_NAMES, got, ref, TOL[cdt])
    assert bool((got[1][inp["tok_k"] < 0] == 0).all())  # slab zeros
    whole = emulate_band_core(*args, 0.03, **kw, **unpieced(S, W, walk), cdt=cdt)
    assert_unpieced_order(CORE_NAMES, got, whole)


def test_slot_shapes_reach_past_a_slot_piece():
    """Each slot shape walks more than one slot piece a center piece, the
    W 10 / W 20 ones share a slot among three and four center pieces, and
    w10-past-row holds a slot piece with no slot inside any row."""
    for (d, KP, W, S, L, B), walk in SLOT_SHAPES.values():
        sc, kc = walk.get("sc", SC), walk.get("kc", KC)
        assert min(S, sc) + 2 * W > kc
    for name, share in (("w10-s30", 3), ("w20-s45", 4)):
        (d, KP, W, S, L, B), walk = SLOT_SHAPES[name]
        assert -(-2 * W // walk["sc"]) + 1 == share
    (d, KP, W, S, L, B), walk = SLOT_SHAPES["w10-past-row"]
    inp = grad_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32, seed=21)
    tok_k = inp["tok_k"]
    assert bool((tok_k[:, 1, 16:32] < 0).all())
    assert SLOT_SHAPES["w95-l192"][0][3] == 190  # the auto S at W 95, L 192


def test_grad_core_slot_pieces_match_jax_kernel():
    (d, KP, W, S, L, B), walk = SLOT_SHAPES["w10-s30"]
    inp = grad_inputs(V=60, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32, seed=23)
    got = emulate_grad_core(*[inp[k] for k in GRAD_ORDER], 0.03, W=W, K=3, L=L,
                            is_cbow=False, **walk)
    jargs = [_jax(inp["emb"], jnp.float32)] + [
        jnp.asarray(inp[k].numpy()) for k in GRAD_ORDER[1:]]
    ref = j_grad_core(*jargs, jnp.float32(0.03), W=W, K=3, L=L, cdt=jnp.bfloat16,
                      is_cbow=False, cbow_mean=True, interpret=True)
    assert_close(GRAD_NAMES, got, ref, TOL[BF16])


def test_band_core_slot_pieces_match_jax_kernel():
    (d, KP, W, S, L, B), walk = SLOT_SHAPES["w20-s45"]
    inp = core_inputs(V=60, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope="row", model="cbow", seed=24)
    got = emulate_band_core(*[inp[k] for k in CORE_ORDER], 0.03, W=W, K=3,
                            is_cbow=True, **walk)
    jargs = [_jax(inp[k], jnp.float32) for k in ("a", "bk", "en")] + [
        jnp.asarray(inp[k].numpy()) for k in CORE_ORDER[3:]]
    ref = j_band_core(*jargs, jnp.float32(0.03), W=W, K=3, cdt=jnp.bfloat16,
                      is_cbow=True, cbow_mean=True, interpret=True)
    assert_close(CORE_NAMES, got, ref, TOL[BF16])


def test_pieces_match_the_host_copy():
    """The pieces the tiles hold are the header's constants, multiples of
    the mma tile, the flagship and every auto chunk (S <= 126,
    word2vec_tpu/ops/banded.py resolve_chunk) one piece of each; the
    host's shared-memory formula and workspaces read the same numbers."""
    from word2vec_tpu_torch.ops import launch

    assert (launch.CORE_S_PIECE, launch.CORE_KP_PIECE, launch.CORE_D_PIECE,
            launch.CORE_K_PIECE) == (SC, KPC, DC, KC)
    assert SC % MMA_M == 0 and KPC % (2 * MMA_N) == 0 and DC % MMA_K == 0
    # a center piece of kSc is one slot piece up to W 16
    assert KC % MMA_K == 0 and SC + 2 * 16 <= KC
    assert SC >= 126 and KPC >= 64 and DC >= up(300, MMA_K)
    assert launch._CORE_WARPS == const("kThreads") // 32
    assert "round_up(2 * W, kMmaM)" in HEADER  # carry_rows
    for kernel in ("fused_grad_core", "band_core"):
        for S, bf16 in ((SC, True), (SC + 1, True), (SC + 1, False)):
            ws = launch.core_workspaces(kernel, 3, S, 40, 7, 5, bf16, "cpu")
            shapes = [tuple(t.shape) for t in ws]
            if S == SC:
                assert shapes == [(0,), (0,)]
            elif kernel == "fused_grad_core":
                dneg = (3, 40, 7) if bf16 else (0,)  # f32 body: d_neg in place
                assert shapes == [dneg, (3, 2, up(10, MMA_M), 7)]
            else:
                assert shapes == [(3, 40, 7), (3, 40)]


def test_phase_record_needs_the_card():
    """The cycle record is a measurement of the CUDA kernels: the CPU path
    (the plain versions) refuses it instead of leaving it unwritten."""
    d, KP, W, S, L, B = ODD_SHAPES["d7-kp8-w1"]
    rec = torch.zeros((B, len(CORE_PHASES)), dtype=torch.int64)
    inp = grad_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32)
    with pytest.raises(ValueError, match="phase_cycles"):
        fs.fused_grad_core(*[inp[k] for k in GRAD_ORDER], 0.03, W=W, K=5, L=L,
                           phase_cycles=rec)
    inp = core_inputs(V=80, d=d, B=B, L=L, W=W, S=S, KP=KP, table=F32,
                      scope="row", model="sg")
    with pytest.raises(ValueError, match="phase_cycles"):
        bc.band_core(*[inp[k] for k in CORE_ORDER], 0.03, W=W, K=5,
                     phase_cycles=rec)


# ------------------------------------------------------- source structure
def test_tile_constants_fit_mma_m16n8k16():
    assert (MMA_M, MMA_N, MMA_K) == (16, 8, 16)
    pad = const("kRowPad")
    # a staged row stride of an odd number of 16-byte units: the 8 row
    # addresses of an ldmatrix on 8 distinct 16-byte bank groups, every
    # row start 16-byte aligned
    for d in (7, 64, 300):
        stride = (up(d, MMA_K) + pad) * 2
        assert stride % 16 == 0 and (stride // 16) % 2 == 1
        assert len({r * stride % 128 for r in range(8)}) == 8


def test_phase_names_match_the_header_enum():
    body = HEADER[HEADER.index("enum Phase {"):]
    body = body[:body.index("};")]
    names = re.findall(r"kPhase(\w+)", body)
    assert [n.lower() for n in names if n != "s"] == list(CORE_PHASES)
    assert "kPhases" in body


@pytest.mark.parametrize("src", ["fused_step.cu", "band_core.cu"])
def test_kernels_share_the_tile_header(src):
    """Both kernels include band_tiles.cuh, run their dense products
    through its mma tile pass, and no longer carry their own copies of
    the helpers."""
    text = (CSRC / src).read_text()
    assert '#include "band_tiles.cuh"' in text
    assert "tile_pass<" in text and "neg_logits(" in text and "context_tiles<" in text
    for helper in ("float sigmoid_stable(", "float log_sigmoid(", "float warp_sum(",
                   "float rc(", "float to_f("):
        assert helper not in text, helper
    assert "mma.sync.aligned.m16n8k16" in HEADER and "ldmatrix" in HEADER
