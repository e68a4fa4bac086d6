// Hand-written Hopper (sm_90a) kernel of the split-table fused band core.
//
// Replaces word2vec_tpu/ops/pallas_band.py, band_core / _band_kernel
// (pallas_band.py:72-310): over rows the caller gathered from the two
// [V, d] tables (a = center rows, bk = context slabs, en = shared negative
// rows), the band mask, the positive and negative logits, the sigmoid,
// every gradient, and the reductions: d_h in token order, the context
// gradient in SLAB space (the sorted slab scatter adds the aliased slots),
// d_neg and w_neg_sum over C (and over B too under batch scope), n_ctx,
// the slab column weights and the losses.
//
// What bounds it on the H100. At the flagship (B=256, C=2, S=118,
// S+2W=128, d=300, KP=64, f32 tables) it reads a + bk + en (about 171 MB)
// and writes d_h + d_ctx + d_neg (about 171 MB): about 0.10 ms at
// 3.35 TB/s. Its dense products (about 8 GFLOP a call) are far under the
// bf16 tensor cores' rate but would take about as long as the bytes on the
// f32 CUDA cores; the first port also re-read the a and bk rows from L2
// inside scalar warp-reduced dot products.
//
// The design, shared with grad_core (csrc/fused_step.cu) through
// csrc/band_tiles.cuh. One CTA of 512 threads per batch row loops over its
// C chunks: the TPU kernel accumulates d_neg, w_neg_sum and the losses
// across its sequential (B, C) grid, which GPU blocks (no order, no carry)
// cannot do. With bf16 compute (the default) each chunk's dense operands
// are staged in shared memory, rounded once to bf16, one piece of at most
// kKPc = 64 negative rows and kDc = 304 columns at a time:
//   A [SP x lda]   the center rows a (sg) or the cbow projection h,
//                  zero-padded to SP = 128 x 304 (+8 columns: ldmatrix
//                  rows on distinct banks)   128 x 312 x 2 B = 79,872 B
//   E [KPP x lda]  the negative rows (once per row in one piece)
//                                           64 x 312 x 2 B = 39,936 B
//   G [SP x ldg]   gn = -sigmoid(nlog) w_neg alpha    128 x 72 x 2 B  = 18,432 B
//   f32: ids and gates, the band-compressed gp [S x 2W+1], w_neg [S x KPc]
//   (30,208 B), ...                         total at the flagship 177,408 B
// and no more at any wider KP or d: the flagship is one piece of each, and
// a wider pool or row is walked piece by piece (band_tiles.cuh states the
// order of every sum that crosses pieces: that of one unpieced product).
// The slabs bk (another 80 KB, over the 227 KB a block has) stay in L1/L2.
// Every product runs on the tensor cores (mma.sync.m16n8k16, f32
// accumulate): nlog = A E^T, d_neg = G^T A and d_hid = G E from the tiles;
// the sg band logits A bk^T and the band product gp bk (added into d_hid's
// accumulator), the cbow projection mask bk, with bk read straight into
// mma operands; the slab-space context sums band^T A, the band matrix (gp
// or the cbow mask) built in the registers. Every output is owned by one
// thread (no float atomics: two runs are bitwise equal):
//   * d_neg is the TPU kernel's shape of reduction: a tile product over the
//     chunk's S positions, then added over c in order by the thread that
//     owns the output (pallas_band.py:158, 198); w_neg_sum likewise;
//   * under batch scope every row writes its own partial [KP, d] and [KP];
//     a second kernel adds the rows in order (0..B-1). The losses leave as
//     per-row partials reduced the same way;
//   * the negative weights compare the raw, -1-padded center ids; cbow's
//     d_h = gp h uses the unrounded f32 projection, its d_hid2 goes back
//     into A, rounded once, for the context sums (d_hid's running sum over
//     negative pieces waits in a workspace); the cbow center logit is an
//     f32 multiply and row sum of cdt-rounded operands
//     (pallas_band.py:175-179).
// With f32 compute the products stay exact f32 multiply-adds on the CUDA
// cores (TF32 would be outside the 1e-5 tolerance, and f32 tiles do not
// fit): band_core_f32_kernel keeps the first port's body (the negative rows
// through L1/L2), the negative pool in pieces of kKPc. Both bodies take an
// optional per-phase clock64() record (PhaseClock). A chunk S whose tiles
// exceed the block's shared memory fails its launch (the wrapper raises
// first).
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "band_tiles.cuh"

namespace {

using namespace w2v_band;

struct BandArgs {
  const void* a;         // [B, C, S, d] T   center rows (zero past L)
  const void* bk;        // [B, C, SK, d] T  context slabs (zero outside)
  const void* en;        // [NB, KP, d] T    negative rows
  const int* tok_c;      // [B, C, S] center ids, -1 past the row
  const int* tok_k;      // [B, C, SK] slab ids, -1 outside the row
  const float* keep_c;   // [B, C, S]
  const float* w_c;      // [B, C, S]
  const int* negs;       // [NB, KP]
  const float* alpha;    // [] the step's learning rate, on the device
  float* d_h;            // [B, C, S, d]
  float* d_ctx;          // [B, C, SK, d]
  float* n_ctx;          // [B, C, S]
  float* ctx_w;          // [B, C, SK]
  float* dneg_row;       // [B, KP, d] per-row d_neg (the output, row scope)
  float* wsum_row;       // [B, KP] per-row w_neg_sum (the output, row scope)
  float* loss_part;      // [B, 2]
  float* h_ws;           // [B, S, d] cbow only: this chunk's projection
  float* dh_ws;          // [B, S, d] cbow only: this chunk's hidden grad
  int C, S, SK, KP, d, W, K, neg_shared, cbow_mean;
  long long* phase_rec;  // null, or [B, kPhases] cycles (PhaseClock)
};

// shared memory of the f32-compute body, in 4-byte words, in
// band_core_f32_kernel's order: one negative piece (at most kKPc rows) at
// a time, nothing that grows with d
inline size_t band_smem_words(int S, int SK, int KP, int W) {
  const int NB = 2 * W + 1;
  const int KPc = KP < kKPc ? KP : kKPc;
  return (size_t)S * 4          // tok_c, keep, w, n_ctx
         + (size_t)SK * 2       // tok_k, cwy
         + (size_t)KPc          // the piece's negative ids
         + (size_t)S * NB       // band-compressed gp (sg)
         + (size_t)S            // gp per center (cbow)
         + (size_t)S * KPc * 2  // gn, w_neg of the piece
         + (size_t)2 * kWarps;  // loss block reduction
}

// f32 compute: exact f32 products on the CUDA cores (the staged f32 tiles
// would not fit), the design of the first port; the negative rows are read
// through L1/L2, the negative pool walked in pieces of kKPc
template <typename T, bool CBOW>
__global__ void __launch_bounds__(kThreads)
    band_core_f32_kernel(const BandArgs p) {
  // read once a block: a captured graph replays the pointer, not a value
  const float alpha = *p.alpha;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = p.C, S = p.S, SK = p.SK, KP = p.KP, d = p.d, W = p.W;
  const int NB = 2 * W + 1;
  const int KPc = KP < kKPc ? KP : kKPc, nK = pieces(KP, kKPc);
  const int nb = p.neg_shared ? 0 : b;
  const T* A = static_cast<const T*>(p.a);
  const T* BK = static_cast<const T*>(p.bk);
  const T* EN = static_cast<const T*>(p.en) + (size_t)nb * KP * d;

  extern __shared__ float smem[];
  int* s_tokc = reinterpret_cast<int*>(smem);
  float* s_keep = smem + S;
  float* s_w = s_keep + S;
  float* s_nctx = s_w + S;
  int* s_tokk = reinterpret_cast<int*>(s_nctx + S);
  float* s_cwy = reinterpret_cast<float*>(s_tokk + SK);
  int* s_negs = reinterpret_cast<int*>(s_cwy + SK);
  float* s_gpb = reinterpret_cast<float*>(s_negs + KPc);
  float* s_gpc = s_gpb + (size_t)S * NB;
  float* s_gn = s_gpc + S;
  float* s_wn = s_gn + (size_t)S * KPc;
  float* s_red = s_wn + (size_t)S * KPc;

  // the band mask (pallas_band.py:113-122): keep_s & valid_k & 0 < dist <= w_s
  const Band band{s_tokc, s_keep, s_w, s_nctx, s_tokk, s_negs, S, W, p.K, KP};
  auto mask = [&](int s, int k) -> float { return band.mask(s, k); };
  PhaseClock clk(p.phase_rec);
  float* h_ws = p.h_ws + (size_t)b * S * d;
  float* dh_ws = p.dh_ws + (size_t)b * S * d;
  auto load_negs = [&](int q) {
    for (int j = tid; j < piece_len(KP, kKPc, q); j += kThreads)
      s_negs[j] = p.negs[(size_t)nb * KP + q * kKPc + j];
  };

  float pos_acc = 0.f;  // sum of mask * log_sigmoid(plog)
  float neg_acc = 0.f;  // sum of w_neg * (log_sigmoid(nlog) - nlog)

  load_negs(0);  // once per row when the pool is one piece

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // the previous chunk is done with the tiles
    const size_t bc = (size_t)b * C + c;
    const T* a = A + bc * S * d;
    const T* bk = BK + bc * SK * d;
    auto h_val = [&](int s, int e) -> float {
      if constexpr (CBOW) {
        return h_ws[(size_t)s * d + e];
      } else {
        return to_f(a[(size_t)s * d + e]);
      }
    };
    for (int s = tid; s < S; s += kThreads) {
      s_tokc[s] = p.tok_c[bc * S + s];
      s_keep[s] = p.keep_c[bc * S + s];
      s_w[s] = p.w_c[bc * S + s];
    }
    for (int k = tid; k < SK; k += kThreads) s_tokk[k] = p.tok_k[bc * SK + k];
    __syncthreads();
    clk.mark(kPhaseRows);

    // ---- mask row sums (n_ctx) and slab column sums (ctx_w): 0/1 sums,
    // exact in any order
    for (int s = tid; s < S; s += kThreads) {
      const float n = band.row_sum(s);
      s_nctx[s] = n;
      p.n_ctx[bc * S + s] = n;
    }
    for (int k = tid; k < SK; k += kThreads) {
      const float cw = band.col_sum(k);
      s_cwy[k] = cw;
      p.ctx_w[bc * SK + k] = cw;
    }
    __syncthreads();
    if constexpr (CBOW) {
      // projection h = mask @ bk (divided by n_ctx under cbow_mean)
      for (int i = tid; i < S * d; i += kThreads) {
        const int s = i / d, e = i - s * d;
        float acc = 0.f;
        for (int k = s; k <= s + 2 * W; ++k) {
          const float m = mask(s, k);
          if (m != 0.f) acc += m * to_f(bk[(size_t)k * d + e]);
        }
        if (p.cbow_mean) acc = acc / fmaxf(s_nctx[s], 1.f);
        h_ws[i] = acc;
      }
      __syncthreads();
    }
    clk.mark(kPhaseMasks);

    // ---- positive side
    if constexpr (!CBOW) {
      // band logits over the band only, one warp per (s, k)
      for (int q = warp; q < S * NB; q += kWarps) {
        const int s = q / NB, k = s + (q - s * NB);
        const float m = mask(s, k);
        if (m == 0.f) {
          if (lane == 0) s_gpb[q] = 0.f;
          continue;
        }
        float part = 0.f;
        for (int e = lane; e < d; e += 32)
          part += to_f(a[(size_t)s * d + e]) *
                  to_f(bk[(size_t)k * d + e]);
        const float plog = warp_sum(part);
        if (lane == 0) {
          s_gpb[q] = (1.f - sigmoid_stable(plog)) * m * alpha;
          pos_acc += m * log_sigmoid(plog);
        }
      }
    } else {
      // center logit: f32 multiply and row sum of cdt-rounded h and a
      for (int s = warp; s < S; s += kWarps) {
        float part = 0.f;
        for (int e = lane; e < d; e += 32)
          part += h_val(s, e) * to_f(a[(size_t)s * d + e]);
        const float plog = warp_sum(part);
        if (lane == 0) {
          const float active = s_nctx[s] > 0.f ? 1.f : 0.f;
          s_gpc[s] = (1.f - sigmoid_stable(plog)) * active * alpha;
          pos_acc += active * log_sigmoid(plog);
        }
      }
    }
    clk.mark(kPhaseLogits);

    // ---- the negative pool, piece by piece
    for (int q = 0; q < nK; ++q) {
      const int KPp = piece_len(KP, kKPc, q), j0 = q * kKPc;
      const bool last = q == nK - 1;
      const T* en = EN + (size_t)j0 * d;
      if (nK > 1) {
        __syncthreads();  // the previous piece is done with the ids
        load_negs(q);
        __syncthreads();
      }
      // negative weights (collision masks, pallas_band.py:144-154):
      // center_hit compares the raw, -1-padded center ids
      for (int i = tid; i < S * KPp; i += kThreads) {
        const int s = i / KPp, j = i - s * KPp;
        s_wn[i] = band.neg_weight<false, CBOW>(s, j);
      }
      __syncthreads();
      clk.mark(kPhaseMasks);

      // negative logits and gradient weights, one warp per (s, j)
      for (int r = warp; r < S * KPp; r += kWarps) {
        const int s = r / KPp, j = r - s * KPp;
        float part = 0.f;
        for (int e = lane; e < d; e += 32)
          part += h_val(s, e) * to_f(en[(size_t)j * d + e]);
        const float nlog = warp_sum(part);
        if (lane == 0) {
          const float wn = s_wn[r];
          s_gn[r] = (0.f - sigmoid_stable(nlog)) * wn * alpha;
          neg_acc += wn * (log_sigmoid(nlog) - nlog);
        }
      }
      __syncthreads();
      clk.mark(kPhaseLogits);

      // center-side rows: d_hid = gn @ en over the pieces, each value's
      // running sum kept in d_h (sg) or dh_ws (cbow) between pieces, then
      // the band product (sg); the center's out-row update and the hidden
      // grad (cbow)
      for (int i = tid; i < S * d; i += kThreads) {
        const int s = i / d, e = i - s * d;
        float* part = CBOW ? dh_ws + i : p.d_h + bc * S * d + i;
        float dh = q == 0 ? 0.f : *part;
        for (int j = 0; j < KPp; ++j)
          dh += s_gn[s * KPp + j] * to_f(en[(size_t)j * d + e]);
        if (!last) {
          *part = dh;
        } else if constexpr (!CBOW) {
          float dp = 0.f;
          for (int t = 0; t < NB; ++t) {
            const float g = s_gpb[s * NB + t];
            if (g != 0.f) dp += g * to_f(bk[(size_t)(s + t) * d + e]);
          }
          p.d_h[bc * S * d + i] = dh + dp;
        } else {
          const float gp = s_gpc[s];
          p.d_h[bc * S * d + i] = gp * h_ws[i];
          float dh2 = dh + gp * to_f(a[i]);
          // second divide (Word2Vec.cpp:313-315, pallas_band.py:184-185)
          if (p.cbow_mean) dh2 = dh2 / fmaxf(s_nctx[s], 1.f);
          dh_ws[i] = dh2;
        }
      }
      // d_neg: this chunk's contraction over its S positions, then added
      // to the sum over the earlier chunks by the same thread
      float* dneg = p.dneg_row + ((size_t)b * KP + j0) * d;
      for (int i = tid; i < KPp * d; i += kThreads) {
        const int j = i / d, e = i - j * d;
        float part = 0.f;
        for (int s = 0; s < S; ++s) part += s_gn[s * KPp + j] * h_val(s, e);
        dneg[i] = c == 0 ? part : dneg[i] + part;
      }
      float* wsum = p.wsum_row + (size_t)b * KP + j0;
      for (int j = tid; j < KPp; j += kThreads) {
        float part = 0.f;
        for (int s = 0; s < S; ++s) part += s_wn[s * KPp + j];
        wsum[j] = (c == 0 ? 0.f : wsum[j]) + part;
      }
      __syncthreads();
      clk.mark(kPhaseCenter);
    }

    // ---- slab-space context grads: slot k sums the centers s in
    // [k-2W, k] that see it (zero at invalid slots: their mask column is 0)
    for (int i = tid; i < SK * d; i += kThreads) {
      const int k = i / d, e = i - k * d;
      const int lo = max(0, k - 2 * W), hi = min(S - 1, k);
      float y = 0.f;
      for (int s = lo; s <= hi; ++s) {
        if constexpr (!CBOW) {
          const float g = s_gpb[s * NB + (k - s)];
          if (g != 0.f) y += g * to_f(a[(size_t)s * d + e]);
        } else {
          const float m = mask(s, k);
          if (m != 0.f) y += m * dh_ws[(size_t)s * d + e];
        }
      }
      p.d_ctx[bc * SK * d + i] = y;
    }
    __syncthreads();
    clk.mark(kPhaseContext);
  }
  block_losses(pos_acc, neg_acc, s_red, p.loss_part + (size_t)b * 2);
  clk.mark(kPhaseTail);
}

// shared memory of the tensor-core body, in bytes: the bf16 tiles
// (TileLayout, one piece) and then, in 4-byte words, in
// band_core_tc_kernel's order; nothing grows with KP or d past one piece
inline size_t band_tc_smem_bytes(int S, int SK, int KP, int d, int W) {
  const int NB = 2 * W + 1;
  const int KPc = KP < kKPc ? KP : kKPc;
  const size_t words = (size_t)S * 4          // tok_c, keep, w, n_ctx
                       + (size_t)SK * 2       // tok_k, cwy
                       + (size_t)KPc          // the piece's negative ids
                       + (size_t)S * NB       // band-compressed gp (sg)
                       + (size_t)S            // gp per center (cbow)
                       + (size_t)S * KPc      // w_neg of the piece
                       + (size_t)2 * kWarps;  // loss block reduction
  return TileLayout(S, KP, d).bf16_bytes() + words * sizeof(float);
}

// bf16 compute: the three dense products on the tensor cores, the
// negative pool in pieces of kKPc rows and the width in pieces of kDc
// columns (band_tiles.cuh says how the sums cross the pieces)
template <typename T, bool CBOW>
__global__ void __launch_bounds__(kThreads, 1)
    band_core_tc_kernel(const BandArgs p) {
  // read once a block: a captured graph replays the pointer, not a value
  const float alpha = *p.alpha;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = p.C, S = p.S, SK = p.SK, KP = p.KP, d = p.d, W = p.W;
  const int NB = 2 * W + 1;
  const int nK = pieces(KP, kKPc), nD = pieces(d, kDc);
  const int KPc = KP < kKPc ? KP : kKPc;
  const int nb = p.neg_shared ? 0 : b;
  const T* A = static_cast<const T*>(p.a);
  const T* BK = static_cast<const T*>(p.bk);
  const T* EN = static_cast<const T*>(p.en) + (size_t)nb * KP * d;
  const TileLayout tl(S, KP, d);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sE = sA + tl.a_elems();
  __nv_bfloat16* sG = sE + tl.e_elems();
  float* f = reinterpret_cast<float*>(sG + tl.g_elems());
  int* s_tokc = reinterpret_cast<int*>(f);
  float* s_keep = f + S;
  float* s_w = s_keep + S;
  float* s_nctx = s_w + S;
  int* s_tokk = reinterpret_cast<int*>(s_nctx + S);
  float* s_cwy = reinterpret_cast<float*>(s_tokk + SK);
  int* s_negs = reinterpret_cast<int*>(s_cwy + SK);
  float* s_gpb = reinterpret_cast<float*>(s_negs + KPc);
  float* s_gpc = s_gpb + (size_t)S * NB;
  float* s_wn = s_gpc + S;
  float* s_red = s_wn + (size_t)S * KPc;

  const Band band{s_tokc, s_keep, s_w, s_nctx, s_tokk, s_negs, S, W, p.K, KP};
  PhaseClock clk(p.phase_rec);
  float* h_ws = p.h_ws + (size_t)b * S * d;
  float* dh_ws = p.dh_ws + (size_t)b * S * d;
  const T* a = A;    // this chunk's center rows and slabs
  const T* bk = BK;
  auto a_row = [&](int s) { return a + (size_t)s * d; };
  auto bk_row = [&](int k) { return bk + (size_t)k * d; };

  // the pieces staged in the tiles: A's width piece, E's (r, q) as
  // r * nD + q (-1: none); every thread tracks them alike
  int a_at = -1, e_at = -1;
  auto stage_a = [&](int q) {
    const int dq = piece_len(d, kDc, q), off = q * kDc;
    if constexpr (CBOW) {
      stage_rows(sA, tl.lda, tl.SP, round_up(dq, kMmaK), S, dq,
                 [&](int s) { return h_ws + (size_t)s * d + off; });
    } else {
      stage_rows(sA, tl.lda, tl.SP, round_up(dq, kMmaK), S, dq,
                 [&](int s) { return a_row(s) + off; });
    }
    a_at = q;
  };
  auto stage_e = [&](int r, int q) {
    const int KPp = piece_len(KP, kKPc, r), dq = piece_len(d, kDc, q);
    stage_rows(sE, tl.lda, round_up(KPp, 2 * kMmaN), round_up(dq, kMmaK), KPp, dq,
               [&](int j) { return EN + (size_t)(r * kKPc + j) * d + q * kDc; });
    e_at = r * nD + q;
  };
  // piece q of A (and piece (r, q) of E unless r < 0) in the tiles
  auto load = [&](int r, int q) {
    const bool na = a_at != q, ne = r >= 0 && e_at != r * nD + q;
    if (!na && !ne) return;
    __syncthreads();  // everyone is done with the tiles
    if (na) stage_a(q);
    if (ne) stage_e(r, q);
    __syncthreads();
  };
  auto load_negs = [&](int r) {
    for (int j = tid; j < piece_len(KP, kKPc, r); j += kThreads)
      s_negs[j] = p.negs[(size_t)nb * KP + r * kKPc + j];
  };

  float pos_acc = 0.f;  // sum of mask * log_sigmoid(plog)
  float neg_acc = 0.f;  // sum of w_neg * (log_sigmoid(nlog) - nlog)

  // once per row: the first negative piece, bf16 in E (the only one when
  // the pool and the row are one piece each)
  load_negs(0);
  stage_e(0, 0);

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // the previous chunk is done with the tiles
    const size_t bc = (size_t)b * C + c;
    a = A + bc * S * d;
    bk = BK + bc * SK * d;
    for (int s = tid; s < S; s += kThreads) {
      s_tokc[s] = p.tok_c[bc * S + s];
      s_keep[s] = p.keep_c[bc * S + s];
      s_w[s] = p.w_c[bc * S + s];
    }
    for (int k = tid; k < SK; k += kThreads) s_tokk[k] = p.tok_k[bc * SK + k];
    // sg: A holds the center rows (the first width piece); cbow: zeros
    // that the projection fills
    stage_rows(sA, tl.lda, tl.SP, round_up(piece_len(d, kDc, 0), kMmaK),
               CBOW ? 0 : S, piece_len(d, kDc, 0), a_row);
    a_at = CBOW ? -1 : 0;
    __syncthreads();
    clk.mark(kPhaseRows);

    // ---- mask row sums (n_ctx) and slab column sums (ctx_w): 0/1 sums,
    // exact in any order
    for (int s = tid; s < S; s += kThreads) {
      const float n = band.row_sum(s);
      s_nctx[s] = n;
      p.n_ctx[bc * S + s] = n;
    }
    for (int k = tid; k < SK; k += kThreads) {
      const float cw = band.col_sum(k);
      s_cwy[k] = cw;
      p.ctx_w[bc * SK + k] = cw;
    }
    __syncthreads();
    if constexpr (CBOW) {
      projection(band, tl, d, p.cbow_mean != 0, h_ws, sA, bk_row);
      if (nD == 1) a_at = 0;
      __syncthreads();
    }
    clk.mark(kPhaseMasks);

    float* dh_out = p.d_h + bc * S * d;
    float* dctx = p.d_ctx + bc * SK * d;
    for (int r = 0; r < nK; ++r) {
      const int KPp = piece_len(KP, kKPc, r), KPPp = round_up(KPp, 2 * kMmaN);
      const int j0 = r * kKPc;
      const bool last = r == nK - 1;
      if (nK > 1) {
        __syncthreads();  // the previous piece is done with the ids
        load_negs(r);
        __syncthreads();
      }
      // ---- negative weights (collision masks, pallas_band.py:144-154):
      // center_hit compares the raw, -1-padded center ids
      for (int i = tid; i < S * KPp; i += kThreads) {
        const int s = i / KPp, j = i - s * KPp;
        s_wn[i] = band.neg_weight<true, CBOW>(s, j);
      }
      __syncthreads();
      clk.mark(kPhaseMasks);

      // ---- positive logits: the sg band (tensor cores) or the cbow
      // center, beside the first piece's negative logits (they overlap
      // better there than beside the weights: 1.3% on the flagship, where
      // grad_core measured the other way; PERF.md §6 PR 19)
      if (r == 0) {
        if constexpr (!CBOW) {
          pos_acc += band_logits(band, tl, sA, d, alpha, s_gpb,
                                 [&](int q) { load(-1, q); }, bk_row);
        } else {
          pos_acc += center_logits(band, h_ws, d, alpha, s_gpc, a_row);
        }
      }
      // ---- negative logits and weights (tensor cores), over the width
      neg_acc += neg_logits(tl, d, [&](int q) { load(r, q); }, sA, sE, sG, s_wn,
                            S, KPp, alpha);
      __syncthreads();
      clk.mark(kPhaseLogits);
      // ---- w_neg_sum: this chunk's sum, added to the earlier chunks' by
      // the thread that owns the output
      float* wsum = p.wsum_row + (size_t)b * KP + j0;
      for (int j = tid; j < KPp; j += kThreads) {
        float part = 0.f;
        for (int s = 0; s < S; ++s) part += s_wn[s * KPp + j];
        wsum[j] = (c == 0 ? 0.f : wsum[j]) + part;
      }

      for (int q = 0; q < nD; ++q) {
        const int dq = piece_len(d, kDc, q), DPq = round_up(dq, kMmaK);
        const int off = q * kDc;
        load(r, q);
        // ---- d_neg: this chunk's contraction over its S positions (tensor
        // cores), then added to the sum over the earlier chunks by the
        // thread that owns the output
        float* dneg = p.dneg_row + ((size_t)b * KP + j0) * d + off;
        tile_pass<true, true>(KPPp, DPq, tl.SP, tl.SP, sG, tl.ldg, sA, tl.lda,
                              [&](int j, const int (&col)[4], const float (&v)[4]) {
                                add_row(dneg, d, dq, j, KPp, col, v, c > 0);
                              });
        __syncthreads();
        clk.mark(kPhaseNeg);

        // ---- center-side rows: d_hid = gn @ en (tensor cores), its
        // running sum over the pieces in d_h (sg) or dh_ws (cbow); after
        // the last piece the band product (sg) or the center's out-row
        // update and d_hid2 (cbow, into A)
        float* part = (CBOW ? dh_ws : dh_out) + off;
        auto partial = [&](int s, int e) -> float {
          return (s < S && e < dq) ? part[(size_t)s * d + e] : 0.f;
        };
        auto w = [&](int s, int k) -> float {
          return (s < S && k - s >= 0 && k - s < NB) ? s_gpb[s * NB + (k - s)] : 0.f;
        };
        block_pass(
            tl.SP, DPq,
            [&](float (&acc)[2][4], int m0, int n0) {
              if (r > 0) load_block(acc, m0, n0, partial);
              warp_mma_16x16<false, true>(acc, sG, tl.ldg, m0, sE, tl.lda, n0,
                                          KPPp, KPPp);
              if (!CBOW && last)
                band_rows_mma(acc, m0, n0, 2 * W, SK, dq, w,
                              [&](int k) { return bk_row(k) + off; });
            },
            [&](int s, const int (&col)[4], const float (&v)[4]) {
              if (s >= S) return;
              if (CBOW && last) {
                cbow_center_row(s, col, v, s_gpc[s], p.cbow_mean != 0, s_nctx[s],
                                a_row(s) + off, h_ws + off, dh_out + off, d, dq,
                                sA, tl.lda);
                return;
              }
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (col[u] < dq) part[(size_t)s * d + col[u]] = v[u];
            });
        if (CBOW && last) a_at = -1;  // A holds d_hid2 now
        __syncthreads();
        clk.mark(kPhaseCenter);
        if (!last) continue;

        // ---- slab-space context grads: slot k sums the centers s in
        // [k-2W, k] that see it (zero at invalid slots: their mask column is 0)
        context_tiles<CBOW>(band, s_gpb, sA, tl.lda, SK, DPq,
                            [&](int k, const int (&col)[4], const float (&y)[4]) {
#pragma unroll
                              for (int v = 0; v < 4; ++v)
                                if (k < SK && col[v] < dq)
                                  dctx[(size_t)k * d + off + col[v]] = y[v];
                            });
        __syncthreads();
        clk.mark(kPhaseContext);
      }
    }
  }
  block_losses(pos_acc, neg_acc, s_red, p.loss_part + (size_t)b * 2);
  clk.mark(kPhaseTail);
}

// out[i] = sum over rows b = 0..B-1 of part[b, i], in row order
__global__ void rows_reduce_kernel(const float* part, float* out, int B,
                                   int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int b = 0; b < B; ++b) acc += part[(size_t)b * n + i];
  out[i] = acc;
}

template <typename T, bool CBOW>
cudaError_t launch_band(const BandArgs& p, int B, size_t smem, bool tc,
                        cudaStream_t st) {
  auto kern = tc ? &band_core_tc_kernel<T, CBOW> : &band_core_f32_kernel<T, CBOW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_band_model(const BandArgs& p, int B, size_t smem, bool tc,
                              cudaStream_t st, int is_cbow) {
  return is_cbow ? launch_band<T, true>(p, B, smem, tc, st)
                 : launch_band<T, false>(p, B, smem, tc, st);
}

// resident blocks a SM of the body a launch at this shared memory runs
template <typename T, bool CBOW>
cudaError_t band_occupancy(int* n, size_t smem, bool tc) {
  auto kern = tc ? &band_core_tc_kernel<T, CBOW> : &band_core_f32_kernel<T, CBOW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, kThreads, smem);
}

cudaError_t reduce_rows(const float* part, float* out, int B, int n,
                        cudaStream_t st) {
  rows_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 compute runs the tensor-core body, f32 compute the f32 one
size_t w2v_band_core_smem_bytes(int S, int SK, int KP, int d, int W,
                                int cdt_bf16) {
  return cdt_bf16 ? band_tc_smem_bytes(S, SK, KP, d, W)
                  : band_smem_words(S, SK, KP, W) * sizeof(float);
}

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blocks of band_core resident on one SM at this shape (the occupancy
// calculator's answer), or minus the CUDA error
int w2v_band_core_blocks_per_sm(int S, int SK, int KP, int d, int W,
                                int table_bf16, int cdt_bf16, int is_cbow) {
  const size_t smem = w2v_band_core_smem_bytes(S, SK, KP, d, W, cdt_bf16);
  const bool tc = cdt_bf16 != 0;
  int n = 0;
  cudaError_t err;
  if (table_bf16) {
    err = is_cbow ? band_occupancy<__nv_bfloat16, true>(&n, smem, tc)
                  : band_occupancy<__nv_bfloat16, false>(&n, smem, tc);
  } else {
    err = is_cbow ? band_occupancy<float, true>(&n, smem, tc)
                  : band_occupancy<float, false>(&n, smem, tc);
  }
  return err == cudaSuccess ? n : -(int)err;
}

// Row scope (neg_shared = 0): dneg_row/wsum_row are the d_neg [B, KP, d]
// and w_neg_sum [B, KP] outputs. Batch scope: they are per-row partials,
// reduced in row order into d_neg [1, KP, d] and w_neg_sum [1, KP].
int w2v_band_core(const void* a, const void* bk, const void* en,
                  int table_bf16, const int* tok_c, const int* tok_k,
                  const float* keep_c, const float* w_c, const int* negs,
                  const float* alpha, float* d_h, float* d_ctx, float* n_ctx,
                  float* ctx_w, float* dneg_row, float* wsum_row,
                  float* d_neg, float* w_neg_sum, float* loss_part,
                  float* losses, float* h_ws, float* dh_ws, int B, int C,
                  int S, int SK, int KP, int d, int W, int K, int neg_shared,
                  int cdt_bf16, int is_cbow, int cbow_mean,
                  long long* phase_rec, void* stream) {
  BandArgs p{a,        bk,        en,     tok_c,    tok_k,     keep_c,
             w_c,      negs,      alpha,  d_h,      d_ctx,     n_ctx,
             ctx_w,    dneg_row,  wsum_row, loss_part, h_ws,    dh_ws,
             C,        S,         SK,     KP,       d,         W,
             K,        neg_shared, cbow_mean, phase_rec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = w2v_band_core_smem_bytes(S, SK, KP, d, W, cdt_bf16);
  const bool tc = cdt_bf16 != 0;
  cudaError_t err =
      table_bf16 ? launch_band_model<__nv_bfloat16>(p, B, smem, tc, st, is_cbow)
                 : launch_band_model<float>(p, B, smem, tc, st, is_cbow);
  if (err != cudaSuccess) return (int)err;
  if (neg_shared) {
    err = reduce_rows(dneg_row, d_neg, B, KP * d, st);
    if (err != cudaSuccess) return (int)err;
    err = reduce_rows(wsum_row, w_neg_sum, B, KP, st);
    if (err != cudaSuccess) return (int)err;
  }
  err = reduce_rows(loss_part, losses, B, 2, st);
  return (int)err;
}

}  // extern "C"
