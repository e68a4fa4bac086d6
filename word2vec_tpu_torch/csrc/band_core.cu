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
// kSc = 128 centers, kKPc = 64 negative rows and kDc = 304 columns at a
// time:
//   A [SP x lda]   the center rows a (sg) or the cbow projection h,
//                  zero-padded to SP = 128 x 304 (+8 columns: ldmatrix
//                  rows on distinct banks)   128 x 312 x 2 B = 79,872 B
//   E [KPP x lda]  the negative rows (once per row in one piece)
//                                           64 x 312 x 2 B = 39,936 B
//   G [SP x ldg]   gn = -sigmoid(nlog) w_neg alpha    128 x 72 x 2 B  = 18,432 B
//   f32: ids and gates, the band-compressed gp [S x 2W+1], w_neg [S x KPc]
//   (30,208 B), ...                         total at the flagship 177,408 B
// and never more than 225,152 B, at any S, KP, d or W (past kKc = 160
// slab slots a center piece, one slot piece of gp, bf16, at a time): the
// flagship is one piece of each, and a longer chunk, a wider pool or row
// is walked piece by piece (band_tiles.cuh states the order of every sum
// that crosses pieces: that of one unpieced product; the slab slots two
// center pieces share continue their sums in the output rows).
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
// through L1/L2), the chunk in center pieces of kSc, the negative pool
// in pieces of kKPc and a center piece's band weights in slot pieces of
// kKc (at most 158,592 B a block). Both bodies take an optional per-phase
// clock64() record (PhaseClock). The pieces bound a block's shared memory
// at every shape the JAX kernels take; a wider window costs time.
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
  float* dneg_ws;        // [B, KP, d] S > kSc only: a chunk's d_neg so far
  float* wsum_ws;        // [B, KP] S > kSc only: a chunk's w_neg_sum so far
  int C, S, SK, KP, d, W, K, neg_shared, cbow_mean;
  long long* phase_rec;  // null, or [B, kPhases] cycles (PhaseClock)
};

// shared memory of the f32-compute body, in 4-byte words, in
// band_core_f32_kernel's order: one center piece (at most kSc) and one
// negative piece (at most kKPc rows) at a time, and the band weights gp of
// one slot piece, band-compressed [Sc x 2W+1] when a center piece's slots
// fit one (Sc + 2W <= kKc), else [Sc x kKc]: nothing that grows with S,
// KP, d or W past them
inline size_t band_smem_words(int S, int KP, int W) {
  const int Sc = S < kSc ? S : kSc;
  const int KPc = KP < kKPc ? KP : kKPc;
  const int gld = Sc + 2 * W <= kKc ? 2 * W + 1 : kKc;
  return (size_t)Sc * 4          // tok_c, keep, w, n_ctx
         + (size_t)kTokRoom      // the staged slab ids
         + (size_t)KPc           // the piece's negative ids
         + (size_t)Sc * gld      // gp (sg) of the slot piece
         + (size_t)Sc            // gp per center (cbow)
         + (size_t)Sc * KPc * 2  // gn, w_neg of the piece
         + (size_t)2 * kWarps;   // loss block reduction
}

// A chunk's sum over its positions that crosses center pieces (d_neg,
// w_neg_sum): the piece's part `v` continues the chunk's sum so far (in
// the workspace `part` after the first piece), goes back there while a
// piece follows, and after the last one is added to the earlier chunks'
// sum in the output (c > 0) by the thread that owns the value
__device__ __forceinline__ float chunk_sum_in(const float* part, size_t x,
                                              int i) {
  return i > 0 ? part[x] : 0.f;
}
__device__ __forceinline__ void chunk_sum_out(float* out, float* part,
                                              size_t x, float v, int c,
                                              bool more) {
  if (more) {
    part[x] = v;
  } else {
    out[x] = c == 0 ? v : out[x] + v;
  }
}

// slab column sums (ctx_w) of the piece's slots into the chunk's slab row:
// a slot an earlier piece reached too adds its part (0/1 sums: exact)
__device__ __forceinline__ void slab_cw(float* ctx_w, int k, float cw,
                                        bool cont) {
  ctx_w[k] = cont ? ctx_w[k] + cw : cw;
}

// f32 compute: exact f32 products on the CUDA cores (the staged f32 tiles
// would not fit), the design of the first port; the negative rows are read
// through L1/L2, the chunk walked in center pieces of kSc, the negative
// pool in pieces of kKPc and a center piece's slots, for the sg band
// weights, in slot pieces of kKc (one band-compressed piece when they fit:
// Sc + 2W <= kKc), as grad_core_f32_kernel
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
  const int W2 = 2 * W;
  const int KPc = KP < kKPc ? KP : kKPc, nK = pieces(KP, kKPc);
  const int Sc = S < kSc ? S : kSc, nS = pieces(S, kSc);
  // gp's row stride: band-compressed in one slot piece, else by slot
  const bool slotted = Sc + W2 > kKc;
  const int gld = slotted ? kKc : W2 + 1;
  const int nb = p.neg_shared ? 0 : b;
  const T* A = static_cast<const T*>(p.a);
  const T* BK = static_cast<const T*>(p.bk);
  const T* EN = static_cast<const T*>(p.en) + (size_t)nb * KP * d;

  extern __shared__ float smem[];
  int* s_tokc = reinterpret_cast<int*>(smem);
  float* s_keep = smem + Sc;
  float* s_w = s_keep + Sc;
  float* s_nctx = s_w + Sc;
  int* s_tokk = reinterpret_cast<int*>(s_nctx + Sc);
  int* s_negs = s_tokk + kTokRoom;
  float* s_gpb = reinterpret_cast<float*>(s_negs + KPc);
  float* s_gpc = s_gpb + (size_t)Sc * gld;
  float* s_gn = s_gpc + Sc;
  float* s_wn = s_gn + (size_t)Sc * KPc;
  float* s_red = s_wn + (size_t)Sc * KPc;

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
    const size_t bc = (size_t)b * C + c;
    for (int i = 0; i < nS; ++i) {
      // center piece i: centers [s0, s0 + Sp) and their slots [s0, s0 + SKp)
      const int s0 = i * kSc, Sp = piece_len(S, kSc, i), SKp = Sp + W2;
      const bool more = i + 1 < nS;
      const size_t cs = bc * S + s0, ck = bc * SK + s0;
      const T* a = A + cs * d;
      const T* bk = BK + ck * d;
      float* hp = h_ws + (size_t)s0 * d;
      float* dhp = dh_ws + (size_t)s0 * d;
      float* dh_out = p.d_h + cs * d;
      float* dctx = p.d_ctx + ck * d;
      auto h_val = [&](int s, int e) -> float {
        if constexpr (CBOW) {
          return hp[(size_t)s * d + e];
        } else {
          return to_f(a[(size_t)s * d + e]);
        }
      };
      __syncthreads();  // the previous piece is done with shared memory
      for (int s = tid; s < Sp; s += kThreads) {
        s_tokc[s] = p.tok_c[cs + s];
        s_keep[s] = p.keep_c[cs + s];
        s_w[s] = p.w_c[cs + s];
      }
      // the slab ids: staged while they fit kTokRoom, else in device memory
      const int* tokk = p.tok_k + ck;
      if (SKp <= kTokRoom) {
        for (int k = tid; k < SKp; k += kThreads) s_tokk[k] = tokk[k];
        tokk = s_tokk;
      }
      __syncthreads();
      clk.mark(kPhaseRows);
      // the band mask (pallas_band.py:113-122): keep_s & valid_k & 0 < dist <= w_s
      const Band band{s_tokc, s_keep, s_w, s_nctx, tokk, s_negs, Sp, W, p.K, KP};

      // ---- mask row sums (n_ctx) and slab column sums (ctx_w): 0/1 sums,
      // exact in any order
      row_sums(band, s_nctx, p.n_ctx + cs);
      for (int k = tid; k < SKp; k += kThreads)
        slab_cw(p.ctx_w + ck, k, band.col_sum(k), i > 0 && k < W2);
      __syncthreads();
      if constexpr (CBOW) {
        // projection h = mask @ bk (divided by n_ctx under cbow_mean)
        for (int x = tid; x < Sp * d; x += kThreads) {
          const int s = x / d, e = x - s * d;
          float acc = 0.f;
          for (int k = s; k <= s + W2; ++k) {
            const float m = band.mask(s, k);
            if (m != 0.f) acc += m * to_f(bk[(size_t)k * d + e]);
          }
          if (p.cbow_mean) acc = acc / fmaxf(s_nctx[s], 1.f);
          hp[x] = acc;
        }
        __syncthreads();
      }
      clk.mark(kPhaseMasks);

      if constexpr (CBOW) {
        // center logit: f32 multiply and row sum of cdt-rounded h and a
        for (int s = warp; s < Sp; s += kWarps) {
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
        neg_weights_mma<CBOW>(band, KPp, s_wn);
        __syncthreads();
        clk.mark(kPhaseMasks);

        // negative logits and gradient weights, one warp per (s, j)
        for (int r = warp; r < Sp * KPp; r += kWarps) {
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
        // running sum kept in d_h (sg, where the band product then adds to
        // it) or dh_ws (cbow); after the last piece the center's out-row
        // update and the hidden grad (cbow)
        for (int x = tid; x < Sp * d; x += kThreads) {
          const int s = x / d, e = x - s * d;
          float* part = CBOW ? dhp + x : dh_out + x;
          float dh = q == 0 ? 0.f : *part;
          for (int j = 0; j < KPp; ++j)
            dh += s_gn[s * KPp + j] * to_f(en[(size_t)j * d + e]);
          if (!CBOW || !last) {
            *part = dh;
          } else {
            const float gp = s_gpc[s];
            dh_out[x] = gp * hp[x];
            float dh2 = dh + gp * to_f(a[x]);
            // second divide (Word2Vec.cpp:313-315, pallas_band.py:184-185)
            if (p.cbow_mean) dh2 = dh2 / fmaxf(s_nctx[s], 1.f);
            dhp[x] = dh2;
          }
        }
        // d_neg: this chunk's contraction over its S positions (continued
        // from the previous piece), then added to the sum over the earlier
        // chunks by the same thread
        const size_t n0 = ((size_t)b * KP + j0) * d;
        for (int x = tid; x < KPp * d; x += kThreads) {
          const int j = x / d, e = x - j * d;
          float part = chunk_sum_in(p.dneg_ws, n0 + x, i);
          for (int s = 0; s < Sp; ++s) part += s_gn[s * KPp + j] * h_val(s, e);
          chunk_sum_out(p.dneg_row, p.dneg_ws, n0 + x, part, c, more);
        }
        const size_t w0 = (size_t)b * KP + j0;
        for (int j = tid; j < KPp; j += kThreads) {
          float part = chunk_sum_in(p.wsum_ws, w0 + j, i);
          for (int s = 0; s < Sp; ++s) part += s_wn[s * KPp + j];
          chunk_sum_out(p.wsum_row, p.wsum_ws, w0 + j, part, c, more);
        }
        __syncthreads();
        clk.mark(kPhaseCenter);
      }

      // ---- slab-space context grads: slot k sums the centers s in
      // [k-2W, k] that see it, in order (zero at invalid slots: their mask
      // column is 0), continued from the previous piece's part in the
      // output row; sg slot piece by slot piece, after its band logits and
      // band product
      auto carried = [&](int k, int e) -> float {
        return (i > 0 && k < W2) ? dctx[(size_t)k * d + e] : 0.f;
      };
      if constexpr (!CBOW) {
        for (int j = 0; j < pieces(SKp, kKc); ++j) {
          const int k0 = j * kKc, Kj = piece_len(SKp, kKc, j);
          auto gp = [&](int s, int k) -> float {
            return s_gpb[s * gld + (slotted ? k - k0 : k - s)];
          };
          // band logits, one warp per (s, slot) of the band
          const int ncol = slotted ? Kj : W2 + 1;
          for (int x = warp; x < Sp * ncol; x += kWarps) {
            const int s = x / ncol, col = x - s * ncol;
            const int k = slotted ? k0 + col : s + col;
            if (k < s || k > s + W2) continue;
            const float m = band.mask(s, k);
            if (m == 0.f) {
              if (lane == 0) s_gpb[s * gld + col] = 0.f;
              continue;
            }
            float part = 0.f;
            for (int e = lane; e < d; e += 32)
              part += to_f(a[(size_t)s * d + e]) * to_f(bk[(size_t)k * d + e]);
            const float plog = warp_sum(part);
            if (lane == 0) {
              s_gpb[s * gld + col] = (1.f - sigmoid_stable(plog)) * m * alpha;
              pos_acc += m * log_sigmoid(plog);
            }
          }
          __syncthreads();
          // the band product of the slot piece, added to d_hid
          for (int x = tid; x < Sp * d; x += kThreads) {
            const int s = x / d, e = x - s * d;
            const int k_hi = min(s + W2, k0 + Kj - 1);
            float dp = 0.f;
            for (int k = max(s, k0); k <= k_hi; ++k) {
              const float g = gp(s, k);
              if (g != 0.f) dp += g * to_f(bk[(size_t)k * d + e]);
            }
            dh_out[x] = dh_out[x] + dp;
          }
          // the context sums of the slot piece's slots
          for (int x = tid; x < Kj * d; x += kThreads) {
            const int k = k0 + x / d, e = x % d;
            const int lo = max(0, k - W2), hi = min(Sp - 1, k);
            float y = carried(k, e);
            for (int s = lo; s <= hi; ++s) {
              const float g = gp(s, k);
              if (g != 0.f) y += g * to_f(a[(size_t)s * d + e]);
            }
            dctx[(size_t)k * d + e] = y;
          }
          __syncthreads();
        }
      } else {
        for (int x = tid; x < SKp * d; x += kThreads) {
          const int k = x / d, e = x - k * d;
          const int lo = max(0, k - W2), hi = min(Sp - 1, k);
          float y = carried(k, e);
          for (int s = lo; s <= hi; ++s) {
            const float m = band.mask(s, k);
            if (m != 0.f) y += m * dhp[(size_t)s * d + e];
          }
          dctx[(size_t)k * d + e] = y;
        }
      }
      __syncthreads();
      clk.mark(kPhaseContext);
    }
  }
  block_losses(pos_acc, neg_acc, s_red, p.loss_part + (size_t)b * 2);
  clk.mark(kPhaseTail);
}

// shared memory of the tensor-core body, in bytes: a chunk of one piece,
// the bf16 tiles (TileLayout) and then, in 4-byte words, in
// band_core_tc_kernel's order; a pieced chunk (chunk_pieced), the layout
// of band_tiles.cuh's pieced_tc_smem_bytes, which no W changes
inline size_t band_tc_smem_bytes(int S, int KP, int d, int W) {
  if (chunk_pieced(S, W)) return pieced_tc_smem_bytes(S, KP, d);
  const int NB = 2 * W + 1;
  const int Sc = S < kSc ? S : kSc, SKc = Sc + 2 * W;
  const int KPc = KP < kKPc ? KP : kKPc;
  const size_t words = (size_t)Sc * 4          // tok_c, keep, w, n_ctx
                       + (size_t)SKc * 2       // tok_k, cwy
                       + (size_t)KPc           // the piece's negative ids
                       + (size_t)Sc * NB       // band-compressed gp (sg)
                       + (size_t)Sc            // gp per center (cbow)
                       + (size_t)Sc * KPc      // w_neg of the piece
                       + (size_t)2 * kWarps;   // loss block reduction
  return TileLayout(S, KP, d).bf16_bytes() + words * sizeof(float);
}

// bf16 compute: the three dense products on the tensor cores, the chunk
// in center pieces of kSc, the negative pool in pieces of kKPc rows, the
// width in pieces of kDc columns and a center piece's slots in slot pieces
// of kKc (band_tiles.cuh says how the sums cross the pieces); PIECED:
// chunk_pieced(S, W). A chunk of one piece runs an instantiation without
// the pieces' carries: with them compiled in, the one-piece shapes read
// 5-19% slower (PERF.md §6). The pieced one stages the slab ids in a fixed
// room (past it, reads them from device memory), counts the collisions on
// the tensor cores (neg_weights_mma),
// and walks the sg band (its logits, the band product into d_hid, the
// context sums) slot piece by slot piece: slot piece 0 where one piece
// runs its band, the later ones after the negatives, each in the row
// blocks whose band reaches it
template <typename T, bool CBOW, bool PIECED>
__global__ void __launch_bounds__(kThreads, 1)
    band_core_tc_kernel(const BandArgs p) {
  // read once a block: a captured graph replays the pointer, not a value
  const float alpha = *p.alpha;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = p.C, S = p.S, SK = p.SK, KP = p.KP, d = p.d, W = p.W;
  const int NB = 2 * W + 1;
  const int nK = pieces(KP, kKPc), nD = pieces(d, kDc);
  const int nS = PIECED ? pieces(S, kSc) : 1;  // one piece: no carry is compiled
  const int KPc = KP < kKPc ? KP : kKPc;
  const int Sc = S < kSc ? S : kSc, SKc = Sc + 2 * W;
  const int nb = p.neg_shared ? 0 : b;
  const T* A = static_cast<const T*>(p.a);
  const T* BK = static_cast<const T*>(p.bk);
  const T* EN = static_cast<const T*>(p.en) + (size_t)nb * KP * d;
  const TileLayout tl(S, KP, d);  // the room: one piece of each

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sE = sA + tl.a_elems();
  __nv_bfloat16* sG = sE + tl.e_elems();
  // pieced: one slot piece of the sg band weights, bf16 [SP x kGpLd]
  __nv_bfloat16* s_gps = sG + tl.g_elems();
  float* f = reinterpret_cast<float*>(s_gps + (PIECED ? (size_t)tl.SP * kGpLd : 0));
  int* s_tokc = reinterpret_cast<int*>(f);
  float* s_keep = f + Sc;
  float* s_w = s_keep + Sc;
  float* s_nctx = s_w + Sc;
  // one piece: the slab ids and column sums and the band-compressed gp in
  // shared memory (pieced: the slab ids' fixed room, neither of the rest)
  int* s_tokk = reinterpret_cast<int*>(s_nctx + Sc);
  float* s_cwy = reinterpret_cast<float*>(s_tokk + (PIECED ? kTokRoom : SKc));
  int* s_negs = reinterpret_cast<int*>(s_cwy + (PIECED ? 0 : SKc));
  float* s_gpb = reinterpret_cast<float*>(s_negs + KPc);
  float* s_gpc = s_gpb + (PIECED ? 0 : (size_t)Sc * NB);
  float* s_wn = s_gpc + Sc;
  float* s_red = s_wn + (size_t)Sc * KPc;

  PhaseClock clk(p.phase_rec);
  float* h_ws = p.h_ws + (size_t)b * S * d;
  float* dh_ws = p.dh_ws + (size_t)b * S * d;
  // the center piece in hand: its center rows and slabs, its rows of the
  // cbow workspaces (by position in the chunk), its extent in the tiles
  const T* a = A;
  const T* bk = BK;
  float* hp = h_ws;
  int Sp = Sc, SPp = tl.SP;
  auto a_row = [&](int s) { return a + (size_t)s * d; };
  auto bk_row = [&](int k) { return bk + (size_t)k * d; };

  // the pieces staged in the tiles: A's width piece, E's (r, q) as
  // r * nD + q (-1: none); every thread tracks them alike
  int a_at = -1, e_at = -1;
  auto stage_a = [&](int q) {
    const int dq = piece_len(d, kDc, q), off = q * kDc;
    if constexpr (CBOW) {
      stage_rows(sA, tl.lda, SPp, round_up(dq, kMmaK), Sp, dq,
                 [&](int s) { return hp + (size_t)s * d + off; });
    } else {
      stage_rows(sA, tl.lda, SPp, round_up(dq, kMmaK), Sp, dq,
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
    const size_t bc = (size_t)b * C + c;
    float* dctx = p.d_ctx + bc * SK * d;  // the chunk's slab rows
    for (int i = 0; i < nS; ++i) {
      // center piece i: centers [s0, s0 + Sp) and their slots [s0, s0 + SKp)
      const int s0 = i * kSc;
      Sp = piece_len(S, kSc, i);
      SPp = round_up(Sp, kMmaM);
      const int SKp = Sp + 2 * W;
      const bool more = i + 1 < nS;
      const TileLayout tp(Sp, KP, d);  // the piece's extent, tl's strides
      const size_t cs = bc * S + s0, ck = bc * SK + s0;
      a = A + cs * d;
      bk = BK + ck * d;
      hp = h_ws + (size_t)s0 * d;
      float* dhp = dh_ws + (size_t)s0 * d;
      __syncthreads();  // the previous piece is done with the tiles
      for (int s = tid; s < Sp; s += kThreads) {
        s_tokc[s] = p.tok_c[cs + s];
        s_keep[s] = p.keep_c[cs + s];
        s_w[s] = p.w_c[cs + s];
      }
      // the slab ids (pieced: staged while they fit kTokRoom, else read
      // from device memory)
      const int* tokk = p.tok_k + ck;
      if (!PIECED || SKp <= kTokRoom) {
        for (int k = tid; k < SKp; k += kThreads) s_tokk[k] = tokk[k];
        tokk = s_tokk;
      }
      // sg: A holds the center rows (the first width piece); cbow: zeros
      // that the projection fills
      stage_rows(sA, tl.lda, SPp, round_up(piece_len(d, kDc, 0), kMmaK),
                 CBOW ? 0 : Sp, piece_len(d, kDc, 0), a_row);
      a_at = CBOW ? -1 : 0;
      __syncthreads();
      clk.mark(kPhaseRows);
      const Band band{s_tokc, s_keep, s_w, s_nctx, PIECED ? tokk : s_tokk,
                      s_negs, Sp, W, p.K, KP};

      // ---- mask row sums (n_ctx) and slab column sums (ctx_w): 0/1 sums,
      // exact in any order
      if constexpr (PIECED) {
        row_sums(band, s_nctx, p.n_ctx + cs);
        for (int k = tid; k < SKp; k += kThreads)
          slab_cw(p.ctx_w + ck, k, band.col_sum(k), i > 0 && k < 2 * W);
      } else {
        for (int s = tid; s < Sp; s += kThreads) {
          const float n = band.row_sum(s);
          s_nctx[s] = n;
          p.n_ctx[cs + s] = n;
        }
        for (int k = tid; k < SKp; k += kThreads) {
          const float cw = band.col_sum(k);
          s_cwy[k] = cw;
          slab_cw(p.ctx_w + ck, k, cw, i > 0 && k < 2 * W);
        }
      }
      __syncthreads();
      if constexpr (CBOW) {
        projection<PIECED>(band, tp, d, p.cbow_mean != 0, hp, sA, bk_row);
        if (nD == 1) a_at = 0;
        __syncthreads();
      }
      clk.mark(kPhaseMasks);

      // ---- slab-space context grads: slot k sums the centers s in
      // [k-2W, k] that see it (zero at invalid slots: their mask column
      // is 0); a slot the previous piece reached continues its
      // accumulator from the output row; over slot rows [k_lo, k_hi),
      // width piece q
      auto context = [&](auto&& wv, int k_lo, int k_hi, int q) {
        const int dq = piece_len(d, kDc, q), off = q * kDc;
        context_tiles<PIECED>(
            band, wv, sA, tl.lda, k_lo, k_hi, round_up(dq, kMmaK),
            [&](float (&acc)[2][4], int m0, int n0) {
              if (i > 0 && m0 < 2 * W)
                load_block(acc, m0, n0, [&](int k, int e) -> float {
                  return (s0 + k < SK && e < dq)
                             ? dctx[(size_t)(s0 + k) * d + off + e]
                             : 0.f;
                });
            },
            [&](int k, const int (&col)[4], const float (&y)[4]) {
#pragma unroll
              for (int v = 0; v < 4; ++v)
                if (s0 + k < SK && col[v] < dq)
                  dctx[(size_t)(s0 + k) * d + off + col[v]] = y[v];
            });
      };

      float* dh_out = p.d_h + cs * d;
      const int K0 = min(SKp, kKc);  // pieced: the end of slot piece 0
      // pieced: gp of slot piece j (slots from k0), in the band of s
      auto gp_at = [&](int k0) {
        return [&, k0](int s, int k) -> float {
          return __bfloat162float(s_gps[(size_t)s * kGpLd + (k - k0)]);
        };
      };
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
        if constexpr (PIECED) {
          neg_weights_mma<CBOW>(band, KPp, s_wn);
        } else {
          for (int x = tid; x < Sp * KPp; x += kThreads) {
            const int s = x / KPp, j = x - s * KPp;
            s_wn[x] = band.neg_weight<true, CBOW>(s, j);
          }
        }
        __syncthreads();
        clk.mark(kPhaseMasks);

        // ---- positive logits: the sg band (tensor cores; pieced: its slot
        // piece 0, the later ones below) or the cbow center, beside the
        // first piece's negative logits (they overlap better there than
        // beside the weights: 1.3% on the flagship, where grad_core
        // measured the other way; PERF.md §6)
        if (r == 0) {
          if constexpr (!CBOW) {
            if constexpr (PIECED) {
              pos_acc += band_logits_slots(band, tp, sA, d, alpha, s_gps, 0, K0,
                                           [&](int q) { load(-1, q); }, bk_row);
            } else {
              pos_acc += band_logits(band, tp, sA, d, alpha, s_gpb,
                                     [&](int q) { load(-1, q); }, bk_row);
            }
          } else {
            pos_acc += center_logits(band, hp, d, alpha, s_gpc, a_row);
          }
        }
        // ---- negative logits and weights (tensor cores), over the width
        neg_acc += neg_logits(tp, d, [&](int q) { load(r, q); }, sA, sE, sG, s_wn,
                              Sp, KPp, alpha);
        __syncthreads();
        clk.mark(kPhaseLogits);
        // ---- w_neg_sum: this chunk's sum (continued from the previous
        // piece), added to the earlier chunks' by the thread that owns it
        const size_t w0 = (size_t)b * KP + j0;
        for (int j = tid; j < KPp; j += kThreads) {
          float part = chunk_sum_in(p.wsum_ws, w0 + j, i);
          for (int s = 0; s < Sp; ++s) part += s_wn[s * KPp + j];
          chunk_sum_out(p.wsum_row, p.wsum_ws, w0 + j, part, c, more);
        }

        for (int q = 0; q < nD; ++q) {
          const int dq = piece_len(d, kDc, q), DPq = round_up(dq, kMmaK);
          const int off = q * kDc;
          load(r, q);
          // ---- d_neg: this chunk's contraction over its S positions (tensor
          // cores), its accumulator handed from piece to piece through
          // dneg_ws, then added to the sum over the earlier chunks by the
          // thread that owns the output
          float* dneg = p.dneg_row + ((size_t)b * KP + j0) * d + off;
          float* dpart = p.dneg_ws + ((size_t)b * KP + j0) * d + off;
          tile_pass<true, true>(
              KPPp, DPq, SPp, SPp, sG, tl.ldg, sA, tl.lda,
              [&](float (&acc)[2][4], int m0, int n0) {
                if (i > 0)
                  load_block(acc, m0, n0, [&](int j, int e) -> float {
                    return (j < KPp && e < dq) ? dpart[(size_t)j * d + e] : 0.f;
                  });
              },
              [&](int j, const int (&col)[4], const float (&v)[4]) {
                if (more) {
                  add_row(dpart, d, dq, j, KPp, col, v, false);
                } else {
                  add_row(dneg, d, dq, j, KPp, col, v, c > 0);
                }
              });
          __syncthreads();
          clk.mark(kPhaseNeg);

          // ---- center-side rows: d_hid = gn @ en (tensor cores), its
          // running sum over the pieces in d_h (sg) or dh_ws (cbow); after
          // the last piece the band product (sg; pieced: its slot piece 0, the
          // rest below) or the center's out-row update and d_hid2
          // (cbow, into A)
          float* part = (CBOW ? dhp : dh_out) + off;
          auto partial = [&](int s, int e) -> float {
            return (s < Sp && e < dq) ? part[(size_t)s * d + e] : 0.f;
          };
          auto w = [&](int s, int k) -> float {
            if (s >= Sp || k - s < 0 || k - s >= NB) return 0.f;
            return PIECED ? gp_at(0)(s, k) : s_gpb[s * NB + (k - s)];
          };
          block_pass(
              SPp, DPq,
              [&](float (&acc)[2][4], int m0, int n0) {
                if (r > 0) load_block(acc, m0, n0, partial);
                warp_mma_16x16<false, true>(acc, sG, tl.ldg, m0, sE, tl.lda, n0,
                                            KPPp, KPPp);
                // the band product (pieced: its slot piece 0, the rest
                // below, continuing this accumulator through d_h)
                if (!CBOW && last && (!PIECED || rows_active(s_nctx, m0, Sp)))
                  band_rows_mma(acc, m0, n0, m0,
                                PIECED ? min(m0 + kMmaM + 2 * W, K0)
                                       : m0 + kMmaM + 2 * W,
                                SKp, dq, w, [&](int k) { return bk_row(k) + off; });
              },
              [&](int s, const int (&col)[4], const float (&v)[4]) {
                if (s >= Sp) return;
                if (CBOW && last) {
                  cbow_center_row(s, col, v, s_gpc[s], p.cbow_mean != 0, s_nctx[s],
                                  a_row(s) + off, hp + off, dh_out + off, d, dq,
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

          if constexpr (CBOW) {
            context([&](int s, int k) { return band.mask(s, k); }, 0, SKp, q);
          } else if constexpr (PIECED) {
            context(gp_at(0), 0, K0, q);  // slot piece 0's slots
          } else {
            context([&](int s, int k) { return s_gpb[s * NB + (k - s)]; }, 0, SKp, q);
          }
          __syncthreads();
          clk.mark(kPhaseContext);
        }
      }

      if constexpr (PIECED && !CBOW) {
        // ---- the sg band's later slot pieces (slot piece 0 ran beside
        // the negatives): each one's logits, its k-slices of the band
        // product continuing d_hid's accumulator (through d_h) in the
        // row blocks whose band reaches it, its slots' context sums
        for (int j = 1; j < pieces(SKp, kKc); ++j) {
          const int k0 = j * kKc, Kj = piece_len(SKp, kKc, j);
          __syncthreads();  // the previous slot piece is done with gp
          pos_acc += band_logits_slots(band, tp, sA, d, alpha, s_gps, k0, Kj,
                                       [&](int q) { load(-1, q); }, bk_row);
          __syncthreads();
          clk.mark(kPhaseLogits);
          const auto gp = gp_at(k0);
          auto w = [&](int s, int k) -> float {
            return (s < Sp && k - s >= 0 && k - s <= 2 * W) ? gp(s, k) : 0.f;
          };
          // the row blocks m0 with [m0, m0 + 16 + 2W) reaching [k0, k0 + Kj)
          const int m_lo = round_up(max(0, k0 - (kMmaM - 1) - 2 * W), kMmaM);
          const int m_hi = min(SPp, round_up(k0 + Kj, kMmaM));
          for (int q = 0; q < nD; ++q) {
            const int dq = piece_len(d, kDc, q), off = q * kDc;
            load(-1, q);
            float* part = dh_out + off;
            block_pass(
                m_hi - m_lo, round_up(dq, kMmaK),
                [&](float (&acc)[2][4], int m0, int n0) {
                  load_block(acc, m0, n0, [&](int s, int e) -> float {
                    return (s < Sp && e < dq) ? part[(size_t)s * d + e] : 0.f;
                  });
                  if (rows_active(s_nctx, m0, Sp))
                    band_rows_mma(acc, m0, n0, max(m0, k0),
                                  min(m0 + kMmaM + 2 * W, k0 + Kj), SKp, dq, w,
                                  [&](int k) { return bk_row(k) + off; });
                },
                [&](int s, const int (&col)[4], const float (&v)[4]) {
                  if (s >= Sp) return;
#pragma unroll
                  for (int u = 0; u < 4; ++u)
                    if (col[u] < dq) part[(size_t)s * d + col[u]] = v[u];
                },
                m_lo);
            clk.mark(kPhaseCenter);
            context(gp, k0, k0 + Kj, q);
            clk.mark(kPhaseContext);
          }
        }
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

// the body a launch of this shape runs: tensor cores (bf16 compute) or
// f32, and on the tensor cores a chunk of one center piece or of several
template <typename T, bool CBOW>
auto band_core_kernel(bool tc, bool pieced) -> void (*)(BandArgs) {
  if (!tc) return &band_core_f32_kernel<T, CBOW>;
  return pieced ? &band_core_tc_kernel<T, CBOW, true>
                : &band_core_tc_kernel<T, CBOW, false>;
}

template <typename T, bool CBOW>
cudaError_t launch_band(const BandArgs& p, int B, size_t smem, bool tc,
                        bool pieced, cudaStream_t st) {
  auto kern = band_core_kernel<T, CBOW>(tc, pieced);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_band_model(const BandArgs& p, int B, size_t smem, bool tc,
                              bool pieced, cudaStream_t st, int is_cbow) {
  return is_cbow ? launch_band<T, true>(p, B, smem, tc, pieced, st)
                 : launch_band<T, false>(p, B, smem, tc, pieced, st);
}

// resident blocks a SM of the body a launch at this shared memory runs
template <typename T, bool CBOW>
cudaError_t band_occupancy(int* n, size_t smem, bool tc, bool pieced) {
  auto kern = band_core_kernel<T, CBOW>(tc, pieced);
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
  (void)SK;  // S + 2W: a piece's slots follow from its centers
  return cdt_bf16 ? band_tc_smem_bytes(S, KP, d, W)
                  : band_smem_words(S, KP, W) * sizeof(float);
}

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blocks of band_core resident on one SM at this shape (the occupancy
// calculator's answer), or minus the CUDA error
int w2v_band_core_blocks_per_sm(int S, int SK, int KP, int d, int W,
                                int table_bf16, int cdt_bf16, int is_cbow) {
  const size_t smem = w2v_band_core_smem_bytes(S, SK, KP, d, W, cdt_bf16);
  const bool tc = cdt_bf16 != 0, pieced = chunk_pieced(S, W);
  int n = 0;
  cudaError_t err;
  if (table_bf16) {
    err = is_cbow ? band_occupancy<__nv_bfloat16, true>(&n, smem, tc, pieced)
                  : band_occupancy<__nv_bfloat16, false>(&n, smem, tc, pieced);
  } else {
    err = is_cbow ? band_occupancy<float, true>(&n, smem, tc, pieced)
                  : band_occupancy<float, false>(&n, smem, tc, pieced);
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
                  float* losses, float* h_ws, float* dh_ws, float* dneg_ws,
                  float* wsum_ws, int B, int C, int S, int SK, int KP, int d,
                  int W, int K, int neg_shared, int cdt_bf16, int is_cbow,
                  int cbow_mean, long long* phase_rec, void* stream) {
  BandArgs p{a,        bk,        en,     tok_c,    tok_k,     keep_c,
             w_c,      negs,      alpha,  d_h,      d_ctx,     n_ctx,
             ctx_w,    dneg_row,  wsum_row, loss_part, h_ws,    dh_ws,
             dneg_ws,  wsum_ws,   C,      S,        SK,        KP,
             d,        W,         K,      neg_shared, cbow_mean, phase_rec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = w2v_band_core_smem_bytes(S, SK, KP, d, W, cdt_bf16);
  const bool tc = cdt_bf16 != 0, pieced = chunk_pieced(S, W);
  cudaError_t err =
      table_bf16
          ? launch_band_model<__nv_bfloat16>(p, B, smem, tc, pieced, st, is_cbow)
          : launch_band_model<float>(p, B, smem, tc, pieced, st, is_cbow);
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
