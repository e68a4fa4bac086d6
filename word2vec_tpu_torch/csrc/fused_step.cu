// Hand-written Hopper (sm_90a) kernels of the fused band train step.
//
// Replaces word2vec_tpu/ops/pallas_step.py, both Pallas kernels:
//   * fused_grad_core / _grad_kernel / _gather_rows (pallas_step.py:84-438)
//     -> grad_core_tc_kernel (bf16 compute) or grad_core_f32_kernel (f32
//     compute), + loss_reduce_kernel below;
//   * fused_slab_scatter / _scatter_kernel (pallas_step.py:441-506)
//     -> slab_scatter_kernel below (and its gathered instantiation, with
//     row_sq_norms_kernel, for the band step's update tail).
//
// What bounds grad_core on the H100. It reads the gathered table rows
// (center rows, context slab rows, KP negative rows) and writes the
// per-token f32 center/context gradients; at the flagship shape (B=256,
// C=2, S=118, S+2W=128, d=300, KP=64) the writes (2 x [256, 236, 300] f32,
// 145 MB) dominate: a bytes bound of ~0.064 ms at 3.35 TB/s. Its dense
// products (~8 GFLOP a call) are far under the bf16 tensor cores' rate
// but would take longer than the bytes on the f32 CUDA cores; the first
// port also re-read every center row from L2 once per negative and per
// band slot (~12 GB of L1/L2 traffic a call) in warp-reduced scalar dots.
//
// The design. One CTA of 512 threads per batch row loops over its C chunks
// (the TPU's sequential grid dimension; nothing carries between blocks).
// With bf16 compute (the default) each chunk's dense operands are staged
// in shared memory, rounded once to bf16 (csrc/band_tiles.cuh), one piece
// of at most kSc = 128 centers, kKPc = 64 negative rows and kDc = 304
// columns at a time:
//   A [SP x lda]   center rows (sg) or the cbow projection h, zero-padded
//                  to SP = 128 rows x 304 columns (+8: ldmatrix rows on
//                  distinct banks)          128 x 312 x 2 B =  79,872 B
//   E [KPP x lda]  the negative rows (once per row in one piece)
//                                           64 x 312 x 2 B = 39,936 B
//   G [SP x ldg]   gn = -sigmoid(nlog) w_neg alpha    128 x 72 x 2 B  = 18,432 B
//   f32: ids and gates, the band-compressed gp [S x 2W+1], w_neg [S x KPc]
//   (30,208 B), ...                         total at the flagship 177,448 B
// and never more than 225,152 B, at any S, KP, d or W: the flagship is one
// piece of each, and a longer chunk, a wider pool or row, a wider band
// (past kKc = 160 slab slots a center piece: one slot piece of gp, bf16,
// at a time) is walked piece by piece (band_tiles.cuh states the order of
// every sum that crosses pieces: that of one unpieced product).
// The context rows bk (another 80 KB, over the 227 KB a block has) stay in
// L1/L2. Every product runs on the tensor cores (mma.sync.m16n8k16, f32
// accumulate): nlog = A E^T, d_neg = G^T A and d_hid = G E from the tiles;
// the sg band logits A bk^T and the band product gp bk (added into d_hid's
// accumulator), the cbow projection mask bk, with bk read straight into
// mma operands; the slab-space context sums band^T A, the band matrix (gp
// or the cbow mask) built in the registers. Every output is owned by one
// thread (no float atomics: two runs are bitwise equal):
//   * d_neg and w_neg_sum sum exactly the row's first L positions: the
//     d_neg product cuts G's depth there in the registers; each chunk's
//     part is added to the row's sum by the thread that owns the output;
//   * the token-order overlap-add replaces the TPU's one-chunk lag: chunk c
//     writes its own rows of d_ctx and adds its left overhang into the last
//     W rows of chunk c-1, which the same block wrote before a barrier; its
//     right overhang waits in the first W rows of chunk c+1 (device memory,
//     not shared: it would grow with d); each output sums exactly the <= 2
//     slab slots banded._overlap_add sums; inside a chunk the slots two
//     center pieces share wait in a workspace until their sum is whole;
//   * cbow's d_ctr = gp h uses the unrounded f32 projection (kept in a
//     global workspace), its d_hid2 goes back into A, rounded once, for the
//     context sums (d_hid's running sum over negative pieces waits in a
//     second workspace); the center logit is an f32 multiply and row sum;
//   * the losses leave as per-row partials [B, 2] that a second kernel
//     reduces in a fixed order.
// With f32 compute the products stay exact f32 multiply-adds on the CUDA
// cores (TF32 would be outside the 1e-5 tolerance, and f32 tiles do not
// fit): grad_core_f32_kernel keeps the first port's body (table and
// negative rows through L1/L2, warp-reduced dot products), the chunk in
// center pieces of kSc, the negative pool in pieces of kKPc and a center
// piece's band weights in slot pieces of kKc (at most 158,592 B a block).
// Both bodies take an optional per-phase clock64() record (PhaseClock).
// The pieces bound a block's shared memory at every shape the JAX kernels
// take; a wider window costs time and, past one center piece, the device
// workspace that hands a slot's context sum on (carry_rows).
//
// The slab scatter is a segmented, ordered pass: each cell receives its
// run's terms in sorted order and rounds to the table type after every
// add, exactly as the Pallas kernel's per-row read-modify-write does.
// What bounds it: the bytes (each update row read once, each touched table
// row read and written once: ~0.055 ms for the flagship's unified
// [49,152 x 600] f32 call) and, for a hot row, the chain of ordered adds
// per cell (~4,000 terms x 4 cycles in f32, more in bf16 with the round).
// The runs come from the prepass of csrc/runs.cu (built once per sorted id
// array and shared with the ordered row sum); a persistent grid walks
// them per run, not per position (short runs from the top block down,
// long-run tiles from block 0 up, so the two kinds mostly land on
// different blocks):
//   * short runs: one warp each, lanes across the row in 16-byte (f32) or
//     8-byte (bf16) vectors, the loads of a term issued together;
//   * long runs: cut into 32-column tiles, one block each, so a hot row is
//     spread over many SMs and stays bitwise the same (columns are
//     independent chains). The block stages vals through a ring of six
//     [128 terms x 32 columns] blocks in shared
//     memory: the block keeps five in flight with cp.async while warp 0
//     adds the oldest, one lane per column, in order. bf16 rows of 300 are
//     600 B, not 16-byte multiples (no TMA), so the copies are 8-byte
//     cp.async vectors there (plain loads for a lone bf16 value of an odd
//     width), and ragged tiles are masked.
// The band step's update tail runs the gathered instantiation (GATHER): a
// term is not a row of a contiguous, table-dtype values array but a row
// of the f32 gradient where its producer wrote it (the grad core's padded
// [B, C*S, d] outputs, the negatives' [B*KP, d]), found through the sort
// order (rows[q]) and multiplied by its id's row-clip scale, then cast,
// at the add. That is the same f32 product and cast the step's torch ops
// made before, so the values added are bitwise theirs, without the
// copies, gathers, multiplies and the stack of both planes that made
// them (~1.3 GB a flagship step). Its long runs stage the f32 rows (96 KB
// of ring in both table dtypes); a short run's source rows are staged in
// shared memory once, so no term's address waits on a load.
// row_sq_norms_kernel gives the row clip its squared norms, one read of
// each row where it lies.
// Every term is added, zeros too (-0.0 + 0.0 = +0.0). No float atomics:
// each cell belongs to one thread, so the result is bitwise deterministic
// and equal to the sorted sequential scatter. Work items are assigned to
// blocks statically; an atomic counter handing them out would keep the
// bits too (which block takes an item does not change who owns a cell or
// the order of its adds), but measured slower (PERF.md, Findings).
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "band_tiles.cuh"
#include "runs.cuh"

namespace {

using namespace w2v_band;

struct GradArgs {
  const void* emb;       // [V, 2, d] T
  const int* tok_c;      // [B, C, S] clamped center ids
  const int* tok_k;      // [B, C, SK] slab ids, -1 outside the row
  const float* keep_c;   // [B, C, S]
  const float* w_c;      // [B, C, S]
  const int* negs;       // [B, KP]
  const float* alpha;    // [] the step's learning rate, on the device
  float* d_ctr;          // [B, C, S, d]
  float* d_ctx;          // [B, C, S, d]
  float* n_ctx;          // [B, C, S]
  float* ctx_w;          // [B, C, S]
  float* d_neg;          // [B, KP, d]
  float* w_neg_sum;      // [B, KP]
  float* loss_part;      // [B, 2]
  float* h_ws;           // [B, S, d] cbow only: this chunk's projection
  float* dh_ws;          // [B, S, d] cbow only: this chunk's d_hid2
  float* dneg_ws;        // [B, KP, d] S > kSc, bf16 compute only: a
                         // chunk's d_neg so far (the f32 body keeps it in
                         // d_neg)
  float* ctx_ws;         // [B, 2, carry_rows(W), d] S > kSc only: the
                         // context sums a center piece hands the next
  int C, S, SK, KP, d, W, K, L, cbow_mean;
  long long* phase_rec;  // null, or [B, kPhases] cycles (PhaseClock)
};

// shared memory of the f32-compute body, in 4-byte words (ints and
// floats), in the order grad_core_f32_kernel lays it out: one center piece
// (at most kSc) and one negative piece (at most kKPc rows) at a time, and
// the band weights gp of one slot piece, band-compressed [Sc x 2W+1] when
// a center piece's slots fit one (Sc + 2W <= kKc), else [Sc x kKc]: nothing
// that grows with S, KP, d or W past them
inline size_t grad_smem_words(int S, int KP, int W) {
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

// The right overhang of the context gradient (slab slots [S+W, S+2W) of
// chunk c, W rows) waits in d_ctx itself, in the first W rows of chunk
// c + 1, which that chunk's pass then adds its own slots to (y + left,
// as the Pallas kernel's lagged add): nothing of it stays in shared memory.
// Between the center pieces of a chunk the context sums of the slots two
// pieces share wait in ctx_ws (the unpieced order, band_tiles.cuh), and
// each token row is written once its slot's sum is whole.

// token-order context row of chunk slot kg (the chunk's slab slot), whose
// sum y is whole: slots [W, S+W) are the chunk's rows (plus the previous
// chunk's right overhang, waiting in the first W), slots [0, W) add into
// the previous chunk's last W rows, slots [S+W, S+2W) wait in the next
// chunk's first W rows
__device__ __forceinline__ void overlap_row(float* d_ctx, size_t bc, int c,
                                            int C, int S, int W, int d,
                                            int kg, int e, float y) {
  if (kg < W) {
    if (c > 0) d_ctx[((bc - 1) * S + (S - W + kg)) * d + e] += y;
  } else if (kg < S + W) {
    float* o = d_ctx + (bc * S + (kg - W)) * d + e;
    const float left = (kg - W < W && c > 0) ? *o : 0.f;
    *o = y + left;
  } else if (c + 1 < C) {
    d_ctx[((bc + 1) * S + (kg - S - W)) * d + e] = y;
  }
}

// ctx_w of chunk slot kg into token order, as overlap_row; `cont`: an
// earlier center piece of the chunk already added its part of this slot
// (0/1 column sums: exact in any order); the right overhang waits in
// s_cwtail, two buffers by chunk parity
__device__ __forceinline__ void overlap_cw(float* ctx_w, float* s_cwtail,
                                           size_t bc, int c, int S, int W,
                                           int kg, float y, bool cont) {
  if (kg < W) {
    if (c > 0) ctx_w[(bc - 1) * S + (S - W + kg)] += y;
  } else if (kg < S + W) {
    const int s = kg - W;
    float* o = ctx_w + bc * S + s;
    const float left =
        cont ? *o : (s < W && c > 0) ? s_cwtail[((c + 1) & 1) * W + s] : 0.f;
    *o = y + left;
  } else {
    float* t = s_cwtail + (c & 1) * W + (kg - S - W);
    *t = cont ? *t + y : y;
  }
}

// overlap_cw with the right overhang waiting in ctx_w itself, in the first
// W positions of chunk c + 1 (as d_ctx's does), not in shared memory: the
// pieced bodies, whose window is not bounded by a block's room
__device__ __forceinline__ void overlap_cw_dev(float* ctx_w, size_t bc, int c,
                                               int C, int S, int W, int kg,
                                               float y, bool cont) {
  if (kg < W) {
    if (c > 0) ctx_w[(bc - 1) * S + (S - W + kg)] += y;
  } else if (kg < S + W) {
    const int s = kg - W;
    float* o = ctx_w + bc * S + s;
    *o = (cont || (s < W && c > 0)) ? *o + y : y;
  } else if (c + 1 < C) {
    float* t = ctx_w + (bc + 1) * S + (kg - S - W);
    *t = cont ? *t + y : y;
  }
}

// f32 compute: exact f32 products on the CUDA cores (the staged f32 tiles
// would not fit), the design of the first port; the negative rows are read
// through L1/L2, the chunk walked in center pieces of kSc, the negative
// pool in pieces of kKPc and a center piece's slots, for the sg band
// weights, in slot pieces of kKc (one band-compressed piece when they fit:
// Sc + 2W <= kKc). The slab ids are staged while they fit kTokRoom; the
// collision counts are the exact tensor-core product neg_weights_mma. The
// sg band product adds each slot piece's sum over its slots, in slot
// order, to d_hid (one piece: d_hid + the whole sum, as before)
template <typename T, bool CBOW>
__global__ void __launch_bounds__(kThreads)
    grad_core_f32_kernel(const GradArgs a) {
  // read once a block: a captured graph replays the pointer, not a value
  const float alpha = *a.alpha;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = a.C, S = a.S, SK = a.SK, KP = a.KP, d = a.d, W = a.W;
  const int W2 = 2 * W;
  const int KPc = KP < kKPc ? KP : kKPc, nK = pieces(KP, kKPc);
  const int Sc = S < kSc ? S : kSc, nS = pieces(S, kSc);
  // gp's row stride: band-compressed (slot s + t at column t) in one slot
  // piece, else by slot (slot k0 + c of slot piece j at column c)
  const bool slotted = Sc + W2 > kKc;
  const int gld = slotted ? kKc : W2 + 1;
  const size_t rs = (size_t)2 * d;  // slab row stride
  // sg scores emb_in centers against emb_out contexts; cbow swaps them;
  // negatives always live on the out plane (pallas_step.py:160-164)
  const int ctr_plane = CBOW ? 1 : 0;
  const int ctx_plane = CBOW ? 0 : 1;
  const T* emb = static_cast<const T*>(a.emb);

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

  PhaseClock clk(a.phase_rec);
  // the center piece's slab ids: staged while they fit kTokRoom, else read
  // from device memory
  const int* tokk = a.tok_k;
  // center-side row (plane ctr_plane) of piece position s
  auto a_row = [&](int s, int e) -> float {
    return to_f(emb[(size_t)s_tokc[s] * rs + (size_t)ctr_plane * d + e]);
  };
  // context-side slab row; callers only reach valid slots (mask != 0)
  auto bk_row = [&](int k, int e) -> float {
    return to_f(emb[(size_t)tokk[k] * rs + (size_t)ctx_plane * d + e]);
  };
  // negative row j of the staged piece (out plane)
  auto en_row = [&](int j, int e) -> float {
    return to_f(emb[(size_t)s_negs[j] * rs + d + e]);
  };
  // the piece's rows of the cbow workspaces (by position in the chunk)
  float* h_ws = a.h_ws + (size_t)b * S * d;
  float* dh_ws = a.dh_ws + (size_t)b * S * d;
  float* ctx_ws = a.ctx_ws + (size_t)b * 2 * carry_rows(W) * d;
  // the negative ids of piece p
  auto load_negs = [&](int p) {
    for (int j = tid; j < piece_len(KP, kKPc, p); j += kThreads)
      s_negs[j] = a.negs[(size_t)b * KP + p * kKPc + j];
  };

  float pos_acc = 0.f;  // sum of mask * log_sigmoid(plog)
  float neg_acc = 0.f;  // sum of w_neg * (log_sigmoid(nlog) - nlog)

  load_negs(0);  // once per row when the pool is one piece

  for (int c = 0; c < C; ++c) {
    const size_t bc = (size_t)b * C + c;
    const int s_end = min(S, a.L - c * S);  // the chunk's positions < L
    for (int i = 0; i < nS; ++i) {
      // center piece i: centers [s0, s0 + Sp) and their slots [s0, s0 + SKp)
      const int s0 = i * kSc, Sp = piece_len(S, kSc, i), SKp = Sp + W2;
      const bool more = i + 1 < nS;
      const int e_end = min(Sp, max(0, s_end - s0));  // its positions < L
      const size_t cs = bc * S + s0;
      float* hp = h_ws + (size_t)s0 * d;
      float* dhp = dh_ws + (size_t)s0 * d;
      float* dctr = a.d_ctr + cs * d;
      // the context sums the previous piece handed on, and this piece's
      const float* carry_in = ctx_ws + (size_t)((i + 1) & 1) * carry_rows(W) * d;
      float* carry_out = ctx_ws + (size_t)(i & 1) * carry_rows(W) * d;
      __syncthreads();  // the previous piece is done with shared memory
      for (int s = tid; s < Sp; s += kThreads) {
        s_tokc[s] = a.tok_c[cs + s];
        s_keep[s] = a.keep_c[cs + s];
        s_w[s] = a.w_c[cs + s];
      }
      tokk = a.tok_k + bc * SK + s0;
      if (SKp <= kTokRoom) {
        for (int k = tid; k < SKp; k += kThreads) s_tokk[k] = tokk[k];
        tokk = s_tokk;
      }
      __syncthreads();
      clk.mark(kPhaseRows);
      // the band mask (banded.band_mask semantics, pallas_step.py:185-194)
      const Band band{s_tokc, s_keep, s_w, s_nctx, tokk, s_negs, Sp, W, a.K, KP};
      auto h_val = [&](int s, int e) -> float {
        if constexpr (CBOW) {
          return hp[(size_t)s * d + e];
        } else {
          return a_row(s, e);
        }
      };

      // ---- mask row sums (n_ctx)
      row_sums(band, s_nctx, a.n_ctx + cs);
      __syncthreads();
      if constexpr (CBOW) {
        // projection h = mask @ bk_rows (divided by n_ctx under cbow_mean)
        for (int x = tid; x < Sp * d; x += kThreads) {
          const int s = x / d, e = x - s * d;
          float acc = 0.f;
          for (int k = s; k <= s + W2; ++k) {
            const float m = band.mask(s, k);
            if (m != 0.f) acc += m * bk_row(k, e);
          }
          if (a.cbow_mean) acc = acc / fmaxf(s_nctx[s], 1.f);
          hp[x] = acc;
        }
        __syncthreads();
      }
      clk.mark(kPhaseMasks);

      if constexpr (CBOW) {
        // center logit: row-dot of h and the center's out-plane row
        for (int s = warp; s < Sp; s += kWarps) {
          float part = 0.f;
          for (int e = lane; e < d; e += 32)
            part += h_val(s, e) * a_row(s, e);
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
      for (int p = 0; p < nK; ++p) {
        const int KPp = piece_len(KP, kKPc, p), j0 = p * kKPc;
        const bool last = p == nK - 1;
        if (nK > 1) {
          __syncthreads();  // the previous piece is done with the ids
          load_negs(p);
          __syncthreads();
        }
        // negative weights (collision masks, pallas_step.py:213-223)
        neg_weights_mma<CBOW>(band, KPp, s_wn);
        __syncthreads();
        clk.mark(kPhaseMasks);

        // negative logits and gradient weights, one warp per (s, j)
        for (int q = warp; q < Sp * KPp; q += kWarps) {
          const int s = q / KPp, j = q - s * KPp;
          float part = 0.f;
          for (int e = lane; e < d; e += 32) part += h_val(s, e) * en_row(j, e);
          const float nlog = warp_sum(part);
          if (lane == 0) {
            const float wn = s_wn[q];
            s_gn[q] = (0.f - sigmoid_stable(nlog)) * wn * alpha;
            neg_acc += wn * (log_sigmoid(nlog) - nlog);
          }
        }
        __syncthreads();
        clk.mark(kPhaseLogits);

        // center-side rows: d_hid = gn @ en over the pieces, each value's
        // running sum kept in d_ctr (sg, where the band product then adds
        // to it) or dh_ws (cbow); after the last piece the center update
        // and d_hid2 (cbow)
        for (int x = tid; x < Sp * d; x += kThreads) {
          const int s = x / d, e = x - s * d;
          float* part = CBOW ? dhp + x : dctr + x;
          float dh = p == 0 ? 0.f : *part;
          for (int j = 0; j < KPp; ++j) dh += s_gn[s * KPp + j] * en_row(j, e);
          if (!CBOW || !last) {
            *part = dh;
          } else {
            const float gp = s_gpc[s];
            dctr[x] = gp * hp[x];
            float dh2 = dh + gp * a_row(s, e);
            // second divide (Word2Vec.cpp:313-315, pallas_step.py:259-260)
            if (a.cbow_mean) dh2 = dh2 / fmaxf(s_nctx[s], 1.f);
            dhp[x] = dh2;
          }
        }
        // d_neg = gn^T h and w_neg_sum over the row's first L positions,
        // continued from the previous piece and chunk by the same thread
        const bool cont = c > 0 || i > 0;
        float* dneg = a.d_neg + ((size_t)b * KP + j0) * d;
        for (int x = tid; x < KPp * d; x += kThreads) {
          const int j = x / d, e = x - j * d;
          float acc = cont ? dneg[x] : 0.f;
          for (int s = 0; s < e_end; ++s) acc += s_gn[s * KPp + j] * h_val(s, e);
          dneg[x] = acc;
        }
        float* wsum = a.w_neg_sum + (size_t)b * KP + j0;
        for (int j = tid; j < KPp; j += kThreads) {
          float acc = cont ? wsum[j] : 0.f;
          for (int s = 0; s < e_end; ++s) acc += s_wn[s * KPp + j];
          wsum[j] = acc;
        }
        __syncthreads();
        clk.mark(kPhaseCenter);
      }

      // ---- slab-space context grads (each slot's sum over the centers
      // s in [k-2W, k], in order, continued from the previous piece's
      // carry), overlap-added straight into token order once whole:
      // sg slot piece by slot piece, after its band logits and band product
      auto context_row = [&](int k, int e, float y) {
        if (more && k >= Sp) {
          carry_out[(size_t)(k - Sp) * d + e] = y;
        } else {
          overlap_row(a.d_ctx, bc, c, C, S, W, d, s0 + k, e, y);
        }
      };
      if constexpr (!CBOW) {
        for (int j = 0; j < pieces(SKp, kKc); ++j) {
          const int k0 = j * kKc, Kj = piece_len(SKp, kKc, j);
          // gp of (s, slot k), k in the band of s and in this slot piece
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
            for (int e = lane; e < d; e += 32) part += a_row(s, e) * bk_row(k, e);
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
              if (g != 0.f) dp += g * bk_row(k, e);
            }
            dctr[x] = dctr[x] + dp;
          }
          // the context sums of the slot piece's slots
          for (int x = tid; x < Kj * d; x += kThreads) {
            const int k = k0 + x / d, e = x % d;
            const int lo = max(0, k - W2), hi = min(Sp - 1, k);
            float y = (i > 0 && k < W2) ? carry_in[(size_t)k * d + e] : 0.f;
            for (int s = lo; s <= hi; ++s) {
              const float g = gp(s, k);
              if (g != 0.f) y += g * a_row(s, e);
            }
            context_row(k, e, y);
          }
          __syncthreads();
        }
      } else {
        for (int x = tid; x < SKp * d; x += kThreads) {
          const int k = x / d, e = x - k * d;
          const int lo = max(0, k - W2), hi = min(Sp - 1, k);
          float y = (i > 0 && k < W2) ? carry_in[(size_t)k * d + e] : 0.f;
          for (int s = lo; s <= hi; ++s) {
            const float m = band.mask(s, k);
            if (m != 0.f) y += m * dhp[(size_t)s * d + e];
          }
          context_row(k, e, y);
        }
      }
      // ctx_w: the slots' mask column sums (0/1: exact in any order)
      for (int k = tid; k < SKp; k += kThreads)
        overlap_cw_dev(a.ctx_w, bc, c, C, S, W, s0 + k, band.col_sum(k),
                       i > 0 && k < W2);
      __syncthreads();
      clk.mark(kPhaseContext);
    }
  }
  block_losses(pos_acc, neg_acc, s_red, a.loss_part + (size_t)b * 2);
  clk.mark(kPhaseTail);
}

// shared memory of the tensor-core body, in bytes: a chunk of one piece,
// the bf16 tiles (TileLayout) and then, in 4-byte words, in
// grad_core_tc_kernel's order; a pieced chunk (chunk_pieced), the layout
// of band_tiles.cuh's pieced_tc_smem_bytes, which no W changes
inline size_t grad_tc_smem_bytes(int S, int KP, int d, int W) {
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
                       + (size_t)2 * W         // ctx_w right overhang, 2 buffers
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
    grad_core_tc_kernel(const GradArgs a) {
  // read once a block: a captured graph replays the pointer, not a value
  const float alpha = *a.alpha;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int C = a.C, S = a.S, SK = a.SK, KP = a.KP, d = a.d, W = a.W;
  const int NB = 2 * W + 1;
  const int nK = pieces(KP, kKPc), nD = pieces(d, kDc);
  const int nS = PIECED ? pieces(S, kSc) : 1;  // one piece: no carry is compiled
  const int Sc = S < kSc ? S : kSc, SKc = Sc + 2 * W;
  const size_t rs = (size_t)2 * d;  // slab row stride
  // sg scores emb_in centers against emb_out contexts; cbow swaps them;
  // negatives always live on the out plane (pallas_step.py:160-164)
  const int ctr_plane = CBOW ? 1 : 0;
  const int ctx_plane = CBOW ? 0 : 1;
  const T* emb = static_cast<const T*>(a.emb);
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
  // one piece: the slab ids and column sums, the band-compressed gp and
  // ctx_w's overhang in shared memory (pieced: the slab ids' fixed room,
  // none of the rest)
  int* s_tokk = reinterpret_cast<int*>(s_nctx + Sc);
  float* s_cwy = reinterpret_cast<float*>(s_tokk + (PIECED ? kTokRoom : SKc));
  int* s_negs = reinterpret_cast<int*>(s_cwy + (PIECED ? 0 : SKc));
  const int KPc = KP < kKPc ? KP : kKPc;
  float* s_gpb = reinterpret_cast<float*>(s_negs + KPc);
  float* s_gpc = s_gpb + (PIECED ? 0 : (size_t)Sc * NB);
  float* s_wn = s_gpc + Sc;
  float* s_cwtail = s_wn + (size_t)Sc * KPc;
  float* s_red = s_cwtail + (PIECED ? 0 : 2 * W);

  PhaseClock clk(a.phase_rec);
  // the slab ids of the center piece in hand (pieced: staged while they
  // fit kTokRoom, else in device memory)
  const int* tokk_g = a.tok_k;
  // table rows: center side (plane ctr_plane) of piece position s, context
  // side of piece slot k (null outside the row)
  auto a_row = [&](int s) { return emb + (size_t)s_tokc[s] * rs + (size_t)ctr_plane * d; };
  auto bk_row = [&](int k) -> const T* {
    const int t = PIECED ? tokk_g[k] : s_tokk[k];
    return t >= 0 ? emb + (size_t)t * rs + (size_t)ctx_plane * d : nullptr;
  };
  float* h_ws = a.h_ws + (size_t)b * S * d;
  float* dh_ws = a.dh_ws + (size_t)b * S * d;
  float* ctx_ws = a.ctx_ws + (size_t)b * 2 * carry_rows(W) * d;
  // the center piece in hand: its rows of the cbow workspaces (by
  // position in the chunk) and its extent in the tiles
  float* hp = h_ws;
  int Sp = Sc, SPp = tl.SP;

  // the pieces staged in the tiles: A's width piece, E's (p, q) as
  // p * nD + q (-1: none); every thread tracks them alike
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
  auto stage_e = [&](int p, int q) {
    const int KPp = piece_len(KP, kKPc, p), dq = piece_len(d, kDc, q);
    stage_rows(sE, tl.lda, round_up(KPp, 2 * kMmaN), round_up(dq, kMmaK), KPp, dq,
               [&](int j) { return emb + (size_t)s_negs[j] * rs + d + q * kDc; });
    e_at = p * nD + q;
  };
  // piece q of A (and piece (p, q) of E unless p < 0) in the tiles
  auto load = [&](int p, int q) {
    const bool na = a_at != q, ne = p >= 0 && e_at != p * nD + q;
    if (!na && !ne) return;
    __syncthreads();  // everyone is done with the tiles
    if (na) stage_a(q);
    if (ne) stage_e(p, q);
    __syncthreads();
  };
  auto load_negs = [&](int p) {
    for (int j = tid; j < piece_len(KP, kKPc, p); j += kThreads)
      s_negs[j] = a.negs[(size_t)b * KP + p * kKPc + j];
  };

  float pos_acc = 0.f;  // sum of mask * log_sigmoid(plog)
  float neg_acc = 0.f;  // sum of w_neg * (log_sigmoid(nlog) - nlog)

  // once per row: the first negative piece (out plane), bf16 in E (the
  // only one when the pool and the row are one piece each)
  load_negs(0);
  __syncthreads();
  stage_e(0, 0);

  for (int c = 0; c < C; ++c) {
    const size_t bc = (size_t)b * C + c;
    const int s_end = min(S, a.L - c * S);  // the chunk's positions < L
    for (int i = 0; i < nS; ++i) {
      // center piece i: centers [s0, s0 + Sp) and their slots [s0, s0 + SKp)
      const int s0 = i * kSc;
      Sp = piece_len(S, kSc, i);
      SPp = round_up(Sp, kMmaM);
      const int SKp = Sp + 2 * W;
      const bool more = i + 1 < nS;
      const int e_end = min(Sp, max(0, s_end - s0));  // its positions < L
      const TileLayout tp(Sp, KP, d);  // the piece's extent, tl's strides
      const size_t cs = bc * S + s0;
      hp = h_ws + (size_t)s0 * d;
      float* dhp = dh_ws + (size_t)s0 * d;
      float* dctr = a.d_ctr + cs * d;
      // the context sums the previous piece handed on, and this piece's
      const float* carry_in = ctx_ws + (size_t)((i + 1) & 1) * carry_rows(W) * d;
      float* carry_out = ctx_ws + (size_t)(i & 1) * carry_rows(W) * d;
      __syncthreads();  // the previous piece is done with the tiles
      for (int s = tid; s < Sp; s += kThreads) {
        s_tokc[s] = a.tok_c[cs + s];
        s_keep[s] = a.keep_c[cs + s];
        s_w[s] = a.w_c[cs + s];
      }
      tokk_g = a.tok_k + bc * SK + s0;
      if (!PIECED || SKp <= kTokRoom) {
        for (int k = tid; k < SKp; k += kThreads) s_tokk[k] = tokk_g[k];
        tokk_g = s_tokk;
      }
      // sg: A holds the center rows (the first width piece); cbow: zeros
      // that the projection fills
      stage_rows(sA, tl.lda, SPp, round_up(piece_len(d, kDc, 0), kMmaK),
                 CBOW ? 0 : Sp, piece_len(d, kDc, 0), [&](int s) {
                   return emb + (size_t)a.tok_c[cs + s] * rs + (size_t)ctr_plane * d;
                 });
      a_at = CBOW ? -1 : 0;
      __syncthreads();
      clk.mark(kPhaseRows);
      const Band band{s_tokc, s_keep, s_w, s_nctx, PIECED ? tokk_g : s_tokk,
                      s_negs, Sp, W, a.K, KP};

      // ---- mask row sums (n_ctx) and, one piece, slab column sums (cwy)
      if constexpr (PIECED) {
        row_sums(band, s_nctx, a.n_ctx + cs);
      } else {
        for (int s = tid; s < Sp; s += kThreads) {
          const float n = band.row_sum(s);
          s_nctx[s] = n;
          a.n_ctx[cs + s] = n;
        }
        for (int k = tid; k < SKp; k += kThreads) s_cwy[k] = band.col_sum(k);
      }
      __syncthreads();
      if constexpr (CBOW) {
        projection<PIECED>(band, tp, d, a.cbow_mean != 0, hp, sA, bk_row);
        if (nD == 1) a_at = 0;
        __syncthreads();
      }
      clk.mark(kPhaseMasks);

      // ---- positive logits: the sg band (tensor cores; pieced: its slot
      // piece 0, the later ones below) or the cbow center, beside the
      // first piece's negative weights (1.3% faster on the flagship than
      // beside its negative logits, where band_core measured the other
      // way; PERF.md §6)
      const int K0 = min(SKp, kKc);  // pieced: the end of slot piece 0
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

      // ---- slab-space context grads: a slot the next piece reaches
      // too leaves as its accumulator (carry_out) and the next piece
      // continues it (carry_in); whole sums go straight into token
      // order (overlap_row); over slot rows [k_lo, k_hi), width piece q
      auto context = [&](auto&& wv, int k_lo, int k_hi, int q) {
        const int dq = piece_len(d, kDc, q), off = q * kDc;
        context_tiles<PIECED>(
            band, wv, sA, tl.lda, k_lo, k_hi, round_up(dq, kMmaK),
            [&](float (&acc)[2][4], int m0, int n0) {
              if (i > 0 && m0 < 2 * W)
                load_block(acc, m0, n0, [&](int k, int e) -> float {
                  return e < dq ? carry_in[(size_t)k * d + off + e] : 0.f;
                });
            },
            [&](int k, const int (&col)[4], const float (&y)[4]) {
              if (more && k >= Sp) {
                add_row(carry_out + off, d, dq, k - Sp, carry_rows(W), col, y,
                        false);
                return;
              }
#pragma unroll
              for (int v = 0; v < 4; ++v)
                if (k < SKp && col[v] < dq)
                  overlap_row(a.d_ctx, bc, c, C, S, W, d, s0 + k, off + col[v],
                              y[v]);
            });
      };

      // pieced: gp of slot piece j (slots from k0), in the band of s
      auto gp_at = [&](int k0) {
        return [&, k0](int s, int k) -> float {
          return __bfloat162float(s_gps[(size_t)s * kGpLd + (k - k0)]);
        };
      };
      for (int p = 0; p < nK; ++p) {
        const int KPp = piece_len(KP, kKPc, p), KPPp = round_up(KPp, 2 * kMmaN);
        const int j0 = p * kKPc;
        const bool last = p == nK - 1;
        if (nK > 1) {
          __syncthreads();  // the previous piece is done with the ids
          load_negs(p);
          __syncthreads();
        }
        // ---- negative weights (collision masks, pallas_step.py:213-223)
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

        // ---- negative logits and weights (tensor cores), over the width
        neg_acc += neg_logits(tp, d, [&](int q) { load(p, q); }, sA, sE, sG, s_wn,
                              Sp, KPp, alpha);
        __syncthreads();
        clk.mark(kPhaseLogits);
        // ---- w_neg_sum over the row's first L positions, continued from
        // the previous piece and chunk by the same thread
        float* wsum = a.w_neg_sum + (size_t)b * KP + j0;
        for (int j = tid; j < KPp; j += kThreads) {
          float acc = (c > 0 || i > 0) ? wsum[j] : 0.f;
          for (int s = 0; s < e_end; ++s) acc += s_wn[s * KPp + j];
          wsum[j] = acc;
        }

        for (int q = 0; q < nD; ++q) {
          const int dq = piece_len(d, kDc, q), DPq = round_up(dq, kMmaK);
          const int off = q * kDc;
          load(p, q);
          // ---- d_neg += gn^T h over the row's first L positions (gn past
          // them is cut in the registers), each output owned by one thread:
          // the chunk's product, its accumulator handed from piece to piece
          // through dneg_ws, then added to the earlier chunks' sum
          float* dneg = a.d_neg + ((size_t)b * KP + j0) * d + off;
          float* dpart = a.dneg_ws + ((size_t)b * KP + j0) * d + off;
          tile_pass<true, true>(
              KPPp, DPq, SPp, e_end, sG, tl.ldg, sA, tl.lda,
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
          // running sum over the pieces in d_ctr (sg) or dh_ws (cbow); after
          // the last piece the band product (sg; pieced: its slot piece 0, the
          // rest below) or the center update and d_hid2 (cbow, into A)
          float* part = (CBOW ? dhp : dctr) + off;
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
                if (p > 0) load_block(acc, m0, n0, partial);
                warp_mma_16x16<false, true>(acc, sG, tl.ldg, m0, sE, tl.lda, n0,
                                            KPPp, KPPp);
                // the band product (pieced: its slot piece 0, the rest
                // below, continuing this accumulator through d_ctr)
                if (!CBOW && last && (!PIECED || rows_active(s_nctx, m0, Sp)))
                  band_rows_mma(acc, m0, n0, m0,
                                PIECED ? min(m0 + kMmaM + 2 * W, K0)
                                       : m0 + kMmaM + 2 * W,
                                SKp, dq, w, [&](int k) {
                                  const T* r = bk_row(k);
                                  return r != nullptr ? r + off : r;
                                });
              },
              [&](int s, const int (&col)[4], const float (&v)[4]) {
                if (s >= Sp) return;
                if (CBOW && last) {
                  cbow_center_row(s, col, v, s_gpc[s], a.cbow_mean != 0, s_nctx[s],
                                  a_row(s) + off, hp + off, dctr + off, d, dq, sA,
                                  tl.lda);
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
        // product continuing d_hid's accumulator (through d_ctr) in the
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
            float* part = dctr + off;
            block_pass(
                m_hi - m_lo, round_up(dq, kMmaK),
                [&](float (&acc)[2][4], int m0, int n0) {
                  load_block(acc, m0, n0, [&](int s, int e) -> float {
                    return (s < Sp && e < dq) ? part[(size_t)s * d + e] : 0.f;
                  });
                  if (rows_active(s_nctx, m0, Sp))
                    band_rows_mma(acc, m0, n0, max(m0, k0),
                                  min(m0 + kMmaM + 2 * W, k0 + Kj), SKp, dq, w,
                                  [&](int k) {
                      const T* r = bk_row(k);
                      return r != nullptr ? r + off : r;
                    });
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

      if constexpr (PIECED) {
        // ctx_w: the slots' mask column sums (0/1: exact in any order)
        for (int k = tid; k < SKp; k += kThreads)
          overlap_cw_dev(a.ctx_w, bc, c, C, S, W, s0 + k, band.col_sum(k),
                         i > 0 && k < 2 * W);
      } else {
        for (int k = tid; k < SKp; k += kThreads)
          overlap_cw(a.ctx_w, s_cwtail, bc, c, S, W, s0 + k, s_cwy[k],
                     i > 0 && k < 2 * W);
      }
    }
  }
  block_losses(pos_acc, neg_acc, s_red, a.loss_part + (size_t)b * 2);
  clk.mark(kPhaseTail);
}

// losses[0, :] = sum over rows of loss_part, in row order
__global__ void loss_reduce_kernel(const float* loss_part, float* losses,
                                   int B) {
  if (threadIdx.x < 2) {
    float acc = 0.f;
    for (int b = 0; b < B; ++b) acc += loss_part[(size_t)b * 2 + threadIdx.x];
    losses[threadIdx.x] = acc;
  }
}

__device__ __forceinline__ float add_round(float row, float v) {
  return row + v;
}
__device__ __forceinline__ __nv_bfloat16 add_round(__nv_bfloat16 row,
                                                   __nv_bfloat16 v) {
  return __float2bfloat16_rn(__bfloat162float(row) + __bfloat162float(v));
}

// NV consecutive table-dtype values, loaded and stored as one vector
// (16 bytes for f32 x4, 8 for bf16 x4)
template <typename T, int NV>
struct alignas(sizeof(T) * NV) Vec {
  T v[NV];
};

template <typename T, int NV>
__device__ __forceinline__ void add_round(Vec<T, NV>& acc, const Vec<T, NV>& x) {
#pragma unroll
  for (int e = 0; e < NV; ++e) acc.v[e] = add_round(acc.v[e], x.v[e]);
}

template <typename T>
__device__ __forceinline__ T to_table(float x);
template <>
__device__ __forceinline__ float to_table<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_table<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a gathered term's value as the sorted tail hands it in: the f32 product
// with the row's scale, rounded once (__fmul_rn is never contracted into
// an FMA with the add that follows), then cast to the table dtype
template <typename T>
__device__ __forceinline__ T scaled(float x, float s) {
  return to_table<T>(__fmul_rn(x, s));
}

template <typename T, int NV>
__device__ __forceinline__ void add_round_scaled(Vec<T, NV>& acc,
                                                 const Vec<float, NV>& x,
                                                 float s) {
#pragma unroll
  for (int e = 0; e < NV; ++e) acc.v[e] = add_round(acc.v[e], scaled<T>(x.v[e], s));
}

// The gathered terms of the scatter (its GATHER instantiations): term q is
// not row q of a table-dtype vals but row rows[q] of an f32 source as its
// producer wrote it, one source a d-wide plane of the columns [col0, col0 +
// width) (two on the doubled-width unified call), multiplied by its id's
// f32 factor (the row clip's scale; none where the plane's scale is null)
// and cast to the table dtype just before the add: the values that
// gather -> multiply -> cast -> stack would hand the contiguous
// instantiation, bitwise, without the passes that make them.
struct Gather {
  const float* src0;
  const float* src1;
  const float* scale0;
  const float* scale1;
  const int* rows;
  int d;  // columns of a source row; a multiple of NV
};

constexpr int kScThreads = 256;  // 8 warps
// Columns per long-run work item: one adder lane each. A hot run is cut
// into width / 32 items (10 at d = 300, 19 on the doubled-width unified
// call) that run on as many SMs; order binds only terms within one cell.
constexpr int kTileCols = 32;
// Terms per staged block of a long-run item ([128 x 32] values, 16 KB in
// f32) and blocks in the shared-memory ring (96 KB in f32, 2 blocks a SM;
// 48 KB in bf16). The whole block keeps kRing - 1 staged blocks of
// cp.async copies in flight (80 KB in f32), which covers the memory
// latency (Little's law: ~1 us x the ~64 GB/s the adder warp consumes in
// f32, 128 B per 4-cycle add) while warp 0 adds the oldest block in order.
constexpr int kStageTerms = 128;
constexpr int kRing = 6;

// asynchronous global -> shared copy of BYTES (4, 8 or 16)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// emb rows [V, row_len]; columns [col0, col0 + width) of row idx[q] get
// vals[q, :width] added (GATHER: the gathered terms of `g`), each cell's
// terms in sorted order, rounded to T after every add. runs: the run list
// of idx (csrc/runs.cuh). NV values a vector; width, col0 and row_len
// (GATHER: and g.d) are multiples of NV.
template <typename T, int NV, bool GATHER>
__global__ void __launch_bounds__(kScThreads, 2)
    slab_scatter_kernel(T* __restrict__ emb, const int* __restrict__ idx,
                        const T* __restrict__ vals, const int* __restrict__ runs,
                        int n, int row_len, int col0, int width, Gather g) {
  using V = Vec<T, NV>;
  using F = Vec<float, NV>;
  // the staged type: the gathered terms are staged as their f32 sources
  using ST = std::conditional_t<GATHER, float, T>;
  using SV = Vec<ST, NV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ST* buf = reinterpret_cast<ST*>(smem_raw);  // [kRing][kStageTerms][kTileCols]
  const int n_short = runs[0], n_long = runs[1];
  const int2* shorts = w2v_runs::short_runs(runs);
  const int2* longs = w2v_runs::long_runs(runs, n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nvec = width / NV;
  constexpr int kWarps = kScThreads / 32;

  // ---- short runs: one warp each, from the top block down; each lane
  // holds up to 4 vectors of the row, so the loads of a term (and, with
  // the unroll, of the next) are in flight together
  for (int i = (gridDim.x - 1 - blockIdx.x) * kWarps + warp; i < n_short;
       i += gridDim.x * kWarps) {
    const int2 se = shorts[i];
    if constexpr (GATHER) {
      static_assert(w2v_runs::kLongRun <= 32,
                    "a short run's source rows are handed out one a lane");
      // the run's source rows, one a lane (a short run has at most
      // kLongRun terms), loaded beside its id and handed out by shuffles,
      // so no term's address waits on a load of its own; a run is one id,
      // so one scale a plane for all its terms
      const int my_row = se.x + lane < se.y ? g.rows[se.x + lane] : 0;
      const int r = idx[se.x];
      V* cell = reinterpret_cast<V*>(emb + (size_t)r * row_len + col0);
      const float s0 = g.scale0 ? g.scale0[r] : 1.f;
      const float s1 = g.scale1 ? g.scale1[r] : 1.f;
      // every lane walks every pass and term: the shuffles need them all
      for (int b0 = 0; b0 < nvec; b0 += 4 * 32) {
        V acc[4];
        const float* base[4];
        float su[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int v = b0 + lane + 32 * u;
          const int c = v * NV;
          const bool p1 = c >= g.d;
          base[u] = p1 ? g.src1 + (c - g.d) : g.src0 + c;
          su[u] = p1 ? s1 : s0;
          if (v < nvec) acc[u] = cell[v];
        }
#pragma unroll 2
        for (int q = se.x; q < se.y; ++q) {
          const size_t off = (size_t)__shfl_sync(0xffffffffu, my_row, q - se.x) * g.d;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (b0 + lane + 32 * u < nvec)
              add_round_scaled(acc[u], *reinterpret_cast<const F*>(base[u] + off), su[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (b0 + lane + 32 * u < nvec) cell[b0 + lane + 32 * u] = acc[u];
      }
    } else {
      const int r = idx[se.x];
      V* cell = reinterpret_cast<V*>(emb + (size_t)r * row_len + col0);
      const V* src = reinterpret_cast<const V*>(vals);
      for (int v0 = lane; v0 < nvec; v0 += 4 * 32) {
        V acc[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (v0 + 32 * u < nvec) acc[u] = cell[v0 + 32 * u];
#pragma unroll 2
        for (int q = se.x; q < se.y; ++q) {
          const V* row = src + (size_t)q * nvec;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (v0 + 32 * u < nvec) add_round(acc[u], row[v0 + 32 * u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (v0 + 32 * u < nvec) cell[v0 + 32 * u] = acc[u];
      }
    }
  }

  // ---- long runs: one block per (run, 32-column tile), staged blocks of
  // kStageTerms terms through a ring of kRing: every thread (GATHER: of
  // warps 1..) issues the copies of the block kRing - 1 ahead, warp 0 adds
  // the oldest, in order
  constexpr int kTileVecs = kTileCols / NV;
  const int tiles = (width + kTileCols - 1) / kTileCols;
  const int items = n_long * tiles;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int run = it / tiles;
    const int c0 = (it - run * tiles) * kTileCols;
    const int tv = min(kTileCols, width - c0) / NV;  // ragged last tile
    const int2 se = longs[run];
    const int blocks = (se.y - se.x + kStageTerms - 1) / kStageTerms;
    // GATHER: warps 1.. stage (the adder, warp 0, never waits on a source
    // row's index), each thread's source rows of a block loaded into rr one
    // block before its copies are issued, so the loads overlap the adds
    constexpr int kStagers = kScThreads - 32;
    constexpr int kPer = (kStageTerms * kTileVecs + kStagers - 1) / kStagers;
    int rr[GATHER ? kPer : 1];
    auto load_rows = [&](int b) {
      if constexpr (GATHER) {
        const int q0 = se.x + b * kStageTerms;
        const int cnt = min(kStageTerms, se.y - q0);
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int k = (tid - 32 + i * kStagers) / kTileVecs;
          rr[i] = warp > 0 && k < cnt ? g.rows[q0 + k] : 0;
        }
      }
    };
    // issue the copies of staged block b into ring slot b % kRing
    auto stage = [&](int b) {
      const int q0 = se.x + b * kStageTerms;
      const int cnt = min(kStageTerms, se.y - q0);
      SV* s = reinterpret_cast<SV*>(buf + (size_t)(b % kRing) * kStageTerms * kTileCols);
      if constexpr (GATHER) {
        if (warp == 0) return;
        const int t = tid - 32;
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int x = t + i * kStagers;
          const int k = x / kTileVecs, j = x - k * kTileVecs;
          if (k < cnt && j < tv) {  // f32 vectors: 4 bytes at least
            const int c = c0 + j * NV;
            const bool p1 = c >= g.d;
            const size_t row = (size_t)rr[i] * g.d;
            cp_async<sizeof(SV)>(s + x, p1 ? g.src1 + (row + c - g.d) : g.src0 + (row + c));
          }
        }
      } else {
        const V* src = reinterpret_cast<const V*>(vals + c0) + (size_t)q0 * nvec;
        for (int x = tid; x < cnt * kTileVecs; x += kScThreads) {
          const int k = x / kTileVecs, j = x - k * kTileVecs;
          if (j < tv) {
            if constexpr (sizeof(V) >= 4) {
              cp_async<sizeof(V)>(s + x, src + (size_t)k * nvec + j);
            } else {  // a lone bf16 value: cp.async copies 4 bytes at least
              s[x] = src[(size_t)k * nvec + j];
            }
          }
        }
      }
    };
#pragma unroll
    for (int b = 0; b < kRing - 1; ++b) {
      if (b < blocks) {
        load_rows(b);
        stage(b);
      }
      cp_async_commit();
    }
    if (kRing - 1 < blocks) load_rows(kRing - 1);
    T* cell = emb + (size_t)idx[se.x] * row_len + col0 + c0 + lane;
    const bool adder = warp == 0 && lane < tv * NV;
    T acc{};
    if (adder) acc = *cell;
    float sc = 1.f;  // GATHER: the adder's plane's scale of the run's id
    if constexpr (GATHER) {
      const float* sp = c0 + lane >= g.d ? g.scale1 : g.scale0;
      if (adder && sp) sc = sp[idx[se.x]];
    }
    for (int b = 0; b < blocks; ++b) {
      // slot (b - 1) % kRing was emptied before the last barrier
      if (b + kRing - 1 < blocks) {
        stage(b + kRing - 1);
        if (b + kRing < blocks) load_rows(b + kRing);
      }
      cp_async_commit();
      cp_async_wait<kRing - 1>();  // this thread's copies of block b landed
      __syncthreads();             // everyone's did
      if (adder) {
        const ST* s = buf + (size_t)(b % kRing) * kStageTerms * kTileCols + lane;
        const int cnt = min(kStageTerms, se.y - se.x - b * kStageTerms);
        // unrolled by 16: the shared-memory reads issue ahead of the chain
        if constexpr (GATHER) {
#pragma unroll 16
          for (int k = 0; k < cnt; ++k)
            acc = add_round(acc, scaled<T>(s[k * kTileCols], sc));
        } else {
#pragma unroll 16
          for (int k = 0; k < cnt; ++k) acc = add_round(acc, s[k * kTileCols]);
        }
      }
      __syncthreads();  // block b's slot may be refilled
    }
    if (adder) *cell = acc;
  }
}

int g_sms = 0;

template <typename T, int NV, bool GATHER>
cudaError_t launch_scatter(T* emb, const int* idx, const T* vals,
                           const int* runs, int n, int row_len, int col0,
                           int width, const Gather& g, cudaStream_t st) {
  auto kern = slab_scatter_kernel<T, NV, GATHER>;
  using ST = std::conditional_t<GATHER, float, T>;
  const int smem = kRing * kStageTerms * kTileCols * (int)sizeof(ST);
  static int per_sm = 0;  // resident blocks a SM, one per instantiation
  if (per_sm == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kScThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
  }
  // persistent grid: as many blocks as fit at once (2 a SM in f32, by the
  // ring's shared memory), fewer for small calls (8 short runs a block)
  const int blocks = max(1, min((n + 7) / 8, per_sm * g_sms));
  kern<<<blocks, kScThreads, smem, st>>>(emb, idx, vals, runs, n, row_len,
                                         col0, width, g);
  return cudaGetLastError();
}

template <typename T, bool GATHER>
cudaError_t launch_scatter_vec(void* emb, const int* idx, const void* vals,
                               const int* runs, int n, int row_len, int col0,
                               int width, int vec, const Gather& g,
                               cudaStream_t st) {
  T* e = static_cast<T*>(emb);
  const T* v = static_cast<const T*>(vals);
  switch (vec) {
    case 4:
      return launch_scatter<T, 4, GATHER>(e, idx, v, runs, n, row_len, col0, width, g, st);
    case 2:
      return launch_scatter<T, 2, GATHER>(e, idx, v, runs, n, row_len, col0, width, g, st);
    case 1:
      return launch_scatter<T, 1, GATHER>(e, idx, v, runs, n, row_len, col0, width, g, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool GATHER>
cudaError_t launch_scatter_table(void* emb, int table_bf16, const int* idx,
                                 const void* vals, const int* runs, int n,
                                 int row_len, int col0, int width, int vec,
                                 const Gather& g, cudaStream_t st) {
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  return table_bf16
             ? launch_scatter_vec<__nv_bfloat16, GATHER>(emb, idx, vals, runs, n, row_len,
                                                         col0, width, vec, g, st)
             : launch_scatter_vec<float, GATHER>(emb, idx, vals, runs, n, row_len, col0,
                                                 width, vec, g, st);
}

// out[i] = ||row i||^2 in f32 for the `live` first rows of each group of
// `stride` rows of src [groups * stride, d] (i = group * live + t): one
// warp a row, lanes across its NV-vectors, fused multiply-adds, then a
// shuffle tree; a fixed order, so two runs agree bitwise. Each row is read
// once, where its producer wrote it.
constexpr int kNormThreads = 256;

template <int NV>
__global__ void __launch_bounds__(kNormThreads)
    row_sq_norms_kernel(const float* __restrict__ src, float* __restrict__ out,
                        int groups, int stride, int live, int d) {
  using F = Vec<float, NV>;
  constexpr int kWarps = kNormThreads / 32;
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)groups * live;
  for (long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       i < rows; i += (long long)gridDim.x * kWarps) {
    const long long grp = i / live;
    const F* row = reinterpret_cast<const F*>(
        src + ((size_t)grp * stride + (size_t)(i - grp * live)) * d);
    float acc = 0.f;
    for (int j = lane; j < d / NV; j += 32) {
      const F x = row[j];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc = fmaf(x.v[e], x.v[e], acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[i] = acc;
  }
}

// the body a launch of this shape runs: tensor cores (bf16 compute) or
// f32, and on the tensor cores a chunk of one center piece or of several
template <typename T, bool CBOW>
auto grad_core_kernel(bool tc, bool pieced) -> void (*)(GradArgs) {
  if (!tc) return &grad_core_f32_kernel<T, CBOW>;
  return pieced ? &grad_core_tc_kernel<T, CBOW, true>
                : &grad_core_tc_kernel<T, CBOW, false>;
}

template <typename T, bool CBOW>
cudaError_t launch_grad(const GradArgs& a, int B, size_t smem, bool tc,
                        bool pieced, cudaStream_t st) {
  auto kern = grad_core_kernel<T, CBOW>(tc, pieced);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_grad_model(const GradArgs& a, int B, size_t smem, bool tc,
                              bool pieced, cudaStream_t st, int is_cbow) {
  return is_cbow ? launch_grad<T, true>(a, B, smem, tc, pieced, st)
                 : launch_grad<T, false>(a, B, smem, tc, pieced, st);
}

// resident blocks a SM of the body a launch at this shared memory runs
template <typename T, bool CBOW>
cudaError_t grad_occupancy(int* n, size_t smem, bool tc, bool pieced) {
  auto kern = grad_core_kernel<T, CBOW>(tc, pieced);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kern, kThreads, smem);
}

}  // namespace

extern "C" {

// bf16 compute runs the tensor-core body, f32 compute the f32 one
size_t w2v_grad_core_smem_bytes(int S, int SK, int KP, int d, int W,
                                int cdt_bf16) {
  (void)SK;  // S + 2W: a piece's slots follow from its centers
  return cdt_bf16 ? grad_tc_smem_bytes(S, KP, d, W)
                  : grad_smem_words(S, KP, W) * sizeof(float);
}

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// blocks of fused_grad_core resident on one SM at this shape (the
// occupancy calculator's answer), or minus the CUDA error
int w2v_grad_core_blocks_per_sm(int S, int SK, int KP, int d, int W,
                                int table_bf16, int cdt_bf16, int is_cbow) {
  const size_t smem = w2v_grad_core_smem_bytes(S, SK, KP, d, W, cdt_bf16);
  const bool tc = cdt_bf16 != 0, pieced = chunk_pieced(S, W);
  int n = 0;
  cudaError_t err;
  if (table_bf16) {
    err = is_cbow ? grad_occupancy<__nv_bfloat16, true>(&n, smem, tc, pieced)
                  : grad_occupancy<__nv_bfloat16, false>(&n, smem, tc, pieced);
  } else {
    err = is_cbow ? grad_occupancy<float, true>(&n, smem, tc, pieced)
                  : grad_occupancy<float, false>(&n, smem, tc, pieced);
  }
  return err == cudaSuccess ? n : -(int)err;
}

int w2v_fused_grad_core(const void* emb, int table_bf16, const int* tok_c,
                        const int* tok_k, const float* keep_c,
                        const float* w_c, const int* negs, const float* alpha,
                        float* d_ctr, float* d_ctx, float* n_ctx,
                        float* ctx_w, float* d_neg, float* w_neg_sum,
                        float* loss_part, float* losses, float* h_ws,
                        float* dh_ws, float* dneg_ws, float* ctx_ws, int B,
                        int C, int S, int SK, int KP, int d, int W, int K,
                        int L, int cdt_bf16, int is_cbow, int cbow_mean,
                        long long* phase_rec, void* stream) {
  GradArgs a{emb,   tok_c,     tok_k,     keep_c, w_c,   negs,  alpha,
             d_ctr, d_ctx,     n_ctx,     ctx_w,  d_neg, w_neg_sum,
             loss_part, h_ws,  dh_ws,     dneg_ws, ctx_ws, C,   S,
             SK,    KP,        d,         W,      K,     L,     cbow_mean,
             phase_rec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = w2v_grad_core_smem_bytes(S, SK, KP, d, W, cdt_bf16);
  const bool tc = cdt_bf16 != 0, pieced = chunk_pieced(S, W);
  const cudaError_t err =
      table_bf16
          ? launch_grad_model<__nv_bfloat16>(a, B, smem, tc, pieced, st, is_cbow)
          : launch_grad_model<float>(a, B, smem, tc, pieced, st, is_cbow);
  if (err != cudaSuccess) return (int)err;
  loss_reduce_kernel<<<1, 32, 0, st>>>(loss_part, losses, B);
  return (int)cudaGetLastError();
}

int w2v_scatter_stage_terms() { return kStageTerms; }

// runs: the run list of idx (csrc/runs.cu); vec: values per vector (4, 2
// or 1), dividing width, col0 and row_len, with emb and vals aligned to it
int w2v_slab_scatter(void* emb, int table_bf16, const int* idx,
                     const void* vals, const int* runs, int n, int row_len,
                     int col0, int width, int vec, void* stream) {
  if (n <= 0) return 0;
  return (int)launch_scatter_table<false>(emb, table_bf16, idx, vals, runs, n,
                                          row_len, col0, width, vec, Gather{},
                                          static_cast<cudaStream_t>(stream));
}

// the gathered scatter: term q is row rows[q] of src0 (columns below d of
// the call's width) or src1 (the rest: a doubled-width call), times
// scale0 / scale1 [V] at its id (null: none), cast to the table dtype;
// vec also divides d, and src0 / src1 are aligned to vec floats
int w2v_slab_scatter_gathered(void* emb, int table_bf16, const int* idx,
                              const float* src0, const float* src1,
                              const float* scale0, const float* scale1,
                              const int* rows, int d, const int* runs, int n,
                              int row_len, int col0, int width, int vec,
                              void* stream) {
  if (n <= 0) return 0;
  const Gather g{src0, src1, scale0, scale1, rows, d};
  return (int)launch_scatter_table<true>(emb, table_bf16, idx, nullptr, runs, n,
                                         row_len, col0, width, vec, g,
                                         static_cast<cudaStream_t>(stream));
}

// out [groups * live] = the squared norms of the live rows of src (see
// row_sq_norms_kernel); vec 4 needs d % 4 == 0 and src 16-byte aligned
int w2v_row_sq_norms(const float* src, float* out, int groups, int stride,
                     int live, int d, int vec, void* stream) {
  const long long rows = (long long)groups * live;
  if (rows <= 0) return 0;
  constexpr int kWarps = kNormThreads / 32;
  const int blocks = (int)std::min<long long>((rows + kWarps - 1) / kWarps, 8192);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    row_sq_norms_kernel<4><<<blocks, kNormThreads, 0, st>>>(src, out, groups, stride, live, d);
  else if (vec == 1)
    row_sq_norms_kernel<1><<<blocks, kNormThreads, 0, st>>>(src, out, groups, stride, live, d);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
