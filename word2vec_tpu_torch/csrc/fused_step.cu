// Hand-written Hopper (sm_90a) kernels of the fused band train step.
//
// Replaces word2vec_tpu/ops/pallas_step.py, both Pallas kernels:
//   * fused_grad_core / _grad_kernel / _gather_rows (pallas_step.py:84-438)
//     -> grad_core_kernel + loss_reduce_kernel below;
//   * fused_slab_scatter / _scatter_kernel (pallas_step.py:441-506)
//     -> slab_scatter_kernel below.
//
// What bounds them on the H100. grad_core reads the gathered table rows
// (center rows both planes, context slab rows, KP negative rows) and writes
// the per-token f32 center/context gradients; at the flagship shape the
// writes (2 x [256, 236, 300] f32, 145 MB) dominate, so the bound is the
// bytes over 3.35 TB/s, as long as the contractions (about 7 GFLOP a step,
// most of them the [S x d].[d x KP] negative logits, d_hid and d_neg) run
// on the bf16 tensor cores; on the f32 CUDA cores (67 TFLOP/s) they alone
// would take longer than the bytes. The slab scatter reads each update row
// once and reads and writes each touched table row once: bytes too.
//
// What the design does about it. The TPU kernel walks a sequential
// (B, C+1) grid and carries scratch (lag stashes, full-row h/gn/w_neg,
// the loss) from one grid step to the next - about 1.47 MB at the
// flagship, far above the 227 KB of shared memory a Hopper block has, and
// GPU blocks run in no order. Here:
//   * one CTA per batch row loops over its C chunks itself (the sequential
//     grid dimension becomes a loop), so nothing carries between blocks;
//   * shared memory keeps only the chunk's band-compressed positive
//     gradient [S, 2W+1], the [S, KP] negative tiles, the KP negative rows
//     (rounded to the compute type) and the W-row right overhang of the
//     previous chunk, ~158 KB at the flagship; table rows are read from
//     global memory (they stay in the 50 MB L2 while the block works);
//   * the token-order overlap-add replaces the one-chunk lag: chunk c
//     writes its own rows of d_ctx and adds its left overhang into the
//     last W rows of chunk c-1, which the same block wrote before a
//     __syncthreads; each output still sums exactly the <= 2 slab slots
//     banded._overlap_add sums;
//   * d_neg and w_neg_sum are running sums over the row's first L
//     positions, continued chunk by chunk by the same thread, so each is
//     one sequential reduction over the row (no reassociation per chunk);
//   * the losses leave as per-row partials [B, 2] that a second kernel
//     reduces in a fixed order (deterministic, like the rest).
// Every contraction rounds both operands to the compute type (bf16 by
// default) and accumulates in f32, as the Pallas kernel's `dot` does; the
// products are scalar f32 multiply-adds (no tensor cores yet: that, and
// staging the center rows in shared memory, is the next step for speed).
// The positive side only visits the band (k in [s, s+2W]) and skips masked
// pairs: the masked terms are exact zeros in the Pallas kernel too.
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

#include "runs.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an operand to the compute type (the Pallas `dot`'s astype(cdt))
template <bool CB>
__device__ __forceinline__ float rc(float x) {
  if constexpr (CB) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ float sigmoid_stable(float x) {
  if (x >= 0.f) return 1.f / (1.f + expf(-x));
  const float e = expf(x);
  return e / (1.f + e);
}

// jax.nn.log_sigmoid(x) = -softplus(-x) = -(max(-x, 0) + log1p(exp(-|x|)))
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(fmaxf(-x, 0.f) + log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct GradArgs {
  const void* emb;       // [V, 2, d] T
  const int* tok_c;      // [B, C, S] clamped center ids
  const int* tok_k;      // [B, C, SK] slab ids, -1 outside the row
  const float* keep_c;   // [B, C, S]
  const float* w_c;      // [B, C, S]
  const int* negs;       // [B, KP]
  float alpha;
  float* d_ctr;          // [B, C, S, d]
  float* d_ctx;          // [B, C, S, d]
  float* n_ctx;          // [B, C, S]
  float* ctx_w;          // [B, C, S]
  float* d_neg;          // [B, KP, d]
  float* w_neg_sum;      // [B, KP]
  float* loss_part;      // [B, 2]
  float* h_ws;           // [B, S, d] cbow only: this chunk's projection
  float* dh_ws;          // [B, S, d] cbow only: this chunk's d_hid2
  int C, S, SK, KP, d, W, K, L, cbow_mean;
};

// shared memory of one block, in 4-byte words (ints and floats), in the
// order grad_core_kernel lays it out
inline size_t grad_smem_words(int S, int SK, int KP, int d, int W) {
  const int NB = 2 * W + 1;
  return (size_t)S * 4          // tok_c, keep, w, n_ctx
         + (size_t)SK * 2       // tok_k, cwy
         + (size_t)KP * 2       // negs, wsum
         + (size_t)S * NB       // band-compressed gp (sg)
         + (size_t)S            // gp per center (cbow)
         + (size_t)S * KP * 2   // gn, w_neg
         + (size_t)KP * d       // negative rows, rounded to cdt
         + (size_t)2 * W * d    // context-grad right overhang, 2 buffers
         + (size_t)2 * W        // ctx_w right overhang, 2 buffers
         + (size_t)2 * kWarps;  // loss block reduction
}

template <typename T, bool CB, bool CBOW>
__global__ void __launch_bounds__(kThreads)
    grad_core_kernel(const GradArgs a) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = a.C, S = a.S, SK = a.SK, KP = a.KP, d = a.d, W = a.W;
  const int NB = 2 * W + 1;
  const size_t rs = (size_t)2 * d;  // slab row stride
  // sg scores emb_in centers against emb_out contexts; cbow swaps them;
  // negatives always live on the out plane (pallas_step.py:160-164)
  const int ctr_plane = CBOW ? 1 : 0;
  const int ctx_plane = CBOW ? 0 : 1;
  const T* emb = static_cast<const T*>(a.emb);

  extern __shared__ float smem[];
  int* s_tokc = reinterpret_cast<int*>(smem);
  float* s_keep = smem + S;
  float* s_w = s_keep + S;
  float* s_nctx = s_w + S;
  int* s_tokk = reinterpret_cast<int*>(s_nctx + S);
  float* s_cwy = reinterpret_cast<float*>(s_tokk + SK);
  int* s_negs = reinterpret_cast<int*>(s_cwy + SK);
  float* s_wsum = reinterpret_cast<float*>(s_negs + KP);
  float* s_gpb = s_wsum + KP;
  float* s_gpc = s_gpb + (size_t)S * NB;
  float* s_gn = s_gpc + S;
  float* s_wn = s_gn + (size_t)S * KP;
  float* s_en = s_wn + (size_t)S * KP;
  float* s_tail = s_en + (size_t)KP * d;
  float* s_cwtail = s_tail + (size_t)2 * W * d;
  float* s_red = s_cwtail + 2 * W;

  // the band mask (banded.band_mask semantics, pallas_step.py:185-194)
  auto mask = [&](int s, int k) -> float {
    const int dist = abs(s + W - k);
    const bool on = s_tokk[k] >= 0 && (float)dist <= s_w[s] && dist > 0;
    return on ? s_keep[s] : 0.f;
  };
  // center-side row (plane ctr_plane) of chunk position s
  auto a_row = [&](int s, int e) -> float {
    return to_f(emb[(size_t)s_tokc[s] * rs + (size_t)ctr_plane * d + e]);
  };
  // context-side slab row; callers only reach valid slots (mask != 0)
  auto bk_row = [&](int k, int e) -> float {
    return to_f(emb[(size_t)s_tokk[k] * rs + (size_t)ctx_plane * d + e]);
  };
  float* h_ws = a.h_ws + (size_t)b * S * d;
  float* dh_ws = a.dh_ws + (size_t)b * S * d;
  auto h_val = [&](int s, int e) -> float {
    if constexpr (CBOW) {
      return h_ws[(size_t)s * d + e];
    } else {
      return a_row(s, e);
    }
  };

  float pos_acc = 0.f;  // sum of mask * log_sigmoid(plog)
  float neg_acc = 0.f;  // sum of w_neg * (log_sigmoid(nlog) - nlog)

  // once per row: the KP negative rows (out plane), rounded to cdt
  for (int j = tid; j < KP; j += kThreads) {
    s_negs[j] = a.negs[(size_t)b * KP + j];
    s_wsum[j] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < KP * d; i += kThreads) {
    const int j = i / d, e = i - j * d;
    s_en[i] = rc<CB>(to_f(emb[(size_t)s_negs[j] * rs + d + e]));
  }

  for (int c = 0; c < C; ++c) {
    __syncthreads();  // the previous chunk is done with the tiles
    const size_t bc = (size_t)b * C + c;
    for (int s = tid; s < S; s += kThreads) {
      s_tokc[s] = a.tok_c[bc * S + s];
      s_keep[s] = a.keep_c[bc * S + s];
      s_w[s] = a.w_c[bc * S + s];
    }
    for (int k = tid; k < SK; k += kThreads) s_tokk[k] = a.tok_k[bc * SK + k];
    __syncthreads();

    // ---- mask row sums (n_ctx) and slab column sums (cwy)
    for (int s = tid; s < S; s += kThreads) {
      float n = 0.f;
      for (int k = s; k <= s + 2 * W; ++k) n += mask(s, k);
      s_nctx[s] = n;
      a.n_ctx[bc * S + s] = n;
    }
    for (int k = tid; k < SK; k += kThreads) {
      float cw = 0.f;
      const int lo = max(0, k - 2 * W), hi = min(S - 1, k);
      for (int s = lo; s <= hi; ++s) cw += mask(s, k);
      s_cwy[k] = cw;
    }
    __syncthreads();

    // ---- negative weights (collision masks, pallas_step.py:213-223)
    for (int i = tid; i < S * KP; i += kThreads) {
      const int s = i / KP, j = i - s * KP;
      const int neg = s_negs[j];
      const float center_hit = s_tokc[s] == neg ? 1.f : 0.f;
      float ctx_hit = 0.f;
      for (int k = s; k <= s + 2 * W; ++k) {
        const float m = mask(s, k);
        if (m != 0.f && s_tokk[k] == neg) ctx_hit += rc<CB>(m);
      }
      const float neg_ok =
          1.f - fminf(fmaxf(center_hit + ctx_hit, 0.f), 1.f);
      const float n = s_nctx[s];
      const float k_i =
          CBOW ? (n > 0.f ? (float)a.K : 0.f) : n * (float)a.K;
      s_wn[i] = (k_i / (float)KP) * neg_ok;
    }
    if constexpr (CBOW) {
      // projection h = mask @ bk_rows (divided by n_ctx under cbow_mean)
      for (int i = tid; i < S * d; i += kThreads) {
        const int s = i / d, e = i - s * d;
        float acc = 0.f;
        for (int k = s; k <= s + 2 * W; ++k) {
          const float m = mask(s, k);
          if (m != 0.f) acc += rc<CB>(m) * rc<CB>(bk_row(k, e));
        }
        if (a.cbow_mean) acc = acc / fmaxf(s_nctx[s], 1.f);
        h_ws[i] = acc;
      }
    }
    __syncthreads();

    // ---- negative logits and gradient weights, one warp per (s, j)
    for (int p = warp; p < S * KP; p += kWarps) {
      const int s = p / KP, j = p - s * KP;
      float part = 0.f;
      for (int e = lane; e < d; e += 32)
        part += rc<CB>(h_val(s, e)) * s_en[(size_t)j * d + e];
      const float nlog = warp_sum(part);
      if (lane == 0) {
        const float wn = s_wn[p];
        s_gn[p] = (0.f - sigmoid_stable(nlog)) * wn * a.alpha;
        neg_acc += wn * (log_sigmoid(nlog) - nlog);
      }
    }
    // ---- positive side
    if constexpr (!CBOW) {
      // band logits over the band only, one warp per (s, k)
      for (int p = warp; p < S * NB; p += kWarps) {
        const int s = p / NB, k = s + (p - s * NB);
        const float m = mask(s, k);
        if (m == 0.f) {
          if (lane == 0) s_gpb[p] = 0.f;
          continue;
        }
        float part = 0.f;
        for (int e = lane; e < d; e += 32)
          part += rc<CB>(a_row(s, e)) * rc<CB>(bk_row(k, e));
        const float plog = warp_sum(part);
        if (lane == 0) {
          s_gpb[p] = (1.f - sigmoid_stable(plog)) * m * a.alpha;
          pos_acc += m * log_sigmoid(plog);
        }
      }
    } else {
      // center logit: row-dot of h and the center's out-plane row
      for (int s = warp; s < S; s += kWarps) {
        float part = 0.f;
        for (int e = lane; e < d; e += 32)
          part += rc<CB>(h_val(s, e)) * rc<CB>(a_row(s, e));
        const float plog = warp_sum(part);
        if (lane == 0) {
          const float active = s_nctx[s] > 0.f ? 1.f : 0.f;
          s_gpc[s] = (1.f - sigmoid_stable(plog)) * active * a.alpha;
          pos_acc += active * log_sigmoid(plog);
        }
      }
    }
    __syncthreads();

    // ---- center-side rows: d_hid = gn @ en, plus the band product
    for (int i = tid; i < S * d; i += kThreads) {
      const int s = i / d, e = i - s * d;
      float dh = 0.f;
      for (int j = 0; j < KP; ++j)
        dh += rc<CB>(s_gn[s * KP + j]) * s_en[(size_t)j * d + e];
      if constexpr (!CBOW) {
        float dp = 0.f;
        for (int t = 0; t < NB; ++t) {
          const float g = s_gpb[s * NB + t];
          if (g != 0.f) dp += rc<CB>(g) * rc<CB>(bk_row(s + t, e));
        }
        a.d_ctr[bc * S * d + i] = dh + dp;
      } else {
        const float gp = s_gpc[s];
        a.d_ctr[bc * S * d + i] = gp * h_ws[i];
        float dh2 = dh + gp * a_row(s, e);
        // second divide (Word2Vec.cpp:313-315, pallas_step.py:259-260)
        if (a.cbow_mean) dh2 = dh2 / fmaxf(s_nctx[s], 1.f);
        dh_ws[i] = dh2;
      }
    }
    __syncthreads();

    // ---- slab-space context grads, overlap-added straight into token
    // order: slots [W, S+W) are this chunk's rows (plus the previous
    // chunk's right overhang in the first W), slots [0, W) add into the
    // previous chunk's last W rows, slots [S+W, S+2W) wait for the next
    float* tail_new = s_tail + (size_t)(c & 1) * W * d;
    const float* tail_old = s_tail + (size_t)((c + 1) & 1) * W * d;
    for (int i = tid; i < SK * d; i += kThreads) {
      const int k = i / d, e = i - k * d;
      const int lo = max(0, k - 2 * W), hi = min(S - 1, k);
      float y = 0.f;
      for (int s = lo; s <= hi; ++s) {
        if constexpr (!CBOW) {
          const float g = s_gpb[s * NB + (k - s)];
          if (g != 0.f) y += rc<CB>(g) * rc<CB>(a_row(s, e));
        } else {
          const float m = mask(s, k);
          if (m != 0.f) y += rc<CB>(m) * rc<CB>(dh_ws[(size_t)s * d + e]);
        }
      }
      if (k < W) {
        if (c > 0) a.d_ctx[((bc - 1) * S + (S - W + k)) * d + e] += y;
      } else if (k < S + W) {
        const int s = k - W;
        const float left = (s < W && c > 0) ? tail_old[(size_t)s * d + e] : 0.f;
        a.d_ctx[(bc * S + s) * d + e] = y + left;
      } else {
        tail_new[(size_t)(k - S - W) * d + e] = y;
      }
    }
    for (int k = tid; k < SK; k += kThreads) {
      const float y = s_cwy[k];
      if (k < W) {
        if (c > 0) a.ctx_w[(bc - 1) * S + (S - W + k)] += y;
      } else if (k < S + W) {
        const int s = k - W;
        const float left =
            (s < W && c > 0) ? s_cwtail[((c + 1) & 1) * W + s] : 0.f;
        a.ctx_w[bc * S + s] = y + left;
      } else {
        s_cwtail[(c & 1) * W + (k - S - W)] = y;
      }
    }

    // ---- d_neg = gn^T h and w_neg_sum over the row's first L positions,
    // continued from the previous chunk by the same thread
    const int s_end = min(S, a.L - c * S);
    for (int i = tid; i < KP * d; i += kThreads) {
      const int j = i / d, e = i - j * d;
      float acc = c == 0 ? 0.f : a.d_neg[(size_t)b * KP * d + i];
      for (int s = 0; s < s_end; ++s)
        acc += rc<CB>(s_gn[s * KP + j]) * rc<CB>(h_val(s, e));
      a.d_neg[(size_t)b * KP * d + i] = acc;
    }
    for (int j = tid; j < KP; j += kThreads) {
      float acc = s_wsum[j];
      for (int s = 0; s < s_end; ++s) acc += s_wn[s * KP + j];
      s_wsum[j] = acc;
    }
  }
  __syncthreads();
  for (int j = tid; j < KP; j += kThreads)
    a.w_neg_sum[(size_t)b * KP + j] = s_wsum[j];

  // per-row loss partials, reduced in a fixed order
  pos_acc = warp_sum(pos_acc);
  neg_acc = warp_sum(neg_acc);
  if (lane == 0) {
    s_red[warp] = pos_acc;
    s_red[kWarps + warp] = neg_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float p = 0.f, n = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      p += s_red[w];
      n += s_red[kWarps + w];
    }
    a.loss_part[(size_t)b * 2] = -p;
    a.loss_part[(size_t)b * 2 + 1] = -n;
  }
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
// vals[q, :width] added, each cell's terms in sorted order, rounded to T
// after every add. runs: the run list of idx (csrc/runs.cuh). NV values a
// vector; width, col0 and row_len are multiples of NV.
template <typename T, int NV>
__global__ void __launch_bounds__(kScThreads, 2)
    slab_scatter_kernel(T* __restrict__ emb, const int* __restrict__ idx,
                        const T* __restrict__ vals, const int* __restrict__ runs,
                        int n, int row_len, int col0, int width) {
  using V = Vec<T, NV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);  // [kRing][kStageTerms][kTileCols]
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

  // ---- long runs: one block per (run, 32-column tile), staged blocks of
  // kStageTerms terms through a ring of kRing: every thread issues the
  // copies of the block kRing - 1 ahead, warp 0 adds the oldest, in order
  constexpr int kTileVecs = kTileCols / NV;
  const int tiles = (width + kTileCols - 1) / kTileCols;
  const int items = n_long * tiles;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int run = it / tiles;
    const int c0 = (it - run * tiles) * kTileCols;
    const int tv = min(kTileCols, width - c0) / NV;  // ragged last tile
    const int2 se = longs[run];
    const int blocks = (se.y - se.x + kStageTerms - 1) / kStageTerms;
    // issue the copies of staged block b into ring slot b % kRing
    auto stage = [&](int b) {
      const int q0 = se.x + b * kStageTerms;
      const int cnt = min(kStageTerms, se.y - q0);
      V* s = reinterpret_cast<V*>(buf + (size_t)(b % kRing) * kStageTerms * kTileCols);
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
    };
#pragma unroll
    for (int b = 0; b < kRing - 1; ++b) {
      if (b < blocks) stage(b);
      cp_async_commit();
    }
    T* cell = emb + (size_t)idx[se.x] * row_len + col0 + c0 + lane;
    const bool adder = warp == 0 && lane < tv * NV;
    T acc{};
    if (adder) acc = *cell;
    for (int b = 0; b < blocks; ++b) {
      // slot (b - 1) % kRing was emptied before the last barrier
      if (b + kRing - 1 < blocks) stage(b + kRing - 1);
      cp_async_commit();
      cp_async_wait<kRing - 1>();  // this thread's copies of block b landed
      __syncthreads();             // everyone's did
      if (adder) {
        const T* s = buf + (size_t)(b % kRing) * kStageTerms * kTileCols + lane;
        const int cnt = min(kStageTerms, se.y - se.x - b * kStageTerms);
        // unrolled by 16: the shared-memory reads issue ahead of the chain
#pragma unroll 16
        for (int k = 0; k < cnt; ++k) acc = add_round(acc, s[k * kTileCols]);
      }
      __syncthreads();  // block b's slot may be refilled
    }
    if (adder) *cell = acc;
  }
}

int g_sms = 0;

template <typename T, int NV>
cudaError_t launch_scatter(T* emb, const int* idx, const T* vals,
                           const int* runs, int n, int row_len, int col0,
                           int width, cudaStream_t st) {
  auto kern = slab_scatter_kernel<T, NV>;
  const int smem = kRing * kStageTerms * kTileCols * (int)sizeof(T);
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
                                         col0, width);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scatter_vec(void* emb, const int* idx, const void* vals,
                               const int* runs, int n, int row_len, int col0,
                               int width, int vec, cudaStream_t st) {
  T* e = static_cast<T*>(emb);
  const T* v = static_cast<const T*>(vals);
  switch (vec) {
    case 4:
      return launch_scatter<T, 4>(e, idx, v, runs, n, row_len, col0, width, st);
    case 2:
      return launch_scatter<T, 2>(e, idx, v, runs, n, row_len, col0, width, st);
    case 1:
      return launch_scatter<T, 1>(e, idx, v, runs, n, row_len, col0, width, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool CB, bool CBOW>
cudaError_t launch_grad(const GradArgs& a, int B, size_t smem,
                        cudaStream_t st) {
  auto kern = grad_core_kernel<T, CB, CBOW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool CB>
cudaError_t launch_grad_model(const GradArgs& a, int B, size_t smem,
                              cudaStream_t st, int is_cbow) {
  return is_cbow ? launch_grad<T, CB, true>(a, B, smem, st)
                 : launch_grad<T, CB, false>(a, B, smem, st);
}

}  // namespace

extern "C" {

size_t w2v_grad_core_smem_bytes(int S, int SK, int KP, int d, int W) {
  return grad_smem_words(S, SK, KP, d, W) * sizeof(float);
}

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int w2v_fused_grad_core(const void* emb, int table_bf16, const int* tok_c,
                        const int* tok_k, const float* keep_c,
                        const float* w_c, const int* negs, float alpha,
                        float* d_ctr, float* d_ctx, float* n_ctx,
                        float* ctx_w, float* d_neg, float* w_neg_sum,
                        float* loss_part, float* losses, float* h_ws,
                        float* dh_ws, int B, int C, int S, int SK, int KP,
                        int d, int W, int K, int L, int cdt_bf16, int is_cbow,
                        int cbow_mean, void* stream) {
  GradArgs a{emb,   tok_c,     tok_k,     keep_c, w_c,   negs,  alpha,
             d_ctr, d_ctx,     n_ctx,     ctx_w,  d_neg, w_neg_sum,
             loss_part, h_ws,  dh_ws,     C,      S,     SK,    KP,
             d,     W,         K,         L,      cbow_mean};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = w2v_grad_core_smem_bytes(S, SK, KP, d, W);
  cudaError_t err;
  if (table_bf16) {
    err = cdt_bf16
              ? launch_grad_model<__nv_bfloat16, true>(a, B, smem, st, is_cbow)
              : launch_grad_model<__nv_bfloat16, false>(a, B, smem, st,
                                                        is_cbow);
  } else {
    err = cdt_bf16 ? launch_grad_model<float, true>(a, B, smem, st, is_cbow)
                   : launch_grad_model<float, false>(a, B, smem, st, is_cbow);
  }
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
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      table_bf16 ? launch_scatter_vec<__nv_bfloat16>(emb, idx, vals, runs, n,
                                                     row_len, col0, width, vec, st)
                 : launch_scatter_vec<float>(emb, idx, vals, runs, n, row_len,
                                             col0, width, vec, st);
  return (int)err;
}

}  // extern "C"
