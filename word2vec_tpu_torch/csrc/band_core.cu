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
// 3.35 TB/s. Its contractions (about 8 GFLOP a step that the band and the
// negatives need) are far under the bf16 tensor-core peak, but would take
// about as long as the bytes on the f32 CUDA cores.
//
// What the design does about it. The TPU kernel walks a sequential
// (B, C) grid and accumulates d_neg, w_neg_sum and the losses across grid
// steps in its output blocks, which GPU blocks (no order, no carry) cannot
// do; one (b, c) tile's a, bk and en in f32 (141 + 154 + 77 KB) is above
// the 227 KB of shared memory a block has. So, as in the slice-1 grad core
// (csrc/fused_step.cu):
//   * one CTA per batch row loops over its C chunks; the sequential grid
//     dimension becomes that loop;
//   * shared memory keeps the chunk's band-compressed [S, 2W+1] positive
//     gradient, the [S, KP] negative tiles (gradient weights and w_neg)
//     and the KP negative rows rounded to the compute type (~146 KB at
//     the flagship); a and bk rows are read through L2;
//   * d_neg is the TPU kernel's shape of reduction: a contraction over
//     the chunk's S positions, then added over c in order by the thread
//     that owns the output (pallas_band.py:158, 198); w_neg_sum likewise;
//   * under batch scope every row writes its own partial [KP, d] and
//     [KP]; a second kernel adds the rows in order (0..B-1). The losses
//     leave as per-row partials reduced the same way. Deterministic, and
//     within f32 rounding of the TPU kernel's single running sum.
// Every contraction rounds both operands to the compute type (bf16 by
// default) and accumulates in f32, as the Pallas `dot` does; the products
// are scalar f32 multiply-adds (tensor cores are later work). The positive
// side only visits the band and skips masked pairs, whose terms are exact
// zeros in the Pallas kernel too. The cbow center logit is an f32 multiply
// and row sum of cdt-rounded operands (pallas_band.py:175-179).
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

struct BandArgs {
  const void* a;         // [B, C, S, d] T   center rows (zero past L)
  const void* bk;        // [B, C, SK, d] T  context slabs (zero outside)
  const void* en;        // [NB, KP, d] T    negative rows
  const int* tok_c;      // [B, C, S] center ids, -1 past the row
  const int* tok_k;      // [B, C, SK] slab ids, -1 outside the row
  const float* keep_c;   // [B, C, S]
  const float* w_c;      // [B, C, S]
  const int* negs;       // [NB, KP]
  float alpha;
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
};

// shared memory of one block, in 4-byte words, in band_core_kernel's order
inline size_t band_smem_words(int S, int SK, int KP, int d, int W) {
  const int NB = 2 * W + 1;
  return (size_t)S * 4          // tok_c, keep, w, n_ctx
         + (size_t)SK * 2       // tok_k, cwy
         + (size_t)KP * 2       // negs, wsum
         + (size_t)S * NB       // band-compressed gp (sg)
         + (size_t)S            // gp per center (cbow)
         + (size_t)S * KP * 2   // gn, w_neg
         + (size_t)KP * d       // negative rows, rounded to cdt
         + (size_t)2 * kWarps;  // loss block reduction
}

template <typename T, bool CB, bool CBOW>
__global__ void __launch_bounds__(kThreads)
    band_core_kernel(const BandArgs p) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int C = p.C, S = p.S, SK = p.SK, KP = p.KP, d = p.d, W = p.W;
  const int NB = 2 * W + 1;
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
  float* s_wsum = reinterpret_cast<float*>(s_negs + KP);
  float* s_gpb = s_wsum + KP;
  float* s_gpc = s_gpb + (size_t)S * NB;
  float* s_gn = s_gpc + S;
  float* s_wn = s_gn + (size_t)S * KP;
  float* s_en = s_wn + (size_t)S * KP;
  float* s_red = s_en + (size_t)KP * d;

  // the band mask (pallas_band.py:113-122): keep_s & valid_k & 0 < dist <= w_s
  auto mask = [&](int s, int k) -> float {
    const int dist = abs(s + W - k);
    const bool on = s_tokk[k] >= 0 && (float)dist <= s_w[s] && dist > 0;
    return on ? s_keep[s] : 0.f;
  };
  float* h_ws = p.h_ws + (size_t)b * S * d;
  float* dh_ws = p.dh_ws + (size_t)b * S * d;

  float pos_acc = 0.f;  // sum of mask * log_sigmoid(plog)
  float neg_acc = 0.f;  // sum of w_neg * (log_sigmoid(nlog) - nlog)

  // once per row: the KP negative rows, rounded to cdt
  for (int j = tid; j < KP; j += kThreads) {
    s_negs[j] = p.negs[(size_t)nb * KP + j];
    s_wsum[j] = 0.f;
  }
  for (int i = tid; i < KP * d; i += kThreads) s_en[i] = rc<CB>(to_f(EN[i]));

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

    // ---- mask row sums (n_ctx) and slab column sums (ctx_w): 0/1 sums,
    // exact in any order
    for (int s = tid; s < S; s += kThreads) {
      float n = 0.f;
      for (int k = s; k <= s + 2 * W; ++k) n += mask(s, k);
      s_nctx[s] = n;
      p.n_ctx[bc * S + s] = n;
    }
    for (int k = tid; k < SK; k += kThreads) {
      float cw = 0.f;
      const int lo = max(0, k - 2 * W), hi = min(S - 1, k);
      for (int s = lo; s <= hi; ++s) cw += mask(s, k);
      s_cwy[k] = cw;
      p.ctx_w[bc * SK + k] = cw;
    }
    __syncthreads();

    // ---- negative weights (collision masks, pallas_band.py:144-154):
    // center_hit compares the raw, -1-padded center ids
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
          CBOW ? (n > 0.f ? (float)p.K : 0.f) : n * (float)p.K;
      s_wn[i] = (k_i / (float)KP) * neg_ok;
    }
    if constexpr (CBOW) {
      // projection h = mask @ bk (divided by n_ctx under cbow_mean)
      for (int i = tid; i < S * d; i += kThreads) {
        const int s = i / d, e = i - s * d;
        float acc = 0.f;
        for (int k = s; k <= s + 2 * W; ++k) {
          const float m = mask(s, k);
          if (m != 0.f) acc += rc<CB>(m) * rc<CB>(to_f(bk[(size_t)k * d + e]));
        }
        if (p.cbow_mean) acc = acc / fmaxf(s_nctx[s], 1.f);
        h_ws[i] = acc;
      }
    }
    __syncthreads();

    // ---- negative logits and gradient weights, one warp per (s, j)
    for (int q = warp; q < S * KP; q += kWarps) {
      const int s = q / KP, j = q - s * KP;
      float part = 0.f;
      for (int e = lane; e < d; e += 32)
        part += rc<CB>(h_val(s, e)) * s_en[(size_t)j * d + e];
      const float nlog = warp_sum(part);
      if (lane == 0) {
        const float wn = s_wn[q];
        s_gn[q] = (0.f - sigmoid_stable(nlog)) * wn * p.alpha;
        neg_acc += wn * (log_sigmoid(nlog) - nlog);
      }
    }
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
          part += rc<CB>(to_f(a[(size_t)s * d + e])) *
                  rc<CB>(to_f(bk[(size_t)k * d + e]));
        const float plog = warp_sum(part);
        if (lane == 0) {
          s_gpb[q] = (1.f - sigmoid_stable(plog)) * m * p.alpha;
          pos_acc += m * log_sigmoid(plog);
        }
      }
    } else {
      // center logit: f32 multiply and row sum of cdt-rounded h and a
      for (int s = warp; s < S; s += kWarps) {
        float part = 0.f;
        for (int e = lane; e < d; e += 32)
          part += rc<CB>(h_val(s, e)) * rc<CB>(to_f(a[(size_t)s * d + e]));
        const float plog = warp_sum(part);
        if (lane == 0) {
          const float active = s_nctx[s] > 0.f ? 1.f : 0.f;
          s_gpc[s] = (1.f - sigmoid_stable(plog)) * active * p.alpha;
          pos_acc += active * log_sigmoid(plog);
        }
      }
    }
    __syncthreads();

    // ---- center-side rows: d_hid = gn @ en, plus the band product (sg);
    // the center's out-row update and the hidden grad (cbow)
    for (int i = tid; i < S * d; i += kThreads) {
      const int s = i / d, e = i - s * d;
      float dh = 0.f;
      for (int j = 0; j < KP; ++j)
        dh += rc<CB>(s_gn[s * KP + j]) * s_en[(size_t)j * d + e];
      if constexpr (!CBOW) {
        float dp = 0.f;
        for (int t = 0; t < NB; ++t) {
          const float g = s_gpb[s * NB + t];
          if (g != 0.f) dp += rc<CB>(g) * rc<CB>(to_f(bk[(size_t)(s + t) * d + e]));
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
    __syncthreads();

    // ---- slab-space context grads: slot k sums the centers s in
    // [k-2W, k] that see it (zero at invalid slots: their mask column is 0)
    for (int i = tid; i < SK * d; i += kThreads) {
      const int k = i / d, e = i - k * d;
      const int lo = max(0, k - 2 * W), hi = min(S - 1, k);
      float y = 0.f;
      for (int s = lo; s <= hi; ++s) {
        if constexpr (!CBOW) {
          const float g = s_gpb[s * NB + (k - s)];
          if (g != 0.f) y += rc<CB>(g) * rc<CB>(to_f(a[(size_t)s * d + e]));
        } else {
          const float m = mask(s, k);
          if (m != 0.f) y += rc<CB>(m) * rc<CB>(dh_ws[(size_t)s * d + e]);
        }
      }
      p.d_ctx[bc * SK * d + i] = y;
    }

    // ---- d_neg: this chunk's contraction over its S positions, then
    // added to the sum over the earlier chunks by the same thread
    float* dneg = p.dneg_row + (size_t)b * KP * d;
    for (int i = tid; i < KP * d; i += kThreads) {
      const int j = i / d, e = i - j * d;
      float part = 0.f;
      for (int s = 0; s < S; ++s)
        part += rc<CB>(s_gn[s * KP + j]) * rc<CB>(h_val(s, e));
      dneg[i] = c == 0 ? part : dneg[i] + part;
    }
    for (int j = tid; j < KP; j += kThreads) {
      float part = 0.f;
      for (int s = 0; s < S; ++s) part += s_wn[s * KP + j];
      s_wsum[j] += part;
    }
  }
  __syncthreads();
  for (int j = tid; j < KP; j += kThreads)
    p.wsum_row[(size_t)b * KP + j] = s_wsum[j];

  // per-row loss partials, reduced in a fixed order
  pos_acc = warp_sum(pos_acc);
  neg_acc = warp_sum(neg_acc);
  if (lane == 0) {
    s_red[warp] = pos_acc;
    s_red[kWarps + warp] = neg_acc;
  }
  __syncthreads();
  if (tid == 0) {
    float ps = 0.f, ns = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      ps += s_red[w];
      ns += s_red[kWarps + w];
    }
    p.loss_part[(size_t)b * 2] = -ps;
    p.loss_part[(size_t)b * 2 + 1] = -ns;
  }
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

template <typename T, bool CB, bool CBOW>
cudaError_t launch_band(const BandArgs& p, int B, size_t smem,
                        cudaStream_t st) {
  auto kern = band_core_kernel<T, CB, CBOW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<B, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <typename T, bool CB>
cudaError_t launch_band_model(const BandArgs& p, int B, size_t smem,
                              cudaStream_t st, int is_cbow) {
  return is_cbow ? launch_band<T, CB, true>(p, B, smem, st)
                 : launch_band<T, CB, false>(p, B, smem, st);
}

cudaError_t reduce_rows(const float* part, float* out, int B, int n,
                        cudaStream_t st) {
  rows_reduce_kernel<<<(n + 255) / 256, 256, 0, st>>>(part, out, B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

size_t w2v_band_core_smem_bytes(int S, int SK, int KP, int d, int W) {
  return band_smem_words(S, SK, KP, d, W) * sizeof(float);
}

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Row scope (neg_shared = 0): dneg_row/wsum_row are the d_neg [B, KP, d]
// and w_neg_sum [B, KP] outputs. Batch scope: they are per-row partials,
// reduced in row order into d_neg [1, KP, d] and w_neg_sum [1, KP].
int w2v_band_core(const void* a, const void* bk, const void* en,
                  int table_bf16, const int* tok_c, const int* tok_k,
                  const float* keep_c, const float* w_c, const int* negs,
                  float alpha, float* d_h, float* d_ctx, float* n_ctx,
                  float* ctx_w, float* dneg_row, float* wsum_row,
                  float* d_neg, float* w_neg_sum, float* loss_part,
                  float* losses, float* h_ws, float* dh_ws, int B, int C,
                  int S, int SK, int KP, int d, int W, int K, int neg_shared,
                  int cdt_bf16, int is_cbow, int cbow_mean, void* stream) {
  BandArgs p{a,        bk,        en,     tok_c,    tok_k,     keep_c,
             w_c,      negs,      alpha,  d_h,      d_ctx,     n_ctx,
             ctx_w,    dneg_row,  wsum_row, loss_part, h_ws,    dh_ws,
             C,        S,         SK,     KP,       d,         W,
             K,        neg_shared, cbow_mean};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = w2v_band_core_smem_bytes(S, SK, KP, d, W);
  cudaError_t err;
  if (table_bf16) {
    err = cdt_bf16
              ? launch_band_model<__nv_bfloat16, true>(p, B, smem, st, is_cbow)
              : launch_band_model<__nv_bfloat16, false>(p, B, smem, st,
                                                        is_cbow);
  } else {
    err = cdt_bf16 ? launch_band_model<float, true>(p, B, smem, st, is_cbow)
                   : launch_band_model<float, false>(p, B, smem, st, is_cbow);
  }
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
