// Tile code shared by the two band-core kernels: grad_core (csrc/fused_step.cu,
// the port of word2vec_tpu/ops/pallas_step.py fused_grad_core) and band_core
// (csrc/band_core.cu, the port of word2vec_tpu/ops/pallas_band.py band_core).
//
// Both kernels run one CTA of kThreads per batch row and walk its C chunks
// of S centers and SK = S + 2W slab slots, each chunk in center pieces of
// at most kSc centers (below). What they share lives here:
//   * the band mask and the negative gradient weights (collision masks);
//   * the operand rounding to the compute type (the Pallas `dot`'s
//     astype(cdt)) and the stable sigmoid / log-sigmoid;
//   * the bf16 shared-memory layout of a chunk's dense operands
//     (TileLayout): the center rows or cbow projection A [SP x lda], the
//     negative rows E [KPP x lda] and the negative gradient weights
//     G [SP x ldg], zero-padded to the mma tile (S, KP and d rounded up
//     to 16) plus kRowPad columns, so the eight row addresses of one
//     ldmatrix fall on eight distinct bank groups;
//   * the pieces: the tiles hold at most kSc centers, kKPc negative rows
//     and kDc columns, and a center piece's band weights at most kKc slab
//     slots, so a block's shared memory stops growing with S, KP, d and W
//     past one piece. A chunk of more centers is walked in center pieces i
//     of Sp <= kSc centers (the first at center s0 = i kSc), each with the
//     Sp + 2W slab slots its band reaches, the 2W slots shared with the
//     next pieces included; a wider pool or row is walked piece by piece
//     (piece_pass, and the kernels' loops over p and q); a center piece
//     whose Sp + 2W slots exceed kKc is walked in slot pieces j of at most
//     kKc slots (from slot k0 = j kKc of the piece), its sg band weights gp
//     an [Sp x kKc] block of one slot piece at a time (bf16 in the
//     tensor-core bodies, which only read them rounded), its slab ids
//     staged in a fixed room of kTokRoom while they fit and read from
//     device memory (through L1) past it. The sums that cross pieces keep
//     the order of one unpieced product:
//       - the negative logits A E^T and the sg band logits A bk^T sum
//         over the width pieces q = 0, 1, ... in one register accumulator
//         per output block (piece_pass), k-slice after k-slice, exactly
//         as one product over the whole width does;
//       - d_hid = G E sums over the negative pieces p = 0, 1, ...: the
//         f32 accumulator of each output value goes to device memory (the
//         output row itself, or cbow's d_hid workspace) after piece p and
//         is loaded again, by the thread that owns the value, before
//         piece p + 1; the last piece continues it with the sg band
//         product. f32 stores and loads are exact, so this is the
//         unpieced order too;
//       - d_neg = G^T A and w_neg_sum sum over the chunk's S positions:
//         inside one negative and width piece (p, q), whose pieces only
//         cut which outputs a pass writes; across the center pieces the
//         chunk's f32 accumulator goes to device memory (a workspace: the
//         output holds the earlier chunks' sum) after piece i and is
//         loaded again, by the thread that owns the value, before piece
//         i + 1 (the fused core's w_neg_sum, one running sum over the
//         row's positions, continues in its output). Pieces are multiples
//         of 16 centers, so the k-slices add in the order of one unpieced
//         product; the sum over chunks stays in the output, in chunk
//         order, by the thread that owns each value;
//       - the context sums over centers (the slab-space d_ctx and ctx_w
//         of band_core, the fused core's before its overlap-add): a slot
//         that piece i + 1 reaches too (its first 2W slots, rounded up
//         to whole [16 x 16] blocks) leaves piece i as its f32
//         accumulator (band_core's output rows, the fused core's carry
//         workspace) and piece i + 1 continues it (context_tiles' init)
//         over its own depth blocks: the unpieced order again; ctx_w's
//         0/1 column sums add piece after piece (exact in any order);
//       - the sums over the slots of a center's band, in slot pieces:
//         the sg band product gp bk continues d_hid's accumulator (slot
//         piece 0 in the negatives' pass, as one piece adds its band),
//         which goes to device memory (the output row) after each slot
//         piece and is loaded again, by the thread that owns the value,
//         before the next, whose k-slices of 16 slots follow in slot order
//         (pieces are multiples of 16 slots): the unpieced order; cbow's
//         projection mask bk needs no gp and reads the whole band in one
//         accumulator; a slot's context sum over the centers of one
//         center piece lies inside one slot piece; n_ctx,
//         ctx_w and the collision counts ctx_hit sum 0/1 terms (exact in
//         any order): warp sums, column sums read at the write, and a
//         tensor-core product mask . hit_k (neg_weights_mma,
//         pallas_band.py:151) over the whole band;
//       - d_hid, n_ctx, the band and negative logits, cbow's projection
//         are per center: a piece computes its own centers' whole sums;
//       - the loss partials add piece after piece in each thread, then
//         the block sum in warp order (block_losses). They are the one
//         output that does not keep the unpieced order: which thread adds
//         which term follows the piece's warp tasks, so the losses of one
//         chunk in pieces of two lengths agree to rounding, not bitwise.
//     No atomics anywhere: two calls are bitwise equal. A chunk of at
//     most kSc centers whose S + 2W slots fit one slot piece runs no
//     carry (its own instantiation in the tensor-core bodies); the
//     pieced instantiation skips the products of 16 centers whose mask
//     rows are all zero (n_ctx 0: past the row, or dropped), so its time
//     follows the row's centers, not the chunk's;
//   * the tensor-core tile products (ldmatrix + mma.sync.m16n8k16, bf16
//     operands, f32 accumulate, one [16 x 16] output block per warp task,
//     every output value owned by one thread):
//       - tile_pass: both operands from the staged tiles, either one
//         stored transposed, the accumulator started at zero or at a
//         carried partial sum, the depth cut at `kvalid` in the registers
//         (d_neg's sum over exactly the row's first L positions): d_hid =
//         G E, d_neg = G^T A; piece_pass, its depth in width pieces: the
//         negative logits A E^T;
//       - the band side, whose context rows bk do not fit in shared memory
//         beside the tiles and are read from L1/L2 straight into mma
//         operands: the sg band logits A bk^T (rows_bk_mma), the band
//         matrix of slot weights (gp, or the cbow mask) built in the
//         A registers against bk (band_rows_mma: the sg band product, the
//         cbow projection) or against A (context_tiles: the slab-space
//         context gradients);
//   * the per-phase cycle record (PhaseClock).
// Plain device code, no PyTorch headers (the library builds in seconds).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w2v_band {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the tensor-core tile of mma.sync.m16n8k16: rows, columns, depth; a warp
// task is a [kMmaM x 2 kMmaN] output block
constexpr int kMmaM = 16;
constexpr int kMmaN = 8;
constexpr int kMmaK = 16;
// bf16 columns added to every staged row (16 bytes): a row stride of
// 16 (mod 128) bytes puts the 8 rows of an ldmatrix on distinct banks
constexpr int kRowPad = 8;
// the pieces the tiles hold: centers a piece (a multiple of kMmaM: the
// center pieces cut the depth of d_neg and of the context sums at whole
// k-slices), negative rows a piece (a multiple of 16) and columns a piece
// (a multiple of kMmaK), and slab slots a slot piece (a multiple of kMmaK:
// the slot pieces cut the depth of the band product at whole k-slices);
// the flagship (S 118, KP 64, d 300, S + 2W = 128) and every auto chunk
// up to W 40 (S + 2W <= 160) are one piece of each, and a center piece of
// 128 is one slot piece up to W 16. What bounds a block is these four
// constants and kTokRoom alone: one piece of each fits the 232,448 B a
// block may use (225,152 B, the most, in the pieced tensor-core body), at
// every W, S, KP and d. A slot reaches back at most 2W centers, so it is
// shared by up to ceil(2W / kSc) + 1 center pieces; its context sum is
// handed on through the middle ones (carry_rows)
constexpr int kSc = 128;
constexpr int kKPc = 64;
constexpr int kDc = 304;
constexpr int kKc = 160;
// bf16 columns of a row of the pieced bodies' band weights (one slot
// piece plus kRowPad: the 8 rows a k-slice reads fall on distinct banks)
constexpr int kGpLd = kKc + kRowPad;
// slab ids the pieced bodies stage for a center piece (its Sp + 2W slots
// while they fit: every W up to 960; a wider band's are read from device
// memory, through L1)
constexpr int kTokRoom = 2048;
// [16 x 16] output blocks a warp holds at once across the width pieces
constexpr int kSlots = 2;

// phases of the cycle record, in the order a chunk runs them in the
// tensor-core kernels; the f32-compute bodies record the same names
enum Phase {
  kPhaseRows,     // ids and rows staged (the negative rows once per row)
  kPhaseMasks,    // n_ctx, ctx_w, negative weights (cbow: the projection)
  kPhaseLogits,   // negative logits and weights; band or center logits
  kPhaseNeg,      // d_neg and w_neg_sum
  kPhaseCenter,   // d_hid and the center-side gradient
  kPhaseContext,  // the context-side gradient (overlap-add in grad_core)
  kPhaseTail,     // w_neg_sum out, the loss partials
  kPhases
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

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

// A chunk's ids and gates in shared memory, and what the two kernels
// compute from them alone (pallas_step.py:185-223, pallas_band.py:113-154).
struct Band {
  const int* tokc;     // [S] center ids (clamped in grad_core, raw in band_core)
  const float* keep;   // [S]
  const float* w;      // [S] shrunk window
  const float* nctx;   // [S] mask row sums, once computed
  const int* tokk;     // [SK] slab ids, -1 outside the row
  const int* negs;     // [KPp] the ids of the negative piece in hand
  int S, W, K, KP;     // KP: the whole pool (the weights' divisor)

  // keep_s & valid_k & 0 < |s + W - k| <= w_s
  __device__ __forceinline__ float mask(int s, int k) const {
    const int dist = abs(s + W - k);
    const bool on = tokk[k] >= 0 && (float)dist <= w[s] && dist > 0;
    return on ? keep[s] : 0.f;
  }
  // n_ctx: the mask row sum (0/1 terms: exact in any order)
  __device__ __forceinline__ float row_sum(int s) const {
    float n = 0.f;
    for (int k = s; k <= s + 2 * W; ++k) n += mask(s, k);
    return n;
  }
  // ctx_w of slab slot k: the mask column sum
  __device__ __forceinline__ float col_sum(int k) const {
    float cw = 0.f;
    const int lo = max(0, k - 2 * W), hi = min(S - 1, k);
    for (int s = lo; s <= hi; ++s) cw += mask(s, k);
    return cw;
  }
  // w_neg of (center s, negative j): K (or K per context under sg) / KP,
  // zero where the draw collides with the center or a context it sees
  template <bool CB, bool CBOW>
  __device__ __forceinline__ float neg_weight(int s, int j) const {
    const int neg = negs[j];
    float ctx_hit = 0.f;
    for (int k = s; k <= s + 2 * W; ++k) {
      const float m = mask(s, k);
      if (m != 0.f && tokk[k] == neg) ctx_hit += rc<CB>(m);
    }
    return weight<CBOW>(s, j, ctx_hit);
  }
  // w_neg of (s, j) from its context collision count ctx_hit
  template <bool CBOW>
  __device__ __forceinline__ float weight(int s, int j, float ctx_hit) const {
    const float center_hit = tokc[s] == negs[j] ? 1.f : 0.f;
    const float neg_ok = 1.f - fminf(fmaxf(center_hit + ctx_hit, 0.f), 1.f);
    const float n = nctx[s];
    const float k_i = CBOW ? (n > 0.f ? (float)K : 0.f) : n * (float)K;
    return (k_i / (float)KP) * neg_ok;
  }
};

// n_ctx of the piece's centers into s_nctx and out (device memory): one
// warp a center, its band's mask summed lane by lane, then warp_sum (0/1
// terms: exact in any order), so a wide band costs (2W + 1) / 32 reads a
// lane
__device__ __forceinline__ void row_sums(const Band& band, float* s_nctx,
                                         float* out) {
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x >> 5; s < band.S; s += kWarps) {
    float n = 0.f;
    for (int k = s + lane; k <= s + 2 * band.W; k += 32) n += band.mask(s, k);
    n = warp_sum(n);
    if (lane == 0) {
      s_nctx[s] = n;
      out[s] = n;
    }
  }
}

// true when some center of [s0, s0 + 16) has a mask row that is not all
// zero (n_ctx > 0); a warp-wide answer, every lane must call it
__device__ __forceinline__ bool rows_active(const float* nctx, int s0, int S) {
  const int s = s0 + (threadIdx.x & 15);
  return __any_sync(kFull, s < S && nctx[s] > 0.f);
}

// the length of piece i, and the count of pieces, of n cut in pieces of
// `piece` (the last one ragged)
__host__ __device__ inline int piece_len(int n, int piece, int i) {
  return n - i * piece < piece ? n - i * piece : piece;
}
__host__ __device__ inline int pieces(int n, int piece) {
  return (n + piece - 1) / piece;
}

// The bf16 tiles of the tensor-core bodies, at the head of dynamic shared
// memory: A [SP][lda], E [KPP][lda], G [SP][ldg], one piece wide (at most
// kSc centers, kDc columns, kKPc negative rows); f32 words follow.
struct TileLayout {
  int SP, DP, KPP, lda, ldg;
  __host__ __device__ TileLayout(int S, int KP, int d)
      : SP(round_up(S < kSc ? S : kSc, kMmaM)),
        DP(round_up(d < kDc ? d : kDc, kMmaK)),
        KPP(round_up(KP < kKPc ? KP : kKPc, 2 * kMmaN)),
        lda(DP + kRowPad),
        ldg(KPP + kRowPad) {}
  __host__ __device__ size_t a_elems() const { return (size_t)SP * lda; }
  __host__ __device__ size_t e_elems() const { return (size_t)KPP * lda; }
  __host__ __device__ size_t g_elems() const { return (size_t)SP * ldg; }
  __host__ __device__ size_t bf16_bytes() const {
    return (a_elems() + e_elems() + g_elems()) * sizeof(__nv_bfloat16);
  }
};

// rows of a carry between center pieces of the context sums: the next
// piece's first 2W slots, rounded up to whole [16 x 16] output blocks
__host__ __device__ inline int carry_rows(int W) { return round_up(2 * W, kMmaM); }

// a chunk of S centers in more than one center or slot piece: the
// tensor-core bodies' pieced instantiation
__host__ __device__ inline bool chunk_pieced(int S, int W) {
  return S > kSc || S + 2 * W > kKc;
}

// shared memory of the pieced tensor-core bodies (both kernels), in bytes:
// the tiles, one slot piece of bf16 band weights [SP x kGpLd], then in
// 4-byte words tok_c, keep, w, n_ctx, the staged slab ids, the negative
// ids, gp per center (cbow), w_neg of the negative piece and the loss
// reduction; no W
__host__ __device__ inline size_t pieced_tc_smem_bytes(int S, int KP, int d) {
  const TileLayout tl(S, KP, d);
  const int Sc = S < kSc ? S : kSc;
  const int KPc = KP < kKPc ? KP : kKPc;
  const size_t words =
      (size_t)Sc * 4 + kTokRoom + KPc + Sc + (size_t)Sc * KPc + 2 * kWarps;
  return tl.bf16_bytes() + (size_t)tl.SP * kGpLd * sizeof(__nv_bfloat16) +
         words * sizeof(float);
}

// ---------------------------------------------------------------- mma
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 operands, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// zero the bf16 halves of a packed pair (columns k, k + 1) at k >= kvalid
__device__ __forceinline__ uint32_t cut_pair(uint32_t v, int k, int kvalid) {
  return k >= kvalid ? 0u : (k + 1 >= kvalid ? (v & 0xffffu) : v);
}

// acc += A[m0 : m0+16, 0 : K] x B[0 : K, n0 : n0+16] for one warp, both
// operands bf16 in shared memory, K a multiple of kMmaK:
//   AT = false: A[m][k] at A + m * lda + k;  AT = true: A[k][m] at A + k * lda + m
//   BT = false: B[k][n] at B + n * ldb + k;  BT = true: B[k][n] at B + k * ldb + n
// acc[t] is the m16n8 fragment of columns n0 + 8t: acc[t][0..1] at row
// m0 + lane/4, columns 2 (lane%4) + {0, 1}; acc[t][2..3] 8 rows below.
// Depth k >= kvalid contributes nothing (A's columns there are zeroed).
template <bool AT, bool BT>
__device__ __forceinline__ void warp_mma_16x16(
    float (&acc)[2][4], const __nv_bfloat16* A, int lda, int m0,
    const __nv_bfloat16* B, int ldb, int n0, int K, int kvalid) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  // this lane's ldmatrix row address at depth 0 (matrix i, row r)
  const __nv_bfloat16* pa =
      AT ? A + (size_t)(r + ((i >> 1) << 3)) * lda + m0 + ((i & 1) << 3)
         : A + (size_t)(m0 + (lane & 15)) * lda + ((lane >> 4) << 3);
  const __nv_bfloat16* pb =
      BT ? B + (size_t)(r + ((i & 1) << 3)) * ldb + n0 + ((i >> 1) << 3)
         : B + (size_t)(n0 + r + ((i >> 1) << 3)) * ldb + ((i & 1) << 3);
  const int kl = 2 * (lane & 3);
  for (int k = 0; k < K; k += kMmaK) {
    uint32_t a[4], b[4];
    if constexpr (AT) {
      ldsm_x4_t(a, pa + (size_t)k * lda);
    } else {
      ldsm_x4(a, pa + k);
    }
    if constexpr (BT) {
      ldsm_x4_t(b, pb + (size_t)k * ldb);
    } else {
      ldsm_x4(b, pb + k);
    }
    if (k + kMmaK > kvalid) {
      a[0] = cut_pair(a[0], k + kl, kvalid);
      a[1] = cut_pair(a[1], k + kl, kvalid);
      a[2] = cut_pair(a[2], k + kl + 8, kvalid);
      a[3] = cut_pair(a[3], k + kl + 8, kvalid);
    }
    mma_bf16(acc[0], a, b[0], b[1]);
    mma_bf16(acc[1], a, b[2], b[3]);
  }
}

// call f(row, col, val) for each of this lane's two rows of the [16 x 16]
// accumulator block at (m0, n0): col[4] its four columns, val[4] the values
template <typename F>
__device__ __forceinline__ void for_each_row(const float (&acc)[2][4], int m0,
                                             int n0, F&& f) {
  const int lane = threadIdx.x & 31;
  const int r = m0 + (lane >> 2), c = n0 + 2 * (lane & 3);
  const int col[4] = {c, c + 1, c + 8, c + 9};
  const float top[4] = {acc[0][0], acc[0][1], acc[1][0], acc[1][1]};
  const float bottom[4] = {acc[0][2], acc[0][3], acc[1][2], acc[1][3]};
  f(r, col, top);
  f(r + 8, col, bottom);
}

// one warp per [16 x 16] block of an [M x N] output (M, N multiples of
// 16; its rows from m_lo): fill(acc, m0, n0) forms the block's
// accumulators, then f(row, col, val) as in for_each_row; every output
// value owned by one thread
template <typename Fill, typename F>
__device__ __forceinline__ void block_pass(int M, int N, Fill&& fill, F&& f,
                                           int m_lo = 0) {
  const int nn = N / (2 * kMmaN);
  const int tasks = (M / kMmaM) * nn;
  for (int t = threadIdx.x >> 5; t < tasks; t += kWarps) {
    const int m0 = m_lo + t / nn * kMmaM, n0 = t % nn * (2 * kMmaN);
    float acc[2][4] = {};
    fill(acc, m0, n0);
    for_each_row(acc, m0, n0, f);
  }
}

// the block's [M x N] = A[M x K] x B[K x N] (K a multiple of kMmaK), both
// operands in shared memory (warp_mma_16x16), each block's accumulator
// started by init(acc, m0, n0) (zero, or a partial sum read back: an
// earlier center piece's), f as in block_pass
template <bool AT, bool BT, typename Init, typename F>
__device__ __forceinline__ void tile_pass(int M, int N, int K, int kvalid,
                                          const __nv_bfloat16* A, int lda,
                                          const __nv_bfloat16* B, int ldb,
                                          Init&& init, F&& f) {
  block_pass(
      M, N,
      [&](float (&acc)[2][4], int m0, int n0) {
        init(acc, m0, n0);
        warp_mma_16x16<AT, BT>(acc, A, lda, m0, B, ldb, n0, K, kvalid);
      },
      f);
}

// An [M x N] output (M, N multiples of 16) whose depth is cut in nq
// pieces: for each piece q, stage(q) (a block-wide call that may restage
// the tiles between barriers), then fill(acc, m0, n0, q) adds piece q's
// products into the block at (m0, n0); after the last piece, f(row, col,
// val) as in for_each_row. A warp holds kSlots blocks at once (tasks
// t = warp + kWarps i, as block_pass assigns them), in rounds when there
// are more, so every block sums its whole depth in one accumulator,
// piece after piece: the order of one product over the whole depth.
template <typename Stage, typename Fill, typename F>
__device__ __forceinline__ void piece_pass(int M, int N, int nq, Stage&& stage,
                                           Fill&& fill, F&& f) {
  const int nn = N / (2 * kMmaN);
  const int tasks = (M / kMmaM) * nn;
  const int warp = threadIdx.x >> 5;
  for (int t0 = 0; t0 < tasks; t0 += kSlots * kWarps) {
    float acc[kSlots][2][4] = {};
    for (int q = 0; q < nq; ++q) {
      stage(q);
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int t = t0 + warp + kWarps * i;
        if (t < tasks) fill(acc[i], t / nn * kMmaM, t % nn * (2 * kMmaN), q);
      }
    }
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int t = t0 + warp + kWarps * i;
      if (t < tasks) for_each_row(acc[i], t / nn * kMmaM, t % nn * (2 * kMmaN), f);
    }
  }
}

// acc = g(row, col) at this lane's places of the [16 x 16] block at
// (m0, n0), the layout for_each_row reads (a partial sum read back)
template <typename G>
__device__ __forceinline__ void load_block(float (&acc)[2][4], int m0, int n0,
                                           G&& g) {
  const int lane = threadIdx.x & 31;
  const int r = m0 + (lane >> 2), c = n0 + 2 * (lane & 3);
  acc[0][0] = g(r, c);
  acc[0][1] = g(r, c + 1);
  acc[1][0] = g(r, c + 8);
  acc[1][1] = g(r, c + 9);
  acc[0][2] = g(r + 8, c);
  acc[0][3] = g(r + 8, c + 1);
  acc[1][2] = g(r + 8, c + 8);
  acc[1][3] = g(r + 8, c + 9);
}

// ------------------------------------------------ a chunk's band side
// The context rows bk do not fit in shared memory beside the tiles: the
// band products read them from L1/L2 straight into mma B operands (k, e),
// bk_row(k) null for an invalid slot (a zero row). The band matrix, the
// weight w(s, k) of slot k seen from center s (zero outside the band), is
// built in the A-operand registers.
constexpr int kCols = 8;  // 32-column strides of a row a lane loads at once

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

template <typename P>
__device__ __forceinline__ float row_val(P p, int e, int d) {
  return (p != nullptr && e < d) ? to_f(p[e]) : 0.f;
}

// dst[r][e] = row(r)[e] as bf16 for r < n_valid and e < d, zero over the
// rest of [rows x cols]; one warp per row, kCols loads a lane in flight
template <typename RowFn>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int ld, int rows,
                                           int cols, int n_valid, int d,
                                           RowFn row) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    const auto* p = r < n_valid ? row(r) : nullptr;
    __nv_bfloat16* out = dst + (size_t)r * ld;
    for (int e0 = lane; e0 < cols; e0 += 32 * kCols) {
      float v[kCols];
#pragma unroll
      for (int u = 0; u < kCols; ++u) v[u] = row_val(p, e0 + 32 * u, d);
#pragma unroll
      for (int u = 0; u < kCols; ++u)
        if (e0 + 32 * u < cols) out[e0 + 32 * u] = __float2bfloat16_rn(v[u]);
    }
  }
}

// acc += Wb[m0 : m0+16, k] x bk[k, n0 : n0+16] over the depth blocks
// k in [k_lo, k_hi) (multiples of kMmaK apart): all of [m0, m0 + 16 + 2W)
// that the band of rows m0 .. m0+15 reaches, or the part of it in one
// slot piece
template <typename WFn, typename RowFn>
__device__ __forceinline__ void band_rows_mma(float (&acc)[2][4], int m0,
                                              int n0, int k_lo, int k_hi,
                                              int SK, int d, WFn w,
                                              RowFn bk_row) {
  const int lane = threadIdx.x & 31, g = lane >> 2, kl = 2 * (lane & 3);
  const int s0 = m0 + g, s1 = s0 + 8;
  for (int k0 = k_lo; k0 < k_hi; k0 += kMmaK) {
    const int k = k0 + kl;
    const uint32_t a[4] = {pack_bf16(w(s0, k), w(s0, k + 1)),
                           pack_bf16(w(s1, k), w(s1, k + 1)),
                           pack_bf16(w(s0, k + 8), w(s0, k + 9)),
                           pack_bf16(w(s1, k + 8), w(s1, k + 9))};
    const auto* p0 = k < SK ? bk_row(k) : nullptr;
    const auto* p1 = k + 1 < SK ? bk_row(k + 1) : nullptr;
    const auto* p8 = k + 8 < SK ? bk_row(k + 8) : nullptr;
    const auto* p9 = k + 9 < SK ? bk_row(k + 9) : nullptr;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int e = n0 + 8 * t + g;
      mma_bf16(acc[t], a, pack_bf16(row_val(p0, e, d), row_val(p1, e, d)),
               pack_bf16(row_val(p8, e, d), row_val(p9, e, d)));
    }
  }
}

// acc += A[m0 : m0+16, :] x bk[n0 : n0+16, :]^T: the staged rows (ldmatrix)
// against the context rows of slots n0 .. n0+15 over the depth DP
template <typename RowFn>
__device__ __forceinline__ void rows_bk_mma(float (&acc)[2][4],
                                            const __nv_bfloat16* sA, int lda,
                                            int m0, int n0, int DP, int SK,
                                            int d, RowFn bk_row) {
  const int lane = threadIdx.x & 31, g = lane >> 2, kl = 2 * (lane & 3);
  const __nv_bfloat16* pa = sA + (size_t)(m0 + (lane & 15)) * lda + ((lane >> 4) << 3);
  const auto* q0 = n0 + g < SK ? bk_row(n0 + g) : nullptr;
  const auto* q1 = n0 + 8 + g < SK ? bk_row(n0 + 8 + g) : nullptr;
#pragma unroll 2
  for (int kk = 0; kk < DP; kk += kMmaK) {
    uint32_t a[4];
    ldsm_x4(a, pa + kk);
    const int e = kk + kl;
    mma_bf16(acc[0], a, pack_bf16(row_val(q0, e, d), row_val(q0, e + 1, d)),
             pack_bf16(row_val(q0, e + 8, d), row_val(q0, e + 9, d)));
    mma_bf16(acc[1], a, pack_bf16(row_val(q1, e, d), row_val(q1, e + 1, d)),
             pack_bf16(row_val(q1, e + 8, d), row_val(q1, e + 9, d)));
  }
}

// nlog = A E^T for the negative piece of KPp rows staged in E, summed
// over the nq width pieces of d (load_a_e(q) stages piece q of A and E),
// then G[s][j] = rc(-sigmoid(nlog) * w_neg * alpha) for the [SP x KPPp]
// tile (zero in the padding; w_neg [S x KPp]); returns this thread's part
// of sum w_neg * (log_sigmoid(nlog) - nlog)
template <typename Load>
__device__ __forceinline__ float neg_logits(const TileLayout& tl, int d,
                                            Load&& load_a_e,
                                            const __nv_bfloat16* sA,
                                            const __nv_bfloat16* sE,
                                            __nv_bfloat16* sG,
                                            const float* s_wn, int S, int KPp,
                                            float alpha) {
  float neg_acc = 0.f;
  piece_pass(
      tl.SP, round_up(KPp, 2 * kMmaN), pieces(d, kDc), load_a_e,
      [&](float (&acc)[2][4], int m0, int n0, int q) {
        const int DPq = round_up(piece_len(d, kDc, q), kMmaK);
        warp_mma_16x16<false, false>(acc, sA, tl.lda, m0, sE, tl.lda, n0, DPq, DPq);
      },
      [&](int s, const int (&col)[4], const float (&nlog)[4]) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int j = col[v];
          float g = 0.f;
          if (s < S && j < KPp) {
            const float wn = s_wn[s * KPp + j];
            g = (0.f - sigmoid_stable(nlog[v])) * wn * alpha;
            neg_acc += wn * (log_sigmoid(nlog[v]) - nlog[v]);
          }
          sG[(size_t)s * tl.ldg + j] = __float2bfloat16_rn(g);
        }
      });
  return neg_acc;
}

// sg band logits plog = A bk^T on the tensor cores, over the [16 x 16]
// blocks that hold a row block's band, summed over the width pieces
// (load_a(q) stages piece q of A); s_gpb[s][t] = (1 - sigmoid(plog)) *
// m * alpha for the slot k = s + t, 0 where masked. Returns this thread's
// part of sum m * log_sigmoid(plog).
template <typename Load, typename RowFn>
__device__ __forceinline__ float band_logits(const Band& band,
                                             const TileLayout& tl,
                                             const __nv_bfloat16* sA, int d,
                                             float alpha, float* s_gpb,
                                             Load&& load_a, RowFn bk_row) {
  const int W2 = 2 * band.W, NB = W2 + 1, SK = band.S + W2;
  const int nb = round_up(kMmaM + W2, 2 * kMmaN) / (2 * kMmaN);
  float pos_acc = 0.f;
  piece_pass(
      tl.SP, nb * 2 * kMmaN, pieces(d, kDc), load_a,
      [&](float (&acc)[2][4], int m0, int n0, int q) {
        const int dq = piece_len(d, kDc, q), off = q * kDc;
        rows_bk_mma(acc, sA, tl.lda, m0, m0 + n0, round_up(dq, kMmaK), SK, dq,
                    [&](int k) {
                      const auto* r = bk_row(k);
                      return r != nullptr ? r + off : r;
                    });
      },
      [&](int s, const int (&col)[4], const float (&plog)[4]) {
        const int m0 = s / kMmaM * kMmaM;  // slots are offset by the row block
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int t = m0 + col[v] - s;
          if (s >= band.S || t < 0 || t > W2) continue;
          const float m = band.mask(s, s + t);
          float g = 0.f;
          if (m != 0.f) {
            g = (1.f - sigmoid_stable(plog[v])) * m * alpha;
            pos_acc += m * log_sigmoid(plog[v]);
          }
          s_gpb[s * NB + t] = g;
        }
      });
  return pos_acc;
}

// band_logits for one slot piece, slots [k0, k0 + Kj) of the center
// piece: for each row block of 16 centers m0, the [16 x 16] blocks of
// slots from max(k0, m0) on that its band [m0, m0 + 16 + 2W) reaches (as
// band_logits, at most as many as the slot piece holds), a block whose
// centers' mask rows are all zero running no product; gp[s][k - k0] (row
// stride kGpLd) = bf16((1 - sigmoid(plog)) m alpha) for the slots k in
// the band of s, 0 where masked (the tensor-core products read gp rounded
// to bf16 alone)
template <typename Load, typename RowFn>
__device__ __forceinline__ float band_logits_slots(
    const Band& band, const TileLayout& tl, const __nv_bfloat16* sA, int d,
    float alpha, __nv_bfloat16* gp, int k0, int Kj, Load&& load_a,
    RowFn bk_row) {
  const int W2 = 2 * band.W, SK = band.S + W2;
  const int nb = min(round_up(kMmaM + W2, 2 * kMmaN), round_up(Kj, 2 * kMmaN));
  auto first = [&](int m0) { return max(k0, m0); };  // a row block's first slot
  float pos_acc = 0.f;
  piece_pass(
      tl.SP, nb, pieces(d, kDc), load_a,
      [&](float (&acc)[2][4], int m0, int n0, int q) {
        const int c0 = first(m0) + n0;  // the block's first slot
        if (c0 >= min(k0 + Kj, m0 + kMmaM + W2)) return;
        if (!rows_active(band.nctx, m0, band.S)) return;
        const int dq = piece_len(d, kDc, q), off = q * kDc;
        rows_bk_mma(acc, sA, tl.lda, m0, c0, round_up(dq, kMmaK), SK, dq,
                    [&](int k) {
                      const auto* r = bk_row(k);
                      return r != nullptr ? r + off : r;
                    });
      },
      [&](int s, const int (&col)[4], const float (&plog)[4]) {
        const int base = first(s / kMmaM * kMmaM);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int k = base + col[v], t = k - s;
          if (s >= band.S || k >= k0 + Kj || t < 0 || t > W2) continue;
          const float m = band.mask(s, k);
          float g = 0.f;
          if (m != 0.f) {
            g = (1.f - sigmoid_stable(plog[v])) * m * alpha;
            pos_acc += m * log_sigmoid(plog[v]);
          }
          gp[(size_t)s * kGpLd + (k - k0)] = __float2bfloat16_rn(g);
        }
      });
  return pos_acc;
}

// w_neg [S x KPp] of the negative piece in hand into s_wn, its collision
// counts ctx_hit = mask . hit_k (hit_k[k][j] = tokk[k] == negs[j]) on the
// tensor cores as pallas_band.py:151 forms them: 0/1 operands and f32
// sums, so the count is exact and the weight equals Band::neg_weight's,
// for (2W + 16) / 16 k-slices a block where neg_weight reads 2W + 1 slots
// a (center, negative); rows of 16 centers with no mask skip the product
// (their weight is 0 at any count)
template <bool CBOW>
__device__ __forceinline__ void neg_weights_mma(const Band& band, int KPp,
                                                float* s_wn) {
  const int W2 = 2 * band.W, SK = band.S + W2;
  const int lane = threadIdx.x & 31, g = lane >> 2, kl = 2 * (lane & 3);
  auto m = [&](int s, int k) -> float {
    return (s < band.S && k - s >= 0 && k - s <= W2) ? band.mask(s, k) : 0.f;
  };
  auto hit = [&](int k, int j) -> float {
    return (k < SK && j < KPp && band.tokk[k] == band.negs[j]) ? 1.f : 0.f;
  };
  block_pass(
      round_up(band.S, kMmaM), round_up(KPp, 2 * kMmaN),
      [&](float (&acc)[2][4], int m0, int n0) {
        if (!rows_active(band.nctx, m0, band.S)) return;
        const int s0 = m0 + g, s1 = s0 + 8;
        for (int k0 = m0; k0 < m0 + kMmaM + W2; k0 += kMmaK) {
          const int k = k0 + kl;
          const uint32_t a[4] = {pack_bf16(m(s0, k), m(s0, k + 1)),
                                 pack_bf16(m(s1, k), m(s1, k + 1)),
                                 pack_bf16(m(s0, k + 8), m(s0, k + 9)),
                                 pack_bf16(m(s1, k + 8), m(s1, k + 9))};
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int j = n0 + 8 * t + g;
            mma_bf16(acc[t], a, pack_bf16(hit(k, j), hit(k + 1, j)),
                     pack_bf16(hit(k + 8, j), hit(k + 9, j)));
          }
        }
      },
      [&](int s, const int (&col)[4], const float (&cnt)[4]) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (s < band.S && col[v] < KPp)
            s_wn[s * KPp + col[v]] = band.weight<CBOW>(s, col[v], cnt[v]);
      });
}

// cbow projection h = mask @ bk on the tensor cores (divided by n_ctx
// under cbow_mean), piece by piece of the width: f32 into h_ws [S x d]
// (d_ctr = gp h reads it unrounded), and, when the row is one piece,
// rounded once into A for the negative products (else the pieces are
// staged from h_ws, rounded the same way); SKIP: rows of 16 centers with
// no mask (n_ctx 0) run no product (their h is 0)
template <bool SKIP = false, typename RowFn>
__device__ __forceinline__ void projection(const Band& band,
                                           const TileLayout& tl, int d,
                                           bool mean, float* h_ws,
                                           __nv_bfloat16* sA, RowFn bk_row) {
  const int W2 = 2 * band.W, SK = band.S + W2;
  const int nq = pieces(d, kDc);
  auto w = [&](int s, int k) -> float {
    return (s < band.S && k - s >= 0 && k - s <= W2) ? band.mask(s, k) : 0.f;
  };
  for (int q = 0; q < nq; ++q) {
    const int dq = piece_len(d, kDc, q), off = q * kDc;
    block_pass(
        tl.SP, round_up(dq, kMmaK),
        [&](float (&acc)[2][4], int m0, int n0) {
          if (SKIP && !rows_active(band.nctx, m0, band.S)) return;
          band_rows_mma(acc, m0, n0, m0, m0 + kMmaM + W2, SK, dq, w, [&](int k) {
            const auto* r = bk_row(k);
            return r != nullptr ? r + off : r;
          });
        },
        [&](int s, const int (&col)[4], const float (&acc)[4]) {
          if (s >= band.S) return;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (col[v] >= dq) continue;
            const float h = mean ? acc[v] / fmaxf(band.nctx[s], 1.f) : acc[v];
            h_ws[(size_t)s * d + off + col[v]] = h;
            if (nq == 1) sA[(size_t)s * tl.lda + col[v]] = __float2bfloat16_rn(h);
          }
        });
  }
}

// cbow center logit: an f32 multiply and row sum of rc(h) (h_ws rounded
// as A stages it) and rc(a), one warp per center over the whole width
// (pallas_step.py:239-254); s_gpc[s] = (1 - sigmoid) * active * alpha.
// Returns this thread's loss part.
template <typename RowFn>
__device__ __forceinline__ float center_logits(const Band& band,
                                               const float* h_ws, int d,
                                               float alpha, float* s_gpc,
                                               RowFn a_row) {
  const int lane = threadIdx.x & 31;
  float pos_acc = 0.f;
  for (int s = threadIdx.x >> 5; s < band.S; s += kWarps) {
    const auto* a = a_row(s);
    float part = 0.f;
    for (int e0 = lane; e0 < d; e0 += 32 * kCols) {
      float x[kCols], y[kCols];
#pragma unroll
      for (int v = 0; v < kCols; ++v) {
        const int e = e0 + 32 * v;
        x[v] = e < d ? rc<true>(h_ws[(size_t)s * d + e]) : 0.f;
        y[v] = e < d ? to_f(a[e]) : 0.f;
      }
#pragma unroll
      for (int v = 0; v < kCols; ++v) part += x[v] * rc<true>(y[v]);
    }
    const float plog = warp_sum(part);
    if (lane == 0) {
      const float active = band.nctx[s] > 0.f ? 1.f : 0.f;
      s_gpc[s] = (1.f - sigmoid_stable(plog)) * active * alpha;
      pos_acc += active * log_sigmoid(plog);
    }
  }
  return pos_acc;
}

// out[j][col[v]] = val[v] (add: out += val, the old values loaded first)
// for j < rows and the columns < n; rows ld apart
__device__ __forceinline__ void add_row(float* out, int ld, int n, int j,
                                        int rows, const int (&col)[4],
                                        const float (&val)[4], bool add) {
  if (j >= rows) return;
  float* o = out + (size_t)j * ld;
  float old[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) old[v] = (add && col[v] < n) ? o[col[v]] : 0.f;
#pragma unroll
  for (int v = 0; v < 4; ++v)
    if (col[v] < n) o[col[v]] = add ? old[v] + val[v] : val[v];
}

// cbow center s at the four columns col (those < n) of a width piece,
// from d_hid: the center update out = gp h (the unrounded f32 projection
// in h_ws) and d_hid2 = d_hid + gp a (divided by n_ctx under cbow_mean),
// rounded once into A for the context sums; a, h_ws and out point at the
// piece's first column, rows of h_ws and out ld apart
template <typename T>
__device__ __forceinline__ void cbow_center_row(
    int s, const int (&col)[4], const float (&dh)[4], float gp, bool mean,
    float nctx, const T* a, const float* h_ws, float* out, int ld, int n,
    __nv_bfloat16* sA, int lda) {
  float h[4], x[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    h[v] = col[v] < n ? h_ws[(size_t)s * ld + col[v]] : 0.f;
    x[v] = col[v] < n ? to_f(a[col[v]]) : 0.f;
  }
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    if (col[v] >= n) continue;
    out[(size_t)s * ld + col[v]] = gp * h[v];
    float dh2 = dh[v] + gp * x[v];
    if (mean) dh2 = dh2 / fmaxf(nctx, 1.f);
    sA[(size_t)s * lda + col[v]] = __float2bfloat16_rn(dh2);
  }
}

// slab-space context gradients on the tensor cores: y[k][e] =
// sum_s rc(w(s, k)) A[s][e] over the slot rows [k_lo, k_hi) (all of a
// piece's slots, or one slot piece) and DP columns, w(s, k) = wv(s, k)
// the band weight of slot k seen from center s (sg: gp, cbow: the mask)
// inside the band and zero outside it; A (sg: the center rows, cbow:
// rc(d_hid2)) is the B operand, the band matrix is built in the A-operand
// registers from the band weights, and only the depth blocks of s that
// reach the row block are visited (SKIP: and of those, only blocks of 16
// centers with a mask, n_ctx > 0). init(acc, m0, n0) starts each block's
// accumulator (zero, or what an earlier center piece carried); f(k, col,
// val) as in for_each_row.
template <bool SKIP, typename WV, typename Init, typename F>
__device__ __forceinline__ void context_tiles(const Band& band, WV&& wv,
                                              const __nv_bfloat16* sA, int lda,
                                              int k_lo, int k_hi, int DP,
                                              Init&& init, F&& f) {
  const int lane = threadIdx.x & 31, i = lane >> 3, r = lane & 7;
  const int S = band.S, W2 = 2 * band.W;
  const int kl = 2 * (lane & 3);
  auto w = [&](int k, int s) -> float {
    if (s >= S || k - s < 0 || k - s > W2) return 0.f;
    return wv(s, k);
  };
  const int nn = DP / (2 * kMmaN);
  const int tasks = round_up(k_hi - k_lo, kMmaM) / kMmaM * nn;
  for (int t = threadIdx.x >> 5; t < tasks; t += kWarps) {
    const int m0 = k_lo + t / nn * kMmaM, n0 = t % nn * (2 * kMmaN);
    const int k0 = m0 + (lane >> 2), k1 = k0 + 8;
    float acc[2][4] = {};
    init(acc, m0, n0);
    const int s_hi = min(S - 1, m0 + kMmaM - 1);
    for (int s0 = max(0, m0 - W2) / kMmaK * kMmaK; s0 <= s_hi; s0 += kMmaK) {
      if (SKIP && !rows_active(band.nctx, s0, S)) continue;
      const int s = s0 + kl;
      const uint32_t a[4] = {pack_bf16(w(k0, s), w(k0, s + 1)),
                             pack_bf16(w(k1, s), w(k1, s + 1)),
                             pack_bf16(w(k0, s + 8), w(k0, s + 9)),
                             pack_bf16(w(k1, s + 8), w(k1, s + 9))};
      uint32_t b[4];
      ldsm_x4_t(b, sA + (size_t)(s0 + r + ((i & 1) << 3)) * lda + n0 + ((i >> 1) << 3));
      mma_bf16(acc[0], a, b[0], b[1]);
      mma_bf16(acc[1], a, b[2], b[3]);
    }
    for_each_row(acc, m0, n0, f);
  }
}

// the block's loss partials into out[0..1] = (-pos, -neg): warp sums,
// then thread 0 adds the warps in order (deterministic)
__device__ __forceinline__ void block_losses(float pos, float neg, float* s_red,
                                             float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  pos = warp_sum(pos);
  neg = warp_sum(neg);
  if (lane == 0) {
    s_red[warp] = pos;
    s_red[kWarps + warp] = neg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float p = 0.f, n = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      p += s_red[w];
      n += s_red[kWarps + w];
    }
    out[0] = -p;
    out[1] = -n;
  }
}

// ------------------------------------------------------- cycle record
// rec: null, or [gridDim.x][kPhases] int64 cycle counts; thread 0 of each
// block adds the clock64() time since the previous mark to the phase named
// (marks follow a __syncthreads, so a phase ends when its last thread does)
struct PhaseClock {
  long long* rec;
  long long t;
  __device__ __forceinline__ explicit PhaseClock(long long* base)
      : rec(base != nullptr && threadIdx.x == 0
                ? base + (size_t)blockIdx.x * kPhases
                : nullptr),
        t(0) {
    if (rec != nullptr) {
      for (int p = 0; p < kPhases; ++p) rec[p] = 0;
      t = clock64();
    }
  }
  __device__ __forceinline__ void mark(Phase p) {
    if (rec != nullptr) {
      const long long now = clock64();
      rec[p] += now - t;
      t = now;
    }
  }
};

}  // namespace w2v_band
