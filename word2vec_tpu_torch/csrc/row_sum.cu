// Hand-written Hopper (sm_90a) kernel of the ordered per-row sum.
//
// Replaces no Pallas kernel: it is the CUDA form of XLA's sequential
// `zeros(V).at[idx].add(vals)` that the JAX package's step helpers use for
// the scatter_mean counts and the row-clip norms
// (word2vec_tpu/ops/train_step.py:81-89, :155-165, band_step.py:486-511).
// On the card an `index_add_` of floats adds in atomic order, so a hot
// row's sum changed from run to run; this kernel adds each row's terms in
// the order they appear, the same order every run, bitwise XLA's.
//
// What bounds it on the H100. It reads N ids and N values once and
// read-modify-writes each touched row once: a few hundred KB a call at the
// flagship, ~0.2 us of bytes at 3.35 TB/s. The real floor is the chain:
// the required order makes each row's sum one dependent chain of FADDs
// (4 cycles each), so the longest run sets it. At the flagship (49,152
// sorted Zipf ids of a 71,000-word vocabulary) the hottest row has ~4,000
// terms, ~16,000 cycles, ~8 us; row 0 collects every padded position too.
//
// What the design does about it. The runs of equal sorted ids come from
// the prepass of csrc/runs.cu (start, end per run, short and long lists,
// counts on the device), so work is handed out per run, not per position:
//   * short runs (<= kLongRun terms): one thread each, loads issued ahead
//     of the add chain (they do not depend on it);
//   * long runs: one block each. The block copies the run into shared
//     memory kStage values at a time; one thread adds the staged values in
//     order from shared memory (float4 reads, independent of the sum, so
//     the chain runs near the FADD's latency), while the other warps stage
//     the next piece into the second buffer.
// A persistent grid walks both lists; its blocks take short runs from the
// top block down and long runs from block 0 up, so the two kinds land on
// different blocks. Each output row belongs to exactly one run and so to
// one thread: no atomics, the result is bitwise deterministic.
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

#include "runs.cuh"

namespace {

constexpr int kThreads = 256;
// Values per staged piece of a long run: 16 KB, two buffers (32 KB of
// static shared memory). The first piece is 16 loads a thread, all in
// flight at once; a flagship hot run (~4,000 terms) fits in one piece,
// row 0's run of padded positions takes a few, and each later piece lands
// while the 4,096 dependent adds of the one before run (~8 us).
constexpr int kStage = 4096;

// acc + s[0] + s[1] + ... + s[cnt - 1], in order (float4 reads from
// shared memory, unrolled by 128 values so the reads issue ahead of the
// dependent adds and their latency is paid once per 128 adds)
__device__ __forceinline__ float add_in_order(float acc, const float* s, int cnt) {
  const int c4 = cnt & ~3;
#pragma unroll 32
  for (int k = 0; k < c4; k += 4) {
    const float4 v = *reinterpret_cast<const float4*>(s + k);
    acc += v.x;
    acc += v.y;
    acc += v.z;
    acc += v.w;
  }
  for (int k = c4; k < cnt; ++k) acc += s[k];
  return acc;
}

// out[idx[j]] += vals[j] for j in order, runs from the prepass.
__global__ void __launch_bounds__(kThreads)
    ordered_row_sum_kernel(float* __restrict__ out, const int* __restrict__ idx,
                           const float* __restrict__ vals,
                           const int* __restrict__ runs, int n) {
  __shared__ __align__(16) float buf[2][kStage];
  const int n_short = runs[0], n_long = runs[1];
  const int2* shorts = w2v_runs::short_runs(runs);
  const int2* longs = w2v_runs::long_runs(runs, n);
  const int tid = threadIdx.x;

  // short runs: one thread each, from the top block down
  for (int i = (gridDim.x - 1 - blockIdx.x) * kThreads + tid; i < n_short;
       i += gridDim.x * kThreads) {
    const int2 se = shorts[i];
    const int r = idx[se.x];
    float acc = out[r];
#pragma unroll 8
    for (int q = se.x; q < se.y; ++q) acc += vals[q];
    out[r] = acc;
  }

  // long runs: one block each, staged through shared memory; thread 0
  // adds, warps 1-7 stage the next piece meanwhile
  for (int i = blockIdx.x; i < n_long; i += gridDim.x) {
    const int2 se = longs[i];
    const int len = se.y - se.x;
    const int pieces = (len + kStage - 1) / kStage;
    int r = 0;
    float acc = 0.f;
    if (tid == 0) {  // in flight with the first piece's loads
      r = idx[se.x];
      acc = out[r];
    }
    {
      const int cnt = min(kStage, len);
#pragma unroll
      for (int u = 0; u < kStage / kThreads; ++u) {
        const int k = tid + u * kThreads;
        if (k < cnt) buf[0][k] = vals[se.x + k];
      }
    }
    __syncthreads();
    for (int pc = 0; pc < pieces; ++pc) {
      const int lo = se.x + pc * kStage;
      if (tid == 0) {
        acc = add_in_order(acc, buf[pc & 1], min(kStage, se.y - lo));
      } else if (tid >= 32 && pc + 1 < pieces) {
        const int nlo = lo + kStage;
        const int cnt = min(kStage, se.y - nlo);
        float* s = buf[(pc + 1) & 1];
#pragma unroll
        for (int u = 0; u < (kStage + kThreads - 33) / (kThreads - 32); ++u) {
          const int k = tid - 32 + u * (kThreads - 32);
          if (k < cnt) s[k] = vals[nlo + k];
        }
      }
      __syncthreads();
    }
    if (tid == 0) out[r] = acc;
  }
}

int g_sms = 0;

}  // namespace

extern "C" {

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int w2v_row_sum_stage() { return kStage; }

// runs: the run list of idx from w2v_find_runs (csrc/runs.cu)
int w2v_ordered_row_sum(float* out, const int* idx, const float* vals,
                        const int* runs, int n, void* stream) {
  if (n <= 0) return 0;
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // enough blocks for one short run per thread, capped at 4 a SM (the
  // grid is persistent: blocks loop over what is left)
  const int blocks = min((n + kThreads - 1) / kThreads, 4 * g_sms);
  ordered_row_sum_kernel<<<blocks, kThreads, 0, st>>>(out, idx, vals, runs, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
