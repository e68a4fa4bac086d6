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
// read-modify-writes each touched row once: bytes, a few hundred KB a
// call at the flagship (0.1-0.2 us at 3.35 TB/s), so in practice launch
// latency and the longest run's serial chain of adds bound it.
//
// What the design does about it. The slab-scatter design
// (csrc/fused_step.cu): ids arrive sorted (callers stable-sort unsorted
// ids with their values, which keeps each row's terms in order); the warp
// of the first position of each run of equal ids owns the run. It loads
// the run 32 values at a time, one per lane, and every lane adds the 32
// broadcast values in order into its copy of the row sum, so a hot row of
// thousands of terms costs one coalesced load and 32 dependent adds per
// 32 terms. No atomics: the result is deterministic.
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// out[idx[j]] += vals[j] for j in order; idx sorted ascending, -1 skipped.
// Block = 8 warps = 8 positions j.
__global__ void __launch_bounds__(256)
    ordered_row_sum_kernel(float* out, const int* idx, const float* vals,
                           int n) {
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (j >= n) return;
  const int r = idx[j];
  if (r < 0 || (j > 0 && idx[j - 1] == r)) return;
  float acc = out[r];
  for (int q0 = j;; q0 += 32) {
    const int q = q0 + lane;
    const bool in_run = q < n && idx[q] == r;
    const float v = in_run ? vals[q] : 0.f;
    // sorted ids: the run's positions in this window are a lane prefix
    const int cnt = __popc(__ballot_sync(kFull, in_run));
    for (int k = 0; k < cnt; ++k) acc += __shfl_sync(kFull, v, k);
    if (cnt < 32) break;
  }
  if (lane == 0) out[r] = acc;
}

}  // namespace

extern "C" {

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int w2v_ordered_row_sum(float* out, const int* idx, const float* vals, int n,
                        void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ordered_row_sum_kernel<<<(n + 7) / 8, 256, 0, st>>>(out, idx, vals, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
