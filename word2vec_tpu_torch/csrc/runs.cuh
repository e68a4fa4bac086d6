// The run list of a sorted id array: its layout, shared by the kernel that
// writes it (csrc/runs.cu) and the kernels that read it (csrc/row_sum.cu,
// csrc/fused_step.cu slab_scatter_kernel). ops/runs.py mirrors it.
//
// int32 words, for n ids:
//   [0] n_short, [1] n_long, [2] [3] zero (16-byte alignment)
//   int2 short_runs[n] at kHeader              (start, end), end exclusive
//   int2 long_runs[n]  at kHeader + 2n         (start, end)
//   int  tile_counts[] at kHeader + 4n         the prepass's scratch
// Runs in ascending id order; a run is long when it has more than
// kLongRun terms (csrc/runs.cu). Ids < 0 belong to no run.

#pragma once

namespace w2v_runs {

constexpr int kHeader = 4;

__device__ __forceinline__ const int2* short_runs(const int* runs) {
  return reinterpret_cast<const int2*>(runs + kHeader);
}
__device__ __forceinline__ const int2* long_runs(const int* runs, int n) {
  return reinterpret_cast<const int2*>(runs + kHeader + 2 * (size_t)n);
}

}  // namespace w2v_runs
