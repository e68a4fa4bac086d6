// Hand-written Hopper (sm_90a) kernel: the run list of a sorted id array.
//
// Replaces no Pallas kernel by itself. It is the first half of the port of
// the two ordered sums: fused_slab_scatter / _scatter_kernel
// (word2vec_tpu/ops/pallas_step.py:441-506), whose sequential grid walks
// the sorted ids one by one and so never needs to know where a run of
// equal ids starts, and XLA's sequential `.at[idx].add` of the row sums
// (word2vec_tpu/ops/train_step.py:88,164). On the card the kernels that
// add those sums (csrc/row_sum.cu, csrc/fused_step.cu slab_scatter_kernel)
// hand out work per run of equal ids, so they need the runs first. Every
// sorted id array of the step feeds one row sum and one scatter, so the
// list is built once per array and passed to both.
//
// Output: the run list of csrc/runs.cuh (counts, then (start, end) pairs
// of the short and the long runs, in ascending id order). Ids < 0 (the -1
// padding, a sorted prefix) belong to no run. A run is long when it has
// more than kLongRun terms.
//
// What bounds it on the H100: it reads n ids once and writes a few words
// per run, some hundred KB at the flagship (well under 1 us of bytes), so
// launch latency and the round trips of each block bound it.
//
// What the design does about it. Two launches over tiles of 1024
// positions (256 threads x 4 consecutive positions), one block per tile,
// so every SM works at once. A position starts a run when its id differs
// from the one before, ends one when it differs from the one after, and
// the run is long when the id kLongRun places further on (before, for an
// end) is the same (ids are sorted). The first kernel counts each tile's
// short and long starts (packed in one int). The second recomputes the
// flags, takes its tile's offset as the sum of the counts of the tiles
// before it, and a block scan of the per-thread counts gives each start
// its slot; an end takes the slot of its class's last start, which is its
// own run's. No host sync: the counts stay on the device, and the
// consumers read them there.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

#include "runs.cuh"

namespace {

using w2v_runs::kLongRun;  // csrc/runs.cuh
constexpr int kThreads = 256;
constexpr int kPer = 4;  // consecutive positions per thread
constexpr int kTile = kThreads * kPer;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLongUnit = 1 << 16;  // long starts count in the high half

// The flags of the kPer positions of one thread: bit j = position p0 + j.
struct Flags {
  unsigned start, lng, end, lend;
  int packed;  // short starts + kLongUnit * long starts
};

__device__ __forceinline__ Flags thread_flags(const int* __restrict__ idx,
                                              int n, int p0) {
  // w[j] = idx[p0 - 1 + j]; -2 outside [0, n) differs from every id
  int w[kPer + 2];
#pragma unroll
  for (int j = 0; j < kPer + 2; ++j) {
    const int p = p0 - 1 + j;
    w[j] = (p >= 0 && p < n) ? idx[p] : -2;
  }
  Flags f{0u, 0u, 0u, 0u, 0};
#pragma unroll
  for (int j = 1; j <= kPer; ++j) {
    const int p = p0 + j - 1;
    const int r = w[j];
    if (p >= n || r < 0) continue;
    const unsigned bit = 1u << (j - 1);
    if (w[j - 1] != r) {
      f.start |= bit;
      const bool is_long = p + kLongRun < n && idx[p + kLongRun] == r;
      if (is_long) f.lng |= bit;
      f.packed += is_long ? kLongUnit : 1;
    }
    if (w[j + 1] != r) {
      f.end |= bit;
      if (p - kLongRun >= 0 && idx[p - kLongRun] == r) f.lend |= bit;
    }
  }
  return f;
}

// Block-wide exclusive scan of v; *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = lane < kThreads / 32 ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < kThreads / 32) s_warp[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  *total = s_warp[kThreads / 32 - 1];
  return incl - v + (warp > 0 ? s_warp[warp - 1] : 0);
}

// tile_counts[b] = packed start counts of tile b
__global__ void __launch_bounds__(kThreads)
    count_runs_kernel(const int* __restrict__ idx, int n,
                      int* __restrict__ tile_counts) {
  __shared__ int s_warp[kThreads / 32];
  const Flags f = thread_flags(idx, n, blockIdx.x * kTile + threadIdx.x * kPer);
  int total;
  block_scan(f.packed, s_warp, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    write_runs_kernel(const int* __restrict__ idx, int n,
                      const int* __restrict__ tile_counts,
                      int* __restrict__ runs) {
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_base[2];
  using w2v_runs::kHeader;
  int2* shorts = reinterpret_cast<int2*>(runs + kHeader);
  int2* longs = reinterpret_cast<int2*>(runs + kHeader + 2 * (size_t)n);
  const int tid = threadIdx.x;
  // this tile's offsets: the counts of the tiles before it (each tile's
  // packed halves are <= kTile, so they are summed apart)
  if (tid < 32) {
    int bs = 0, bl = 0;
    for (int t = tid; t < (int)blockIdx.x; t += 32) {
      const int c = tile_counts[t];
      bs += c & (kLongUnit - 1);
      bl += c >> 16;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      bs += __shfl_xor_sync(kFull, bs, o);
      bl += __shfl_xor_sync(kFull, bl, o);
    }
    if (tid == 0) {
      s_base[0] = bs;
      s_base[1] = bl;
    }
  }
  const int p0 = blockIdx.x * kTile + tid * kPer;
  const Flags f = thread_flags(idx, n, p0);
  int total;
  const int excl = block_scan(f.packed, s_warp, &total);  // syncs s_base too
  int cs = s_base[0] + (excl & (kLongUnit - 1));
  int cl = s_base[1] + (excl >> 16);
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const unsigned bit = 1u << j;
    const int p = p0 + j;
    if (f.start & bit) {
      if (f.lng & bit) {
        longs[cl++].x = p;
      } else {
        shorts[cs++].x = p;
      }
    }
    // an end takes its own run's slot: no other start lies between them
    if (f.end & bit) {
      if (f.lend & bit) {
        longs[cl - 1].y = p + 1;
      } else {
        shorts[cs - 1].y = p + 1;
      }
    }
  }
  if (blockIdx.x == gridDim.x - 1 && tid < kHeader) {
    // the counts, then zero padding
    runs[tid] = tid == 0   ? s_base[0] + (total & (kLongUnit - 1))
                : tid == 1 ? s_base[1] + (total >> 16)
                           : 0;
  }
}

}  // namespace

extern "C" {

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int w2v_long_run() { return kLongRun; }

// tile_counts: scratch of ceil(n / kTile) ints
int w2v_find_runs(const int* idx, int n, int* runs, int* tile_counts,
                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) {
    return (int)cudaMemsetAsync(runs, 0, w2v_runs::kHeader * sizeof(int), st);
  }
  const int tiles = (n + kTile - 1) / kTile;
  count_runs_kernel<<<tiles, kThreads, 0, st>>>(idx, n, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  write_runs_kernel<<<tiles, kThreads, 0, st>>>(idx, n, tile_counts, runs);
  return (int)cudaGetLastError();
}

}  // extern "C"
