// Hand-written Hopper (sm_90a) kernel of the slab-space overlap-add.
//
// Replaces word2vec_tpu/ops/pallas_overlap.py, overlap_add_slabs /
// _oa_kernel (pallas_overlap.py:60-120): slab-space context gradients
// y [B, C, S+2W, d] -> token order [B, C*S, d]. Token row i = c*S + s sums
//     y[b, c, s+W]                        (its own slot)
//   + y[b, c-1, S+W+s]   if s < W, c > 0   (left neighbour's right halo)
//   + y[b, c+1, s+W-S]   if s >= S-W, c < C-1 (right neighbour's left halo)
// and S >= 2W keeps the two neighbour terms disjoint, so every output is
// `own + other` with other the neighbour slot or +0.0: exactly the two
// operands ops/banded._overlap_add adds, in an order that float addition
// does not see (IEEE addition is commutative). Bitwise equal to it.
//
// What bounds it on the H100. Pure data movement: it reads y once
// (78.6 MB at the flagship, [256, 2, 128, 300] f32) and writes the token
// rows once (72.5 MB): about 0.045 ms at 3.35 TB/s. No arithmetic to speak
// of.
//
// What the design does about it. The TPU kernel fetched three blocks per
// (row, chunk) grid step through shifted index maps; here one thread owns
// one (token row, 4-column group), reads its own slot and at most one
// neighbour slot as float4 (16-byte, coalesced across the row's columns)
// and writes one float4. A column-scalar variant covers d % 4 != 0.
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launch.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float zero_of(float) { return 0.f; }
__device__ __forceinline__ float4 zero_of(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// V is float4 (G = d / 4 groups per row) or float (G = d)
template <typename V>
__global__ void __launch_bounds__(256)
    overlap_add_kernel(const V* __restrict__ y, V* __restrict__ out, int B,
                       int C, int S, int W, int G) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t rows = (size_t)B * C * S;
  if (i >= rows * G) return;
  const size_t row = i / G;
  const int g = (int)(i - row * G);
  const int b = (int)(row / ((size_t)C * S));
  const int t = (int)(row - (size_t)b * C * S);
  const int c = t / S, s = t - c * S;
  const int SK = S + 2 * W;
  const size_t bc = (size_t)b * C + c;
  const V own = y[((bc * SK) + s + W) * G + g];
  V other = zero_of(own);
  if (s < W) {
    if (c > 0) other = y[(((bc - 1) * SK) + S + W + s) * G + g];
  } else if (s >= S - W) {
    if (c < C - 1) other = y[(((bc + 1) * SK) + s + W - S) * G + g];
  }
  out[i] = add(own, other);
}

}  // namespace

extern "C" {

const char* w2v_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int w2v_overlap_add(const float* y, float* out, int B, int C, int S, int W,
                    int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0;
  const int G = vec ? d / 4 : d;
  const size_t n = (size_t)B * C * S * G;
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (vec) {
    overlap_add_kernel<float4><<<blocks, 256, 0, st>>>(
        reinterpret_cast<const float4*>(y), reinterpret_cast<float4*>(out), B,
        C, S, W, G);
  } else {
    overlap_add_kernel<float><<<blocks, 256, 0, st>>>(y, out, B, C, S, W, G);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
