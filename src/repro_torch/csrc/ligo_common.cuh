// Device helpers of the LiGO kernels K1 (ligo_expand.cu) and K2
// (ligo_expand_bwd.cu): f32 <-> storage-type conversion (both) and the
// layer-axis blend pass (K1; K2 blends dP with its own kernel, which reads
// each element once). Each kernel source includes this header and compiles
// on its own; kernels/_build.py hashes it into both libraries' names.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Blend over the layer axis, in f32:
//   out[(g*Lo + o)*E + e][r] = sum_i w[g, o, i] * X[(g*Li + i)*E + e][r]
// w is (G, Lo, Li) f32; r runs over one (A, Bd) slab. K1 blends the source
// stack W with w (Lo = L2, Li = L1). A grid-stride loop over every output
// element; each output is one in-order sum, so the result is deterministic.
template <typename TX, typename TO>
__global__ void blend_kernel(const float* __restrict__ w,
                             const TX* __restrict__ X, TO* __restrict__ out,
                             int Lo, int Li, int E, int64_t slab,
                             int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t n = idx / slab;            // (g*Lo + o)*E + e
    const int64_t r = idx - n * slab;
    const int64_t e = n % E;
    const int64_t go = n / E;                // g*Lo + o
    const int64_t g = go / Lo;
    const float* wr = w + go * Li;
    const TX* src = X + (g * Li * E + e) * slab + r;
    const int64_t istep = (int64_t)E * slab;
    float acc = 0.f;
    for (int i = 0; i < Li; ++i) {
      acc = fmaf(wr[i], to_f32(src[i * istep]), acc);
    }
    out[idx] = from_f32<TO>(acc);
  }
}

// Launch geometry of blend_kernel: 256 threads, at most 64 blocks per SM of
// the 132 on an H100; the grid-stride loop covers the rest.
template <typename TX, typename TO>
cudaError_t launch_blend(const float* w, const TX* X, TO* out, int G, int Lo,
                         int Li, int E, int64_t slab, cudaStream_t stream) {
  const int64_t total = (int64_t)G * Lo * E * slab;
  int64_t blocks = (total + 255) / 256;
  if (blocks > 132 * 64) blocks = 132 * 64;
  blend_kernel<TX, TO><<<(unsigned)blocks, 256, 0, stream>>>(
      w, X, out, Lo, Li, E, slab, total);
  return cudaGetLastError();
}

}  // namespace
