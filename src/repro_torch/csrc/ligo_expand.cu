// LiGO fused depth-blend + left width-expansion (forward), for Hopper (sm_90a).
//
//   P[g, k, e] = B @ (sum_l w[g, k, l] * W[g, l, e])
//
//   w (G, L2, L1) f32;  B (I, A);  W (G, L1, E, A, Bd)  ->  P (G, L2, E, I, Bd)
//   B, W and P share one dtype (f32 or bf16); every sum accumulates in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ligo_expand.py::
// ligo_blend_expand_grouped (body `_kernel`, pallas_call at line 138). The TPU
// kernel keeps B whole in VMEM and carries the blended (A, TB) slab in
// scratch across its sequential i grid axis. Hopper blocks run in parallel and
// in no order, and 227 KB of shared memory cannot hold B at A = 3072, so this
// port splits the work into two launches on the caller's stream:
//
//   1. blend:  blended[g, k, e] = sum_l w[g, k, l] * W[g, l, e], in f32, in
//      the small (A, Bd) space. Memory-bound and cheap (L1 reads per output).
//   2. expand: a batched tiled GEMM, P[n] = B @ blended[n] for the
//      n = (g, k, e) batch, with 128x128 output tiles per 256-thread block,
//      16-deep A slices staged through shared memory, an 8x8 f32 register
//      tile per thread, and the ragged I, A and Bd edges masked in-kernel.
//      The wrapper allocates `blended` (the scratch) and P.
//
// What bounds it. On the serving path (gpt2-base -> gpt2-medium hot-grow) the
// kernel runs 6 times per grow (wq, wk, wv, wo, mlp/w1, mlp/w2). The function
// needs ~353 GFLOP per grow in its cheapest order (expand the L1 = 12 source
// layers, then blend in the large space), 234 GFLOP of it mlp/w2 (I=4096,
// A=3072, Bd=768): that is compute, a floor of ~0.36 ms at the H100 SXM's
// 989 TFLOP/s dense bf16, against ~0.66 GB of traffic, 0.45 GB of it output
// (~0.20 ms at 3.35 TB/s). This first version runs the expand GEMM on the
// f32 FMA pipes (67 TFLOP/s peak), not the tensor cores, so that bf16 and f32
// results both hold to the plain version's f32 arithmetic; a wgmma pipeline
// is later work.
//
// The fused order used here blends first and then expands L2 = 24 times
// (~700 GFLOP per grow), so the kernel does ~2x the FLOPs the function needs
// by design.
//
// Plain C interface (built with nvcc into a shared library, loaded by ctypes):
// the launcher returns cudaGetLastError() and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ligo_common.cuh"

namespace {

constexpr int kBM = 128;       // output rows (I) per block
constexpr int kBN = 128;       // output cols (Bd) per block
constexpr int kBK = 16;        // A slice staged per shared-memory round
constexpr int kThreads = 256;  // 16 x 16 threads, each an 8 x 8 output tile
constexpr int kTM = 8;         // rows per thread: ty + 16 * m
constexpr int kTN = 8;         // cols per thread: tx + 16 * c
constexpr int kPad = 4;        // keeps the transposed B-tile stores off one bank

// Pass 1 is blend_kernel (ligo_common.cuh): blended[g, k, e] = sum_l
// w[g, k, l] * W[g, l, e], into the f32 scratch.
// Pass 2: P[n] (I, Bd) = B (I, A) @ X[n] (A, Bd), X = blended (f32).
// grid = (ceil(Bd/kBN), ceil(I/kBM), N); block = kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const T* __restrict__ B, const float* __restrict__ X,
              T* __restrict__ P, int I, int A, int Bd) {
  __shared__ float Bs[kBK][kBM + kPad];   // B tile, transposed: Bs[a][i]
  __shared__ float Xs[kBK][kBN];          // blended tile: Xs[a][b]

  const int64_t n = blockIdx.z;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const float* Xn = X + n * (int64_t)A * Bd;
  T* Pn = P + n * (int64_t)I * Bd;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[m][c] = 0.f;
  }

  for (int a0 = 0; a0 < A; a0 += kBK) {
    // B tile: kBM rows x kBK cols, read along A (row-major B), zero-masked.
#pragma unroll
    for (int j = 0; j < kBM * kBK / kThreads; ++j) {
      const int t = tid + j * kThreads;
      const int i = t / kBK;
      const int a = t % kBK;
      const int gi = row0 + i;
      const int ga = a0 + a;
      Bs[a][i] = (gi < I && ga < A) ? to_f32(B[(int64_t)gi * A + ga]) : 0.f;
    }
    // blended tile: kBK rows x kBN cols, read along Bd, zero-masked.
#pragma unroll
    for (int j = 0; j < kBK * kBN / kThreads; ++j) {
      const int t = tid + j * kThreads;
      const int a = t / kBN;
      const int b = t % kBN;
      const int ga = a0 + a;
      const int gb = col0 + b;
      Xs[a][b] = (ga < A && gb < Bd) ? Xn[(int64_t)ga * Bd + gb] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < kBK; ++a) {
      float rb[kTM];
      float rx[kTN];
#pragma unroll
      for (int m = 0; m < kTM; ++m) rb[m] = Bs[a][ty + 16 * m];
#pragma unroll
      for (int c = 0; c < kTN; ++c) rx[c] = Xs[a][tx + 16 * c];
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[m][c] = fmaf(rb[m], rx[c], acc[m][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int gi = row0 + ty + 16 * m;
    if (gi >= I) continue;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int gb = col0 + tx + 16 * c;
      if (gb < Bd) Pn[(int64_t)gi * Bd + gb] = from_f32<T>(acc[m][c]);
    }
  }
}

template <typename T>
int launch(const float* w, const T* B, const T* W, float* blended, T* P,
           int G, int L2, int L1, int E, int I, int A, int Bd,
           cudaStream_t stream) {
  cudaError_t err = launch_blend<T, float>(w, W, blended, G, L2, L1, E,
                                           (int64_t)A * Bd, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Bd + kBN - 1) / kBN, (I + kBM - 1) / kBM, G * L2 * E);
  expand_kernel<T><<<grid, kThreads, 0, stream>>>(B, blended, P, I, A, Bd);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (for B, W and P). Returns a cudaError_t.
int ligo_blend_expand_grouped(const void* w, const void* B, const void* W,
                              void* blended, void* P, int G, int L2, int L1,
                              int E, int I, int A, int Bd, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(
        static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(W), static_cast<float*>(blended),
        static_cast<__nv_bfloat16*>(P), G, L2, L1, E, I, A, Bd, s);
  }
  return launch<float>(static_cast<const float*>(w),
                       static_cast<const float*>(B),
                       static_cast<const float*>(W),
                       static_cast<float*>(blended), static_cast<float*>(P), G,
                       L2, L1, E, I, A, Bd, s);
}

const char* ligo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
