// LiGO fused blend-expand, backward: all three cotangents, for Hopper (sm_90a).
//
// Forward (kernel K1, ligo_expand.cu):
//   P[g, k, e] = B @ blended[g, k, e],  blended[g, k, e] = sum_l w[g, k, l] W[g, l, e]
//   w (G, L2, L1) f32;  B (I, A);  W (G, L1, E, A, Bd)  ->  P (G, L2, E, I, Bd)
//
// Backward, given dP (G, L2, E, I, Bd) in the dtype of B and W, in the order
// that needs the fewest operations (blend dP over the L2 target layers
// first, then three products batched over the L1 source layers):
//   Q[g, l, e]  = sum_k w[g, k, l] dP[g, k, e]        (I, Bd), dP's dtype
//   dW[g, l, e] = B^T Q[g, l, e]                       -> W's dtype
//   dB          = sum_{g,l,e} Q[g, l, e] W[g, l, e]^T  -> B's dtype
//   U[g, l, e]  = B W[g, l, e]                         (I, Bd), f32
//   dw[g, k, l] = sum_e <dP[g, k, e], U[g, l, e]>      -> f32
// Every sum accumulates in f32. In bf16, Q's rounding is the one rounding
// that the function's own definition does not have.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ligo_expand_bwd.py::
// ligo_blend_expand_bwd_fused (body `_bwd_kernel`, pallas_call at line 164).
// The TPU kernel makes one serial pass over the dP tiles and keeps a whole
// (I, A) dB accumulator and an (L1, A, TB) dW accumulator resident in VMEM
// across its (n, k, i) grid nest. Hopper blocks run in parallel and in no
// order, and 227 KB of shared memory cannot hold B (let alone dB) at
// A = 3072. So this port runs a short sequence of launches on the caller's
// stream, each block owning its outputs, with no float atomics: every sum
// has one fixed order, and repeated runs agree bit for bit.
//
//   1. k2_blend_dp_kernel: Q from dP, each dP element read once, 4-wide
//      where the rows allow it;
//   2. products 2-4 (dW, dB, U) on one of two GEMM cores (below); dB's
//      contraction runs over (g, l, e, Bd), and where its (I, A) tile grid
//      under-fills the 132 SMs (the attention and mlp/w1 groups give 8 x 6
//      tiles) it is split into S contiguous parts, each writing an f32
//      partial that k2_sum_parts_kernel reduces in order;
//   3. k2_dw_partial_kernel: a block per chunk of the E*I*Bd axis stages
//      U[g, :, chunk] (all l) in shared memory and streams dP[g, k, chunk]
//      for every k, three k at a time a warp, so dP and U are each read once;
//      k2_sum_rows_kernel adds each dw entry's chunk partials, one block an
//      entry, in a fixed order.
// The two in-order reductions differ in shape, so one kernel cannot serve
// both well: dB has I*A outputs (3.1 M for mlp/w2) of at most a few parts
// each, written part-major by whole GEMM tiles, so a thread an output reads
// coalesced; dw has G*L2*L1 outputs (288) of thousands of chunk partials
// each, where a thread an output leaves the card nearly idle (0.40 ms for
// the dw sum when it ran on k2_sum_parts_kernel) and a block an output
// keeps it busy.
//
// The GEMM cores. bf16 calls whose I, A and Bd are multiples of 8 (TMA's
// 16-byte stride rule) run k2_wgmma_gemm_kernel: C[z] = sum_r X_r Y_r^T
// with both operands K-major, one block per 128 x 128 output tile, a
// producer warp keeping a 4-stage ring of 64-deep X and Y tiles filled by
// TMA (3-D tensor maps (K, rows, batch), 128-byte swizzle, zero fill at
// the ragged K, M and N edges), two consumer warpgroups issuing
// wgmma.m64n128k16 (bf16 in, f32 accumulate) from shared-memory
// descriptors, a masked epilogue. dB's operands Q and W are K-major as
// they are; k2_transpose_kernel supplies B^T, Q^T and W^T for dW and U.
// Every other call (f32, whose tolerance tensor cores cannot hold, or an
// unaligned width) runs k2_fma_gemm_kernel: an f32 FMA GEMM on any strides,
// 128 x 128 tiles per 256-thread block, 16-deep slices through shared
// memory, an 8 x 8 register tile a thread.
//
// What bounds it. On the LiGO training path (gpt2-base -> gpt2-medium) the
// kernel runs once per eligible group per SGD step: wq, wk, wv, wo (I 1024,
// A 768, Bd 768), mlp/w1 (I 1024, A 768, Bd 3072) and mlp/w2 (I 4096,
// A 3072, Bd 768), all G = E = 1, L2 = 24, L1 = 12. Products 2-4 cost
// 2 G E L1 I A Bd operations each, ~1.04 TFLOP per backward with the blend
// and dw, ~0.70 of it in mlp/w2: compute, a floor of ~1.06 ms at the H100
// SXM's 989 TFLOP/s dense bf16, against ~0.9 GB of traffic. The tensor-core
// core is what moves it towards that floor; what it leaves for later is a
// persistent tile loop (the epilogue does not overlap the next tile's
// loads), clusters with TMA multicast, and MN-major descriptors in place of
// the transpose passes.
//
// Plain C interface (built with nvcc into a shared library, loaded by ctypes):
// the launcher returns cudaGetLastError() (or a tensor-map encode failure)
// and never synchronises.

#include <cuda.h>  // CUtensorMap and its enums only: cuTensorMapEncodeTiled
                    // is looked up at run time, so nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ligo_common.cuh"

namespace {

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output cols per block
constexpr int kBK = 16;        // contraction slice per shared-memory round
constexpr int kThreads = 256;  // 16 x 16 threads, each an 8 x 8 output tile
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;         // rows per thread: ty + 16 * m
constexpr int kTN = 8;         // cols per thread: tx + 16 * c
constexpr int kPad = 4;        // spreads the k-major tile stores over banks
constexpr int kBlendL = 12;    // l values per pass of the dP blend
constexpr int kDwL = 12;       // l values per pass of the dw partials
constexpr int kDwK = 3;        // k values per warp pass of the dw partials

// Product tags: they only name the GEMM kernel's instances apart, so that a
// profile shows each product on its own line.
constexpr int kProdDW = 0;     // dW[z] = B^T Q[z]
constexpr int kProdDB = 1;     // dB = sum_r Q[r] W[r]^T
constexpr int kProdU = 2;      // U[z] = B W[z]

// C[z] (M x N) = sum_{r in split} sum_k Aop_r(m, k) * Bop_r(k, n), where
// Aop_r(m, k) = A[zb*sAz + r*sAr + m*sAm + k*sAk] and
// Bop_r(k, n) = B[zb*sBz + r*sBr + k*sBk + n*sBn], for z = zb*S + zs and r in
// the zs-th of S contiguous parts of [0, R).
struct GemmArgs {
  int M, N, K, R, S;
  int64_t sAm, sAk, sAz, sAr;
  int64_t sBk, sBn, sBz, sBr;
  int64_t ldc, sCz;
};

// The f32 FMA GEMM (the route for f32 operands and unaligned bf16 widths).
template <int kProd, typename TA, typename TB, typename TC>
__global__ void __launch_bounds__(kThreads)
k2_fma_gemm_kernel(const TA* __restrict__ Ap, const TB* __restrict__ Bp,
                   TC* __restrict__ C, const GemmArgs g) {
  __shared__ float As[kBK][kBM + kPad];   // As[k][m]
  __shared__ float Bs[kBK][kBN + kPad];   // Bs[k][n]

  const int z = blockIdx.z;
  const int64_t zb = z / g.S;
  const int zs = z % g.S;
  const int r0 = (int)((int64_t)zs * g.R / g.S);
  const int r1 = (int)((int64_t)(zs + 1) * g.R / g.S);
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // Stage each tile along the operand's contiguous axis, so that
  // neighbouring threads read neighbouring addresses.
  const bool a_kmajor = g.sAk == 1;
  const bool b_kmajor = g.sBk == 1;

  float acc[kTM][kTN];
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[m][c] = 0.f;
  }

  for (int r = r0; r < r1; ++r) {
    const TA* A = Ap + zb * g.sAz + (int64_t)r * g.sAr;
    const TB* B = Bp + zb * g.sBz + (int64_t)r * g.sBr;
    for (int k0 = 0; k0 < g.K; k0 += kBK) {
#pragma unroll
      for (int j = 0; j < kBM * kBK / kThreads; ++j) {
        const int t = tid + j * kThreads;
        const int m = a_kmajor ? t / kBK : t % kBM;
        const int k = a_kmajor ? t % kBK : t / kBM;
        const int gm = row0 + m;
        const int gk = k0 + k;
        As[k][m] = (gm < g.M && gk < g.K)
                       ? to_f32(A[gm * g.sAm + gk * g.sAk]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBK * kBN / kThreads; ++j) {
        const int t = tid + j * kThreads;
        const int n = b_kmajor ? t / kBK : t % kBN;
        const int k = b_kmajor ? t % kBK : t / kBN;
        const int gn = col0 + n;
        const int gk = k0 + k;
        Bs[k][n] = (gk < g.K && gn < g.N)
                       ? to_f32(B[gk * g.sBk + gn * g.sBn]) : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float ra[kTM];
        float rb[kTN];
#pragma unroll
        for (int m = 0; m < kTM; ++m) ra[m] = As[k][ty + 16 * m];
#pragma unroll
        for (int c = 0; c < kTN; ++c) rb[c] = Bs[k][tx + 16 * c];
#pragma unroll
        for (int m = 0; m < kTM; ++m) {
#pragma unroll
          for (int c = 0; c < kTN; ++c) acc[m][c] = fmaf(ra[m], rb[c], acc[m][c]);
        }
      }
      __syncthreads();
    }
  }

  TC* Cz = C + (int64_t)z * g.sCz;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int gm = row0 + ty + 16 * m;
    if (gm >= g.M) continue;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int gn = col0 + tx + 16 * c;
      if (gn < g.N) Cz[gm * g.ldc + gn] = from_f32<TC>(acc[m][c]);
    }
  }
}

// V consecutive values at p, as f32 (V = 1, or 4 from an aligned address).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float* x) {
  if (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* x) {
  if (V == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float* x) {
  if (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p, const float* x) {
  if (V == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x[2], x[3]);
    uint2 v;
    v.x = *reinterpret_cast<const uint32_t*>(&a);
    v.y = *reinterpret_cast<const uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = v;
  } else {
    *p = __float2bfloat16(x[0]);
  }
}

// Q[g, l, e][r] = sum_k w[g, k, l] dP[g, k, e][r], in dP's dtype. Each thread
// owns V consecutive r of one (g, e) and kBlendL values of l at a time, so
// each dP element is read once (for L1 <= kBlendL) in V-wide loads; the sum
// over k runs in order. `total` counts V-groups: G * E * slab / V.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
k2_blend_dp_kernel(const float* __restrict__ w, const T* __restrict__ dP,
                   T* __restrict__ Q, int L2, int L1, int E, int64_t slab,
                   int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t kstep = (int64_t)E * slab;
  const int64_t slab_v = slab / V;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const int64_t n = idx / slab_v;          // g*E + e
    const int64_t r = (idx - n * slab_v) * V;
    const int64_t e = n % E;
    const int64_t g = n / E;
    const T* src = dP + (g * L2 * E + e) * slab + r;
    const float* wg = w + g * L2 * L1;
    for (int l0 = 0; l0 < L1; l0 += kBlendL) {
      float acc[kBlendL][V];
#pragma unroll
      for (int li = 0; li < kBlendL; ++li) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[li][v] = 0.f;
      }
#pragma unroll 4
      for (int k = 0; k < L2; ++k) {
        float x[V];
        load_v<V>(src + k * kstep, x);
        const float* wk = wg + k * L1 + l0;
#pragma unroll
        for (int li = 0; li < kBlendL; ++li) {
          if (l0 + li < L1) {
            const float wv = wk[li];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              acc[li][v] = fmaf(wv, x[v], acc[li][v]);
            }
          }
        }
      }
#pragma unroll
      for (int li = 0; li < kBlendL; ++li) {
        if (l0 + li < L1) {
          store_v<V>(Q + ((g * L1 + l0 + li) * E + e) * slab + r, acc[li]);
        }
      }
    }
  }
}

// out[i] = sum_{s < S} part[s * n + i] in order, cast to TO.
template <typename TO>
__global__ void k2_sum_parts_kernel(const float* __restrict__ part,
                                    TO* __restrict__ out, int S, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[s * n + i];
    out[i] = from_f32<TO>(acc);
  }
}

// dwp[g][k][l][c] = sum_{j in chunk c} dP[g][k][j] * U[g][l][j], j over the
// E*I*Bd axis. grid = (n_chunks, G); the block stages U[g, :, chunk] (L1 x
// chunk f32, dynamic shared memory) once, then warp w streams dP[g, k, chunk]
// for kDwK values k = kb + i*kWarps at a time (so each U value read from
// shared memory serves kDwK products), lane by lane in V-wide loads with two
// iterations of loads in flight, and reduces each (k, l) over its lanes by a
// fixed shuffle tree: dP and U are each read once from device memory.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
k2_dw_partial_kernel(const T* __restrict__ dP, const float* __restrict__ U,
                     float* __restrict__ dwp, int L2, int L1, int64_t K,
                     int chunk) {
  extern __shared__ float Us[];            // Us[l * chunk + j]
  const int64_t c = blockIdx.x;
  const int64_t g = blockIdx.y;
  const int64_t j0 = c * chunk;
  const int n = (int)((K - j0 < chunk) ? K - j0 : chunk);
  const float* Ug = U + g * L1 * K + j0;
  for (int i = threadIdx.x * V; i < L1 * chunk; i += kThreads * V) {
    const int l = i / chunk;
    const int j = i - l * chunk;           // V divides chunk and n
    float x[V];
    if (j < n) {
      load_v<V>(Ug + (int64_t)l * K + j, x);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = 0.f;
    }
    store_v<V>(Us + i, x);
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int kb = warp; kb < L2; kb += kWarps * kDwK) {
    for (int l0 = 0; l0 < L1; l0 += kDwL) {
      float acc[kDwK][kDwL];
#pragma unroll
      for (int i = 0; i < kDwK; ++i) {
#pragma unroll
        for (int li = 0; li < kDwL; ++li) acc[i][li] = 0.f;
      }
#pragma unroll 2
      for (int j = lane * V; j < n; j += 32 * V) {
        float x[kDwK][V];
#pragma unroll
        for (int i = 0; i < kDwK; ++i) {
          const int k = kb + i * kWarps;
          if (k < L2) {
            load_v<V>(dP + (g * L2 + k) * K + j0 + j, x[i]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) x[i][v] = 0.f;
          }
        }
#pragma unroll
        for (int li = 0; li < kDwL; ++li) {
          if (l0 + li < L1) {
            float u[V];
            load_v<V>(Us + (l0 + li) * chunk + j, u);
#pragma unroll
            for (int i = 0; i < kDwK; ++i) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                acc[i][li] = fmaf(x[i][v], u[v], acc[i][li]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kDwK; ++i) {
        const int k = kb + i * kWarps;
#pragma unroll
        for (int li = 0; li < kDwL; ++li) {
          float v = acc[i][li];
          for (int off = 16; off > 0; off /= 2) {
            v += __shfl_down_sync(0xffffffffu, v, off);
          }
          if (lane == 0 && k < L2 && l0 + li < L1) {
            dwp[((g * L2 + k) * L1 + l0 + li) * gridDim.x + c] = v;
          }
        }
      }
    }
  }
}

// out[i] = sum_{c < S} part[i * S + c]: one block per output, each thread
// an in-order run over c = t, t + kThreads, ..., then a fixed shuffle tree
// and an in-order sum over the warps. Deterministic.
__global__ void __launch_bounds__(kThreads)
k2_sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out,
                   int S) {
  __shared__ float red[kWarps];
  const float* p = part + (int64_t)blockIdx.x * S;
  float acc = 0.f;
  for (int c = threadIdx.x; c < S; c += kThreads) acc += p[c];
  for (int off = 16; off > 0; off /= 2) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int i = 0; i < kWarps; ++i) sum += red[i];
    out[blockIdx.x] = sum;
  }
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core GEMM:  C[z] = sum_{r in split} X_r[z] . Y_r[z]^T,
// X (M x K) and Y (N x K) bf16 with K contiguous (K-major), f32 accumulator,
// C in f32 or bf16. One block per 128 x 128 output tile: a producer warp
// keeps a kTcStages ring of 64-deep X and Y tiles filled by TMA (3-D tensor
// maps (K, rows, batch), 128-byte swizzle, zero fill past every edge),
// completed on mbarriers; two consumer warpgroups each run
// wgmma.m64n128k16 on 64 of the tile's rows from shared-memory descriptors.

constexpr int kTcBM = 128;                  // output rows per block
constexpr int kTcBN = 128;                  // output cols per block
constexpr int kTcBK = 64;                   // contraction per stage: 128 bytes
constexpr int kTcStages = 4;
constexpr int kTcConsumers = 2;             // warpgroups, 64 rows each
constexpr int kTcThreads = 128 * kTcConsumers + 32;   // + the producer warp
constexpr int kTcTileBytes = kTcBM * kTcBK * 2;       // one operand tile
constexpr int kTcSmem = 2 * kTcStages * kTcTileBytes  // X and Y rings
                        + 2 * kTcStages * 8           // full, empty barriers
                        + 1024;                       // 1024-byte alignment

// Batch coordinate of X: zb*xz + r*xr; of Y: zb*yz + r*yr, for output batch
// z = zb*S + zs and r in the zs-th of S contiguous parts of [0, R).
struct TcArgs {
  int M, N, K, R, S;
  int xz, xr, yz, yr;
  int64_t ldc, sCz;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), layout type B128.
__device__ __forceinline__ uint64_t gmma_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16)
         | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 128, f32) += A (64 x 16) . B (128 x 16)^T, both from shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int kProd, typename TC>
__global__ void __launch_bounds__(kTcThreads, 1)
k2_wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tmX,
                     const __grid_constant__ CUtensorMap tmY,
                     TC* __restrict__ C, const TcArgs g) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the rings to it.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sY =
      reinterpret_cast<__nv_bfloat16*>(smem + kTcStages * kTcTileBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + 2 * kTcStages * kTcTileBytes);
  uint64_t* empty = full + kTcStages;

  const int z = blockIdx.z;
  const int zb = z / g.S;
  const int zs = z % g.S;
  const int r0 = (int)((int64_t)zs * g.R / g.S);
  const int r1 = (int)((int64_t)(zs + 1) * g.R / g.S);
  const int nk = (g.K + kTcBK - 1) / kTcBK;
  const int n_iter = (r1 - r0) * nk;
  const int row0 = blockIdx.y * kTcBM;
  const int col0 = blockIdx.x * kTcBN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kTcConsumers) {
    // Producer: one thread keeps the ring full.
    if (threadIdx.x % 32 == 0) {
      for (int it = 0; it < n_iter; ++it) {
        const int s = it % kTcStages;
        mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTcTileBytes);
        const int r = r0 + it / nk;
        const int k0 = (it % nk) * kTcBK;
        tma_load_3d(sX + s * kTcBM * kTcBK, &tmX, &full[s], k0, row0,
                    zb * g.xz + r * g.xr);
        tma_load_3d(sY + s * kTcBN * kTcBK, &tmY, &full[s], k0, col0,
                    zb * g.yz + r * g.yr);
      }
    }
  } else {
    // Consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile.
    const int wg = warp / 4;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);
    for (int it = 0; it < n_iter; ++it) {
      const int s = it % kTcStages;
      mbar_wait(&full[s], (it / kTcStages) & 1);
      const uint64_t da = gmma_desc(sX + s * kTcBM * kTcBK + wg * 64 * kTcBK);
      const uint64_t db = gmma_desc(sY + s * kTcBN * kTcBK);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 16; ++kk) {
        // 16 bf16 = 32 bytes further along K: +2 in 16-byte units
        wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      if (it > 0 && threadIdx.x % 128 == 0) {
        mbar_arrive(&empty[(it - 1) % kTcStages]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // Accumulator layout of wgmma m64nN: register i of lane l in warp w4
    // holds row 16 w4 + l/4 + 8 ((i/2) % 2), col 8 (i/4) + 2 (l%4) + i%2.
    const int t = threadIdx.x % 128;
    const int row_b = row0 + wg * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col_b = col0 + 2 * (t % 4);
    TC* Cz = C + (int64_t)z * g.sCz;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int row = row_b + 8 * ((i / 2) % 2);
      const int col = col_b + 8 * (i / 4) + (i % 2);
      if (row < g.M && col < g.N) {
        Cz[(int64_t)row * g.ldc + col] = from_f32<TC>(acc[i]);
      }
    }
  }
}

// out[b][c][r] = in[b][r][c] for in (nb, R, Cc) bf16, R and Cc even:
// 64 x 64 tiles through shared memory, 32 x 8 threads, each moving pairs of
// elements (4-byte loads and stores; a warp covers 128 contiguous bytes).
// Supplies the K-major operands the tensor-core GEMM needs (B^T, Q^T, W^T).
__global__ void __launch_bounds__(256)
k2_transpose_kernel(const __nv_bfloat16* __restrict__ in,
                    __nv_bfloat16* __restrict__ out, int R, int Cc) {
  __shared__ __nv_bfloat16 tile[64][66];
  const int64_t off = (int64_t)blockIdx.z * R * Cc;
  const int c0 = blockIdx.x * 64;
  const int r0 = blockIdx.y * 64;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 64; i += 8) {
    const int r = r0 + i;
    const int c = c0 + 2 * tx;
    if (r < R && c < Cc) {
      *reinterpret_cast<__nv_bfloat162*>(&tile[i][2 * tx]) =
          *reinterpret_cast<const __nv_bfloat162*>(in + off + (int64_t)r * Cc
                                                   + c);
    }
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 64; i += 8) {
    const int c = c0 + i;
    const int r = r0 + 2 * tx;
    if (c < Cc && r < R) {
      __nv_bfloat162 v;
      v.x = tile[2 * tx][i];
      v.y = tile[2 * tx + 1][i];
      *reinterpret_cast<__nv_bfloat162*>(out + off + (int64_t)c * R + r) = v;
    }
  }
}

template <typename T>
bool aligned4(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
}

unsigned grid_stride_blocks(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  return (unsigned)blocks;
}

template <int kProd, typename TA, typename TB, typename TC>
cudaError_t fma_gemm(const TA* A, const TB* B, TC* C, const GemmArgs& g,
                     int Z, cudaStream_t stream) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, Z * g.S);
  k2_fma_gemm_kernel<kProd, TA, TB, TC><<<grid, kThreads, 0, stream>>>(
      A, B, C, g);
  return cudaGetLastError();
}

// A failed tensor-map encode returns kErrTensorMap + its CUresult; a failed
// lookup of cuTensorMapEncodeTiled returns kErrTensorMap - 1.
constexpr int kErrTensorMap = 100000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

int encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) {
      return kErrTensorMap - 1;
    }
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return 0;
}

// Tensor map of a (batches, rows, K) bf16 array, K contiguous: boxes of
// kTcBK x 128 x 1 elements, 128-byte swizzle, zeros out of bounds.
int make_map(CUtensorMap* map, const __nv_bfloat16* base, int K, int rows,
             int batches) {
  EncodeTiledFn fn;
  const int e = encode_fn(&fn);
  if (e != 0) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)rows,
                              (cuuint64_t)batches};
  const cuuint64_t strides[2] = {(cuuint64_t)K * 2,
                                 (cuuint64_t)K * rows * 2};
  const cuuint32_t box[3] = {kTcBK, kTcBM, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<__nv_bfloat16*>(base), dims, strides, box,
                        estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

// C[z] = sum_r X_r Y_r^T on the tensor cores, from the tensor maps of X
// (xb, M, K) and Y (yb, N, K).
template <int kProd, typename TC>
int tc_gemm(const CUtensorMap& mx, const CUtensorMap& my, TC* C,
            const TcArgs& g, int Z, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      k2_wgmma_gemm_kernel<kProd, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.N + kTcBN - 1) / kTcBN, (g.M + kTcBM - 1) / kTcBM,
                  Z * g.S);
  k2_wgmma_gemm_kernel<kProd, TC><<<grid, kTcThreads, kTcSmem, stream>>>(
      mx, my, C, g);
  return (int)cudaGetLastError();
}

cudaError_t transpose(const __nv_bfloat16* in, __nv_bfloat16* out, int nb,
                      int R, int Cc, cudaStream_t stream) {
  const dim3 grid((Cc + 63) / 64, (R + 63) / 64, nb);
  k2_transpose_kernel<<<grid, dim3(32, 8), 0, stream>>>(in, out, R, Cc);
  return cudaGetLastError();
}

// Operands and scratch of one call; the wrapper allocates every buffer.
template <typename T>
struct Bufs {
  const float* w;   // (G, L2, L1) f32
  const T* B;       // (I, A)
  const T* W;       // (G, L1, E, A, Bd)
  const T* dP;      // (G, L2, E, I, Bd)
  T* Q;             // (G, L1, E, I, Bd)
  float* U;         // (G, L1, E, I, Bd) f32
  __nv_bfloat16* Bt;  // (A, I), tensor-core route only
  __nv_bfloat16* Qt;  // (G, L1, E, Bd, I), tensor-core route only
  __nv_bfloat16* Wt;  // (G, L1, E, Bd, A), tensor-core route only
  float* dBpart;    // (splits, I, A) f32, unused when splits == 1
  float* dwpart;    // (G, L2, L1, n_chunks) f32
  float* dw;        // (G, L2, L1) f32
  T* dB;            // (I, A)
  T* dW;            // (G, L1, E, A, Bd)
};

// Products 2-4 on the FMA core; Z = G*L1*E.
template <typename T>
cudaError_t products_fma(const Bufs<T>& b, int Z, int I, int A, int Bd,
                         int splits, cudaStream_t stream) {
  const int64_t sQ = (int64_t)I * Bd;
  const int64_t sW = (int64_t)A * Bd;
  cudaError_t err;

  // dW[z] (A x Bd) = B^T (A x I) @ Q[z] (I x Bd)
  GemmArgs gw;
  gw.M = A; gw.N = Bd; gw.K = I; gw.R = 1; gw.S = 1;
  gw.sAm = 1; gw.sAk = A; gw.sAz = 0; gw.sAr = 0;
  gw.sBk = Bd; gw.sBn = 1; gw.sBz = sQ; gw.sBr = 0;
  gw.ldc = Bd; gw.sCz = sW;
  err = fma_gemm<kProdDW>(b.B, b.Q, b.dW, gw, Z, stream);
  if (err != cudaSuccess) return err;

  // dB (I x A) = sum_r Q[r] (I x Bd) @ W[r]^T (Bd x A), r over the split
  GemmArgs gb;
  gb.M = I; gb.N = A; gb.K = Bd; gb.R = Z; gb.S = splits;
  gb.sAm = Bd; gb.sAk = 1; gb.sAz = 0; gb.sAr = sQ;
  gb.sBk = 1; gb.sBn = Bd; gb.sBz = 0; gb.sBr = sW;
  gb.ldc = A; gb.sCz = (int64_t)I * A;
  err = splits == 1 ? fma_gemm<kProdDB>(b.Q, b.W, b.dB, gb, 1, stream)
                    : fma_gemm<kProdDB>(b.Q, b.W, b.dBpart, gb, 1, stream);
  if (err != cudaSuccess) return err;

  // U[z] (I x Bd) = B (I x A) @ W[z] (A x Bd), f32
  GemmArgs gu;
  gu.M = I; gu.N = Bd; gu.K = A; gu.R = 1; gu.S = 1;
  gu.sAm = A; gu.sAk = 1; gu.sAz = 0; gu.sAr = 0;
  gu.sBk = Bd; gu.sBn = 1; gu.sBz = sW; gu.sBr = 0;
  gu.ldc = Bd; gu.sCz = sQ;
  return fma_gemm<kProdU>(b.B, b.W, b.U, gu, Z, stream);
}

// The six tensor maps of products 2-4 on the tensor cores, X and Y of dW,
// dB and U in turn. launch() encodes them before its first kernel, so a map
// that TMA cannot take returns its error with nothing launched.
int tc_maps(const Bufs<__nv_bfloat16>& b, int Z, int I, int A, int Bd,
            CUtensorMap* m) {
  int e = 0;
  if ((e = make_map(&m[0], b.Bt, I, A, 1)) != 0) return e;    // dW: X = B^T
  if ((e = make_map(&m[1], b.Qt, I, Bd, Z)) != 0) return e;   //     Y = Q^T
  if ((e = make_map(&m[2], b.Q, Bd, I, Z)) != 0) return e;    // dB: X = Q
  if ((e = make_map(&m[3], b.W, Bd, A, Z)) != 0) return e;    //     Y = W
  if ((e = make_map(&m[4], b.B, A, I, 1)) != 0) return e;     // U:  X = B
  return make_map(&m[5], b.Wt, A, Bd, Z);                     //     Y = W^T
}

// Products 2-4 on the tensor cores (bf16 only), from K-major operands.
int products_tc(const Bufs<__nv_bfloat16>& b, const CUtensorMap* m, int Z,
                int I, int A, int Bd, int splits, cudaStream_t stream) {
  int e = 0;
  cudaError_t err = transpose(b.B, b.Bt, 1, I, A, stream);
  if (err != cudaSuccess) return (int)err;
  err = transpose(b.Q, b.Qt, Z, I, Bd, stream);
  if (err != cudaSuccess) return (int)err;
  err = transpose(b.W, b.Wt, Z, A, Bd, stream);
  if (err != cudaSuccess) return (int)err;

  // dW[z] (A x Bd) = B^T (A x I) . (Q[z]^T (Bd x I))^T
  TcArgs gw;
  gw.M = A; gw.N = Bd; gw.K = I; gw.R = 1; gw.S = 1;
  gw.xz = 0; gw.xr = 0; gw.yz = 1; gw.yr = 0;
  gw.ldc = Bd; gw.sCz = (int64_t)A * Bd;
  e = tc_gemm<kProdDW>(m[0], m[1], b.dW, gw, Z, stream);
  if (e != 0) return e;

  // dB (I x A) = sum_r Q[r] (I x Bd) . W[r] (A x Bd)^T, r over the split
  TcArgs gb;
  gb.M = I; gb.N = A; gb.K = Bd; gb.R = Z; gb.S = splits;
  gb.xz = 0; gb.xr = 1; gb.yz = 0; gb.yr = 1;
  gb.ldc = A; gb.sCz = (int64_t)I * A;
  e = splits == 1 ? tc_gemm<kProdDB>(m[2], m[3], b.dB, gb, 1, stream)
                  : tc_gemm<kProdDB>(m[2], m[3], b.dBpart, gb, 1, stream);
  if (e != 0) return e;

  // U[z] (I x Bd) = B (I x A) . (W[z]^T (Bd x A))^T, f32
  TcArgs gu;
  gu.M = I; gu.N = Bd; gu.K = A; gu.R = 1; gu.S = 1;
  gu.xz = 0; gu.xr = 0; gu.yz = 1; gu.yr = 0;
  gu.ldc = Bd; gu.sCz = (int64_t)I * Bd;
  return tc_gemm<kProdU>(m[4], m[5], b.U, gu, Z, stream);
}

template <typename T>
int launch(const Bufs<T>& b, int G, int L2, int L1, int E, int I, int A,
           int Bd, int splits, int dw_chunk, int route, cudaStream_t stream) {
  const int64_t sQ = (int64_t)I * Bd;
  const int Z = G * L1 * E;                  // (g, l, e) batch
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if (route != 0 && (route != 1 || !kBf16)) {
    return (int)cudaErrorNotSupported;
  }
  CUtensorMap maps[6];
  if constexpr (kBf16) {
    if (route == 1) {
      const int e = tc_maps(b, Z, I, A, Bd, maps);
      if (e != 0) return e;
    }
  }
  cudaError_t err;

  // 1. Q = w^T . dP, over the layer axis k; 4-wide where rows allow it
  const bool vec = aligned4(b.dP) && sQ % 4 == 0;
  const int64_t nq = (int64_t)G * E * sQ / (vec ? 4 : 1);
  if (vec) {
    k2_blend_dp_kernel<T, 4><<<grid_stride_blocks(nq), kThreads, 0, stream>>>(
        b.w, b.dP, b.Q, L2, L1, E, sQ, nq);
  } else {
    k2_blend_dp_kernel<T, 1><<<grid_stride_blocks(nq), kThreads, 0, stream>>>(
        b.w, b.dP, b.Q, L2, L1, E, sQ, nq);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 2-4. dW, dB (or its partials), U
  int ep = 0;
  if constexpr (kBf16) {
    if (route == 1) ep = products_tc(b, maps, Z, I, A, Bd, splits, stream);
  }
  if (route == 0) ep = (int)products_fma<T>(b, Z, I, A, Bd, splits, stream);
  if (ep != 0) return ep;

  // dB = sum of the partials
  if (splits > 1) {
    const int64_t nB = (int64_t)I * A;
    k2_sum_parts_kernel<T><<<grid_stride_blocks(nB), kThreads, 0, stream>>>(
        b.dBpart, b.dB, splits, nB);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 5. dw partials over chunks of the E*I*Bd axis, then their sum in order
  const int64_t K = (int64_t)E * sQ;
  const unsigned n_chunks = (unsigned)((K + dw_chunk - 1) / dw_chunk);
  const dim3 grid_w(n_chunks, G);
  const size_t smem = (size_t)L1 * dw_chunk * sizeof(float);
  if (vec) {       // K = E * sQ is then a multiple of 4, and so is dw_chunk
    k2_dw_partial_kernel<T, 4><<<grid_w, kThreads, smem, stream>>>(
        b.dP, b.U, b.dwpart, L2, L1, K, dw_chunk);
  } else {
    k2_dw_partial_kernel<T, 1><<<grid_w, kThreads, smem, stream>>>(
        b.dP, b.U, b.dwpart, L2, L1, K, dw_chunk);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k2_sum_rows_kernel<<<G * L2 * L1, kThreads, 0, stream>>>(
      b.dwpart, b.dw, (int)n_chunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* w, const void* B, const void* W, const void* dP,
                 void* Q, void* U, void* Bt, void* Qt, void* Wt,
                 void* dBpart, void* dwpart, void* dw, void* dB, void* dW,
                 int G, int L2, int L1, int E, int I, int A, int Bd,
                 int splits, int dw_chunk, int route, cudaStream_t stream) {
  Bufs<T> b;
  b.w = static_cast<const float*>(w);
  b.B = static_cast<const T*>(B);
  b.W = static_cast<const T*>(W);
  b.dP = static_cast<const T*>(dP);
  b.Q = static_cast<T*>(Q);
  b.U = static_cast<float*>(U);
  b.Bt = static_cast<__nv_bfloat16*>(Bt);
  b.Qt = static_cast<__nv_bfloat16*>(Qt);
  b.Wt = static_cast<__nv_bfloat16*>(Wt);
  b.dBpart = static_cast<float*>(dBpart);
  b.dwpart = static_cast<float*>(dwpart);
  b.dw = static_cast<float*>(dw);
  b.dB = static_cast<T*>(dB);
  b.dW = static_cast<T*>(dW);
  return launch<T>(b, G, L2, L1, E, I, A, Bd, splits, dw_chunk, route,
                   stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (for B, W, dP, Q, dB and dW). w is
// (G, L2, L1) f32; dw is f32. route: 0 runs products 2-4 on the FMA GEMM,
// 1 on the tensor-core GEMM (bf16 only; the caller has checked that I, A
// and Bd are multiples of 8 and put B and W on 16-byte boundaries).
// Scratch, allocated by the caller: Q (G, L1, E, I, Bd) in the dtype, U (G, L1, E, I, Bd) f32,
// on route 1 Bt (A, I), Qt (G, L1, E, Bd, I) and Wt (G, L1, E, Bd, A) bf16,
// dBpart (splits, I, A) f32 (unused when splits == 1), dwpart
// (G, L2, L1, ceil(E*I*Bd / dw_chunk)) f32; dw_chunk a multiple of 32.
// Returns 0, a cudaError_t, or a value >= kErrTensorMap - 1 for a failed
// tensor-map encode.
int ligo_blend_expand_bwd(const void* w, const void* B, const void* W,
                          const void* dP, void* Q, void* U, void* Bt,
                          void* Qt, void* Wt, void* dBpart, void* dwpart,
                          void* dw, void* dB, void* dW, int G, int L2,
                          int L1, int E, int I, int A, int Bd, int splits,
                          int dw_chunk, int route, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(w, B, W, dP, Q, U, Bt, Qt, Wt, dBpart,
                                       dwpart, dw, dB, dW, G, L2, L1, E, I,
                                       A, Bd, splits, dw_chunk, route, s);
  }
  return launch_typed<float>(w, B, W, dP, Q, U, Bt, Qt, Wt, dBpart, dwpart,
                             dw, dB, dW, G, L2, L1, E, I, A, Bd, splits,
                             dw_chunk, route, s);
}

const char* ligo_bwd_error_string(int err) {
  if (err == kErrTensorMap - 1) {
    return "cuTensorMapEncodeTiled not found";
  }
  if (err >= kErrTensorMap) {
    return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
