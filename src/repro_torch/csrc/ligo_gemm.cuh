// The device core that kernels K1 (ligo_expand.cu) and K2
// (ligo_expand_bwd.cu) share: f32 <-> storage-type conversion, V-wide loads
// and stores, and two batched GEMMs with their launchers.
//
//   ligo_fma_gemm_kernel    C[z] = sum_r A_r B_r on any strides, f32 FMA pipes
//                           (f32 operands, and bf16 at unaligned widths);
//   ligo_wgmma_gemm_kernel  C[z] = sum_r X_r Y_r^T from K-major bf16 operands
//                           through a TMA ring onto wgmma (bf16 at widths that
//                           are multiples of 8);
//   ligo_transpose_kernel   the K-major operands the wgmma GEMM needs.
//
// Each kernel source includes this header and compiles into its own library,
// with its own copy of everything here (an anonymous namespace);
// kernels/_build.py hashes the header into both libraries' names. The
// template tag kProd only names a GEMM instance apart, so that a profile
// shows each product on its own line.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: cuTensorMapEncodeTiled
                    // is looked up at run time, so nothing links libcuda
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

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output cols per block
constexpr int kBK = 16;        // contraction slice per shared-memory round
constexpr int kThreads = 256;  // 16 x 16 threads, each an 8 x 8 output tile
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;         // rows per thread: ty + 16 * m
constexpr int kTN = 8;         // cols per thread: tx + 16 * c
constexpr int kPad = 4;        // spreads the k-major tile stores over banks

// Product tags of the GEMM instances.
constexpr int kProdDW = 0;     // K2: dW[z] = B^T Q[z]
constexpr int kProdDB = 1;     // K2: dB = sum_r Q[r] W[r]^T
constexpr int kProdU = 2;      // K2: U[z] = B W[z]
constexpr int kProdK1U = 3;    // K1: U[z] = B W[z]

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
ligo_fma_gemm_kernel(const TA* __restrict__ Ap, const TB* __restrict__ Bp,
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
ligo_wgmma_gemm_kernel(const __grid_constant__ CUtensorMap tmX,
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
ligo_transpose_kernel(const __nv_bfloat16* __restrict__ in,
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
  ligo_fma_gemm_kernel<kProd, TA, TB, TC><<<grid, kThreads, 0, stream>>>(
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
      ligo_wgmma_gemm_kernel<kProd, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.N + kTcBN - 1) / kTcBN, (g.M + kTcBM - 1) / kTcBM,
                  Z * g.S);
  ligo_wgmma_gemm_kernel<kProd, TC><<<grid, kTcThreads, kTcSmem, stream>>>(
      mx, my, C, g);
  return (int)cudaGetLastError();
}

cudaError_t transpose(const __nv_bfloat16* in, __nv_bfloat16* out, int nb,
                      int R, int Cc, cudaStream_t stream) {
  const dim3 grid((Cc + 63) / 64, (R + 63) / 64, nb);
  ligo_transpose_kernel<<<grid, dim3(32, 8), 0, stream>>>(in, out, R, Cc);
  return cudaGetLastError();
}

// The text of a launcher's return code: a cudaError_t, or a tensor-map
// encode failure (see kErrTensorMap).
const char* error_text(int err) {
  if (err == kErrTensorMap - 1) {
    return "cuTensorMapEncodeTiled not found";
  }
  if (err >= kErrTensorMap) {
    return "cuTensorMapEncodeTiled failed (CUresult = code - 100000)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // namespace
