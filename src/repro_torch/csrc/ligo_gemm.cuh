// The device core that kernels K1 (ligo_expand.cu) and K2
// (ligo_expand_bwd.cu) share: f32 <-> storage-type conversion, V-wide loads
// and stores, and two batched GEMMs with their launchers.
//
//   ligo_f32_gemm_kernel    C[z] = sum_r A_r B_r on any strides, f32 FMA pipes
//                           (f32 operands, and bf16 at unaligned widths),
//                           through a cp.async ring, in one of four tiles
//                           the host picks by shape, its sum split where
//                           the output's blocks leave SMs idle;
//   ligo_sum_parts_kernel   the in-order sum of a split GEMM's partials;
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

#include <atomic>
#include <type_traits>

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

constexpr int kThreads = 256;  // threads of the elementwise kernels
constexpr int kWarps = kThreads / 32;

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

// ---------------------------------------------------------------------------
// The float32 GEMM:  C[z] = sum_{r in split} sum_k Aop_r(m, k) Bop_r(k, n)
// (GemmArgs above) on the FMA pipes in exact f32: the route of every f32
// product of K1 and K2, and of bf16 ones at widths TMA cannot take
// (converted to f32 as they are staged). TF32 would change the arithmetic
// that the f32 tolerance (1e-5, normalised) is reasoned from.
//
// What bounds it. The AdamW-moment grow (gpt2-base -> gpt2-medium: 7 K1
// products a moment, 394 GFLOP) is bound by operations: 5.9 ms a moment at
// the H100 SXM's 67 TFLOP/s f32. Its products are large (M 1024-4096, N
// 768-4096, K 768-3072, 12 batches), so the 128 x 128 tile gives 768-3072
// blocks. The MoE router's group (N = Bd = 8, K 2048) is bound by bytes:
// B (M x K f32) is read once, 33.5 MB, ~10 us at 3.35 TB/s, against ~0.6
// GFLOP.
//
// The design:
// - A ring of kFStages k-slices (kFk deep) in shared memory, filled by
//   cp.async: 16-byte cp.async.cg along an operand's contiguous axis where
//   its strides, extent and base allow it, 4-byte cp.async.ca otherwise,
//   zero fill past every edge (src-size 0). Loads of slice it + 2 fly while
//   slice it is multiplied; one __syncthreads a slice. bf16 operands are
//   loaded, converted and stored by the threads themselves.
// - Each operand is staged along its own contiguous axis: an M- (N-)
//   contiguous operand as [k][m] rows, a K-contiguous one as [m][k] rows of
//   kFk floats whose 16-byte chunks are XOR-swizzled by (m / 4) % 4, so that
//   the rows a warp reads together fall in distinct banks.
// - A thread owns TM x TN outputs as (TM/4) x (TN/4) strips of 4 x 4, 64
//   (or 16) rows or columns apart, and reads shared memory as float4s: 16
//   LDS.128 for 256 FMAs (8 x 8) per four k. A warp's lanes are 4 x 8 (8 x
//   4 on the 16-wide tile), so its float4 reads touch 4 or 8 distinct
//   16-byte chunks, 128 bytes at most.
// - The tile follows the shape (kernels/_gemm.py::f32_gemm_plan picks it and
//   passes its code): 128 x 128 (8 x 8 a thread, 256 threads) for large
//   products; 64 x 64 (4 x 4, 256) where 128 x 128 gives less than a wave;
//   128 x 16 (8 x 4, 64) for N <= 16, the router's Bd = 8. Where the blocks still fall short of 132 SMs, the
//   (r, k-slice) sequence is cut into S contiguous parts, each a block
//   writing an f32 partial, and ligo_sum_parts_kernel adds the parts in
//   order: no float atomics, so every call repeats bit for bit, and K1's
//   and K2's U (the same arguments, the same plan) agree bit for bit.
//
// Where it stands (tools/f32_gemm_times.py, an H100 80GB HBM3 at 700 W):
// the gpt2 moment grow's GEMMs run at about half the FMA peak, level with
// the library's f32 GEMM. The 128 x 128 instance holds 215 registers a
// thread, so one 8-warp block an SM; two blocks an SM (128 registers), a
// 4-deep ring and 32-deep slices were each measured slower.

constexpr int kFk = 16;        // contraction depth of one ring stage
constexpr int kFStages = 3;    // slices in flight

// Tile kTile: BM x BN outputs a block, TM x TN a thread.
template <int kTile> struct F32Tile;
template <> struct F32Tile<0> {
  static constexpr int BM = 128, BN = 128, TM = 8, TN = 8;
};
template <> struct F32Tile<1> {
  static constexpr int BM = 64, BN = 64, TM = 4, TN = 4;
};
template <> struct F32Tile<2> {
  static constexpr int BM = 128, BN = 16, TM = 8, TN = 4;
};

template <int kTile>
constexpr int f32_threads() {
  return (F32Tile<kTile>::BM / F32Tile<kTile>::TM)
         * (F32Tile<kTile>::BN / F32Tile<kTile>::TN);
}

// f32_gemm's flags: which operands take 16-byte copies, and whether C
// takes 16-byte stores
constexpr int kVecA = 1, kVecB = 2, kVecC = 4;

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Offset in a K-contiguous staged tile of element (row, k): rows of kFk
// floats, 16-byte chunks swizzled by (row / 4) % 4.
__device__ __forceinline__ int kc_off(int row, int k) {
  return row * kFk + ((((k >> 2) ^ (row >> 2)) & 3) << 2) + (k & 3);
}

// One operand's share of a ring stage: X(row, k) = base[row*s_row + k*s_k]
// for rows [row0, row0 + kR) and k [k0, k0 + kFk), into s (kR x kFk
// floats), zero past `rows` and `K`. kKc: staged K-contiguous ([row][k]),
// else row-contiguous ([k][row]). Each thread copies kR * kFk / 4 / kT
// vectors of 4 elements along the staged contiguous axis: one 16-byte
// cp.async where `vec`, else 4-byte ones (f32) or loads and stores (bf16).
template <bool kKc, int kR, int kT, typename T>
__device__ __forceinline__ void stage_operand(float* s, const T* base,
                                              int64_t s_row, int64_t s_k,
                                              int row0, int rows, int k0,
                                              int K, bool vec) {
  constexpr int kVecs = kR * kFk / 4;
  static_assert(kVecs % kT == 0, "tile vectors must split over the threads");
#pragma unroll
  for (int j = 0; j < kVecs / kT; ++j) {
    const int v = threadIdx.x + j * kT;
    int row, k, dr, dk;            // first element, and the step between
    float* dst;                    // the vector's four
    if (kKc) {
      row = v >> 2; k = (v & 3) * 4; dr = 0; dk = 1;
      dst = s + kc_off(row, k);
    } else {
      k = v / (kR / 4); row = (v % (kR / 4)) * 4; dr = 1; dk = 0;
      dst = s + k * kR + row;
    }
    const int gr = row0 + row;
    const int gk = k0 + k;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {                   // all four in or out together
        const bool in = gr < rows && gk < K;
        cp_async16(dst, in ? base + gr * s_row + gk * s_k : base,
                   in ? 16 : 0);
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gr + e * dr, kk = gk + e * dk;
        const bool in = r < rows && kk < K;
        cp_async4(dst + e, in ? base + r * s_row + kk * s_k : base,
                  in ? 4 : 0);
      }
    } else {
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gr + e * dr, kk = gk + e * dk;
        x[e] = (r < rows && kk < K) ? to_f32(base[r * s_row + kk * s_k])
                                    : 0.f;
      }
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

template <int kProd, int kTile, bool kAKc, bool kBKc, typename TA,
          typename TB, typename TC>
__global__ void __launch_bounds__(f32_threads<kTile>())
ligo_f32_gemm_kernel(const TA* __restrict__ Ap, const TB* __restrict__ Bp,
                     TC* __restrict__ C, float* __restrict__ part,
                     const GemmArgs g, int flags) {
  using Tl = F32Tile<kTile>;
  constexpr int BM = Tl::BM, BN = Tl::BN, TM = Tl::TM, TN = Tl::TN;
  constexpr int kTX = BN / TN, kTY = BM / TM;      // threads along n, m
  constexpr int kT = kTX * kTY;
  constexpr int kLX = kTX < 8 ? kTX : 8;           // a warp's lanes along n
  constexpr int kLY = 32 / kLX;
  constexpr int kRS = kTY * 4, kCS = kTX * 4;      // strip strides
  __shared__ __align__(16) float As[kFStages][BM * kFk];
  __shared__ __align__(16) float Bs[kFStages][BN * kFk];

  const int Zo = gridDim.z / g.S;                  // output batches
  const int z = blockIdx.z;
  const int zb = z / g.S;
  const int zs = z % g.S;
  const int nk = (g.K + kFk - 1) / kFk;
  const int t0 = (int)((int64_t)zs * g.R * nk / g.S);
  const int t1 = (int)((int64_t)(zs + 1) * g.R * nk / g.S);
  const int n_it = t1 - t0;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = (warp / (kTX / kLX)) * kLY + lane / kLX;
  const int tx = (warp % (kTX / kLX)) * kLX + lane % kLX;
  const bool vec_a = flags & kVecA, vec_b = flags & kVecB;
  const TA* A = Ap + (int64_t)zb * g.sAz;
  const TB* B = Bp + (int64_t)zb * g.sBz;

  // slice t of the (r, k-slice) sequence into ring stage st
  auto load = [&](int st, int t) {
    const int r = t / nk;
    const int k0 = (t - r * nk) * kFk;
    stage_operand<kAKc, BM, kT>(As[st], A + (int64_t)r * g.sAr, g.sAm,
                                g.sAk, row0, g.M, k0, g.K, vec_a);
    stage_operand<kBKc, BN, kT>(Bs[st], B + (int64_t)r * g.sBr, g.sBn,
                                g.sBk, col0, g.N, k0, g.K, vec_b);
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {
    if (st < n_it) load(st, t0 + st);
    cp_async_commit();
  }
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<kFStages - 2>();   // this thread's copies of slice it
    __syncthreads();                 // everyone's; slice it - 1 is done
    if (it + kFStages - 1 < n_it) {
      load((it + kFStages - 1) % kFStages, t0 + it + kFStages - 1);
    }
    cp_async_commit();
    const float* sa = As[it % kFStages];
    const float* sb = Bs[it % kFStages];
#pragma unroll
    for (int kq = 0; kq < kFk / 4; ++kq) {
      float ra[TM][4];               // A(row i, 4 kq + kk)
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        if (kAKc) {
          const int row = (i / 4) * kRS + ty * 4 + i % 4;
          const float4 v = *reinterpret_cast<const float4*>(
              sa + kc_off(row, 4 * kq));
          ra[i][0] = v.x; ra[i][1] = v.y; ra[i][2] = v.z; ra[i][3] = v.w;
        } else if (i % 4 == 0) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 v = *reinterpret_cast<const float4*>(
                sa + (4 * kq + kk) * BM + (i / 4) * kRS + ty * 4);
            ra[i][kk] = v.x; ra[i + 1][kk] = v.y;
            ra[i + 2][kk] = v.z; ra[i + 3][kk] = v.w;
          }
        }
      }
      if (kBKc) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = (j / 4) * kCS + tx * 4 + j % 4;
          const float4 v = *reinterpret_cast<const float4*>(
              sb + kc_off(col, 4 * kq));
          const float rb[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              acc[i][j] = fmaf(ra[i][kk], rb[kk], acc[i][j]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float rb[TN];
#pragma unroll
          for (int j = 0; j < TN; j += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                sb + (4 * kq + kk) * BN + (j / 4) * kCS + tx * 4);
            rb[j] = v.x; rb[j + 1] = v.y; rb[j + 2] = v.z; rb[j + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc[i][j] = fmaf(ra[i][kk], rb[j], acc[i][j]);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // C[z], or with a split the f32 partial (zs, zb) of a dense (Zo, M, N)
  const bool split = g.S > 1;
  const int64_t ld = split ? g.N : g.ldc;
  TC* Cz = C + (int64_t)zb * g.sCz;
  float* Pz = split ? part + ((int64_t)zs * Zo + zb) * g.M * g.N : nullptr;
  const bool vec_c = split ? g.N % 4 == 0 : (flags & kVecC) != 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = row0 + (i / 4) * kRS + ty * 4 + i % 4;
    if (gm >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int gn = col0 + (j / 4) * kCS + tx * 4;
      const int64_t o = (int64_t)gm * ld + gn;
      if (split) {
        if (vec_c && gn + 3 < g.N) {
          *reinterpret_cast<float4*>(Pz + o) = make_float4(
              acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (gn + e < g.N) Pz[o + e] = acc[i][j + e];
        }
        continue;
      }
      if constexpr (std::is_same<TC, float>::value) {
        if (vec_c && gn + 3 < g.N) {
          *reinterpret_cast<float4*>(Cz + o) = make_float4(
              acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gn + e < g.N) Cz[o + e] = from_f32<TC>(acc[i][j + e]);
      }
    }
  }
}

// out[i] = sum_{s < S} part[s * n + i] in order, cast to TO: the second
// pass of a split GEMM (the f32 one's, and K2's dB on the tensor cores).
template <typename TO>
__global__ void __launch_bounds__(kThreads)
ligo_sum_parts_kernel(const float* __restrict__ part, TO* __restrict__ out,
                      int S, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[s * n + i];
    out[i] = from_f32<TO>(acc);
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

template <typename T>
bool aligned16(const T* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether an operand's vectors of 4 along its staged contiguous axis may be
// one 16-byte copy: f32, unit stride there, an extent and every other
// stride that keep each vector on a 16-byte boundary.
template <typename T>
bool vec16(const T* base, int64_t s_unit, int64_t s_other, int64_t s_z,
           int64_t s_r, int extent) {
  return std::is_same<T, float>::value && s_unit == 1 && extent % 4 == 0
         && s_other % 4 == 0 && s_z % 4 == 0 && s_r % 4 == 0
         && aligned16(base);
}

template <int kProd, int kTile, bool kAKc, bool kBKc, typename TA,
          typename TB, typename TC>
cudaError_t f32_gemm_tile(const TA* A, const TB* B, TC* C, float* part,
                          const GemmArgs& g, int Z, cudaStream_t stream) {
  using Tl = F32Tile<kTile>;
  const int flags =
      (vec16(A, kAKc ? g.sAk : g.sAm, kAKc ? g.sAm : g.sAk, g.sAz, g.sAr,
             kAKc ? g.K : g.M) ? kVecA : 0)
      | (vec16(B, kBKc ? g.sBk : g.sBn, kBKc ? g.sBn : g.sBk, g.sBz, g.sBr,
               kBKc ? g.K : g.N) ? kVecB : 0)
      | (std::is_same<TC, float>::value && g.ldc % 4 == 0 && g.sCz % 4 == 0
         && aligned16(C) ? kVecC : 0);
  const dim3 grid((g.N + Tl::BN - 1) / Tl::BN, (g.M + Tl::BM - 1) / Tl::BM,
                  Z * g.S);
  ligo_f32_gemm_kernel<kProd, kTile, kAKc, kBKc, TA, TB, TC>
      <<<grid, f32_threads<kTile>(), 0, stream>>>(A, B, C, part, g, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || g.S == 1) return err;
  const int64_t n = (int64_t)Z * g.M * g.N;
  ligo_sum_parts_kernel<TC><<<grid_stride_blocks(n), kThreads, 0, stream>>>(
      part, C, g.S, n);
  return cudaGetLastError();
}

// C[z] = sum_{r in split} Aop_r Bop_r on the f32 GEMM, in tile `tile`
// (F32Tile) and g.S parts; kAKc / kBKc: A / B K-contiguous (sAk / sBk 1),
// which picks their staged layout. With g.S > 1 the caller gives `part`,
// (g.S, Z, M, N) f32 scratch, and C must be dense (ldc N, sCz M N).
template <int kProd, bool kAKc, bool kBKc, typename TA, typename TB,
          typename TC>
cudaError_t f32_gemm(const TA* A, const TB* B, TC* C, float* part,
                     const GemmArgs& g, int Z, int tile,
                     cudaStream_t stream) {
  if (g.S < 1 || (g.S > 1 && (part == nullptr || g.ldc != g.N
                              || g.sCz != (int64_t)g.M * g.N))) {
    return cudaErrorInvalidValue;
  }
  switch (tile) {
    case 0: return f32_gemm_tile<kProd, 0, kAKc, kBKc>(A, B, C, part, g, Z,
                                                        stream);
    case 1: return f32_gemm_tile<kProd, 1, kAKc, kBKc>(A, B, C, part, g, Z,
                                                        stream);
    case 2: return f32_gemm_tile<kProd, 2, kAKc, kBKc>(A, B, C, part, g, Z,
                                                        stream);
    default: return cudaErrorInvalidValue;
  }
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
  // the shared-memory opt-in, once per device (as K3's): a CUDA API call
  // that a grow beside a decode loop would otherwise make at every launch
  static std::atomic<uint64_t> done{0};  // a bit per device set so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(bit & done.load(std::memory_order_acquire))) {
    err = cudaFuncSetAttribute(ligo_wgmma_gemm_kernel<kProd, TC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTcSmem);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit, std::memory_order_release);
  }
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
