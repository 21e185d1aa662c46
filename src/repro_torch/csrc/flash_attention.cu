// Flash attention forward (K3) for Hopper (sm_90a): causal, sliding-window or
// bidirectional, GQA without a KV repeat.
//
//   o[b, h, t] = softmax_s(q[b, h, t] . k[b, h / G, s] / sqrt(dh)) v[b, h / G, s]
//
//   q (B, H, T, dh);  k, v (B, KV, S, dh);  G = H / KV  ->  o (B, H, T, dh)
//   q, k, v and o share one dtype (f32 or bf16); scores, softmax and the
//   accumulator are f32. Causal alignment puts the last q row on the last k
//   row (query t sits at position t + S - T); `window` keeps keys with
//   kpos > qpos - window. Every tensor is read and written through its
//   strides (the last dim contiguous), so the model's (B, T, H, dh)
//   activations go in without a transposing copy.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (body `_kernel`, pallas_call at line 90). The TPU kernel
// walks a sequential kv grid axis with (m, l, acc) carried in VMEM scratch,
// and lets a fully masked tile add exp(0) terms that a later correction
// cancels. Hopper blocks run in parallel, so here one block owns a tile of
// query rows of one (b, h) and loops over the kv tiles itself, with m, l and
// acc in registers; kv tiles wholly outside the causal range or the window
// are never visited, and a row with no visible key yet keeps exponent base 0
// so masked scores give exactly 0. Any T >= 1 and S >= 1 work: rows at or
// past T and keys at or past S are masked in-kernel (the TPU kernel needs T
// and S to divide its tiles).
//
// Two kernels, chosen by the wrapper (kernels/flash_attention.py):
//   flash_fwd_wgmma  bf16, dh <= 128 with 16-byte aligned rows (so dh a
//                    multiple of 8): the tensor cores through TMA and wgmma
//                    (below), dh padded to the tile width DH, 64 or 128;
//   flash_fwd_simt   any other case (f32, unaligned or broadcast rows):
//                    4 threads per query row, f32 FMA, f32 K/V tiles in
//                    shared memory.
//
// flash_fwd_wgmma. One block owns 128 query rows of one (b, h) and has the
// shape of the GEMM core in ligo_gemm.cuh (kTcThreads): a producer warp and
// two consumer warpgroups of 64 rows each. The producer loads the Q tile once
// and keeps a ring of K and V^T tiles filled by TMA, each completed on an
// mbarrier. Every operand in shared memory is a K-major tile with 128-byte
// swizzle (64-element boxes: DH 128 takes two), the one layout the GEMM core
// has run. Q and K are read through 4-D tensor maps over the model's own
// strided storage. V is K-major only once transposed: the launcher first
// writes V^T (B, KV, dh, S_pad) in one pass (k3_vt_transpose_kernel, S_pad
// the next multiple of 8, TMA's 16-byte rule for row pitches), and the V^T
// map declares S keys, so TMA fills zeros past S and never reads the pad.
// Per kv tile, each consumer warpgroup runs
//   S = Q K^T     wgmma.m64n128k16 (128-key tiles), both operands from
//                 shared memory;
//   softmax       online, in registers, in the exp2 domain; the wgmma
//                 accumulator of each warp is mma.sync m16n8k16's C layout
//                 for its 16 rows, so a row's max and sum take two shuffles;
//                 only tiles that straddle the causal diagonal, the window
//                 edge or S are masked;
//   O += P V      wgmma.m64n{DH}k16 with P rounded to bf16 in registers as
//                 the A operand (the accumulator layout is the A fragment
//                 layout) and the V^T tile as B;
// and the epilogue divides by l and stores through o's strides. The grid
// runs the heads that share a kv head side by side (L2 reuse of K and V^T)
// and the longest causal query tiles first.
//
// Head widths below the tile. The kernel is built for DH = 64 (dh <= 64)
// and DH = 128 (64 < dh <= 128); the tensor maps declare the true dh, so
// TMA fills columns dh..DH-1 of every Q and K box, and rows dh..DH-1 of
// every V^T box, with zeros. The extra k16 steps of Q K^T then add exact
// zeros, P V's extra accumulator columns stay 0, the epilogue stores only
// d < dh and the scale is that of the true dh. Each box still moves its
// whole byte count, so the transaction counts do not change. The padding
// costs MMA work in the ratio DH / dh: 1.6x at dh 80 (zamba2-2.7b,
// hubert-xlarge) and 40 (hubert's half model), 1.33x at 48 (cait), 1.07x
// at 120 (zamba2 grown 2x).
//
// What bounds it. At llama3-8b prefill (B 4, H 32, KV 8, T = S = 2048,
// dh 128, causal) one call needs 4 B H dh T(T+1)/2 ~ 137 GFLOP against
// ~0.17 GB of q, k, v and o: compute, a floor of ~0.14 ms at the H100 SXM's
// 989 TFLOP/s dense bf16. The V^T pass moves 2 x 16.8 MB more (~15 us).
// Each warpgroup runs its two GEMMs and its softmax one after another; only
// the two warpgroups (and the TMA ring) overlap. Reading V through an
// MN-major descriptor (no transpose), ping-pong scheduling of the two
// warpgroups, a softmax overlapped with the next tile's GEMM and, for dh 80,
// a native 80-wide tile (no padded columns) are the levers left.
//
// Plain C interface (built with nvcc into a shared library, loaded by ctypes):
// the launcher returns cudaGetLastError() (or a tensor-map encode failure,
// kErrTensorMap + its CUresult) and never synchronises.

#include <math.h>

#include <atomic>

#include "ligo_gemm.cuh"

namespace {

struct Params {
  int H, KV, T, S, dh, causal, window;
  float scale_log2;  // log2(e) / sqrt(dh): scores live in the exp2 domain
  int64_t q_b, q_h, q_t, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_t;
};

// Keys [lo, hi) that some query row of [r0, r1] (r1 < T) can see.
__device__ __forceinline__ void key_range(const Params& p, int r0, int r1,
                                          int* lo, int* hi) {
  const int off = p.S - p.T;
  *hi = p.causal ? min(p.S, r1 + off + 1) : p.S;
  *lo = p.window ? max(0, r0 + off - p.window + 1) : 0;
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.S && (!p.causal || kpos <= qpos) &&
         (!p.window || kpos > qpos - p.window);
}

// Does any (row, key) pair of rows [r0, r1] x keys [k0, k0 + n) need a mask?
__device__ __forceinline__ bool tile_edge(const Params& p, int r0, int r1,
                                          int k0, int n) {
  const int off = p.S - p.T;
  return k0 + n > p.S || (p.causal && k0 + n - 1 > r0 + off) ||
         (p.window && k0 <= r1 + off - p.window);
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16, dh <= 128 padded to DH = 64 or 128)
// ---------------------------------------------------------------------------
constexpr int kRows = 128;  // query rows per block: 64 per consumer warpgroup
constexpr int kBox = 64;    // elements of one 128-byte swizzled box row

// Keys per kv tile and depth of the K / V^T ring, by head dim: no spill
// under __launch_bounds__(kTcThreads, 1) at either; 64-key tiles and a
// third stage at dh 128 both ran slower (PERF.md).
template <int DH>
struct Tile {
  static constexpr int BK = 128;  // S = Q K^T is wgmma.m64n128k16
  static constexpr int kStages = DH == 64 ? 4 : 2;
  static constexpr int kSmem = 2 * (kRows * DH               // Q
                                    + kStages * 2 * BK * DH)  // K, V^T rings
                               + (2 * kStages + 1) * 8        // barriers
                               + 1024;                        // alignment
};

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma operands held in
// registers across the asynchronous wgmma (the header's fence_acc, any size).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// d (64 x 128, f32) += A (64 x 16, bf16 in registers: the mma.sync m16n8k16
// A fragment of each warp's 16 rows) . B (128 x 16)^T from shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 0;\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) . B (64 x 16)^T.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ float fast_exp2(float x) {  // exp2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid = (H, ceil(T / kRows), B); block = kTcThreads; dynamic shared memory
// Tile<DH>::kSmem. Maps: Q (dh, T, H, B) and K (dh, S, KV, B) with boxes of
// 64 x {kRows, BK} rows; V^T (S, dh, KV, B) with boxes of 64 keys x DH, dh
// the true head width (<= DH): TMA zero-fills what lies past it.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmQ,
                const __grid_constant__ CUtensorMap tmK,
                const __grid_constant__ CUtensorMap tmVt,
                __nv_bfloat16* __restrict__ o, const Params p) {
  constexpr int BK = Tile<DH>::BK;
  constexpr int kStages = Tile<DH>::kStages;
  constexpr int kTileElems = BK * DH;  // one K tile, or one V^T tile
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // DH/64 boxes
  __nv_bfloat16* sK = sQ + kRows * DH;             // [stage][DH/64][BK][64]
  __nv_bfloat16* sV = sK + kStages * kTileElems;   // [stage][BK/64][DH][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kStages * kTileElems);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // longest rows first
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  int k_lo, k_hi;
  key_range(p, q0, min(q0 + kRows, p.T) - 1, &k_lo, &k_hi);
  const int t0 = k_lo / BK;
  const int n_tiles = (k_hi + BK - 1) / BK - t0;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kTcConsumers) {
    // Producer: one thread loads Q, then keeps the K / V^T ring full.
    if (threadIdx.x % 32 == 0) {
      mbar_expect_tx(q_full, kRows * DH * 2);
#pragma unroll
      for (int c = 0; c < DH / kBox; ++c) {
        tma_load_4d(sQ + c * kRows * kBox, &tmQ, q_full, c * kBox, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = (t0 + it) * BK;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * kTileElems * 2);
#pragma unroll
        for (int c = 0; c < DH / kBox; ++c) {
          tma_load_4d(sK + s * kTileElems + c * BK * kBox, &tmK, &full[s],
                      c * kBox, k0, kvh, b);
        }
#pragma unroll
        for (int c = 0; c < BK / kBox; ++c) {
          tma_load_4d(sV + s * kTileElems + c * DH * kBox, &tmVt, &full[s],
                      k0 + c * kBox, 0, kvh, b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns query rows [r_lo, r_lo + 64) of the tile;
  // this thread holds rows row_a and row_a + 8 of them (the wgmma
  // accumulator layout: register i of lane l in warp w4 holds row
  // 16 w4 + l/4 + 8 ((i/2) % 2), col 8 (i/4) + 2 (l%4) + i%2).
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r_lo = q0 + 64 * wg;
  const int r_hi = min(r_lo + 63, p.T - 1);
  const bool idle = r_lo >= p.T;  // every row past T: nothing to compute
  const int row_a = r_lo + 16 * (t / 32) + lane / 4;
  const int qpos_a = row_a + p.S - p.T, qpos_b = qpos_a + 8;
  const int col = 2 * (lane % 4);
  const float sl = p.scale_log2;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    mbar_wait(&full[s], (it / kStages) & 1);
    if (!idle) {
      const int k0 = (t0 + it) * BK;
      const __nv_bfloat16* kt = sK + s * kTileElems;
      const __nv_bfloat16* vt = sV + s * kTileElems;

      // S = Q K^T: 64 rows x BK keys, f32 (raw scores, unscaled).
      float sc[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // 16 bf16 = 32 bytes further along dh: +2 in 16-byte units
        const int c = kk / 4, k16 = 2 * (kk % 4);
        wgmma_m64n128k16(sc, gmma_desc(sQ + c * kRows * kBox + wg * 64 * kBox)
                                 + k16,
                         gmma_desc(kt + c * BK * kBox) + k16);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // Online softmax in the exp2 domain: p = 2^(s sl - m sl).
      const bool edge = tile_edge(p, r_lo, r_hi, k0, BK);
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (edge) {
            const int kpos = k0 + 8 * n + col + e;
            if (!visible(p, qpos_a, kpos)) sc[4 * n + e] = -INFINITY;
            if (!visible(p, qpos_b, kpos)) sc[4 * n + 2 + e] = -INFINITY;
          }
          mx_a = fmaxf(mx_a, sc[4 * n + e]);
          mx_b = fmaxf(mx_b, sc[4 * n + 2 + e]);
        }
      }
      // the four threads lane % 4 = 0..3 share a row
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      // a row that sees no key yet keeps base 0: 2^(-inf - 0) = 0, no NaN
      const float base_a = mn_a == -INFINITY ? 0.f : mn_a * sl;
      const float base_b = mn_b == -INFINITY ? 0.f : mn_b * sl;
      const float corr_a = fast_exp2(m_a * sl - base_a);
      const float corr_b = fast_exp2(m_b * sl - base_b);
      m_a = mn_a;
      m_b = mn_b;
      l_a *= corr_a;
      l_b *= corr_b;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= (i / 2) % 2 ? corr_b : corr_a;

      // P as bf16 A fragments: the accumulator registers of key columns
      // [16 kk, 16 kk + 16) are the A fragment of the kk-th 16-key slice.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        float pr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          pr[e] = fast_exp2(fmaf(sc[8 * kk + e], sl,
                                 -((e / 2) % 2 ? base_b : base_a)));
        }
        l_a += (pr[0] + pr[1]) + (pr[4] + pr[5]);
        l_b += (pr[2] + pr[3]) + (pr[6] + pr[7]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          pa[kk][j] = pack_bf16(pr[2 * j], pr[2 * j + 1]);
        }
      }

      // O += P V: B is the K-major V^T tile (dh rows x BK keys).
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db =
            gmma_desc(vt + (kk / 4) * DH * kBox) + 2 * (kk % 4);
        if constexpr (DH == 128) {
          wgmma_rs_n128(acc, pa[kk], db);
        } else {
          wgmma_rs_n64(acc, pa[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    // this warpgroup's wgmmas have read the stage: hand it back
    if (t == 0) mbar_arrive(&empty[s]);
  }
  if (idle) return;

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* og = o + b * p.o_b + h * p.o_h;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int d = 8 * n + col;  // dh is a multiple of 8: d and d + 1 < dh
    if (d >= p.dh) continue;    // a padded column
    if (row_a < p.T) {
      *reinterpret_cast<uint32_t*>(og + row_a * p.o_t + d) =
          pack_bf16(acc[4 * n] * inv_a, acc[4 * n + 1] * inv_a);
    }
    if (row_a + 8 < p.T) {
      *reinterpret_cast<uint32_t*>(og + (row_a + 8) * p.o_t + d) =
          pack_bf16(acc[4 * n + 2] * inv_b, acc[4 * n + 3] * inv_b);
    }
  }
}

// vt[b][kv][d][s] = v[b][kv][s][d] for s < S and d < dh, bf16, v read
// through its strides, vt with row pitch S_pad (>= S + 1 where S is odd: the
// pair stores reach key S, which gets 0). 64 keys x 64 dims a block through
// shared memory, 32 x 8 threads moving pairs of elements: the K-major V^T
// that the P V product reads (ligo_transpose_kernel with input strides and
// an output pitch). grid = (ceil(S / 64), ceil(dh / 64), B * KV); a block
// past dh on the last 64 dims reads and writes only d < dh (dh a multiple
// of 8, so a pair never straddles it).
__global__ void __launch_bounds__(256)
k3_vt_transpose_kernel(const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ vt, int KV, int S, int dh,
                       int S_pad, int64_t v_b, int64_t v_h, int64_t v_s) {
  __shared__ __nv_bfloat16 tile[64][66];
  const int bk = blockIdx.z;
  const __nv_bfloat16* in = v + (bk / KV) * v_b + (bk % KV) * v_h;
  __nv_bfloat16* out = vt + (int64_t)bk * dh * S_pad;
  const int s0 = blockIdx.x * 64, d0 = blockIdx.y * 64;
  const int tx = threadIdx.x;
  for (int i = threadIdx.y; i < 64; i += 8) {
    const int s = s0 + i;
    __nv_bfloat162 x = __floats2bfloat162_rn(0.f, 0.f);
    if (s < S && d0 + 2 * tx < dh) {
      x = *reinterpret_cast<const __nv_bfloat162*>(in + s * v_s + d0 + 2 * tx);
    }
    *reinterpret_cast<__nv_bfloat162*>(&tile[i][2 * tx]) = x;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 64 && d0 + i < dh; i += 8) {
    const int s = s0 + 2 * tx;
    if (s < S) {
      __nv_bfloat162 x;
      x.x = tile[2 * tx][i];
      x.y = tile[2 * tx + 1][i];
      *reinterpret_cast<__nv_bfloat162*>(out + (int64_t)(d0 + i) * S_pad + s) =
          x;
    }
  }
}

// Tensor map of a 4-D bf16 array (dims innermost first, the first
// contiguous; strides of dims 1-3 in elements): boxes of 64 x rows x 1 x 1,
// 128-byte swizzle, zeros out of bounds.
int make_map_4d(CUtensorMap* map, const void* base, const int64_t (&dims)[4],
                const int64_t (&strides)[3], int rows) {
  EncodeTiledFn fn;
  const int e = encode_fn(&fn);
  if (e != 0) return e;
  const cuuint64_t gdims[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1],
                               (cuuint64_t)dims[2], (cuuint64_t)dims[3]};
  const cuuint64_t gstrides[3] = {(cuuint64_t)strides[0] * 2,
                                  (cuuint64_t)strides[1] * 2,
                                  (cuuint64_t)strides[2] * 2};
  const cuuint32_t box[4] = {kBox, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(base), gdims, gstrides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

// The kernel's opt-in to more than 48 KB of dynamic shared memory, set once
// per device (the setting lasts for the process): setting it on every call
// cost a host-bound call more than the kernel's own device time.
template <int DH>
cudaError_t opt_in_smem() {
  static std::atomic<uint64_t> done{0};  // a bit per device set so far
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit & done.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_wgmma<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<DH>::kSmem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Encodes the three tensor maps, then launches the V^T pass and the kernel.
// The maps declare the true dh (<= DH); their boxes are DH wide, and TMA
// fills the rest with zeros.
template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* vt,
                 void* o, const Params& p, int B, cudaStream_t stream) {
  const int S_pad = (p.S + 7) / 8 * 8;
  const int64_t dh = p.dh;
  CUtensorMap mq, mk, mv;
  int e = make_map_4d(&mq, q, {dh, p.T, p.H, B}, {p.q_t, p.q_h, p.q_b}, kRows);
  if (e == 0) {
    e = make_map_4d(&mk, k, {dh, p.S, p.KV, B}, {p.k_s, p.k_h, p.k_b},
                    Tile<DH>::BK);
  }
  if (e == 0) {
    e = make_map_4d(&mv, vt, {p.S, dh, p.KV, B},
                    {S_pad, dh * S_pad, p.KV * dh * S_pad}, DH);
  }
  if (e != 0) return e;
  k3_vt_transpose_kernel<<<dim3((p.S + 63) / 64, (p.dh + 63) / 64, B * p.KV),
                           dim3(32, 8), 0, stream>>>(
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(vt),
      p.KV, p.S, p.dh, S_pad, p.v_b, p.v_h, p.v_s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = opt_in_smem<DH>();
  if (err != cudaSuccess) return (int)err;
  flash_fwd_wgmma<DH><<<dim3(p.H, (p.T + kRows - 1) / kRows, B), kTcThreads,
                        Tile<DH>::kSmem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// FMA kernel (f32, or bf16 with unaligned or broadcast rows)
// ---------------------------------------------------------------------------
constexpr int kSimtThreads = 128;
constexpr int kSub = 4;                 // threads per query row
constexpr int kSimtRows = kSimtThreads / kSub;  // 32 query rows per block
constexpr int kSimtBK = 32;             // keys per tile

// grid = (ceil(T / kSimtRows), H, B); block = kSimtThreads. Thread `sub` of a
// row holds columns d = sub + 4 j (j < NJ, d < dh) of q and of the
// accumulator; a score is its four partial dots summed by two shuffles.
template <typename T, int NJ>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, const Params p) {
  constexpr int kW = kSub * NJ;
  __shared__ float Ks[kSimtBK][kW];
  __shared__ float Vs[kSimtBK][kW];

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int tid = threadIdx.x, sub = tid % kSub;
  const int r_lo = qb * kSimtRows, r_hi = min(r_lo + kSimtRows, p.T) - 1;
  const int row = r_lo + tid / kSub;
  const int qpos = row + p.S - p.T;
  const bool live = row < p.T;

  const T* qg = q + b * p.q_b + h * p.q_h;
  const T* kg = k + b * p.k_b + kvh * p.k_h;
  const T* vg = v + b * p.v_b + kvh * p.v_h;
  T* og = o + b * p.o_b + h * p.o_h;

  float qr[NJ], acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = sub + kSub * j;
    qr[j] = (live && d < p.dh) ? to_f32(qg[row * p.q_t + d]) * p.scale_log2
                               : 0.f;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  int k_lo, k_hi;
  key_range(p, r_lo, r_hi, &k_lo, &k_hi);

  for (int k0 = (k_lo / kSimtBK) * kSimtBK; k0 < k_hi; k0 += kSimtBK) {
    __syncthreads();
    for (int c = tid; c < kSimtBK * kW; c += kSimtThreads) {
      const int r = c / kW, d = c % kW;
      const bool ok = k0 + r < p.S && d < p.dh;
      Ks[r][d] = ok ? to_f32(kg[(k0 + r) * p.k_s + d]) : 0.f;
      Vs[r][d] = ok ? to_f32(vg[(k0 + r) * p.v_s + d]) : 0.f;
    }
    __syncthreads();

    float s[kSimtBK];
    float mx = -INFINITY;
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) part = fmaf(qr[j], Ks[kk][sub + kSub * j], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (!visible(p, qpos, k0 + kk)) part = -INFINITY;
      s[kk] = part;
      mx = fmaxf(mx, part);
    }
    const float mn = fmaxf(m, mx);
    const float base = mn == -INFINITY ? 0.f : mn;
    const float corr = exp2f(m - base);
    m = mn;
    l *= corr;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= corr;
#pragma unroll
    for (int kk = 0; kk < kSimtBK; ++kk) {
      const float pk = exp2f(s[kk] - base);
      l += pk;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[j] = fmaf(pk, Vs[kk][sub + kSub * j], acc[j]);
    }
  }

  if (!live) return;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = sub + kSub * j;
    if (d < p.dh) og[row * p.o_t + d] = from_f32<T>(acc[j] / denom);
  }
}

template <typename T, int NJ>
void launch_simt(const void* q, const void* k, const void* v, void* o,
                 const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.T + kSimtRows - 1) / kSimtRows, p.H, B);
  flash_fwd_simt<T, NJ><<<grid, kSimtThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), p);
}

template <typename T>
void dispatch_simt(const void* q, const void* k, const void* v, void* o,
                   const Params& p, int B, cudaStream_t stream) {
  if (p.dh <= 32) {
    launch_simt<T, 8>(q, k, v, o, p, B, stream);
  } else if (p.dh <= 64) {
    launch_simt<T, 16>(q, k, v, o, p, B, stream);
  } else {
    launch_simt<T, 32>(q, k, v, o, p, B, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o). use_mma: 1 runs the
// tensor-core kernel (the caller has checked bf16, dh <= 128 and a multiple
// of 8, and 16-byte aligned rows and bases, and passes vt, a (B, KV, dh,
// S_pad) bf16 scratch for V^T with S_pad = S rounded up to a multiple of 8),
// 0 the FMA kernel (dh <= 128; vt unused). Strides are in elements; the
// last dim of every tensor is contiguous. Returns a cudaError_t, or
// kErrTensorMap + the CUresult of a failed tensor-map encode (nothing
// launched then).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* vt,
                        void* o, int B, int H, int KV, int T, int S, int dh,
                        int causal, int window, long long q_b, long long q_h,
                        long long q_t, long long k_b, long long k_h,
                        long long k_s, long long v_b, long long v_h,
                        long long v_s, long long o_b, long long o_h,
                        long long o_t, int dtype, int use_mma, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Params p;
  p.H = H;
  p.KV = KV;
  p.T = T;
  p.S = S;
  p.dh = dh;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(dh));
  p.q_b = q_b;
  p.q_h = q_h;
  p.q_t = q_t;
  p.k_b = k_b;
  p.k_h = k_h;
  p.k_s = k_s;
  p.v_b = v_b;
  p.v_h = v_h;
  p.v_s = v_s;
  p.o_b = o_b;
  p.o_h = o_h;
  p.o_t = o_t;
  if (use_mma) {
    return dh <= 64 ? launch_wgmma<64>(q, k, v, vt, o, p, B, st)
                    : launch_wgmma<128>(q, k, v, vt, o, p, B, st);
  }
  if (dtype == 1) {
    dispatch_simt<__nv_bfloat16>(q, k, v, o, p, B, st);
  } else {
    dispatch_simt<float>(q, k, v, o, p, B, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_error_string(int err) { return error_text(err); }

}  // extern "C"
