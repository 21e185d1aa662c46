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
//   flash_fwd_mma   bf16, dh 64 or 128, 16-byte aligned rows. 4 warps own
//                   64 query rows (16 each); each 64-key tile of K (row-major)
//                   and V (transposed) is staged in shared memory; QK^T and
//                   PV run on the tensor cores with mma.sync m16n8k16 (bf16
//                   in, f32 accumulate), P rounded to bf16 as the A operand
//                   of PV (FlashAttention-2's register layout).
//   flash_fwd_simt  any other case (f32, or another dh <= 128): 4 threads per
//                   query row, f32 FMA, f32 K/V tiles in shared memory.
//
// What bounds it. At llama3-8b prefill (B 4, H 32, KV 8, T = S = 2048,
// dh 128, causal) one call needs 4 B H dh T(T+1)/2 ~ 137 GFLOP against
// ~0.17 GB of q, k, v and o: compute, a floor of ~0.14 ms at the H100 SXM's
// 989 TFLOP/s dense bf16. mma.sync reaches only part of that rate, and this
// first version loads its tiles synchronously (no cp.async/TMA ring, no
// wgmma, no warp specialisation): a later PR's work.
//
// Plain C interface (built with nvcc into a shared library, loaded by ctypes):
// the launcher returns cudaGetLastError() and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

struct Params {
  int H, KV, T, S, dh, causal, window;
  float scale_log2;  // log2(e) / sqrt(dh): scores live in the exp2 domain
  int64_t q_b, q_h, q_t, k_b, k_h, k_s, v_b, v_h, v_s, o_b, o_h, o_t;
};

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
// Tensor-core kernel (bf16, dh 64 or 128)
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBK = 64;           // keys per tile
constexpr int kPad = 8;           // bf16 padding per smem row: rows start 4
                                  // banks apart, so fragment loads don't clash
static_assert(kBQ == kBK, "the Q tile is staged in the K tile's buffer");

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid = (ceil(T / kBQ), H, B); block = kThreads.
// mma.sync m16n8k16 fragments, g = lane / 4, t = lane % 4:
//   A (16x16, row-major): {row g, cols 2t..2t+1}, {row g+8, 2t..}, {row g,
//     2t+8..}, {row g+8, 2t+8..};
//   B (16x8): {k 2t..2t+1, col g}, {k 2t+8.., col g};
//   C (16x8, f32): {row g, cols 2t, 2t+1}, {row g+8, cols 2t, 2t+1}.
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, const Params p) {
  constexpr int kRowK = DH + kPad;    // Ks[key][d] (and the Q staging)
  constexpr int kRowV = kBK + kPad;   // Vt[d][key]
  constexpr int kChunks = DH / 8;     // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * kRowK];
  __shared__ __align__(16) __nv_bfloat16 Vt[DH * kRowV];

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q0 = qb * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  const __nv_bfloat16* qg = q + b * p.q_b + h * p.q_h;
  const __nv_bfloat16* kg = k + b * p.k_b + kvh * p.k_h;
  const __nv_bfloat16* vg = v + b * p.v_b + kvh * p.v_h;
  __nv_bfloat16* og = o + b * p.o_b + h * p.o_h;

  // Stage the Q tile through Ks, then hold it as A fragments in registers.
  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, d = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < p.T)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.q_t + d);
    *reinterpret_cast<uint4*>(&Ks[r * kRowK + d]) = val;
  }
  __syncthreads();
  uint32_t qa[DH / 16][4];
  {
    const __nv_bfloat16* base = Ks + (warp * 16 + g) * kRowK + 2 * t4;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      qa[kk][0] = ld32(base + kk * 16);
      qa[kk][1] = ld32(base + 8 * kRowK + kk * 16);
      qa[kk][2] = ld32(base + kk * 16 + 8);
      qa[kk][3] = ld32(base + 8 * kRowK + kk * 16 + 8);
    }
  }

  const int off = p.S - p.T;
  const int r_lo = q0, r_hi = min(q0 + kBQ, p.T) - 1;
  int k_lo, k_hi;
  key_range(p, r_lo, r_hi, &k_lo, &k_hi);
  const int qpos_a = q0 + warp * 16 + g + off;  // this thread's two rows
  const int qpos_b = qpos_a + 8;

  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile (or the Q staging) is consumed
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, d = (c % kChunks) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.S)
        val = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.k_s + d);
      *reinterpret_cast<uint4*>(&Ks[r * kRowK + d]) = val;
    }
    // V transposed; a warp takes 32 consecutive keys of one 8-wide d chunk,
    // so its 2-byte stores land on consecutive addresses.
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c % kBK, d = (c / kBK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < p.S)
        val = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.v_s + d);
      const uint32_t w[4] = {val.x, val.y, val.z, val.w};  // in registers
#pragma unroll
      for (int i = 0; i < 8; ++i)
        Vt[(d + i) * kRowV + r] = __ushort_as_bfloat16(
            static_cast<unsigned short>(w[i / 2] >> (16 * (i % 2))));
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x kBK keys, f32.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kb = Ks + (j * 8 + g) * kRowK + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        mma_bf16(s[j], qa[kk], ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
    }

    const bool edge = tile_edge(p, r_lo, r_hi, k0, kBK);
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + 2 * t4 + e;
        float sa = s[j][e] * p.scale_log2;
        float sb = s[j][2 + e] * p.scale_log2;
        if (edge) {
          if (!visible(p, qpos_a, kpos)) sa = -INFINITY;
          if (!visible(p, qpos_b, kpos)) sb = -INFINITY;
        }
        s[j][e] = sa;
        s[j][2 + e] = sb;
        mx_a = fmaxf(mx_a, sa);
        mx_b = fmaxf(mx_b, sb);
      }
    }
    // the four threads t4 = 0..3 share a row
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    // a row that sees no key yet keeps base 0: exp2(-inf - 0) = 0, no NaN
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float corr_a = exp2f(m_a - base_a), corr_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= corr_a;
    l_b *= corr_b;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      acc[n][0] *= corr_a;
      acc[n][1] *= corr_a;
      acc[n][2] *= corr_b;
      acc[n][3] *= corr_b;
    }

    // P = exp2(S - m) as bf16 A fragments: the C fragments of key tiles 2kk
    // and 2kk + 1 are the A fragment of keys [16 kk, 16 kk + 16).
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const float p00 = exp2f(s[2 * kk][0] - base_a);
      const float p01 = exp2f(s[2 * kk][1] - base_a);
      const float p02 = exp2f(s[2 * kk][2] - base_b);
      const float p03 = exp2f(s[2 * kk][3] - base_b);
      const float p10 = exp2f(s[2 * kk + 1][0] - base_a);
      const float p11 = exp2f(s[2 * kk + 1][1] - base_a);
      const float p12 = exp2f(s[2 * kk + 1][2] - base_b);
      const float p13 = exp2f(s[2 * kk + 1][3] - base_b);
      l_a += (p00 + p01) + (p10 + p11);
      l_b += (p02 + p03) + (p12 + p13);
      pa[kk][0] = pack_bf16(p00, p01);
      pa[kk][1] = pack_bf16(p02, p03);
      pa[kk][2] = pack_bf16(p10, p11);
      pa[kk][3] = pack_bf16(p12, p13);
    }

    // O += P V
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const __nv_bfloat16* vb = Vt + (n * 8 + g) * kRowV + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        mma_bf16(acc[n], pa[kk], ld32(vb + kk * 16), ld32(vb + kk * 16 + 8));
    }
  }

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
  const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
  const int row_a = q0 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int d = n * 8 + 2 * t4;
    if (row_a < p.T)
      *reinterpret_cast<uint32_t*>(og + row_a * p.o_t + d) =
          pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (row_a + 8 < p.T)
      *reinterpret_cast<uint32_t*>(og + (row_a + 8) * p.o_t + d) =
          pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
}

// ---------------------------------------------------------------------------
// FMA kernel (f32, or bf16 at another dh)
// ---------------------------------------------------------------------------
constexpr int kSub = 4;                 // threads per query row
constexpr int kSimtRows = kThreads / kSub;  // 32 query rows per block
constexpr int kSimtBK = 32;             // keys per tile

// grid = (ceil(T / kSimtRows), H, B); block = kThreads. Thread `sub` of a
// row holds columns d = sub + 4 j (j < NJ, d < dh) of q and of the
// accumulator; a score is its four partial dots summed by two shuffles.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
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
    for (int c = tid; c < kSimtBK * kW; c += kThreads) {
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
  flash_fwd_simt<T, NJ><<<grid, kThreads, 0, stream>>>(
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
// tensor-core kernel (the caller has checked bf16, dh 64 or 128, and 16-byte
// aligned rows), 0 the FMA kernel (dh <= 128). Strides are in elements; the
// last dim of every tensor is contiguous. Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int T, int S, int dh, int causal,
                        int window, long long q_b, long long q_h,
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
    const dim3 grid((T + kBQ - 1) / kBQ, H, B);
    const auto* qq = static_cast<const __nv_bfloat16*>(q);
    const auto* kk = static_cast<const __nv_bfloat16*>(k);
    const auto* vv = static_cast<const __nv_bfloat16*>(v);
    auto* oo = static_cast<__nv_bfloat16*>(o);
    if (dh == 64) {
      flash_fwd_mma<64><<<grid, kThreads, 0, st>>>(qq, kk, vv, oo, p);
    } else {
      flash_fwd_mma<128><<<grid, kThreads, 0, st>>>(qq, kk, vv, oo, p);
    }
  } else if (dtype == 1) {
    dispatch_simt<__nv_bfloat16>(q, k, v, o, p, B, st);
  } else {
    dispatch_simt<float>(q, k, v, o, p, B, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
