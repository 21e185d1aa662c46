// LiGO fused blend-expand, backward: all three cotangents, for Hopper (sm_90a).
//
// Forward (kernel K1, ligo_expand.cu):
//   P[g, k, e] = B @ blended[g, k, e],  blended[g, k, e] = sum_l w[g, k, l] W[g, l, e]
//   w (G, L2, L1) f32;  B (I, A);  W (G, L1, E, A, Bd)  ->  P (G, L2, E, I, Bd)
//
// Backward, given dP (G, L2, E, I, Bd) in the dtype of B and W:
//   T[g, k, e]  = B^T dP[g, k, e]                              (A, Bd), f32
//   dW[g, l, e] = sum_k w[g, k, l] T[g, k, e]                  -> W's dtype
//   dB          = sum_{g,k,e} dP[g, k, e] blended[g, k, e]^T   -> B's dtype
//   dw[g, k, l] = sum_e <T[g, k, e], W[g, l, e]>               -> f32
// Every sum accumulates in f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ligo_expand_bwd.py::
// ligo_blend_expand_bwd_fused (body `_bwd_kernel`, pallas_call at line 164).
// The TPU kernel makes one serial pass over the dP tiles and keeps a whole
// (I, A) dB accumulator and an (L1, A, TB) dW accumulator resident in VMEM
// across its (n, k, i) grid nest. Hopper blocks run in parallel and in no
// order, and 227 KB of shared memory cannot hold B (let alone dB) at
// A = 3072. So this port runs seven launches on the caller's stream, each
// block owning its outputs, with no float atomics: every sum has one fixed
// order, and repeated runs agree bit for bit.
//
//   1. blend (ligo_common.cuh): blended = w . W into an f32 scratch;
//   2. T-GEMM: T[n] = B^T dP[n] for each n = (g, k, e), a batched tiled GEMM
//      (contraction over I) into an f32 scratch;
//   3. dB-GEMM: dB = sum_n dP[n] blended[n]^T, one GEMM whose contraction
//      runs over (n, Bd); each block owns one (128 x 128) dB tile. Where the
//      tile grid under-fills the 132 SMs (the attention and mlp/w1 groups
//      give 8 x 6 tiles) the n range is split into S contiguous parts, each
//      writing its own f32 partial;
//   4. dB-reduce: dB = sum of the S partials in order, cast to B's dtype;
//   5. blend again: dW[g, l, e] = sum_k w[g, k, l] T[g, k, e], with w
//      transposed by the wrapper;
//   6. dw-partial: each block takes one (g, k) and one chunk of the
//      E * A * Bd axis and forms <T[g,k], W[g,l]> over the chunk for every l,
//      reduced in the block by a fixed shuffle tree;
//   7. dw-reduce: dw = sum of the chunk partials in order.
// The GEMMs share one kernel: 128 x 128 output tiles per 256-thread block,
// 16-deep contraction slices staged through shared memory (the load order
// follows whichever operand axis is contiguous, so global reads coalesce),
// an 8 x 8 f32 register tile per thread, ragged edges masked in-kernel.
// The wrapper allocates the outputs and every scratch buffer.
//
// What bounds it. On the LiGO training path (gpt2-base -> gpt2-medium) the
// kernel runs once per eligible group per SGD step: wq, wk, wv, wo (I 1024,
// A 768, Bd 768), mlp/w1 (I 1024, A 768, Bd 3072) and mlp/w2 (I 4096,
// A 3072, Bd 768), all G = E = 1, L2 = 24, L1 = 12. In its cheapest order
// (blend dP over k first, then three L1-batched products) the function needs
// ~1.04 TFLOP per backward, ~0.70 of it in mlp/w2: compute, a floor of
// ~1.06 ms at the H100 SXM's 989 TFLOP/s dense bf16, against ~0.3 GB of
// traffic. This first version runs the GEMMs on the f32 FMA pipes (67 TFLOP/s
// peak), not the tensor cores, so that bf16 and f32 results both hold to the
// plain version's f32 arithmetic, and in the fused order (T over all L2 = 24
// layers, dB against the blended slabs): ~1.39 TFLOP, ~1.3x the fewest.
// A wgmma/TMA pipeline and the cheaper order are later work.
//
// Plain C interface (built with nvcc into a shared library, loaded by ctypes):
// the launcher returns cudaGetLastError() and never synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ligo_common.cuh"

namespace {

constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output cols per block
constexpr int kBK = 16;        // contraction slice per shared-memory round
constexpr int kThreads = 256;  // 16 x 16 threads, each an 8 x 8 output tile
constexpr int kTM = 8;         // rows per thread: ty + 16 * m
constexpr int kTN = 8;         // cols per thread: tx + 16 * c
constexpr int kPad = 4;        // spreads the k-major tile stores over banks
constexpr int kDwL = 8;        // l values per dw-partial pass

// C[z] (M x N, f32) = sum_{r in split} sum_k Aop_r(m, k) * Bop_r(k, n), where
// Aop_r(m, k) = A[zb*sAz + r*sAr + m*sAm + k*sAk] and
// Bop_r(k, n) = B[zb*sBz + r*sBr + k*sBk + n*sBn], for z = zb*S + zs and r in
// the zs-th of S contiguous parts of [0, R).
struct GemmArgs {
  int M, N, K, R, S;
  int64_t sAm, sAk, sAz, sAr;
  int64_t sBk, sBn, sBz, sBr;
  int64_t ldc, sCz;
};

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const TA* __restrict__ Ap, const TB* __restrict__ Bp,
            float* __restrict__ C, const GemmArgs g) {
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

  float* Cz = C + (int64_t)z * g.sCz;
#pragma unroll
  for (int m = 0; m < kTM; ++m) {
    const int gm = row0 + ty + 16 * m;
    if (gm >= g.M) continue;
#pragma unroll
    for (int c = 0; c < kTN; ++c) {
      const int gn = col0 + tx + 16 * c;
      if (gn < g.N) Cz[gm * g.ldc + gn] = acc[m][c];
    }
  }
}

// out[i] = sum_{s < S} part[s * n + i] in order, cast to TO.
template <typename TO>
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 TO* __restrict__ out, int S, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += part[s * n + i];
    out[i] = from_f32<TO>(acc);
  }
}

// dwp[c][gk][l] = sum_{j in chunk c} T[gk][j] * W[g][l][j], gk = g*L2 + k,
// j over the E*A*Bd axis. grid = (G*L2, n_chunks); block = kThreads.
template <typename TW>
__global__ void __launch_bounds__(kThreads)
dw_partial_kernel(const float* __restrict__ T, const TW* __restrict__ W,
                  float* __restrict__ dwp, int L2, int L1, int64_t K,
                  int64_t chunk) {
  __shared__ float red[kDwL][kThreads / 32];
  const int gk = blockIdx.x;
  const int64_t c = blockIdx.y;
  const int64_t g = gk / L2;
  const int64_t j0 = c * chunk;
  const int64_t j1 = (j0 + chunk < K) ? j0 + chunk : K;
  const float* Tr = T + (int64_t)gk * K;
  const TW* Wg = W + g * L1 * K;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  for (int l0 = 0; l0 < L1; l0 += kDwL) {
    float acc[kDwL];
#pragma unroll
    for (int li = 0; li < kDwL; ++li) acc[li] = 0.f;
    for (int64_t j = j0 + threadIdx.x; j < j1; j += kThreads) {
      const float t = Tr[j];
#pragma unroll
      for (int li = 0; li < kDwL; ++li) {
        if (l0 + li < L1) {
          acc[li] = fmaf(t, to_f32(Wg[(int64_t)(l0 + li) * K + j]), acc[li]);
        }
      }
    }
#pragma unroll
    for (int li = 0; li < kDwL; ++li) {
      float v = acc[li];
      for (int off = 16; off > 0; off /= 2) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) red[li][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < kDwL && l0 + threadIdx.x < L1) {
      float s = 0.f;
      for (int wi = 0; wi < kThreads / 32; ++wi) s += red[threadIdx.x][wi];
      dwp[(c * gridDim.x + gk) * L1 + l0 + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

unsigned grid_stride_blocks(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  return (unsigned)blocks;
}

template <typename T>
int launch(const float* w, const float* wT, const T* B, const T* W,
           const T* dP, float* blended, float* Tbuf, float* dBpart,
           float* dwpart, float* dw, T* dB, T* dW, int G, int L2, int L1,
           int E, int I, int A, int Bd, int splits, int64_t dw_chunk,
           cudaStream_t stream) {
  const int64_t slab = (int64_t)A * Bd;
  const int N = G * L2 * E;                  // (g, k, e) batch
  cudaError_t err;

  // 1. blended = w . W  (f32)
  err = launch_blend<T, float>(w, W, blended, G, L2, L1, E, slab, stream);
  if (err != cudaSuccess) return (int)err;

  // 2. T[n] (A x Bd) = B^T (A x I) @ dP[n] (I x Bd)
  GemmArgs gt;
  gt.M = A; gt.N = Bd; gt.K = I; gt.R = 1; gt.S = 1;
  gt.sAm = 1; gt.sAk = A; gt.sAz = 0; gt.sAr = 0;
  gt.sBk = Bd; gt.sBn = 1; gt.sBz = (int64_t)I * Bd; gt.sBr = 0;
  gt.ldc = Bd; gt.sCz = slab;
  const dim3 grid_t((Bd + kBN - 1) / kBN, (A + kBM - 1) / kBM, N);
  gemm_kernel<T, T><<<grid_t, kThreads, 0, stream>>>(B, dP, Tbuf, gt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 3. dB partials (I x A) = sum over the split's n of dP[n] (I x Bd) @
  //    blended[n]^T (Bd x A)
  GemmArgs gb;
  gb.M = I; gb.N = A; gb.K = Bd; gb.R = N; gb.S = splits;
  gb.sAm = Bd; gb.sAk = 1; gb.sAz = 0; gb.sAr = (int64_t)I * Bd;
  gb.sBk = 1; gb.sBn = Bd; gb.sBz = 0; gb.sBr = slab;
  gb.ldc = A; gb.sCz = (int64_t)I * A;
  const dim3 grid_b((A + kBN - 1) / kBN, (I + kBM - 1) / kBM, splits);
  gemm_kernel<T, float><<<grid_b, kThreads, 0, stream>>>(dP, blended, dBpart,
                                                          gb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 4. dB = sum of the partials
  const int64_t nB = (int64_t)I * A;
  sum_parts_kernel<T><<<grid_stride_blocks(nB), kThreads, 0, stream>>>(
      dBpart, dB, splits, nB);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 5. dW[g, l, e] = sum_k w[g, k, l] T[g, k, e]
  err = launch_blend<float, T>(wT, Tbuf, dW, G, L1, L2, E, slab, stream);
  if (err != cudaSuccess) return (int)err;

  // 6. dw partials over chunks of the E*A*Bd axis
  const int64_t K = (int64_t)E * slab;
  const unsigned n_chunks = (unsigned)((K + dw_chunk - 1) / dw_chunk);
  const dim3 grid_w(G * L2, n_chunks);
  dw_partial_kernel<T><<<grid_w, kThreads, 0, stream>>>(Tbuf, W, dwpart, L2,
                                                         L1, K, dw_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // 7. dw = sum of the chunk partials
  const int64_t nw = (int64_t)G * L2 * L1;
  sum_parts_kernel<float><<<grid_stride_blocks(nw), kThreads, 0, stream>>>(
      dwpart, dw, (int)n_chunks, nw);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (for B, W, dP, dB and dW). w and wT are
// (G, L2, L1) and (G, L1, L2) f32; dw is f32. Scratch, allocated by the
// caller: blended and Tbuf (G, L2, E, A, Bd) f32, dBpart (splits, I, A) f32,
// dwpart (ceil(E*A*Bd / dw_chunk), G*L2, L1) f32. Returns a cudaError_t.
int ligo_blend_expand_bwd(const void* w, const void* wT, const void* B,
                          const void* W, const void* dP, void* blended,
                          void* Tbuf, void* dBpart, void* dwpart, void* dw,
                          void* dB, void* dW, int G, int L2, int L1, int E,
                          int I, int A, int Bd, int splits,
                          long long dw_chunk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* wTf = static_cast<const float*>(wT);
  float* bl = static_cast<float*>(blended);
  float* Tb = static_cast<float*>(Tbuf);
  float* dBp = static_cast<float*>(dBpart);
  float* dwp = static_cast<float*>(dwpart);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    return launch<bf>(wf, wTf, static_cast<const bf*>(B),
                      static_cast<const bf*>(W), static_cast<const bf*>(dP),
                      bl, Tb, dBp, dwp, dwf, static_cast<bf*>(dB),
                      static_cast<bf*>(dW), G, L2, L1, E, I, A, Bd, splits,
                      dw_chunk, s);
  }
  return launch<float>(wf, wTf, static_cast<const float*>(B),
                       static_cast<const float*>(W),
                       static_cast<const float*>(dP), bl, Tb, dBp, dwp, dwf,
                       static_cast<float*>(dB), static_cast<float*>(dW), G,
                       L2, L1, E, I, A, Bd, splits, dw_chunk, s);
}

const char* ligo_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
