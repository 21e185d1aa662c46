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
// `flags` says which of these a call runs, so that it does only the work the
// caller's autograd needs: kUGiven takes U from the caller (kernel K1 has
// just computed it, with the same GEMM and arguments: bit for bit this U)
// instead of product U; kQGiven takes Q from the caller instead of the dP
// blend; kNeedDw, kNeedDB and kNeedDWt ask for dw, dB and dW. The GrowthPlan
// asks for dW only where W takes a gradient, and runs the K2 of a group whose
// right expansion sits between K1's U and its blend in two calls: the dP
// blend and dw (against the expanded U), then, after the expansion's own
// backward, dB from the narrow Q.
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
//      partial that ligo_sum_parts_kernel reduces in order (the f32 GEMM
//      splits any of the three products so, by its own plan);
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
// the dw sum when it ran on the dB sum's kernel) and a block an output
// keeps it busy.
//
// The GEMM cores (ligo_gemm.cuh, shared with K1). bf16 calls whose I, A
// and Bd are multiples of 8 (TMA's 16-byte stride rule) run
// ligo_wgmma_gemm_kernel: C[z] = sum_r X_r Y_r^T with both operands K-major,
// one block per 128 x 128 output tile, a producer warp keeping a 4-stage
// ring of 64-deep X and Y tiles filled by TMA (3-D tensor maps (K, rows,
// batch), 128-byte swizzle, zero fill at the ragged K, M and N edges), two
// consumer warpgroups issuing wgmma.m64n128k16 (bf16 in, f32 accumulate)
// from shared-memory descriptors, a masked epilogue. dB's operands Q and W
// are K-major as they are; ligo_transpose_kernel supplies B^T, Q^T and W^T
// for dW and U. Every other call (f32, whose tolerance tensor cores cannot
// hold, or an unaligned width) runs ligo_f32_gemm_kernel: an f32 FMA GEMM on
// any strides through a cp.async ring, in the tile and split that
// kernels/_gemm.py::f32_gemm_plan picks for each product's shape
// (ligo_gemm.cuh says why).
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

#include <type_traits>

#include "ligo_gemm.cuh"

namespace {

constexpr int kUGiven = 1;     // flags: U is the caller's, no product U
constexpr int kQGiven = 2;     //        Q is the caller's, no dP blend
constexpr int kNeedDw = 4;     //        dw (needs dP and U)
constexpr int kNeedDB = 8;     //        dB
constexpr int kNeedDWt = 16;   //        dW

constexpr int kBlendL = 12;    // l values per pass of the dP blend
constexpr int kDwL = 12;       // l values per pass of the dw partials
constexpr int kDwK = 3;        // k values per warp pass of the dw partials

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
  float* part;      // split partials: dB's (splits, I, A) on route 1, the
                    // f32 GEMM's (S, Z, M, N) of a split product on route 0
  float* dwpart;    // (G, L2, L1, n_chunks) f32
  float* dw;        // (G, L2, L1) f32
  T* dB;            // (I, A)
  T* dW;            // (G, L1, E, A, Bd)
};

// The f32 GEMM's tile and split of each product (kernels/_gemm.py::
// f32_gemm_plan); dB's split is the launcher's `splits`.
struct F32Plans {
  int tile_dw, split_dw, tile_db, tile_u, split_u;
};

// Products 2-4 on the f32 GEMM; Z = G*L1*E.
template <typename T>
cudaError_t products_f32(const Bufs<T>& b, int Z, int I, int A, int Bd,
                         int splits, const F32Plans& p, int flags, bool u,
                         cudaStream_t stream) {
  const int64_t sQ = (int64_t)I * Bd;
  const int64_t sW = (int64_t)A * Bd;
  cudaError_t err;

  // dW[z] (A x Bd) = B^T (A x I) @ Q[z] (I x Bd)
  if (flags & kNeedDWt) {
    GemmArgs gw;
    gw.M = A; gw.N = Bd; gw.K = I; gw.R = 1; gw.S = p.split_dw;
    gw.sAm = 1; gw.sAk = A; gw.sAz = 0; gw.sAr = 0;
    gw.sBk = Bd; gw.sBn = 1; gw.sBz = sQ; gw.sBr = 0;
    gw.ldc = Bd; gw.sCz = sW;
    err = f32_gemm<kProdDW, false, false>(b.B, b.Q, b.dW, b.part, gw, Z,
                                          p.tile_dw, stream);
    if (err != cudaSuccess) return err;
  }

  // dB (I x A) = sum_r Q[r] (I x Bd) @ W[r]^T (Bd x A), r over the split
  if (flags & kNeedDB) {
    GemmArgs gb;
    gb.M = I; gb.N = A; gb.K = Bd; gb.R = Z; gb.S = splits;
    gb.sAm = Bd; gb.sAk = 1; gb.sAz = 0; gb.sAr = sQ;
    gb.sBk = 1; gb.sBn = Bd; gb.sBz = 0; gb.sBr = sW;
    gb.ldc = A; gb.sCz = (int64_t)I * A;
    err = f32_gemm<kProdDB, true, true>(b.Q, b.W, b.dB, b.part, gb, 1,
                                        p.tile_db, stream);
    if (err != cudaSuccess) return err;
  }
  if (!u) return cudaSuccess;

  // U[z] (I x Bd) = B (I x A) @ W[z] (A x Bd), f32
  GemmArgs gu;
  gu.M = I; gu.N = Bd; gu.K = A; gu.R = 1; gu.S = p.split_u;
  gu.sAm = A; gu.sAk = 1; gu.sAz = 0; gu.sAr = 0;
  gu.sBk = Bd; gu.sBn = 1; gu.sBz = sW; gu.sBr = 0;
  gu.ldc = Bd; gu.sCz = sQ;
  return f32_gemm<kProdU, true, false>(b.B, b.W, b.U, b.part, gu, Z,
                                       p.tile_u, stream);
}

// The tensor maps of products 2-4 on the tensor cores that a call runs, X
// and Y of dW, dB and U in turn. launch() encodes them before its first
// kernel, so a map that TMA cannot take returns its error with nothing
// launched.
int tc_maps(const Bufs<__nv_bfloat16>& b, int Z, int I, int A, int Bd,
            int flags, bool u, CUtensorMap* m) {
  int e = 0;
  if (flags & kNeedDWt) {
    if ((e = make_map(&m[0], b.Bt, I, A, 1)) != 0) return e;  // dW: X = B^T
    if ((e = make_map(&m[1], b.Qt, I, Bd, Z)) != 0) return e; //     Y = Q^T
  }
  if (flags & kNeedDB) {
    if ((e = make_map(&m[2], b.Q, Bd, I, Z)) != 0) return e;  // dB: X = Q
    if ((e = make_map(&m[3], b.W, Bd, A, Z)) != 0) return e;  //     Y = W
  }
  if (u) {
    if ((e = make_map(&m[4], b.B, A, I, 1)) != 0) return e;   // U:  X = B
    return make_map(&m[5], b.Wt, A, Bd, Z);                   //     Y = W^T
  }
  return 0;
}

// Products 2-4 on the tensor cores (bf16 only), from K-major operands.
int products_tc(const Bufs<__nv_bfloat16>& b, const CUtensorMap* m, int Z,
                int I, int A, int Bd, int splits, int flags, bool u,
                cudaStream_t stream) {
  int e = 0;
  cudaError_t err;
  if (flags & kNeedDWt) {
    err = transpose(b.B, b.Bt, 1, I, A, stream);
    if (err != cudaSuccess) return (int)err;
    err = transpose(b.Q, b.Qt, Z, I, Bd, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (u) {
    err = transpose(b.W, b.Wt, Z, A, Bd, stream);
    if (err != cudaSuccess) return (int)err;
  }

  // dW[z] (A x Bd) = B^T (A x I) . (Q[z]^T (Bd x I))^T
  if (flags & kNeedDWt) {
    TcArgs gw;
    gw.M = A; gw.N = Bd; gw.K = I; gw.R = 1; gw.S = 1;
    gw.xz = 0; gw.xr = 0; gw.yz = 1; gw.yr = 0;
    gw.ldc = Bd; gw.sCz = (int64_t)A * Bd;
    e = tc_gemm<kProdDW>(m[0], m[1], b.dW, gw, Z, stream);
    if (e != 0) return e;
  }

  // dB (I x A) = sum_r Q[r] (I x Bd) . W[r] (A x Bd)^T, r over the split
  if (flags & kNeedDB) {
    TcArgs gb;
    gb.M = I; gb.N = A; gb.K = Bd; gb.R = Z; gb.S = splits;
    gb.xz = 0; gb.xr = 1; gb.yz = 0; gb.yr = 1;
    gb.ldc = A; gb.sCz = (int64_t)I * A;
    e = splits == 1 ? tc_gemm<kProdDB>(m[2], m[3], b.dB, gb, 1, stream)
                    : tc_gemm<kProdDB>(m[2], m[3], b.part, gb, 1, stream);
    if (e != 0) return e;
  }
  if (!u) return 0;

  // U[z] (I x Bd) = B (I x A) . (W[z]^T (Bd x A))^T, f32
  TcArgs gu;
  gu.M = I; gu.N = Bd; gu.K = A; gu.R = 1; gu.S = 1;
  gu.xz = 0; gu.xr = 0; gu.yz = 1; gu.yr = 0;
  gu.ldc = Bd; gu.sCz = (int64_t)I * Bd;
  return tc_gemm<kProdU>(m[4], m[5], b.U, gu, Z, stream);
}

template <typename T>
int launch(const Bufs<T>& b, int G, int L2, int L1, int E, int I, int A,
           int Bd, int splits, const F32Plans& plans, int dw_chunk,
           int route, int flags, cudaStream_t stream) {
  const int64_t sQ = (int64_t)I * Bd;
  const int Z = G * L1 * E;                  // (g, l, e) batch
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if ((route != 0 && (route != 1 || !kBf16)) || flags < 0 || flags > 31) {
    return (int)cudaErrorNotSupported;
  }
  const bool u = (flags & kNeedDw) && !(flags & kUGiven);   // product U
  const bool products = u || (flags & (kNeedDB | kNeedDWt));
  CUtensorMap maps[6];
  if constexpr (kBf16) {
    if (route == 1 && products) {
      const int e = tc_maps(b, Z, I, A, Bd, flags, u, maps);
      if (e != 0) return e;
    }
  }
  cudaError_t err;

  // 1. Q = w^T . dP, over the layer axis k; 4-wide where rows allow it
  const bool vec = aligned4(b.dP) && sQ % 4 == 0;
  if (!(flags & kQGiven)) {
    const int64_t nq = (int64_t)G * E * sQ / (vec ? 4 : 1);
    if (vec) {
      k2_blend_dp_kernel<T, 4><<<grid_stride_blocks(nq), kThreads, 0,
                                 stream>>>(b.w, b.dP, b.Q, L2, L1, E, sQ, nq);
    } else {
      k2_blend_dp_kernel<T, 1><<<grid_stride_blocks(nq), kThreads, 0,
                                 stream>>>(b.w, b.dP, b.Q, L2, L1, E, sQ, nq);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 2-4. dW, dB (or its partials), U: those the flags ask for
  int ep = 0;
  if constexpr (kBf16) {
    if (route == 1 && products) {
      ep = products_tc(b, maps, Z, I, A, Bd, splits, flags, u, stream);
    }
  }
  if (route == 0 && products) {
    ep = (int)products_f32<T>(b, Z, I, A, Bd, splits, plans, flags, u,
                              stream);
  }
  if (ep != 0) return ep;

  // dB = sum of the tensor-core GEMM's partials (the f32 GEMM sums its own)
  if (route == 1 && (flags & kNeedDB) && splits > 1) {
    const int64_t nB = (int64_t)I * A;
    ligo_sum_parts_kernel<T><<<grid_stride_blocks(nB), kThreads, 0,
                               stream>>>(b.part, b.dB, splits, nB);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // 5. dw partials over chunks of the E*I*Bd axis, then their sum in order
  if (!(flags & kNeedDw)) return (int)cudaGetLastError();
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
                 void* Q, void* U, void* Bt, void* Qt, void* Wt, void* part,
                 void* dwpart, void* dw, void* dB, void* dW, int G, int L2,
                 int L1, int E, int I, int A, int Bd, int splits,
                 const F32Plans& plans, int dw_chunk, int route, int flags,
                 cudaStream_t stream) {
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
  b.part = static_cast<float*>(part);
  b.dwpart = static_cast<float*>(dwpart);
  b.dw = static_cast<float*>(dw);
  b.dB = static_cast<T*>(dB);
  b.dW = static_cast<T*>(dW);
  return launch<T>(b, G, L2, L1, E, I, A, Bd, splits, plans, dw_chunk, route,
                   flags, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (for B, W, dP, Q, dB and dW). w is
// (G, L2, L1) f32; dw is f32. route: 0 runs products 2-4 on the f32 GEMM,
// each in the tile and split of its plan (tile_dw, split_dw; tile_db with
// `splits`; tile_u, split_u: kernels/_gemm.py::f32_gemm_plan), 1 on the
// tensor-core GEMM (bf16 only; the caller has checked that I, A and Bd are
// multiples of 8 and put B, W and a given Q on 16-byte boundaries), dB in
// `splits` parts. flags: kUGiven, kQGiven, kNeedDw, kNeedDB, kNeedDWt
// above; an operand or result that the flags leave unused may be null.
// Allocated by the caller: Q (G, L1, E, I, Bd) in the dtype (written, or
// read with kQGiven), U (G, L1, E, I, Bd) f32 (written, or read with
// kUGiven), on route 1 Bt (A, I), Qt (G, L1, E, Bd, I) and Wt
// (G, L1, E, Bd, A) bf16, part f32 scratch for the split partials (route
// 1: (splits, I, A); route 0: the largest (S, output) of a product it
// runs split; unused where nothing splits), dwpart
// (G, L2, L1, ceil(E*I*Bd / dw_chunk)) f32; dw_chunk a multiple of 32.
// Returns 0, a cudaError_t, or a value >= kErrTensorMap - 1 for a failed
// tensor-map encode.
int ligo_blend_expand_bwd(const void* w, const void* B, const void* W,
                          const void* dP, void* Q, void* U, void* Bt,
                          void* Qt, void* Wt, void* part, void* dwpart,
                          void* dw, void* dB, void* dW, int G, int L2,
                          int L1, int E, int I, int A, int Bd, int splits,
                          int tile_dw, int split_dw, int tile_db, int tile_u,
                          int split_u, int dw_chunk, int route, int flags,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const F32Plans plans = {tile_dw, split_dw, tile_db, tile_u, split_u};
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(w, B, W, dP, Q, U, Bt, Qt, Wt, part,
                                       dwpart, dw, dB, dW, G, L2, L1, E, I,
                                       A, Bd, splits, plans, dw_chunk, route,
                                       flags, s);
  }
  return launch_typed<float>(w, B, W, dP, Q, U, Bt, Qt, Wt, part, dwpart,
                             dw, dB, dW, G, L2, L1, E, I, A, Bd, splits,
                             plans, dw_chunk, route, flags, s);
}

const char* ligo_bwd_error_string(int err) { return error_text(err); }

}  // extern "C"
