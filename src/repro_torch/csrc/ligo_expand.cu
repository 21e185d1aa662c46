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
// port runs the function as launches on the caller's stream, in the order
// that needs the fewest operations: expand the L1 source layers, then blend
// in the large space.
//
//   1. U[g, l, e] = B W[g, l, e], an f32 (I, Bd) stack, one batched GEMM over
//      the Z = G*L1*E source slabs, on the GEMM cores of ligo_gemm.cuh (the
//      ones K2 uses): bf16 at widths that are multiples of 8 on the TMA +
//      wgmma GEMM, from X = B (K-major as it is) and Y = W^T (from
//      ligo_transpose_kernel); f32, or an unaligned width, on the f32 GEMM
//      on W's own strides, in the tile and split the caller picked
//      (kernels/_gemm.py::f32_gemm_plan). It is the launch K2 makes for its product U, with
//      the same arguments, so the two agree bit for bit (chip_smoke.py and
//      tests/test_torch_gpu.py check it): K2 takes this U from K1 instead of
//      computing it again.
//   2. k1_blend_kernel: P[g, k, e] = sum_l w[g, k, l] U[g, l, e] in f32, each
//      thread V consecutive elements of one (g, e) and the sums of up to
//      kBlendK target layers k in registers, so U is read once; the sum over
//      l runs in order, so the result is deterministic; P is rounded to its
//      dtype once.
//
// `stage` runs both steps (0), step 1 alone (1: U is the result) or step 2
// alone from the caller's U (2). The GrowthPlan runs the two apart where a
// group's right expansion goes between them (U -> U E^T -> blend), in the
// order that needs the fewest operations for mlp/w2.
//
// Why this order, always. Expanding first costs 2 G E (L1 I A Bd + L2 L1 I Bd)
// operations, blending first 2 G E L2 (L1 A Bd + I A Bd). On the LiGO paths
// (gpt2-base -> gpt2-medium: L2 = 24, L1 = 12, I >= A) expanding first needs
// about half: 353 GFLOP a grow against 700. The two come close only where
// L2 is about L1 (or I much smaller than A), which no LiGO hop of the repo
// has. In bf16 the order adds no rounding that the function's own
// definition lacks: the bf16 products are exact in f32, U and the blend stay
// in f32, and P is rounded once. In f32 only the order of the sums changes.
//
// What bounds it. A grow runs the kernel 6 times (wq, wk, wv, wo, mlp/w1,
// mlp/w2; 234 of the 353 GFLOP in mlp/w2: I 4096, A 3072, Bd 768): compute,
// a floor of ~0.36 ms at the H100 SXM's 989 TFLOP/s dense bf16, against
// ~0.66 GB that the function must move. This design moves more: the f32 U
// stack is written by the GEMM and read by the blend (~0.9 GB a grow with
// the P writes), and W^T is a transposed copy of W; a blend folded into the
// GEMM's epilogue would remove the U round trip.
//
// Plain C interface (built with nvcc into a shared library, loaded by ctypes):
// the launcher returns cudaGetLastError() (or a tensor-map encode failure)
// and never synchronises.

#include <type_traits>

#include "ligo_gemm.cuh"

namespace {

constexpr int kBlendK = 24;    // target layers k a thread sums at once
constexpr size_t kBlendSmem = 48 * 1024;  // staged w a blend block may hold

// P[g, k, e][r] = sum_l w[g, k, l] U[g, l, e][r], r over the I*Bd slab.
// grid = (ceil(slab / (V * kThreads)), G * E): a block serves one (g, e).
// It stages w[g] transposed in shared memory, wT[l * Lp + k] = w[g, k, l]
// with k padded with zeros to Lp, a multiple of kBlendK, so a thread reads
// the kBlendK weights of one l as float4 broadcasts. Each thread owns V
// consecutive r and keeps kBlendK x V f32 sums in registers. Two blocks an
// SM keep enough loads of U in flight: held to 128 registers (a few bytes
// spill) the blend moves 2.3 TB/s at the LiGO shapes, against 1.8 TB/s at
// its free 139 registers and one block an SM (H100 80GB HBM3, 700 W).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
k1_blend_kernel(const float* __restrict__ w, const float* __restrict__ U,
                T* __restrict__ P, int L2, int L1, int E, int64_t slab) {
  extern __shared__ float4 wT4[];
  float* wT = reinterpret_cast<float*>(wT4);
  const int Lp = (L2 + kBlendK - 1) / kBlendK * kBlendK;
  const int64_t n = blockIdx.y;              // g*E + e
  const int64_t g = n / E;
  const int64_t e = n - g * E;
  const float* wg = w + g * L2 * L1;
  for (int i = threadIdx.x; i < L1 * Lp; i += kThreads) {
    const int l = i / Lp;
    const int k = i - l * Lp;
    wT[i] = k < L2 ? wg[k * L1 + l] : 0.f;
  }
  __syncthreads();
  const int64_t r = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (r >= slab) return;
  const int64_t step = (int64_t)E * slab;    // layer to layer, in U and in P
  const float* src = U + (g * L1 * E + e) * slab + r;
  T* dst = P + (g * L2 * E + e) * slab + r;
  for (int k0 = 0; k0 < L2; k0 += kBlendK) {
    float acc[kBlendK][V];
#pragma unroll
    for (int kk = 0; kk < kBlendK; ++kk) {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[kk][v] = 0.f;
    }
#pragma unroll 2
    for (int l = 0; l < L1; ++l) {
      float x[V];
      load_v<V>(src + l * step, x);
      const float4* wl = wT4 + (l * Lp + k0) / 4;
#pragma unroll
      for (int j = 0; j < kBlendK / 4; ++j) {
        const float4 wv = wl[j];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[4 * j][v] = fmaf(wv.x, x[v], acc[4 * j][v]);
          acc[4 * j + 1][v] = fmaf(wv.y, x[v], acc[4 * j + 1][v]);
          acc[4 * j + 2][v] = fmaf(wv.z, x[v], acc[4 * j + 2][v]);
          acc[4 * j + 3][v] = fmaf(wv.w, x[v], acc[4 * j + 3][v]);
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlendK; ++kk) {
      if (k0 + kk < L2) store_v<V>(dst + (k0 + kk) * step, acc[kk]);
    }
  }
}

template <typename T>
int launch(const float* w, const T* B, const T* W, __nv_bfloat16* Wt,
           float* U, T* P, float* part, int G, int L2, int L1, int E, int I,
           int A, int Bd, int route, int stage, int tile, int split,
           cudaStream_t stream) {
  const int Z = G * L1 * E;                  // (g, l, e) batch
  const int64_t slab = (int64_t)I * Bd;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  if ((route != 0 && (route != 1 || !kBf16)) || stage < 0 || stage > 2) {
    return (int)cudaErrorNotSupported;
  }
  const bool expand = stage != 2;
  const bool blend = stage != 1;
  // the blend stages w[g] transposed, its k padded to Lp; refused before
  // anything launches where it would not fit
  const int Lp = (L2 + kBlendK - 1) / kBlendK * kBlendK;
  const size_t smem = (size_t)L1 * Lp * sizeof(float);
  if (blend && smem > kBlendSmem) return (int)cudaErrorInvalidValue;

  // 1. U[z] (I x Bd) = B (I x A) W[z] (A x Bd), f32: K2's product U
  if constexpr (kBf16) {
    if (expand && route == 1) {
      // both maps before the first launch: a map TMA cannot take returns
      // its error with nothing launched
      CUtensorMap mx, my;
      int e = make_map(&mx, B, A, I, 1);     // X = B
      if (e != 0) return e;
      e = make_map(&my, Wt, A, Bd, Z);       // Y = W^T
      if (e != 0) return e;
      const cudaError_t err = transpose(W, Wt, Z, A, Bd, stream);
      if (err != cudaSuccess) return (int)err;
      TcArgs gu;
      gu.M = I; gu.N = Bd; gu.K = A; gu.R = 1; gu.S = 1;
      gu.xz = 0; gu.xr = 0; gu.yz = 1; gu.yr = 0;
      gu.ldc = Bd; gu.sCz = slab;
      e = tc_gemm<kProdK1U>(mx, my, U, gu, Z, stream);
      if (e != 0) return e;
    }
  }
  if (expand && route == 0) {
    GemmArgs gu;
    gu.M = I; gu.N = Bd; gu.K = A; gu.R = 1; gu.S = split;
    gu.sAm = A; gu.sAk = 1; gu.sAz = 0; gu.sAr = 0;
    gu.sBk = Bd; gu.sBn = 1; gu.sBz = (int64_t)A * Bd; gu.sBr = 0;
    gu.ldc = Bd; gu.sCz = slab;
    const cudaError_t err = f32_gemm<kProdK1U, true, false>(
        B, W, U, part, gu, Z, tile, stream);
    if (err != cudaSuccess) return (int)err;
  }

  // 2. P = w . U over the layer axis l; 4-wide where the rows allow it
  if (!blend) return (int)cudaGetLastError();
  if (aligned4(U) && aligned4(P) && slab % 4 == 0) {
    const dim3 grid((unsigned)((slab / 4 + kThreads - 1) / kThreads), G * E);
    k1_blend_kernel<T, 4><<<grid, kThreads, smem, stream>>>(w, U, P, L2, L1,
                                                            E, slab);
  } else {
    const dim3 grid((unsigned)((slab + kThreads - 1) / kThreads), G * E);
    k1_blend_kernel<T, 1><<<grid, kThreads, smem, stream>>>(w, U, P, L2, L1,
                                                            E, slab);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (for B, W and P). w is (G, L2, L1) f32.
// route: 0 runs U = B W on the f32 GEMM in tile `tile` and `split` parts
// (kernels/_gemm.py::f32_gemm_plan), 1 on the tensor-core GEMM (bf16
// only; the caller has checked that I, A and Bd are multiples of 8 and put B
// and W on 16-byte boundaries). stage: 0 both steps, 1 U only (w and P
// unused), 2 the blend only, from the caller's U (B, W and Wt unused).
// Allocated by the caller: on route 1 Wt (G, L1, E, Bd, A) bf16 scratch;
// on route 0 with split > 1 part (split, G, L1, E, I, Bd) f32 scratch;
// U (G, L1, E, I, Bd) f32, which holds B W when the call returns. Returns 0, a
// cudaError_t (cudaErrorInvalidValue, with nothing launched, where the
// blend's staged w, L1 * ceil(L2 / 24) * 24 * 4 bytes, exceeds 48 KB), or a
// value >= kErrTensorMap - 1 for a failed tensor-map encode.
int ligo_blend_expand_grouped(const void* w, const void* B, const void* W,
                              void* Wt, void* U, void* P, void* part, int G,
                              int L2, int L1, int E, int I, int A, int Bd,
                              int route, int stage, int tile, int split,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(part);
  if (dtype == 1) {
    return launch<__nv_bfloat16>(
        static_cast<const float*>(w), static_cast<const __nv_bfloat16*>(B),
        static_cast<const __nv_bfloat16*>(W),
        static_cast<__nv_bfloat16*>(Wt), static_cast<float*>(U),
        static_cast<__nv_bfloat16*>(P), pt, G, L2, L1, E, I, A, Bd, route,
        stage, tile, split, s);
  }
  return launch<float>(static_cast<const float*>(w),
                       static_cast<const float*>(B),
                       static_cast<const float*>(W),
                       static_cast<__nv_bfloat16*>(Wt),
                       static_cast<float*>(U), static_cast<float*>(P), pt, G,
                       L2, L1, E, I, A, Bd, route, stage, tile, split, s);
}

const char* ligo_cuda_error_string(int err) { return error_text(err); }

}  // extern "C"
