"""Kernel K1 on Hopper: fused LiGO depth-blend + left width-expansion.

``P[g, k, e] = B @ (Σ_l w[g, k, l] · W[g, l, e])`` — the hand-written CUDA
kernel in ``csrc/ligo_expand.cu``, in the order that needs the fewest
operations: ``U = B W`` over the L1 source layers as one batched GEMM into
an f32 scratch, then a blend ``P = w · U`` over the layer axis that reads U
once and rounds P once; the source says why and what bounds it. The GEMM
is the core K1 shares with K2 (``csrc/ligo_gemm.cuh``): a TMA + ``wgmma``
tensor-core GEMM for bf16 at widths that are multiples of 8
(:func:`tensor_core_route`), an f32 FMA GEMM otherwise. It replaces the
Pallas kernel ``repro/kernels/ligo_expand.py::ligo_blend_expand_grouped``.
The plain version is
:func:`repro_torch.kernels.ref.ligo_blend_expand_grouped_ref`.

``LAUNCHES`` counts the calls of this wrapper that launched the kernel: a
plain integer that callers reset and read (``chip_smoke.py`` shows with it
that the serving path went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _gemm
from repro_torch.kernels._gemm import tensor_core_route, tma_aligned

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("ligo_expand")
    fn = lib.ligo_blend_expand_grouped
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ligo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ligo_cuda_error_string.restype = ctypes.c_char_p
    return lib


def operation_count(G: int, L2: int, L1: int, E: int, I: int, A: int,
                    Bd: int) -> int:
    """The fewest operations K1's function needs: the lesser of
    blend-then-expand (the fused order, L2 expansions) and
    expand-then-blend (K1's own order: L1 expansions, then the blend in the
    large space). K1's bound and the measured-cost pass count this."""
    fused = 2 * G * E * L2 * (L1 * A * Bd + I * A * Bd)
    own = 2 * G * E * (L1 * I * A * Bd + L2 * L1 * I * Bd)
    return min(fused, own)


def ligo_blend_expand_grouped(w: torch.Tensor, B: torch.Tensor,
                              W: torch.Tensor) -> torch.Tensor:
    """w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).

    CUDA tensors only; B and W share one dtype (float32 or bfloat16), the
    output is in that dtype, and every sum accumulates in float32. Launches
    on the current stream and does not synchronise.
    """
    global LAUNCHES
    if not (W.is_cuda and B.device == W.device and w.device == W.device):
        raise ValueError(f"K1 needs w, B, W on one CUDA device; got "
                         f"{w.device}, {B.device}, {W.device}")
    if B.dtype not in _gemm.DTYPES or W.dtype != B.dtype:
        raise TypeError(f"K1 takes B and W in one of {list(_gemm.DTYPES)}; "
                        f"got B {B.dtype}, W {W.dtype}")
    if w.dim() != 3 or B.dim() != 2 or W.dim() != 5:
        raise ValueError(f"K1 shapes: w (G,L2,L1), B (I,A), W (G,L1,E,A,Bd); "
                         f"got {tuple(w.shape)}, {tuple(B.shape)}, "
                         f"{tuple(W.shape)}")
    G, L2, L1 = w.shape
    I, A = B.shape
    G2, L1b, E, A2, Bd = W.shape
    if (G2, L1b, A2) != (G, L1, A):
        raise ValueError(f"K1 shape mismatch: w {tuple(w.shape)}, "
                         f"B {tuple(B.shape)}, W {tuple(W.shape)}")
    if min(G, L2, L1, E, I, A, Bd) < 1:
        raise ValueError(f"K1 takes no empty dim: w {tuple(w.shape)}, "
                         f"B {tuple(B.shape)}, W {tuple(W.shape)}")
    # grids: the GEMM (Bd/128, I/128, G·L1·E), the transpose (Bd/64, A/64,
    # G·L1·E), the blend (I·Bd/256, G·E); the launcher itself refuses a
    # blend whose staged w would not fit in shared memory
    if (G * L1 * E > _gemm.MAX_GRID_YZ
            or -(-max(I, A) // 64) > _gemm.MAX_GRID_YZ):
        raise ValueError(f"K1 grid too large for G·L1·E={G * L1 * E}, "
                         f"I={I}, A={A}")
    if not (B.is_contiguous() and W.is_contiguous()):
        raise ValueError("K1 takes contiguous B and W")
    if w.requires_grad or B.requires_grad or W.requires_grad:
        raise NotImplementedError(
            "the raw K1 wrapper has no backward: differentiate through "
            "ops.ligo_blend_expand_grouped_vjp (K2 is its backward), or pass "
            "detached tensors")
    lib = _lib()
    dev = W.device
    w32 = w.to(torch.float32).contiguous()
    route = tensor_core_route(B.dtype, I, A, Bd)
    if route:  # TMA reads B, and the transpose W in pairs, as given
        B, W = tma_aligned(B), tma_aligned(W)
    # Wᵀ, the K-major operand of the tensor-core GEMM; the f32 U stack
    Wt = torch.empty((G, L1, E, Bd, A) if route else (0,), dtype=B.dtype,
                     device=dev)
    U = torch.empty((G, L1, E, I, Bd), dtype=torch.float32, device=dev)
    P = torch.empty((G, L2, E, I, Bd), dtype=B.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ligo_blend_expand_grouped(
            w32.data_ptr(), B.data_ptr(), W.data_ptr(), Wt.data_ptr(),
            U.data_ptr(), P.data_ptr(), G, L2, L1, E, I, A, Bd, int(route),
            _gemm.DTYPES[B.dtype], stream)
    if err != 0:
        msg = lib.ligo_cuda_error_string(err).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return P
