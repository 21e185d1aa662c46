"""Kernel K2 on Hopper: all three cotangents of the LiGO blend-expand.

Given ``P[g, k, e] = B @ (Σ_l w[g, k, l] · W[g, l, e])`` and its cotangent
``dP``, returns ``(dw, dB, dW)`` — the hand-written CUDA kernel in
``csrc/ligo_expand_bwd.cu``, in the order that needs the fewest operations:
a blend ``Q = wᵀ·dP`` over the target layers, then ``dW = BᵀQ``,
``dB = Σ Q Wᵀ`` (split over its contraction where the tile grid is small)
and ``U = B W``, and ``dw = Σ ⟨dP, U⟩`` by chunks; every sum in one fixed
order, no float atomics; the source says why and what bounds it. The three
products run on a TMA + ``wgmma`` tensor-core GEMM for bf16 at widths that
are multiples of 8 (:func:`tensor_core_route`), on an f32 FMA GEMM
otherwise: the GEMM core it shares with K1 (``csrc/ligo_gemm.cuh``). It
replaces the Pallas kernel ``repro/kernels/ligo_expand_bwd.py::
ligo_blend_expand_bwd_fused``. The plain version is
:func:`repro_torch.kernels.ref.ligo_blend_expand_bwd_ref`.

``LAUNCHES`` counts the calls of this wrapper that launched the kernel: a
plain integer that callers reset and read (``chip_smoke.py`` shows with it
that the LiGO phase went through the kernel).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build, _gemm
from repro_torch.kernels._gemm import tensor_core_route, tma_aligned

LAUNCHES = 0
_SMS = 132                 # H100 SXM; the dB split aims at two blocks per SM
_DW_SMEM = 48 * 1024       # bytes of U a dw-partial block stages


def _lib() -> ctypes.CDLL:
    lib = _build.load("ligo_expand_bwd")
    fn = lib.ligo_blend_expand_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ligo_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ligo_bwd_error_string.restype = ctypes.c_char_p
    return lib


def operation_count(G: int, L2: int, L1: int, E: int, I: int, A: int,
                    Bd: int) -> int:
    """The fewest operations K2's function needs: the lesser of the fused
    order (T over all L2 layers, dB against the blended slabs) and K2's own
    order, which blends dP over k first (three L1-batched products plus the
    blend and the dw contraction). K2's bound and the measured-cost pass
    count this."""
    fused = (2 * 2 * G * E * L2 * I * A * Bd
             + 3 * 2 * G * E * L2 * L1 * A * Bd)
    own = 3 * 2 * G * E * L1 * I * A * Bd + 2 * 2 * G * E * L2 * L1 * I * Bd
    return min(fused, own)


def db_splits(I: int, A: int, n: int) -> int:
    """Contiguous parts of the ``n = G·L1·E`` contraction that the dB GEMM
    runs as separate blocks: enough for ~2 blocks per SM when the (I, A)
    tile grid alone is smaller, never more than ``n``."""
    tiles = -(-I // _gemm.TILE) * -(-A // _gemm.TILE)
    return max(1, min(n, -(-2 * _SMS // tiles)))


def dw_chunk(L1: int) -> int:
    """Elements of the E·I·Bd axis per dw-partial block: the U rows of all
    L1 source layers over the chunk fill at most 48 KB of shared memory."""
    return max(32, min(1024, _DW_SMEM // (4 * L1) // 32 * 32))


def ligo_blend_expand_bwd(w: torch.Tensor, B: torch.Tensor, W: torch.Tensor,
                          dP: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd); dP: (G, L2, E, I, Bd)
    → (dw (G, L2, L1) float32, dB (I, A), dW (G, L1, E, A, Bd)).

    CUDA tensors only; B, W and dP share one dtype (float32 or bfloat16),
    dB and dW come in that dtype, and every sum accumulates in float32.
    Launches on the current stream and does not synchronise.
    """
    global LAUNCHES
    if not (W.is_cuda and B.device == W.device and w.device == W.device
            and dP.device == W.device):
        raise ValueError(f"K2 needs w, B, W, dP on one CUDA device; got "
                         f"{w.device}, {B.device}, {W.device}, {dP.device}")
    if (B.dtype not in _gemm.DTYPES or W.dtype != B.dtype
            or dP.dtype != B.dtype):
        raise TypeError(f"K2 takes B, W and dP in one of "
                        f"{list(_gemm.DTYPES)}; got "
                        f"B {B.dtype}, W {W.dtype}, dP {dP.dtype}")
    if w.dim() != 3 or B.dim() != 2 or W.dim() != 5 or dP.dim() != 5:
        raise ValueError(f"K2 shapes: w (G,L2,L1), B (I,A), W (G,L1,E,A,Bd), "
                         f"dP (G,L2,E,I,Bd); got {tuple(w.shape)}, "
                         f"{tuple(B.shape)}, {tuple(W.shape)}, "
                         f"{tuple(dP.shape)}")
    G, L2, L1 = w.shape
    I, A = B.shape
    G2, L1b, E, A2, Bd = W.shape
    if (G2, L1b, A2) != (G, L1, A) or tuple(dP.shape) != (G, L2, E, I, Bd):
        raise ValueError(f"K2 shape mismatch: w {tuple(w.shape)}, B "
                         f"{tuple(B.shape)}, W {tuple(W.shape)}, dP "
                         f"{tuple(dP.shape)}")
    if min(G, L2, L1, E, I, A, Bd) < 1:
        raise ValueError(f"K2 takes no empty dim: w {tuple(w.shape)}, "
                         f"B {tuple(B.shape)}, W {tuple(W.shape)}")
    if (G * L1 * E > _gemm.MAX_GRID_YZ or G > _gemm.MAX_GRID_YZ
            or 4 * L1 * dw_chunk(L1) > _DW_SMEM
            or -(-max(I, A) // _gemm.TILE) > _gemm.MAX_GRID_YZ):
        raise ValueError(f"K2 grid too large for G·L1·E={G * L1 * E}, "
                         f"L1={L1}, I={I}, A={A}")
    if not (B.is_contiguous() and W.is_contiguous() and dP.is_contiguous()):
        raise ValueError("K2 takes contiguous B, W and dP")
    lib = _lib()
    dev, f32 = W.device, torch.float32
    w32 = w.to(f32).contiguous()
    splits = db_splits(I, A, G * L1 * E)
    chunk = dw_chunk(L1)
    n_chunks = -(-(E * I * Bd) // chunk)
    route = tensor_core_route(B.dtype, I, A, Bd)
    if route:  # TMA reads B and W straight from the caller
        B, W = tma_aligned(B), tma_aligned(W)
    Q = torch.empty((G, L1, E, I, Bd), dtype=B.dtype, device=dev)
    U = torch.empty((G, L1, E, I, Bd), dtype=f32, device=dev)
    # the K-major operands of the tensor-core GEMM: Bᵀ, Qᵀ and Wᵀ
    Bt, Qt, Wt = (torch.empty(s if route else (0,), dtype=B.dtype, device=dev)
                  for s in ((A, I), (G, L1, E, Bd, I), (G, L1, E, Bd, A)))
    dBpart = torch.empty((splits if splits > 1 else 0, I, A), dtype=f32,
                         device=dev)
    dwpart = torch.empty((G, L2, L1, n_chunks), dtype=f32, device=dev)
    dw = torch.empty((G, L2, L1), dtype=f32, device=dev)
    dB = torch.empty((I, A), dtype=B.dtype, device=dev)
    dW = torch.empty((G, L1, E, A, Bd), dtype=W.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ligo_blend_expand_bwd(
            w32.data_ptr(), B.data_ptr(), W.data_ptr(), dP.data_ptr(),
            Q.data_ptr(), U.data_ptr(), Bt.data_ptr(), Qt.data_ptr(),
            Wt.data_ptr(), dBpart.data_ptr(), dwpart.data_ptr(),
            dw.data_ptr(), dB.data_ptr(), dW.data_ptr(), G, L2, L1, E, I, A,
            Bd, splits, chunk, int(route), _gemm.DTYPES[B.dtype], stream)
    if err != 0:
        msg = lib.ligo_bwd_error_string(err).decode()
        raise RuntimeError(f"K2 launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return dw, dB, dW
