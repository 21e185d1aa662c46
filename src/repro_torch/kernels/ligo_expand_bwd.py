"""Kernel K2 on Hopper: all three cotangents of the LiGO blend-expand.

Given ``P[g, k, e] = B @ (Σ_l w[g, k, l] · W[g, l, e])`` and its cotangent
``dP``, returns ``(dw, dB, dW)`` — the hand-written CUDA kernel in
``csrc/ligo_expand_bwd.cu`` (a blend pass, a batched ``T = Bᵀ dP`` GEMM, a
``dB`` GEMM split over the contraction where the tile grid is small, a blend
of ``T`` for ``dW`` and a chunked reduction for ``dw``; every sum in one fixed
order, no float atomics; the source says why and what bounds it). It
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

from repro_torch.kernels import _build

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_SMS = 132                 # H100 SXM; the dB split aims at two blocks per SM
_TILE = 128                # output tile edge of the GEMM kernel
DW_CHUNK = 8192            # elements of the E·A·Bd axis per dw-partial block


def _lib() -> ctypes.CDLL:
    lib = _build.load("ligo_expand_bwd")
    fn = lib.ligo_blend_expand_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ligo_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ligo_bwd_error_string.restype = ctypes.c_char_p
    return lib


def db_splits(I: int, A: int, n: int) -> int:
    """Contiguous parts of the ``n = G·L2·E`` contraction that the dB GEMM
    runs as separate blocks: enough for ~2 blocks per SM when the (I, A)
    tile grid alone is smaller, never more than ``n``."""
    tiles = -(-I // _TILE) * -(-A // _TILE)
    return max(1, min(n, -(-2 * _SMS // tiles)))


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
    if B.dtype not in _DTYPES or W.dtype != B.dtype or dP.dtype != B.dtype:
        raise TypeError(f"K2 takes B, W and dP in one of {list(_DTYPES)}; got "
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
    n_chunks = -(-(E * A * Bd) // DW_CHUNK)
    if (G * L2 * E > _MAX_GRID_YZ or n_chunks > _MAX_GRID_YZ
            or -(-max(I, A) // _TILE) > _MAX_GRID_YZ):
        raise ValueError(f"K2 grid too large for G·L2·E={G * L2 * E}, "
                         f"I={I}, A={A}, E·A·Bd={E * A * Bd}")
    if not (B.is_contiguous() and W.is_contiguous() and dP.is_contiguous()):
        raise ValueError("K2 takes contiguous B, W and dP")
    lib = _lib()
    dev, f32 = W.device, torch.float32
    w32 = w.to(f32).contiguous()
    wT = w32.transpose(1, 2).contiguous()
    splits = db_splits(I, A, G * L2 * E)
    blended = torch.empty((G, L2, E, A, Bd), dtype=f32, device=dev)
    T = torch.empty((G, L2, E, A, Bd), dtype=f32, device=dev)
    dBpart = torch.empty((splits, I, A), dtype=f32, device=dev)
    dwpart = torch.empty((n_chunks, G * L2, L1), dtype=f32, device=dev)
    dw = torch.empty((G, L2, L1), dtype=f32, device=dev)
    dB = torch.empty((I, A), dtype=B.dtype, device=dev)
    dW = torch.empty((G, L1, E, A, Bd), dtype=W.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ligo_blend_expand_bwd(
            w32.data_ptr(), wT.data_ptr(), B.data_ptr(), W.data_ptr(),
            dP.data_ptr(), blended.data_ptr(), T.data_ptr(),
            dBpart.data_ptr(), dwpart.data_ptr(), dw.data_ptr(),
            dB.data_ptr(), dW.data_ptr(), G, L2, L1, E, I, A, Bd, splits,
            DW_CHUNK, _DTYPES[B.dtype], stream)
    if err != 0:
        msg = lib.ligo_bwd_error_string(err).decode()
        raise RuntimeError(f"K2 launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return dw, dB, dW
