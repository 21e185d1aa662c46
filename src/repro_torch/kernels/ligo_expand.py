"""Kernel K1 on Hopper: fused LiGO depth-blend + left width-expansion.

``P[g, k, e] = B @ (Σ_l w[g, k, l] · W[g, l, e])`` — the hand-written CUDA
kernel in ``csrc/ligo_expand.cu`` (a blend pass into an f32 small-space
scratch, then a batched tiled GEMM; the source says why and what bounds it).
It replaces the Pallas kernel ``repro/kernels/ligo_expand.py::
ligo_blend_expand_grouped``. The plain version is
:func:`repro_torch.kernels.ref.ligo_blend_expand_grouped_ref`.

``LAUNCHES`` counts the launches of this wrapper: it is a plain integer that
callers reset and read (``chip_smoke.py`` shows with it that the serving path
went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535


def _lib() -> ctypes.CDLL:
    lib = _build.load("ligo_expand")
    fn = lib.ligo_blend_expand_grouped
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ligo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ligo_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    if B.dtype not in _DTYPES or W.dtype != B.dtype:
        raise TypeError(f"K1 takes B and W in one of {list(_DTYPES)}; got "
                        f"B {B.dtype}, W {W.dtype}")
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
    if G * L2 * E > _MAX_GRID_YZ or -(-I // 128) > _MAX_GRID_YZ:
        raise ValueError(f"K1 grid too large for G·L2·E={G * L2 * E}, I={I}")
    if not (B.is_contiguous() and W.is_contiguous()):
        raise ValueError("K1 takes contiguous B and W")
    if w.requires_grad or B.requires_grad or W.requires_grad:
        raise NotImplementedError(
            "the raw K1 wrapper has no backward: differentiate through "
            "ops.ligo_blend_expand_grouped_vjp (K2 is its backward), or pass "
            "detached tensors")
    lib = _lib()
    w32 = w.to(torch.float32).contiguous()
    blended = torch.empty((G, L2, E, A, Bd), dtype=torch.float32,
                          device=W.device)
    P = torch.empty((G, L2, E, I, Bd), dtype=B.dtype, device=W.device)
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ligo_blend_expand_grouped(
            w32.data_ptr(), B.data_ptr(), W.data_ptr(), blended.data_ptr(),
            P.data_ptr(), G, L2, L1, E, I, A, Bd, _DTYPES[B.dtype], stream)
    if err != 0:
        msg = lib.ligo_cuda_error_string(err).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return P
