"""Kernel K1 on Hopper: fused LiGO depth-blend + left width-expansion.

``P[g, k, e] = B @ (Σ_l w[g, k, l] · W[g, l, e])`` — the hand-written CUDA
kernel in ``csrc/ligo_expand.cu``, in the order that needs the fewest
operations: ``U = B W`` over the L1 source layers as one batched GEMM into
an f32 scratch, then a blend ``P = w · U`` over the layer axis that reads U
once and rounds P once; the source says why and what bounds it. The GEMM
is the core K1 shares with K2 (``csrc/ligo_gemm.cuh``): a TMA + ``wgmma``
tensor-core GEMM for bf16 at widths that are multiples of 8
(:func:`tensor_core_route`), otherwise an f32 FMA GEMM through a
``cp.async`` ring in the tile and split :func:`f32_gemm_plan` picks for
the shape. It replaces the
Pallas kernel ``repro/kernels/ligo_expand.py::ligo_blend_expand_grouped``.
The plain version is
:func:`repro_torch.kernels.ref.ligo_blend_expand_grouped_ref`.

The two steps also run apart: :func:`ligo_expand` (U alone) and
:func:`ligo_blend` (the blend of a given U), for a group whose right
expansion the GrowthPlan puts between them. ``keep_u=True`` hands back the
U that the GEMM wrote, which kernel K2 then takes instead of computing it.

``LAUNCHES`` counts the calls of this wrapper that launched the kernel: a
plain integer that callers reset and read (``chip_smoke.py`` shows with it
that the serving path went through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _gemm
from repro_torch.kernels._gemm import (f32_gemm_plan, tensor_core_route,
                                       tma_aligned)

LAUNCHES = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("ligo_expand")
    fn = lib.ligo_blend_expand_grouped
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ligo_cuda_error_string.argtypes = [ctypes.c_int]
        lib.ligo_cuda_error_string.restype = ctypes.c_char_p
    return lib


_STAGES = {"both": 0, "expand": 1, "blend": 2}


def operation_count(G: int, L2: int, L1: int, E: int, I: int, A: int,
                    Bd: int, stage: str = "both") -> int:
    """The operations K1 runs: its U product (``stage="expand"``), its blend
    (``"blend"``) or both, in its own order. The measured-cost pass counts
    this."""
    expand = 2 * G * E * L1 * I * A * Bd
    blend = 2 * G * E * L2 * L1 * I * Bd
    return {"both": expand + blend, "expand": expand, "blend": blend}[stage]


def least_operations(G: int, L2: int, L1: int, E: int, I: int, A: int,
                     Bd: int) -> int:
    """The fewest operations K1's function needs: the lesser of
    blend-then-expand (the fused order, L2 expansions) and
    expand-then-blend (K1's own order: L1 expansions, then the blend in the
    large space). K1's bound counts this."""
    fused = 2 * G * E * L2 * (L1 * A * Bd + I * A * Bd)
    return min(fused, operation_count(G, L2, L1, E, I, A, Bd))


def _check(w, B, W, U):
    """Devices, dtypes and shapes of a call; returns (G, L2, L1, E, I, A,
    Bd), with 1 for the dims of an operand the call does not take."""
    given = [x for x in (w, B, W, U) if x is not None]
    dev = given[0].device
    if not all(x.is_cuda and x.device == dev for x in given):
        raise ValueError(f"K1 needs its operands on one CUDA device; got "
                         f"{[str(x.device) for x in given]}")
    if B is not None and (B.dtype not in _gemm.DTYPES or W.dtype != B.dtype):
        raise TypeError(f"K1 takes B and W in one of {list(_gemm.DTYPES)}; "
                        f"got B {B.dtype}, W {W.dtype}")
    if U is not None and U.dtype != torch.float32:
        raise TypeError(f"K1's blend takes a float32 U; got {U.dtype}")
    if ((w is not None and w.dim() != 3) or (B is not None and B.dim() != 2)
            or (W is not None and W.dim() != 5)
            or (U is not None and U.dim() != 5)):
        raise ValueError(f"K1 shapes: w (G,L2,L1), B (I,A), W (G,L1,E,A,Bd), "
                         f"U (G,L1,E,I,Bd); got "
                         f"{[tuple(x.shape) for x in given]}")
    if W is not None:
        G, L1, E, A, Bd = W.shape
        I = B.shape[0]
        ok = B.shape[1] == A
    else:
        G, L1, E, I, Bd = U.shape
        A, ok = 1, True
    L2 = w.shape[1] if w is not None else 1
    if w is not None:
        ok = ok and (w.shape[0], w.shape[2]) == (G, L1)
    if U is not None and W is not None:
        ok = ok and tuple(U.shape) == (G, L1, E, I, Bd)
    if not ok:
        raise ValueError(f"K1 shape mismatch: "
                         f"{[tuple(x.shape) for x in given]}")
    if min(G, L2, L1, E, I, A, Bd) < 1:
        raise ValueError(f"K1 takes no empty dim: "
                         f"{[tuple(x.shape) for x in given]}")
    # grids: the GEMM (Bd/128, I/128, G·L1·E), the transpose (Bd/64, A/64,
    # G·L1·E), the blend (I·Bd/256, G·E); the launcher itself refuses a
    # blend whose staged w would not fit in shared memory
    if (G * L1 * E > _gemm.MAX_GRID_YZ
            or -(-max(I, A) // 64) > _gemm.MAX_GRID_YZ):
        raise ValueError(f"K1 grid too large for G·L1·E={G * L1 * E}, "
                         f"I={I}, A={A}")
    if not all(x.is_contiguous() for x in (B, W, U) if x is not None):
        raise ValueError("K1 takes contiguous B, W and U")
    if any(x.requires_grad for x in given):
        raise NotImplementedError(
            "the raw K1 wrapper has no backward: differentiate through "
            "ops.ligo_blend_expand_grouped_vjp (K2 is its backward), or pass "
            "detached tensors")
    return G, L2, L1, E, I, A, Bd


def _launch(stage: str, w, B, W, U, dtype):
    """One launch of K1: ``stage`` "both" or "expand" computes U from B and
    W into a new f32 tensor, "blend" takes the caller's; returns (P, U)
    (P None for "expand")."""
    global LAUNCHES
    G, L2, L1, E, I, A, Bd = _check(w, B, W, U)
    lib = _lib()
    dev = (W if W is not None else U).device
    null = torch.empty((0,), device=dev)
    w32 = w.to(torch.float32).contiguous() if w is not None else null
    route = B is not None and tensor_core_route(B.dtype, I, A, Bd)
    if route:  # TMA reads B, and the transpose W in pairs, as given
        B, W = tma_aligned(B), tma_aligned(W)
    # Wᵀ, the K-major operand of the tensor-core GEMM; the f32 GEMM's plan
    # and its split partials; the f32 U stack
    Wt = torch.empty((G, L1, E, Bd, A) if route else (0,), dtype=dtype,
                     device=dev)
    plan = f32_gemm_plan(I, Bd, A, 1, G * L1 * E)
    part = (torch.empty((plan.split, G * L1 * E * I * Bd),
                        dtype=torch.float32, device=dev)
            if stage != "blend" and not route and plan.split > 1 else null)
    if U is None:
        U = torch.empty((G, L1, E, I, Bd), dtype=torch.float32, device=dev)
    P = (torch.empty((G, L2, E, I, Bd), dtype=dtype, device=dev)
         if stage != "expand" else null)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ligo_blend_expand_grouped(
            w32.data_ptr(), (B if B is not None else null).data_ptr(),
            (W if W is not None else null).data_ptr(), Wt.data_ptr(),
            U.data_ptr(), P.data_ptr(), part.data_ptr(), G, L2, L1, E, I, A,
            Bd, int(route), _STAGES[stage], plan.tile, plan.split,
            _gemm.DTYPES[dtype], stream)
    if err != 0:
        msg = lib.ligo_cuda_error_string(err).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return (None if stage == "expand" else P), U


def ligo_blend_expand_grouped(w: torch.Tensor, B: torch.Tensor,
                              W: torch.Tensor, *, keep_u: bool = False):
    """w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → P (G, L2, E, I, Bd),
    or ``(P, U)`` with ``keep_u``, U = B W (G, L1, E, I, Bd) in float32.

    CUDA tensors only; B and W share one dtype (float32 or bfloat16), the
    output is in that dtype, and every sum accumulates in float32. Launches
    on the current stream and does not synchronise.
    """
    if w is None or B is None or W is None:
        raise ValueError("K1 takes w, B and W")
    P, U = _launch("both", w, B, W, None, B.dtype)
    return (P, U) if keep_u else P


def ligo_expand(B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """K1's first step alone: U = B W, (I, A) × (G, L1, E, A, Bd) →
    (G, L1, E, I, Bd) in float32."""
    if B is None or W is None:
        raise ValueError("K1's expansion takes B and W")
    return _launch("expand", None, B, W, None, B.dtype)[1]


def ligo_blend(w: torch.Tensor, U: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """K1's second step alone: P[g, k, e] = Σ_l w[g, k, l] U[g, l, e],
    w (G, L2, L1), U (G, L1, E, I, Bd) float32 → (G, L2, E, I, Bd) in
    ``dtype`` (float32 or bfloat16), rounded once."""
    if w is None or U is None:
        raise ValueError("K1's blend takes w and U")
    if dtype not in _gemm.DTYPES:
        raise TypeError(f"K1's blend writes one of {list(_gemm.DTYPES)}; "
                        f"got {dtype}")
    return _launch("blend", w, None, None, U, dtype)[0]
