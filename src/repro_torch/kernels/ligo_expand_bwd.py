"""Kernel K2 on Hopper: all three cotangents of the LiGO blend-expand.

Given ``P[g, k, e] = B @ (Σ_l w[g, k, l] · W[g, l, e])`` and its cotangent
``dP``, returns ``(dw, dB, dW)`` — the hand-written CUDA kernel in
``csrc/ligo_expand_bwd.cu``, in the order that needs the fewest operations:
a blend ``Q = wᵀ·dP`` over the target layers, then ``dW = BᵀQ``,
``dB = Σ Q Wᵀ`` (split over its contraction where the tile grid is small)
and ``U = B W``, and ``dw = Σ ⟨dP, U⟩`` by chunks; every sum in one fixed
order, no float atomics; the source says why and what bounds it. The three
products run on a TMA + ``wgmma`` tensor-core GEMM for bf16 at widths that
are multiples of 8 (:func:`tensor_core_route`), otherwise on an f32 FMA
GEMM, each in the tile and split :func:`f32_gemm_plan` picks for its
shape: the GEMM core it shares with K1 (``csrc/ligo_gemm.cuh``). It
replaces the Pallas kernel ``repro/kernels/ligo_expand_bwd.py::
ligo_blend_expand_bwd_fused``. The plain version is
:func:`repro_torch.kernels.ref.ligo_blend_expand_bwd_ref`.

A call does only what its caller's autograd needs: it takes K1's U
(``U=``) instead of computing it again, and skips dW where W takes no
gradient (``need_dW=False``). :func:`ligo_blend_bwd` and
:func:`ligo_expand_bwd` run its two halves apart (the dP blend and dw;
then dB and dW from a given Q), for a group whose right expansion sits
between K1's U and its blend.

``LAUNCHES`` counts the calls of this wrapper that launched the kernel: a
plain integer that callers reset and read (``chip_smoke.py`` shows with it
that the LiGO phase went through the kernel).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, _gemm
from repro_torch.kernels._gemm import (SMS, f32_gemm_plan,
                                       tensor_core_route, tma_aligned)

LAUNCHES = 0
_DW_SMEM = 48 * 1024       # bytes of U a dw-partial block stages


def _lib() -> ctypes.CDLL:
    lib = _build.load("ligo_expand_bwd")
    fn = lib.ligo_blend_expand_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 17
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.ligo_bwd_error_string.argtypes = [ctypes.c_int]
        lib.ligo_bwd_error_string.restype = ctypes.c_char_p
    return lib


# the C launcher's flags (csrc/ligo_expand_bwd.cu)
U_GIVEN, Q_GIVEN, NEED_DW, NEED_DB, NEED_DWT = 1, 2, 4, 8, 16


def operation_count(G: int, L2: int, L1: int, E: int, I: int, A: int,
                    Bd: int, *, u_given: bool = False, need_dW: bool = True,
                    q_given: bool = False, need_dB: bool = True,
                    need_dw: bool = True) -> int:
    """The operations a K2 call runs, in its own order: the dP blend Q
    (unless ``q_given``), the products dW, dB and U (U only for dw and only
    where ``u_given`` is false), and the dw contraction. The measured-cost
    pass counts this."""
    prod = 2 * G * E * L1 * I * A * Bd
    blend = 2 * G * E * L2 * L1 * I * Bd
    return ((0 if q_given else blend) + (prod if need_dW else 0)
            + (prod if need_dB else 0)
            + ((blend + (0 if u_given else prod)) if need_dw else 0))


def least_operations(G: int, L2: int, L1: int, E: int, I: int, A: int,
                     Bd: int, *, u_given: bool = False,
                     need_dW: bool = True) -> int:
    """The fewest operations K2's function needs: the lesser of the fused
    order (T over all L2 layers, dB against the blended slabs; it needs no
    U) and K2's own order, which blends dP over k first (the L1-batched
    products plus the blend and the dw contraction). K2's bound counts
    this."""
    fused = ((2 if need_dW else 1) * 2 * G * E * L2 * I * A * Bd
             + (3 if need_dW else 2) * 2 * G * E * L2 * L1 * A * Bd)
    own = operation_count(G, L2, L1, E, I, A, Bd, u_given=u_given,
                          need_dW=need_dW)
    return min(fused, own)


def db_splits(I: int, A: int, n: int) -> int:
    """Contiguous parts of the ``n = G·L1·E`` contraction that the
    tensor-core dB GEMM runs as separate blocks: enough for ~2 blocks per SM
    when the (I, A) tile grid alone is smaller, never more than ``n``. (The
    float32 GEMM splits by :func:`f32_gemm_plan`.)"""
    tiles = -(-I // _gemm.TILE) * -(-A // _gemm.TILE)
    return max(1, min(n, -(-2 * SMS // tiles)))


@functools.lru_cache(maxsize=256)
def f32_plans(G: int, L1: int, E: int, I: int, A: int, Bd: int):
    """The float32 GEMM's plan of each of K2's products: {"dW": (M A, N Bd,
    K I, Z), "dB": (M I, N A, K Bd, R Z), "U": (M I, N Bd, K A, Z)} — U's the
    plan of K1's U, so K2 computes the same bits."""
    Z = G * L1 * E
    return {"dW": f32_gemm_plan(A, Bd, I, 1, Z),
            "dB": f32_gemm_plan(I, A, Bd, Z, 1),
            "U": f32_gemm_plan(I, Bd, A, 1, Z)}


def dw_chunk(L1: int) -> int:
    """Elements of the E·I·Bd axis per dw-partial block: the U rows of all
    L1 source layers over the chunk fill at most 48 KB of shared memory."""
    return max(32, min(1024, _DW_SMEM // (4 * L1) // 32 * 32))


def _launch(flags: int, w, B, W, dP, U, Q, dims, dtype):
    """One K2 launch; the operands ``flags`` leaves unused may be None.
    Returns (dw, dB, dW, Q, U), None where not computed."""
    global LAUNCHES
    given = [x for x in (w, B, W, dP, U, Q) if x is not None]
    dev = given[0].device
    if not all(x.is_cuda and x.device == dev for x in given):
        raise ValueError(f"K2 needs its operands on one CUDA device; got "
                         f"{[str(x.device) for x in given]}")
    if dtype not in _gemm.DTYPES or any(
            x.dtype != dtype for x in (B, W, dP, Q) if x is not None):
        raise TypeError(f"K2 takes B, W, dP and Q in one of "
                        f"{list(_gemm.DTYPES)}; got "
                        f"{[x.dtype for x in (B, W, dP, Q) if x is not None]}")
    if U is not None and U.dtype != torch.float32:
        raise TypeError(f"K2 takes a float32 U; got {U.dtype}")
    G, L2, L1, E, I, A, Bd = dims
    shapes = {"w": (G, L2, L1), "B": (I, A), "W": (G, L1, E, A, Bd),
              "dP": (G, L2, E, I, Bd), "U": (G, L1, E, I, Bd),
              "Q": (G, L1, E, I, Bd)}
    for name, x in zip(("w", "B", "W", "dP", "U", "Q"),
                       (w, B, W, dP, U, Q)):
        if x is not None and tuple(x.shape) != shapes[name]:
            raise ValueError(f"K2 shape mismatch: {name} {tuple(x.shape)}, "
                             f"want {shapes[name]}")
    if min(dims) < 1:
        raise ValueError(f"K2 takes no empty dim: {dims}")
    if (G * L1 * E > _gemm.MAX_GRID_YZ or G > _gemm.MAX_GRID_YZ
            or 4 * L1 * dw_chunk(L1) > _DW_SMEM
            or -(-max(I, A) // 64) > _gemm.MAX_GRID_YZ):
        raise ValueError(f"K2 grid too large for G·L1·E={G * L1 * E}, "
                         f"L1={L1}, I={I}, A={A}")
    if not all(x.is_contiguous() for x in (B, W, dP, U, Q) if x is not None):
        raise ValueError("K2 takes contiguous B, W, dP, U and Q")
    lib = _lib()
    f32 = torch.float32

    def new(shape, dt=dtype, on=True):
        return torch.empty(shape if on else (0,), dtype=dt, device=dev)
    null = new((0,))
    need_dw, need_dB, need_dW = (bool(flags & f)
                                 for f in (NEED_DW, NEED_DB, NEED_DWT))
    u = need_dw and U is None
    products = u or need_dB or need_dW
    w32 = w.to(f32).contiguous() if w is not None else new((0,), f32)
    Z = G * L1 * E
    chunk = dw_chunk(L1)
    n_chunks = -(-(E * I * Bd) // chunk)
    route = products and tensor_core_route(dtype, I, A, Bd)
    plans = f32_plans(G, L1, E, I, A, Bd)
    # dB's parts; the split partials' scratch: the tensor-core dB's, or the
    # largest of the split products the f32 GEMM runs
    splits = db_splits(I, A, Z) if route else plans["dB"].split
    outs = {"dW": Z * A * Bd, "dB": I * A, "U": Z * I * Bd}
    runs = {"dW": need_dW, "dB": need_dB, "U": u}
    n_part = (splits * I * A if route and need_dB and splits > 1 else
              max([plans[k].split * outs[k] for k in outs
                   if runs[k] and plans[k].split > 1 and not route],
                  default=0))
    if route:  # TMA reads B, W and a given Q straight from the caller
        B, W = (tma_aligned(x) if x is not None else None for x in (B, W))
        if Q is not None:
            Q = tma_aligned(Q)
    q_given = Q is not None
    if Q is None:
        Q = new((G, L1, E, I, Bd))
    if U is None:
        U = new((G, L1, E, I, Bd), f32, u)
    # the K-major operands of the tensor-core GEMM: Bᵀ, Qᵀ and Wᵀ
    Bt = new((A, I), on=route and need_dW)
    Qt = new((G, L1, E, Bd, I), on=route and need_dW)
    Wt = new((G, L1, E, Bd, A), on=route and u)
    part = new((n_part,), f32)
    dwpart = new((G, L2, L1, n_chunks), f32, need_dw)
    dw = new((G, L2, L1), f32, need_dw)
    dB = new((I, A), on=need_dB)
    dW = new((G, L1, E, A, Bd), on=need_dW)
    flags |= (U_GIVEN if not u else 0) | (Q_GIVEN if q_given else 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ligo_blend_expand_bwd(
            w32.data_ptr(), *((x if x is not None else null).data_ptr()
                              for x in (B, W, dP)),
            Q.data_ptr(), U.data_ptr(), Bt.data_ptr(), Qt.data_ptr(),
            Wt.data_ptr(), part.data_ptr(), dwpart.data_ptr(),
            dw.data_ptr(), dB.data_ptr(), dW.data_ptr(), G, L2, L1, E, I, A,
            Bd, splits, plans["dW"].tile, plans["dW"].split,
            plans["dB"].tile, plans["U"].tile, plans["U"].split, chunk,
            int(route), flags, _gemm.DTYPES[dtype], stream)
    if err != 0:
        msg = lib.ligo_bwd_error_string(err).decode()
        raise RuntimeError(f"K2 launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return (dw if need_dw else None, dB if need_dB else None,
            dW if need_dW else None, Q, U if u else None)


def _dims(w, B, W):
    G, L2, L1 = w.shape
    I, A = B.shape
    return G, L2, L1, W.shape[2], I, A, W.shape[4]


def ligo_blend_expand_bwd(w: torch.Tensor, B: torch.Tensor, W: torch.Tensor,
                          dP: torch.Tensor, *, U: Optional[torch.Tensor] = None,
                          need_dW: bool = True, keep_u: bool = False):
    """w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd); dP: (G, L2, E, I, Bd)
    → (dw (G, L2, L1) float32, dB (I, A), dW (G, L1, E, A, Bd) or None).

    ``U``: K1's float32 U = B W (``ligo_blend_expand_grouped(...,
    keep_u=True)``), used instead of computing it; ``need_dW=False`` skips
    the dW product and returns None for it; ``keep_u`` appends the U this
    call computed (U not given) to the result. CUDA tensors only; B, W and dP
    share one dtype (float32 or bfloat16), dB and dW come in that dtype,
    and every sum accumulates in float32. Launches on the current stream and
    does not synchronise.
    """
    if w is None or B is None or W is None or dP is None:
        raise ValueError("K2 takes w, B, W and dP")
    if w.dim() != 3 or B.dim() != 2 or W.dim() != 5:
        raise ValueError(f"K2 shapes: w (G,L2,L1), B (I,A), W (G,L1,E,A,Bd); "
                         f"got {tuple(w.shape)}, {tuple(B.shape)}, "
                         f"{tuple(W.shape)}")
    if keep_u and U is not None:
        raise ValueError("keep_u returns the U that K2 computes: pass no U")
    flags = NEED_DW | NEED_DB | (NEED_DWT if need_dW else 0)
    dw, dB, dW, _, Uk = _launch(flags, w, B, W, dP, U, None, _dims(w, B, W),
                                B.dtype)
    return (dw, dB, dW, Uk) if keep_u else (dw, dB, dW)


def ligo_blend_bwd(w: torch.Tensor, dP: torch.Tensor, U: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's first half: the dP blend Q = wᵀ·dP (G, L1, E, I, Bd) in dP's
    dtype and dw = Σ ⟨dP, U⟩ (G, L2, L1) float32, for w (G, L2, L1),
    dP (G, L2, E, I, Bd) and a float32 U (G, L1, E, I, Bd). Returns
    (dw, Q)."""
    if w is None or dP is None or U is None:
        raise ValueError("K2's blend takes w, dP and U")
    if w.dim() != 3 or dP.dim() != 5:
        raise ValueError(f"K2 shapes: w (G,L2,L1), dP (G,L2,E,I,Bd); got "
                         f"{tuple(w.shape)}, {tuple(dP.shape)}")
    G, L2, L1 = w.shape
    _, _, E, I, Bd = dP.shape
    dw, _, _, Q, _ = _launch(NEED_DW, w, None, None, dP, U, None,
                             (G, L2, L1, E, I, 1, Bd), dP.dtype)
    return dw, Q


def ligo_expand_bwd(B: torch.Tensor, W: torch.Tensor, Q: torch.Tensor, *,
                    need_dW: bool = True
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's second half from a given Q (G, L1, E, I, Bd): dB = Σ Q Wᵀ (I, A)
    and, with ``need_dW``, dW = Bᵀ Q (G, L1, E, A, Bd), else None."""
    if B is None or W is None or Q is None:
        raise ValueError("K2's products take B, W and Q")
    if B.dim() != 2 or W.dim() != 5:
        raise ValueError(f"K2 shapes: B (I,A), W (G,L1,E,A,Bd); got "
                         f"{tuple(B.shape)}, {tuple(W.shape)}")
    G, L1, E, A, Bd = W.shape
    flags = NEED_DB | (NEED_DWT if need_dW else 0)
    _, dB, dW, _, _ = _launch(flags, None, B, W, None, None, Q,
                              (G, 1, L1, E, B.shape[0], A, Bd), B.dtype)
    return dB, dW
