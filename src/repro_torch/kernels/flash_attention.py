"""Kernel K3 on Hopper: flash attention forward (causal, sliding-window or
bidirectional; GQA without a KV repeat).

q (B, H, T, dh); k, v (B, KV, S, dh) → o (B, H, T, dh) — the hand-written
CUDA kernel in ``csrc/flash_attention.cu`` (one block per 128 query rows of
one (b, h), m, l and the accumulator in registers, kv tiles outside the
causal range or the window never visited; for bf16 with aligned rows at
any dh ≤ 128 the tensor cores through a TMA ring and ``wgmma``, after a
pass that writes Vᵀ, dh padded with zeros to the 64- or 128-wide tile;
f32 FMA otherwise; the source says why and what bounds it). It
replaces the Pallas kernel ``repro/kernels/flash_attention.py::
flash_attention``. The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

The kernel reads q, k and v through their strides (the last dim must be
contiguous), so the model hands in transposed views of its (B, T, H, dh)
activations without a copy; the output is a (B, H, T, dh) view of a
(B, T, H, dh) buffer, so transposing it back is free.

``LAUNCHES`` counts the launches of this wrapper: a plain integer that
callers reset and read (``chip_smoke.py`` shows with it that prefill went
through the kernel).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 128
_MAX_GRID_YZ = 65535
_TC_ROWS = 128   # query rows per block of the tensor-core kernel


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_error_string.argtypes = [ctypes.c_int]
        lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def uses_tensor_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> bool:
    """Whether the call runs the tensor-core kernel: bf16, dh ≤ ``MAX_DH``
    and a multiple of 8, and bases and row strides on 16-byte boundaries
    (TMA's rule for the tensor maps over q and k, and the Vᵀ pass's for v;
    the output buffer is the wrapper's own and always qualifies). In the
    model's (B, T, H, dh) layout a head's stride is dh, so aligned rows
    already make dh a multiple of 8. The kernel pads dh to its 64- or
    128-wide tile with TMA's zero fill. A broadcast (stride 0) dim is no
    layout a tensor map describes: it takes the FMA kernel. S takes any
    value: the Vᵀ scratch is padded to a multiple of 8 keys."""
    def aligned(x):
        return (x.data_ptr() % 16 == 0
                and all(s > 0 and s % 8 == 0 for s in x.stride()[:-1]))
    dh = q.shape[-1]
    return (q.dtype == torch.bfloat16 and 1 <= dh <= MAX_DH and dh % 8 == 0
            and all(aligned(x) for x in (q, k, v)))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, H, T, dh); k, v: (B, KV, S, dh) → (B, H, T, dh).

    CUDA tensors only, one dtype (float32 or bfloat16), H % KV == 0,
    dh ≤ 128, the last dim contiguous, S ≥ T when causal. bf16 with
    aligned rows takes the tensor-core kernel at every such dh
    (:func:`uses_tensor_cores`), the rest the FMA kernel. Scores, softmax
    and accumulator are float32; the output is in q's dtype. There is no
    backward: inputs that require grad while grad is enabled are refused.
    Launches on the current stream and does not synchronise.
    """
    global LAUNCHES
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"K3 takes q, k, v in one of {list(_DTYPES)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"K3 shapes: q (B,H,T,dh), k and v (B,KV,S,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, T, dh = q.shape
    _, KV, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != dh or KV < 1 or H % KV:
        raise ValueError(f"K3 shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if min(B, T, S) < 1 or not 1 <= dh <= MAX_DH:
        raise ValueError(f"K3 takes B, T, S >= 1 and 1 <= dh <= {MAX_DH}; "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"K3 needs q, k, v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if causal and S < T:
        raise ValueError(f"causal K3 needs S >= T (the last q row sits on "
                         f"the last k row); got T={T}, S={S}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    tc = uses_tensor_cores(q, k, v)
    # grids: FMA (T/32, H, B); tensor cores (H, T/128, B), Vᵀ (S/64,
    # ceil(dh/64), B·KV)
    if max(H, B) > _MAX_GRID_YZ or (tc and max(-(-T // _TC_ROWS), B * KV)
                                    > _MAX_GRID_YZ):
        raise ValueError(f"K3 grid too large for H={H}, B={B}, KV={KV}, "
                         f"T={T}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("K3 reads rows through strides: the last dim of q, "
                         "k and v must be contiguous")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "K3 has no backward: differentiate through the plain attention "
            "(models.layers.attention), or call it under torch.no_grad()")
    lib = _lib()
    out = torch.empty((B, T, H, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    # Vᵀ, the K-major operand of O += P V, keys padded to a multiple of 8
    vt = torch.empty((B, KV, dh, -(-S // 8) * 8) if tc else (0,),
                     dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), vt.data_ptr(),
            out.data_ptr(),
            B, H, KV, T, S, dh, int(causal), int(window),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], _DTYPES[q.dtype], int(tc), stream)
    if err != 0:
        msg = lib.flash_error_string(err).decode()
        raise RuntimeError(f"K3 launch failed: CUDA error {err} ({msg})")
    LAUNCHES += 1
    return out
