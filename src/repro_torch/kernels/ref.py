"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

The CPU path runs these; on the card ``chip_smoke.py`` and the card-only
tests hold each hand-written kernel against them on the same inputs. They
accumulate in float32 (float64 for float64 operands, as gradcheck feeds
them) and return each result in its operand's dtype, as the JAX oracles do.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def ligo_blend_expand_grouped_ref(w: torch.Tensor, B: torch.Tensor,
                                  W: torch.Tensor) -> torch.Tensor:
    """Grouped oracle: P[g,k,e] = B @ (Σ_l w[g,k,l] · W[g,l,e]).

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).
    Blends in the small space first, accumulates in float32, and returns the
    result in B's dtype — the plain version of kernel K1.
    """
    acc = _acc(B.dtype)
    blended = torch.einsum("gkl,gleab->gkeab", w.to(acc), W.to(acc))
    return torch.einsum("ia,gkeab->gkeib", B.to(acc), blended).to(B.dtype)


def ligo_blend_expand_bwd_ref(w: torch.Tensor, B: torch.Tensor,
                              W: torch.Tensor, dP: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Einsum oracle for the backward of the grouped blend-expand — the
    plain version of kernel K2, without widened intermediates:

    - T[g,k,e] = Bᵀ dP[g,k,e]                  (small-space (A, Bd) stack)
    - dW[g,l,e] = Σ_k w[g,k,l] T[g,k,e]
    - dB = Σ_{g,k,e} dP[g,k,e] · blendedᵀ      (blended = w·W, small space)
    - dw[g,k,l] = Σ_e ⟨T[g,k,e], W[g,l,e]⟩

    Returns (dw, dB, dW) in the dtypes of (w, B, W).
    """
    acc = _acc(B.dtype)
    w_, B_, W_, dP_ = (x.to(acc) for x in (w, B, W, dP))
    T = torch.einsum("ia,gkeib->gkeab", B_, dP_)
    dW = torch.einsum("gkl,gkeab->gleab", w_, T).to(W.dtype)
    blended = torch.einsum("gkl,gleab->gkeab", w_, W_)
    dB = torch.einsum("gkeib,gkeab->ia", dP_, blended).to(B.dtype)
    dw = torch.einsum("gkeab,gleab->gkl", T, W_).to(w.dtype)
    return dw, dB, dW


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """Full-matrix attention with a float32 softmax — the plain version of
    kernel K3.

    q: (B, H, T, dh); k, v: (B, KV, S, dh) with H % KV == 0 (query head h
    reads kv head h // (H // KV)). Causal alignment puts the last q row on
    the last k row (offset S - T); ``window`` keeps keys
    ``kpos > qpos - window``. Returns (B, H, T, dh) in q's dtype.
    """
    T, dh = q.shape[2], q.shape[3]
    S, G = k.shape[2], q.shape[1] // k.shape[1]
    acc = _acc(q.dtype)
    kk = torch.repeat_interleave(k.to(acc), G, dim=1)
    vv = torch.repeat_interleave(v.to(acc), G, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.to(acc), kk) / math.sqrt(dh)
    qpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, vv).to(q.dtype)
