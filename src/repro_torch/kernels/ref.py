"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

The CPU path runs these; on the card ``chip_smoke.py`` and the card-only
tests hold each hand-written kernel against them on the same inputs. They
accumulate in float32 (float64 for float64 operands, as gradcheck feeds
them) and return each result in its operand's dtype, as the JAX oracles do.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def ligo_expand_ref(B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """U = B W over the source slabs: (I, A) × (G, L1, E, A, Bd) →
    (G, L1, E, I, Bd) in float32 (float64 for float64 operands) — the plain
    version of K1's first step, and of the U that K2 computes for dw."""
    acc = _acc(B.dtype)
    return torch.einsum("ia,gleab->gleib", B.to(acc), W.to(acc))


def ligo_blend_ref(w: torch.Tensor, U: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """P[g, k, e] = Σ_l w[g, k, l] U[g, l, e], accumulated in U's dtype and
    rounded once to ``dtype`` — the plain version of K1's blend step."""
    return torch.einsum("gkl,gleib->gkeib", w.to(U.dtype), U).to(dtype)


def ligo_blend_expand_grouped_ref(w: torch.Tensor, B: torch.Tensor,
                                  W: torch.Tensor, *, keep_u: bool = False):
    """Grouped oracle: P[g,k,e] = B @ (Σ_l w[g,k,l] · W[g,l,e]).

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).
    Blends in the small space first, accumulates in float32, and returns the
    result in B's dtype — the plain version of kernel K1. ``keep_u`` also
    returns U = B W (:func:`ligo_expand_ref`), as K1 hands it to K2.
    """
    acc = _acc(B.dtype)
    blended = torch.einsum("gkl,gleab->gkeab", w.to(acc), W.to(acc))
    P = torch.einsum("ia,gkeab->gkeib", B.to(acc), blended).to(B.dtype)
    return (P, ligo_expand_ref(B, W)) if keep_u else P


def ligo_blend_expand_ref(w: torch.Tensor, B: torch.Tensor,
                          W: torch.Tensor) -> torch.Tensor:
    """One leaf: P[l2] = B @ (Σ_l w[l2, l] W[l]). w: (L2, L1); B: (I, A);
    W: (L1, A, Bd) → (L2, I, Bd) — the grouped oracle at G = E = 1."""
    return ligo_blend_expand_grouped_ref(w[None], B, W[None, :, None])[0, :, 0]


def ligo_grow_ref(w: torch.Tensor, B: torch.Tensor, A: torch.Tensor,
                  W: torch.Tensor) -> torch.Tensor:
    """The full growth of one leaf, Ω[l2] = B (Σ_l w[l2, l] W_l) Aᵀ: the
    oracle of ``ops.ligo_grow``. A: (j, Bd) → (L2, I, j)."""
    P = ligo_blend_expand_ref(w, B, W)
    dt = torch.promote_types(P.dtype, A.dtype)
    return P.to(dt) @ A.to(dt).T


def _dw(dP: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """dw[g, k, l] = Σ_{e,i,b} dP[g,k,e,i,b] U[g,l,e,i,b]: for each group,
    one batched product over its E·I rows ((L2, Bd) @ (Bd, L1) a row, on
    strided views of dP and U), summed over the rows. Folding e·i·b into
    one contraction instead hands cuBLAS a product of only L2·L1 outputs
    with a K of E·I·Bd, up to ~5e8 at the widest expert groups, which it
    runs on a handful of blocks."""
    G, L2, E, I, Bd = dP.shape
    L1 = U.shape[1]
    return torch.stack([
        torch.bmm(dP[g].reshape(L2, E * I, Bd).transpose(0, 1),
                  U[g].reshape(L1, E * I, Bd).permute(1, 2, 0)).sum(0)
        for g in range(G)])


def _blend_bwd(w, dP, U):
    """(dw in w's dtype, Q = wᵀ·dP in the accumulation dtype)."""
    acc = _acc(dP.dtype)
    dP_ = dP.to(acc)
    dw = _dw(dP_, U.to(acc)).to(w.dtype)
    return dw, torch.einsum("gkl,gkeib->gleib", w.to(acc), dP_)


def ligo_blend_bwd_ref(w: torch.Tensor, dP: torch.Tensor, U: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's first half, plain: dw[g,k,l] = Σ_e ⟨dP[g,k,e], U[g,l,e]⟩ in
    float32 (in w's dtype) and the dP blend Q[g,l,e] = Σ_k w[g,k,l] dP[g,k,e]
    rounded to dP's dtype, as K2 writes it. Returns (dw, Q)."""
    dw, Q = _blend_bwd(w, dP, U)
    return dw, Q.to(dP.dtype)


def ligo_expand_bwd_ref(B: torch.Tensor, W: torch.Tensor, Q: torch.Tensor,
                        *, need_dW: bool = True
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's second half, plain: dB = Σ_{g,l,e} Q[g,l,e] W[g,l,e]ᵀ in B's
    dtype and, with ``need_dW``, dW[g,l,e] = Bᵀ Q[g,l,e] in W's dtype."""
    acc = _acc(B.dtype)
    Q_ = Q.to(acc)
    dB = torch.einsum("gleib,gleab->ia", Q_, W.to(acc)).to(B.dtype)
    dW = (torch.einsum("ia,gleib->gleab", B.to(acc), Q_).to(W.dtype)
          if need_dW else None)
    return dB, dW


def ligo_blend_expand_bwd_ref(w: torch.Tensor, B: torch.Tensor,
                              W: torch.Tensor, dP: torch.Tensor, *,
                              U: Optional[torch.Tensor] = None,
                              need_dW: bool = True
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         Optional[torch.Tensor]]:
    """Einsum oracle for the backward of the grouped blend-expand — the
    plain version of kernel K2, in its order:

    - Q[g,l,e] = Σ_k w[g,k,l] dP[g,k,e]        (the dP blend)
    - dW[g,l,e] = Bᵀ Q[g,l,e]                   (only with ``need_dW``)
    - dB = Σ_{g,l,e} Q[g,l,e] W[g,l,e]ᵀ
    - U[g,l,e] = B W[g,l,e]                     (unless ``U`` is given)
    - dw[g,k,l] = Σ_e ⟨dP[g,k,e], U[g,l,e]⟩

    Returns (dw, dB, dW) in the dtypes of (w, B, W); dW None without
    ``need_dW``. A given ``U`` (K1's, :func:`ligo_blend_expand_grouped_ref`
    with ``keep_u``) gives the same bits as the U computed here.
    """
    if U is None:
        U = ligo_expand_ref(B, W)
    dw, Q = _blend_bwd(w, dP, U)
    dB, dW = ligo_expand_bwd_ref(B, W, Q, need_dW=need_dW)
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
