"""Plain PyTorch versions of the port's kernels (the correctness ground truth).

The CPU path runs these; on the card ``chip_smoke.py`` and the card-only
tests hold each hand-written kernel against them on the same inputs.
"""
from __future__ import annotations

import torch


def ligo_blend_expand_grouped_ref(w: torch.Tensor, B: torch.Tensor,
                                  W: torch.Tensor) -> torch.Tensor:
    """Grouped oracle: P[g,k,e] = B @ (Σ_l w[g,k,l] · W[g,l,e]).

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).
    Blends in the small space first, accumulates in float32, and returns the
    result in B's dtype — the plain version of kernel K1.
    """
    f32 = torch.float32
    blended = torch.einsum("gkl,gleab->gkeab", w.to(f32), W.to(f32))
    return torch.einsum("ia,gkeab->gkeib", B.to(f32), blended).to(B.dtype)
