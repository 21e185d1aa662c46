"""Dense→MoE upcycling: grow a dense checkpoint into a sparse MoE model
(the port of the JAX package's ``core/upcycle.py``).

Sparse upcycling (Komatsuzaki et al., ICLR 2023) warm-starts an MoE from a
dense checkpoint: every expert starts as a copy of the dense FFN and the
router starts uniform, so the upcycled model computes the dense model's
function at init. Here that recipe is an ordinary LiGO operator tree over
the cross-family hop (:func:`repro_torch.core.spec.family_hop`), so the
GrowthPlan (kernel K1 on the card), AdamW moment growth, operator
composition and the serving hop apply it with no special case:

- **widths** are LEMON-style zero-pads ``[I; 0]``: identity everywhere, and
  ``eye(moe_d_ff, d_ff)`` for the ``fc`` space, so expert columns past the
  dense width compute 0 and, through the gated activation, contribute 0;
- **depth** is the identity blend (layer counts match across the hop);
- the **expert axis** and the **router** are structural, carried by the
  hop: every dense FFN leaf lands replicated across the E experts and the
  router is made as zeros.

A zero router gives a uniform softmax; ``apply_moe`` renormalises the top-k
gate weights to sum to 1, so each token receives ``Σ (1/k)·MLP(x) =
MLP(x)``, the dense block's output, for any ``experts_top_k`` — as long
as the capacity drops no token. Every token ties across the experts, so
the stable top-k sends all of them to experts 0..k-1; the capacity keeps
them all only when ``capacity_factor >= E / k``.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spec as S
from repro_torch.core.operators import _depth
from repro_torch.device import resolve_device


def upcycle_operator(cfg1: ModelConfig, cfg2: ModelConfig, *,
                     device="cuda") -> Dict:
    """LiGO tree for the dense→MoE upcycling hop ``cfg1 → cfg2``, on
    ``device``. The operator is lossless, so anything that would change the
    computed function is an error here, as in ``lemon_operator``."""
    S.check_growable(cfg1, cfg2)
    if (cfg1.family, cfg2.family) != ("dense", "moe"):
        raise ValueError("upcycle_operator: needs a dense source and an MoE "
                         f"target, got {cfg1.family!r} -> {cfg2.family!r}")
    if cfg1.d_model != cfg2.d_model:
        raise ValueError("upcycle_operator: d_model must match "
                         f"({cfg1.d_model} vs {cfg2.d_model}) — residual "
                         "widening changes norm denominators")
    if cfg1.d_head != cfg2.d_head:
        raise ValueError("upcycle_operator: d_head must match "
                         f"({cfg1.d_head} vs {cfg2.d_head})")
    if (cfg1.n_heads, cfg1.n_kv_heads) != (cfg2.n_heads, cfg2.n_kv_heads):
        raise ValueError("upcycle_operator: head layout must match "
                         f"(({cfg1.n_heads}, {cfg1.n_kv_heads}) vs "
                         f"({cfg2.n_heads}, {cfg2.n_kv_heads}))")
    if cfg1.n_layers != cfg2.n_layers:
        raise ValueError("upcycle_operator: layer counts must match "
                         f"({cfg1.n_layers} vs {cfg2.n_layers}); grow depth "
                         "separately")
    if cfg2.moe_d_ff < cfg1.d_ff:
        raise ValueError("upcycle_operator: expert FFN narrower than the "
                         f"dense source ({cfg2.moe_d_ff} < {cfg1.d_ff}) — "
                         "shrinking the FFN is not function-preserving")
    dev = resolve_device(device)
    d1s, d2s = S.width_dims(cfg1), S.width_dims(cfg2)
    # eye(d2, d1) is [I; 0]: identity on the dense features, zero rows for
    # the padded expert columns
    width = {n: torch.eye(d2s[n], d1s[n], device=dev) for n in d2s}

    def identity(L2, L1, device):       # equal layer counts
        return torch.eye(L1, device=device)
    return {"width": width, "depth": _depth(cfg1, cfg2, identity, dev)}
