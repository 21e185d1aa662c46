"""Optimizer-state growth: carry AdamW moments through a growth operator
(the twin of the JAX package's ``optim/grow_state.py``).

Every growth method is a linear operator ``Θ_large = M Θ_small``, so:

- the first moment ``m`` (an EMA of gradients) maps through ``M`` as is;
- the second moment ``v`` (an EMA of squared gradients) maps through the
  elementwise-squared operator (``apply_ligo(..., square=True)``: every
  resolved expander and depth blend squared after resolution), under the
  independent-gradient approximation ``E[(Σ cᵢ gᵢ)²] ≈ Σ cᵢ² E[gᵢ²]``; the
  squared factors are non-negative, so ``v`` stays ≥ 0;
- the step ``count`` is carried over, so bias correction and the schedule
  continue instead of re-warming;
- the weight-decay mask is not state (``adamw_update`` rebuilds it).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.optim.adamw import AdamWState


def hop_uses_grouped_gamma(cfg1, cfg2) -> bool:
    """True when the hop's ``Γ(B_v)`` expander group-averages (grouped
    heads on either side): then squaring does not commute with composing
    hops (``(Σcᵢ)²`` composed against ``Σcᵢ²`` per hop)."""
    return (cfg1.n_kv_heads != cfg1.n_heads
            or cfg2.n_kv_heads != cfg2.n_heads)


@torch.no_grad()
def grow_adamw_state(state: AdamWState, op, cfg1, cfg2, *,
                     engine: str = "plan",
                     use_kernel: Optional[bool] = None) -> AdamWState:
    """Map an AdamW state through a growth operator (see the module
    docstring). The moments are float32 trees and ride the same GrowthPlan
    as the parameters."""
    from repro_torch.core.ligo import apply_ligo
    m = apply_ligo(op, state.m, cfg1, cfg2, engine=engine,
                   use_kernel=use_kernel)
    v = apply_ligo(op, state.v, cfg1, cfg2, engine=engine,
                   use_kernel=use_kernel, square=True)
    return AdamWState(m=m, v=v, count=state.count)


@torch.no_grad()
def grow_adamw_state_chain(state: AdamWState, ops: Sequence, cfgs: Sequence,
                           *, engine: str = "plan",
                           use_kernel: Optional[bool] = None) -> AdamWState:
    """Map an AdamW state through a chain of operators (``ops[i]: cfgs[i]
    → cfgs[i+1]``). ``m`` rides the composed operator in one apply; ``v``
    does too, unless a hop group-averages (:func:`hop_uses_grouped_gamma`),
    in which case it is grown hop by hop through each squared operator."""
    from repro_torch.core.ligo import apply_ligo
    from repro_torch.core.plan import compose_chain
    if len(ops) != len(cfgs) - 1:
        raise ValueError(f"{len(ops)} operators need {len(ops) + 1} "
                         f"configs, got {len(cfgs)}")
    if len(ops) == 1:
        return grow_adamw_state(state, ops[0], cfgs[0], cfgs[1],
                                engine=engine, use_kernel=use_kernel)
    composed = compose_chain(list(ops), list(cfgs))
    m = apply_ligo(composed, state.m, cfgs[0], cfgs[-1], engine=engine,
                   use_kernel=use_kernel)
    if any(hop_uses_grouped_gamma(a, b) for a, b in zip(cfgs[:-1], cfgs[1:])):
        v = state.v
        for op, a, b in zip(ops, cfgs[:-1], cfgs[1:]):
            v = apply_ligo(op, v, a, b, engine=engine, use_kernel=use_kernel,
                           square=True)
    else:
        v = apply_ligo(composed, state.v, cfgs[0], cfgs[-1], engine=engine,
                       use_kernel=use_kernel, square=True)
    return AdamWState(m=m, v=v, count=state.count)
