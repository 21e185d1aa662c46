"""AdamW and SGD-momentum over nested-dict parameter trees (the twin of the
JAX package's ``optim/adamw.py``).

The moments (m, v) are kept in float32 whatever the parameter dtype, as in
the JAX package; the step count is a Python int. The updates are functional
(new tensors out, inputs untouched), like the JAX ones, so a caller can
compare a step against the inputs it started from.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.tree import (sorted_leaves, tree_leaves, tree_map,
                              tree_unflatten)

Params = Any
F32 = torch.float32


class AdamWState(NamedTuple):
    m: Params
    v: Params
    count: int


def decay_mask(params: Params) -> Params:
    """No weight decay on vectors/scalars (norm scales, biases, gates).

    Not part of :class:`AdamWState`: it is recomputed from the current tree
    on every update, so a grown tree gets the mask of its own shapes."""
    return tree_map(lambda p: p.dim() >= 2, params)


def adamw_init(params: Params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=0)


@torch.no_grad()
def adamw_update(grads: Params, state: AdamWState, params: Params, *,
                 lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 ) -> Tuple[Params, AdamWState]:
    count = state.count + 1
    # bias corrections in float32, as the JAX package computes them
    c1 = float(1 - np.float32(b1) ** np.float32(count))
    c2 = float(1 - np.float32(b2) ** np.float32(count))

    def upd(g, m, v, p, decay):
        gf = g.to(F32)
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        step = (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        if decay:
            step = step + weight_decay * p.to(F32)
        return (p.to(F32) - lr * step).to(p.dtype), m_new, v_new

    flat = tree_leaves(tree_map(upd, grads, state.m, state.v, params,
                                decay_mask(params)))   # p, m, v a leaf
    p, m, v = (tree_unflatten(grads, flat[i::3]) for i in range(3))
    return p, AdamWState(m, v, count)


# ---------------------------------------------------------------------------
class SGDState(NamedTuple):
    mom: Params


def sgd_init(params: Params) -> SGDState:
    return SGDState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params))


@torch.no_grad()
def sgd_update(grads: Params, state: SGDState, params: Params, *,
               lr: float, momentum: float = 0.9) -> Tuple[Params, SGDState]:
    mom = tree_map(lambda m, g: momentum * m + g.to(F32), state.mom, grads)
    params = tree_map(lambda p, m: (p.to(F32) - lr * m).to(p.dtype),
                      params, mom)
    return params, SGDState(mom)


# ---------------------------------------------------------------------------
@torch.no_grad()
def global_norm(tree: Params) -> torch.Tensor:
    """Summed in JAX's leaf order, whatever the dicts' insertion order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in sorted_leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm
