"""Mixture-of-Experts layer: token-choice top-k routing with capacity buffers
(the port of the JAX package's ``models/moe.py``).

Tokens are placed into per-expert capacity buffers ``(E, C, D)`` by their
position-in-expert (the cumulative sum of the routing one-hot), the experts
run as batched products over E, and the results are gathered back and
combined with the routing weights. Capacity ``C = ceil(k · N · cf / E)``;
overflowing tokens are dropped (GShard/Switch semantics: the residual
stream carries them unchanged). The JAX package's mesh layouts of the
buffers (``maybe_shard``, ``moe_weight_gather``) are left out.

Two details keep the port's routing the JAX package's:

- **top-k tie order.** ``jax.lax.top_k`` returns the lowest expert index
  first among equal probabilities; ``torch.topk`` promises no order on
  ties. After an upcycle the router is zero and every token ties across all
  E experts, so the order decides which experts fill up and which tokens
  the capacity drops. The top k here come from a stable descending sort.
- **the capacity scatter** adds every routed row into its ``(e, pos)``
  slot with the dropped rows zeroed, as JAX does. Kept rows land in
  distinct slots and every other add is an exact zero, so the buffer does
  not depend on the order of the adds.

The router is float32 in a model of any dtype, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def _expert_stack(gen, cfg, in_dim: int, out_dim: int, scale: float, *,
                  dtype, device, lead: Tuple[int, ...]) -> torch.Tensor:
    """An ``lead + (E, in, out)`` expert stack, drawn one layer (E experts)
    at a time, so only one layer's float32 draw exists at once (a whole
    qwen3-moe ``w1`` drawn at once would be a 38.7 GB float32 temporary)."""
    E = cfg.n_experts
    out = torch.empty(tuple(lead) + (E, in_dim, out_dim), dtype=dtype,
                      device=device)
    flat = out.view((-1, E, in_dim, out_dim))
    for l in range(flat.shape[0]):
        flat[l] = dense_init(gen, in_dim, out_dim, scale, dtype=dtype,
                             device=device, lead=(E,))
    return out


def init_moe(gen, cfg, *, dtype=torch.float32, device=None,
             lead: Tuple[int, ...] = ()):
    """One layer's MoE params (or a stack with ``lead=(L,)``): the float32
    router ``(D, E)`` and the expert stacks ``w1``/``w3`` ``(E, D, F)``,
    ``w2`` ``(E, F, D)``."""
    D, Fm = cfg.d_model, cfg.moe_d_ff
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {
        "router": dense_init(gen, D, cfg.n_experts, device=device,
                             lead=lead),
        "w1": _expert_stack(gen, cfg, D, Fm, 1.0, **kw),
        "w2": _expert_stack(gen, cfg, Fm, D,
                            1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }
    if cfg.act == "swiglu":
        p["w3"] = _expert_stack(gen, cfg, D, Fm, 1.0, **kw)
    return p


def top_k_stable(probs: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last dim: the k largest values and their
    indices, the lowest index first among equal values."""
    _, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(probs, -1, idx), idx


def route(p, xf: torch.Tensor, cfg):
    """Router of N tokens ``xf`` (N, D): (probs (N, E), top_w (N, k)
    renormalised, top_e (N, k)), all but top_e float32."""
    logits = xf.float() @ p["router"]                       # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k_stable(probs, cfg.experts_top_k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)  # renormalise
    return probs, top_w, top_e


def apply_moe(p, x: torch.Tensor, cfg, *, return_keep: bool = False):
    """x: (B, T, D). Returns (out (B, T, D), aux_loss scalar), and with
    ``return_keep`` the (B·T·k,) bool mask of the routed rows the capacity
    kept, in token-major order."""
    B, T, D = x.shape
    E, k = cfg.n_experts, cfg.experts_top_k
    N = B * T
    C = int(math.ceil(k * N * cfg.capacity_factor / E))
    xf = x.reshape(N, D)

    probs, top_w, top_e = route(p, xf, cfg)
    # load-balancing auxiliary loss (Switch): E · Σ_e fraction_e · prob_e
    frac = torch.mean(F.one_hot(top_e[:, 0], E).float(), dim=0)
    aux = E * torch.sum(frac * torch.mean(probs, dim=0))

    e_flat = top_e.reshape(-1)                              # (N·k,)
    w_flat = top_w.reshape(-1)
    oh = F.one_hot(e_flat, E)                               # (N·k, E) int64
    pos_flat = torch.sum((torch.cumsum(oh, dim=0) - oh) * oh, dim=-1)
    keep = pos_flat < C
    pos_c = torch.clamp(pos_flat, max=C - 1)

    x_rep = torch.repeat_interleave(xf, k, dim=0) * keep[:, None].to(x.dtype)
    buf = x.new_zeros((E, C, D)).index_put_((e_flat, pos_c), x_rep,
                                             accumulate=True)
    h = torch.bmm(buf, p["w1"])
    if "w3" in p:
        h = F.silu(h) * torch.bmm(buf, p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    y = torch.bmm(h, p["w2"])                               # (E, C, D)

    gathered = y[e_flat, pos_c] * (w_flat * keep).to(x.dtype)[:, None]
    out = torch.sum(gathered.reshape(N, k, D), dim=1).reshape(B, T, D)
    if return_keep:
        return out, aux, keep
    return out, aux
