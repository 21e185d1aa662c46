"""LiGO: the learned Linear Growth Operator (paper Eq. 8).

``vec(Θ_large) = L_depth · R_width · vec(Θ_small)`` with

- width: per-tensor ``Ω = E_in · W · E_outᵀ`` where the expanders are resolved
  from a small set of learnable matrices (B_emb, B_q, B_k, B_v, B_fc1, ...)
  through the tying registry in :mod:`repro_torch.core.spec`;
- depth: per-module blend ``Ω'_{l₂} = Σ_j w[l₂,j] Ω_j``, one learnable
  ``w ∈ R^{L₂×L₁}`` per leaf of each module family (Alg. 1).

Untied in-expanders are stored under ``"<name>__in"``. ``apply_ligo`` routes
through the :class:`repro_torch.core.plan.GrowthPlan` (``engine="plan"``) or
the per-leaf walk below (``engine="legacy"``), which is the port's own
correctness oracle, as in the JAX package. Both carry the dense→MoE hop
(:func:`repro_torch.core.spec.family_hop`): renamed leaves, expert
replication and created (zero) leaves.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spec as S
from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Expander resolution
# ---------------------------------------------------------------------------
def gamma_expand(Bv: torch.Tensor, cfg1: ModelConfig, cfg2: ModelConfig
                 ) -> torch.Tensor:
    """Γ(B_v): kv-head-space expander → query-head-space expander.

    Block-repeats each kv-group block over its group's query heads; identity
    mapping for MHA (KV == H), which recovers the paper's ``A^O = B_vᵀ``.
    """
    KV1, KV2 = cfg1.n_kv_heads, cfg2.n_kv_heads
    H1, H2 = cfg1.n_heads, cfg2.n_heads
    dh1, dh2 = cfg1.d_head, cfg2.d_head
    if KV1 == H1 and KV2 == H2:
        return Bv
    G1, G2 = H1 // KV1, H2 // KV2
    B = Bv.reshape(KV2, dh2, KV1, dh1)
    if KV1 == KV2 and H1 == H2 and dh1 == dh2:
        # Unchanged head layout: query head (g, j) maps through B_v's
        # (g → g') block to query head (g', j), so Γ(I) = I.
        eye = torch.eye(G1, dtype=B.dtype, device=B.device)
        T = torch.einsum("adbe,jk->ajdbke", B, eye)
        return T.reshape(H2 * dh2, H1 * dh1)
    B = torch.repeat_interleave(B, G2, dim=0)       # query heads of large model
    B = torch.repeat_interleave(B, G1, dim=2) / G1  # average over small groups
    return B.reshape(H2 * dh2, H1 * dh1)


def resolve_expander(expr, width: Params, cfg1: ModelConfig,
                     cfg2: ModelConfig, role: str) -> Optional[torch.Tensor]:
    """Materialise an expander expression to a (d2, d1) matrix (or None)."""
    if expr is None:
        return None
    if isinstance(expr, str):
        if role == "in" and f"{expr}__in" in width:
            return width[f"{expr}__in"]
        return width[expr]
    kind = expr[0]
    if kind == "gamma":
        return gamma_expand(
            resolve_expander(expr[1], width, cfg1, cfg2, role), cfg1, cfg2)
    if kind == "seg":
        like = next(iter(width.values()))
        blocks = []
        for (sub, n1, n2) in expr[1]:
            if sub is None:
                if n1 != n2:
                    raise ValueError(f"identity segment must be square: "
                                     f"{n1} -> {n2}")
                blocks.append(torch.eye(n1, dtype=like.dtype,
                                        device=like.device))
            else:
                m = resolve_expander(sub, width, cfg1, cfg2, role)
                if tuple(m.shape) != (n2, n1):
                    raise ValueError(f"segment {sub!r} resolves to "
                                     f"{tuple(m.shape)}, want {(n2, n1)}")
                blocks.append(m)
        return torch.block_diag(*blocks)
    raise ValueError(expr)


def expand_leaf(W: torch.Tensor, E_in: Optional[torch.Tensor],
                E_out: Optional[torch.Tensor]) -> torch.Tensor:
    """Ω = E_in · W · E_outᵀ in the x@W convention; broadcast leading dims."""
    out = W
    if E_in is not None:
        out = torch.einsum("ia,...ab->...ib", E_in.to(W.dtype), out)
    if E_out is not None:
        out = torch.einsum("...ab,jb->...aj", out, E_out.to(W.dtype))
    return out


def expand_vector(v: torch.Tensor, E_out: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    if E_out is None:
        return v
    return torch.einsum("ja,...a->...j", E_out.to(v.dtype), v)


# ---------------------------------------------------------------------------
# Parameter-tree walking
# ---------------------------------------------------------------------------
def _flatten(d: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in d.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    out: Params = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def replicate_experts(stack: torch.Tensor, E: int) -> torch.Tensor:
    """Expert replication of a grown stack, (L2, a, b) -> (L2, E, a, b):
    coefficient-1 copies, so equally the squared (AdamW ``v``) operator.
    Each copy is whole, as a JAX array is a value: a stride-0 view would
    alias every expert under in-place updates and checkpoint writes."""
    return stack[:, None].expand(
        stack.shape[:1] + (E,) + stack.shape[1:]).clone()


def _kind_counts(cfg: ModelConfig) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for k in cfg.blocks:
        counts[k] = counts.get(k, 0) + 1
    return counts


# ---------------------------------------------------------------------------
# LiGO params: init
# ---------------------------------------------------------------------------
def _expand_init(gen: torch.Generator, d2: int, d1: int, noise: float,
                 device: torch.device) -> torch.Tensor:
    """[I; random-row-copies] + noise — a Net2Net-flavoured starting point.

    For shrinking spaces (d2 < d1) the start point is the truncated identity
    [I 0] — keep the first d2 features.
    """
    eye = torch.eye(d2, d1, device=device)
    if d2 > d1:
        src = torch.randint(0, d1, (d2 - d1,), generator=gen, device=device)
        eye = torch.cat([torch.eye(d1, device=device),
                         torch.nn.functional.one_hot(src, d1).float()], dim=0)
    return eye + noise * torch.randn((d2, d1), generator=gen, device=device)


def stack_pattern(L2: int, L1: int, device=None) -> torch.Tensor:
    """StackBERT: layer l₂ copies layer l₂ mod L₁ (paper Eq. 1)."""
    idx = torch.arange(L2, device=device) % L1
    return torch.nn.functional.one_hot(idx, L1).float()


def interp_pattern(L2: int, L1: int, device=None) -> torch.Tensor:
    """Interpolation: layer l₂ copies layer ⌊l₂·L₁/L₂⌋ (paper Eq. 1)."""
    idx = torch.arange(L2, device=device) * L1 // L2
    return torch.nn.functional.one_hot(idx, L1).float()


def init_ligo_params(gen: torch.Generator, cfg1: ModelConfig,
                     cfg2: ModelConfig, *, device="cuda",
                     depth_init: str = "stack", noise: float = 0.01) -> Params:
    """Learnable LiGO parameters: width expanders + per-module depth blends.

    Random draws come from ``gen``, which must live on ``device``.
    """
    dev = resolve_device(device)
    S.check_growable(cfg1, cfg2)
    d1s, d2s = S.width_dims(cfg1), S.width_dims(cfg2)
    width = {name: _expand_init(gen, d2s[name], d1s[name], noise, dev)
             for name in sorted(d2s)}
    pattern = stack_pattern if depth_init == "stack" else interp_pattern
    c1, c2 = _kind_counts(cfg1), _kind_counts(cfg2)
    hop = S.family_hop(cfg1, cfg2)
    kmap = hop["kind_map"] if hop else {}
    # depth blends are keyed by SOURCE kind; on a family-changing hop the
    # target layer count lives under the mapped kind
    depth = {kind: {leaf: pattern(c2[kmap.get(kind, kind)], c1[kind], dev)
                    for leaf in S.layer_spec(kind, cfg1, cfg2)}
             for kind in c1}
    return {"width": width, "depth": depth}


def count_ligo_params(ligo: Params) -> int:
    return sum(int(x.numel()) for x in tree_leaves(ligo))


# ---------------------------------------------------------------------------
# Apply: Θ_large = M(Θ_small)
# ---------------------------------------------------------------------------
def apply_ligo(ligo: Params, small: Params, cfg1: ModelConfig,
               cfg2: ModelConfig, *, engine: str = "plan",
               use_kernel: Optional[bool] = None,
               square: bool = False) -> Params:
    """Grow a small model's parameter tree into the large architecture.

    ``engine="plan"`` routes through the :class:`GrowthPlan` (expanders
    resolved once, leaves batched by family/shape/expander pair, kernel K1
    for eligible groups on CUDA tensors); ``engine="legacy"`` is the per-leaf
    einsum walk, the correctness oracle. ``square=True`` applies the
    elementwise-squared operator (the AdamW second-moment map).
    """
    if engine == "plan":
        from repro_torch.core.plan import plan_for
        return plan_for(cfg1, cfg2, small).apply(
            ligo, small, use_kernel=use_kernel, square=square)
    if engine != "legacy":
        raise ValueError(f"unknown growth engine {engine!r}")
    width = ligo["width"]
    top = S.top_spec()
    out_layers: Params = {}
    hop = S.family_hop(cfg1, cfg2)
    kmap = hop["kind_map"] if hop else {}
    renames = hop["renames"] if hop else {}
    bcast = hop["broadcast"] if hop else {}
    created = hop["created"] if hop else {}
    c2 = _kind_counts(cfg2)

    def _sq(E):
        return None if E is None else E * E

    for kind, stack in small["layers"].items():
        lspec = S.layer_spec(kind, cfg1, cfg2)
        grown: Dict[str, torch.Tensor] = {}
        stacked = kind != "shared_attn"
        for path, W in _flatten(stack).items():
            in_e, out_e = lspec[path]
            E_in = resolve_expander(in_e, width, cfg1, cfg2, "in")
            E_out = resolve_expander(out_e, width, cfg1, cfg2, "out")
            if square:
                E_in, E_out = _sq(E_in), _sq(E_out)
            vec = W.dim() == (2 if stacked else 1)
            wide = (expand_vector(W, E_out) if vec
                    else expand_leaf(W, E_in, E_out))
            if stacked and kind in ligo["depth"]:
                blend = ligo["depth"][kind][path]
                if square:
                    blend = blend * blend
                wide = torch.einsum("kl,l...->k...", blend.to(wide.dtype),
                                    wide)
            dst = renames.get(path, path)
            grown[dst] = (replicate_experts(wide, bcast[dst]) if dst in bcast
                          else wide)
        tgt_kind = kmap.get(kind, kind)
        for cpath, (shape, dt) in created.get(tgt_kind, {}).items():
            grown[cpath] = torch.zeros((c2[tgt_kind],) + tuple(shape),
                                       dtype=getattr(torch, dt),
                                       device=W.device)
        out_layers[tgt_kind] = _unflatten(grown)

    out: Params = {"layers": out_layers}
    flat_top = _flatten({k: v for k, v in small.items() if k != "layers"})
    grown_top: Dict[str, torch.Tensor] = {}
    for path, W in flat_top.items():
        in_e, out_e = top[path]
        E_in = resolve_expander(in_e, width, cfg1, cfg2, "in")
        E_out = resolve_expander(out_e, width, cfg1, cfg2, "out")
        if square:
            E_in, E_out = _sq(E_in), _sq(E_out)
        if W.dim() == 1:
            grown_top[path] = expand_vector(W, E_out)
        else:
            grown_top[path] = expand_leaf(W, E_in, E_out)
    out.update(_unflatten(grown_top))
    return out
