"""KV-cache growth: migrate live decode state across an architecture hop
(the port of the JAX package's ``core/grow_cache.py``).

The serving engine's live hop (``repro_torch.serving``) swaps grown weights
in between two decode steps. In-flight sessions keep their per-slot K/V
caches, so the cache must be grown with the *same* operator as the weights
or the first post-hop attention read is garbage.

The rule falls out of the LiGO algebra: a cached key row is an activation
``k = x·Wk`` reshaped to ``(n_kv_heads, d_head)``. Growing ``Wk`` with the
out-expander ``E_k`` means the grown activation is ``k_big = E_k · k`` over
the flattened ``(KV·dh)`` axis, the GrowthPlan expander applied per cached
position, for every position at once:

    K_big[l, b, s] = E_k @ K[l, b, s].reshape(KV1*dh1)

Depth blends average *layers*; a blended cache only equals the grown
model's own prefill when the blend is the identity, so the in-place rule is
lossless exactly for LEMON-style zero-pad operators
(``operators.lemon_operator``). Everything else (learned LiGO, depth
growth) takes the universal fallback: re-prefill the session's token
history under the grown weights (the engine keeps the history for exactly
this reason), or, for a hop that only appends layers, replay the new layers
over the residual stream the engine kept.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.ligo import _flatten, resolve_expander


class CacheGrowthError(RuntimeError):
    """A decode state cannot be grown in place: re-prefill the session."""


def can_grow_cache(cfg1: ModelConfig, cfg2: ModelConfig) -> bool:
    """Static eligibility: families whose whole decode state is one stacked
    attention K/V cache, at an unchanged attention window (a changed window
    changes the cache budget)."""
    return (cfg1.family in ("dense", "moe", "vlm")
            and cfg2.family in ("dense", "moe", "vlm")
            and cfg1.window == cfg2.window)


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().cpu()


def _is_eye(w: torch.Tensor) -> bool:
    return (w.dim() == 2 and w.shape[0] == w.shape[1]
            and torch.equal(w, torch.eye(w.shape[0], dtype=w.dtype)))


def is_lossless_operator(ligo: Dict, cfg1: ModelConfig,
                         cfg2: ModelConfig) -> bool:
    """True iff ``ligo`` is a LEMON-style zero-pad operator, i.e. growing
    with it is bitwise function-preserving (see ``operators.lemon_operator``
    for why each condition is load-bearing). Reads the operator's values
    on the host, before any migration work is launched."""
    if (cfg1.d_model != cfg2.d_model or cfg1.d_head != cfg2.d_head
            or cfg1.n_layers != cfg2.n_layers):
        return False
    # an unchanged head layout is always eligible (gamma_expand is exactly
    # the identity there); a changed one only when both sides are MHA, since
    # wo's grouped in-expander averages query heads within a kv group
    layout_same = (cfg1.n_heads == cfg2.n_heads
                   and cfg1.n_kv_heads == cfg2.n_kv_heads)
    if not layout_same and not (cfg1.n_heads == cfg1.n_kv_heads
                                and cfg2.n_heads == cfg2.n_kv_heads):
        return False
    for E in _flatten(ligo.get("width", {})).values():
        E = _host(E)
        if E.dim() != 2:
            return False
        d2, d1 = E.shape
        if not torch.equal(E[:d1], torch.eye(d1, dtype=E.dtype)):
            return False
        if d2 > d1 and bool(E[d1:].any()):
            return False
    for leaves in ligo.get("depth", {}).values():
        for w in leaves.values():
            if not _is_eye(_host(w)):
                return False
    return True


def kv_cache_expanders(ligo: Dict, cfg1: ModelConfig, cfg2: ModelConfig):
    """The (KV2·dh2, KV1·dh1) out-expanders for cached K and V, the same
    matrices the GrowthPlan applies to ``wk``/``wv`` columns."""
    width = ligo["width"]
    E_k = resolve_expander("k", width, cfg1, cfg2, "out")
    E_v = resolve_expander("v", width, cfg1, cfg2, "out")
    return E_k, E_v


def _expand_kv(C: torch.Tensor, E: torch.Tensor,
               cfg2: ModelConfig) -> torch.Tensor:
    """Apply a flat-kv-space expander per cached position:
    (lead, KV1, dh1) → (lead, KV2, dh2)."""
    lead = C.shape[:-2]
    flat = C.reshape(lead + (-1,)).float()
    out = torch.einsum("...i,oi->...o", flat, E.to(C.device, torch.float32))
    return out.to(C.dtype).reshape(lead + (cfg2.n_kv_heads, cfg2.d_head))


def grow_attn_caches(caches: Dict[str, torch.Tensor], ligo: Dict,
                     cfg1: ModelConfig, cfg2: ModelConfig, *,
                     depth: str = "strict") -> Dict[str, torch.Tensor]:
    """Grow a stacked attention cache ``{"k","v"}: (L1, ..., KV1, dh1)`` to
    the big architecture. ``depth="strict"`` (the serving default) refuses
    non-identity depth blends: a blended cache is an approximation, and the
    engine's re-prefill fallback is exact. ``depth="blend"`` applies the
    operator's ``wk``/``wv`` layer blends anyway."""
    E_k, E_v = kv_cache_expanders(ligo, cfg1, cfg2)
    kind = cfg1.blocks[0]
    dwk = ligo["depth"][kind]["wk"]
    dwv = ligo["depth"][kind]["wv"]
    identity = (cfg1.n_layers == cfg2.n_layers and _is_eye(_host(dwk))
                and _is_eye(_host(dwv)))
    if not identity and depth != "blend":
        raise CacheGrowthError(
            "non-identity depth blend is not lossless for cached "
            "activations; re-prefill the session history instead")
    k = _expand_kv(caches["k"], E_k, cfg2)
    v = _expand_kv(caches["v"], E_v, cfg2)
    if not identity:
        k = torch.einsum("kl,l...->k...", dwk.to(k.device, torch.float32),
                         k.float()).to(k.dtype)
        v = torch.einsum("kl,l...->k...", dwv.to(v.device, torch.float32),
                         v.float()).to(v.dtype)
    return {"k": k, "v": v}


def grow_decode_state(state: Dict[str, Any], ligo: Dict, cfg1: ModelConfig,
                      cfg2: ModelConfig, *,
                      depth: str = "strict") -> Dict[str, Any]:
    """Grow a live decode state in place of a re-prefill (into new tensors:
    the old state is left as it was). Raises :class:`CacheGrowthError`
    whenever the in-place rule does not apply; callers treat that as
    "re-prefill this session".

    Paged states (a ``"pages"`` entry; ``serving.kv_pages``) grow
    *per-block*: the expander applies position-wise, so the block pool
    ``(L, n_blocks + 1, bs, KV1, dh1)`` grows exactly like a dense row and
    the page table rides through untouched."""
    if not can_grow_cache(cfg1, cfg2):
        raise CacheGrowthError(
            f"family {cfg1.family!r} (window={cfg1.window}->{cfg2.window}): "
            "no in-place cache growth rule; re-prefill")
    new_state = {"caches": grow_attn_caches(state["caches"], ligo, cfg1,
                                            cfg2, depth=depth),
                 "pos": state["pos"]}
    if "pages" in state:
        new_state["pages"] = state["pages"]
    return new_state


# ---------------------------------------------------------------------------
# Depth-replay fast path
# ---------------------------------------------------------------------------
def depth_replay_plan(ligo: Dict, cfg1: ModelConfig,
                      cfg2: ModelConfig) -> Optional[int]:
    """If the hop only *appends* layers (width untouched, every depth matrix
    carrying the old layers unchanged at the bottom of the grown stack:
    identity first-L1 rows, as StackBERT's ``stack_pattern`` has), the old
    layers' caches are already exact for the grown model and only the new
    layers need K/V. Returns the preserved-prefix length (``cfg1.n_layers``),
    or None when the plan does not apply. Reads the operator on the host."""
    if not (cfg1.family in ("dense", "moe", "vlm")
            and cfg2.family == cfg1.family
            and cfg1.window == 0 and cfg2.window == 0
            and cfg2.n_layers > cfg1.n_layers
            and cfg1.blocks[0] == cfg2.blocks[0]):
        return None
    if (cfg1.d_model, cfg1.n_heads, cfg1.n_kv_heads, cfg1.d_head,
            cfg1.d_ff, cfg1.moe_d_ff) != (
            cfg2.d_model, cfg2.n_heads, cfg2.n_kv_heads, cfg2.d_head,
            cfg2.d_ff, cfg2.moe_d_ff):
        return None
    for E in _flatten(ligo.get("width", {})).values():
        if not _is_eye(_host(E)):
            return None
    L1, L2 = cfg1.n_layers, cfg2.n_layers
    eye = torch.eye(L1)
    for leaves in ligo.get("depth", {}).values():
        for w in leaves.values():
            w = _host(w)
            if tuple(w.shape) != (L2, L1) or not torch.equal(
                    w[:L1], eye.to(w.dtype)):
                return None
    return L1


def replay_grow_state(state: Dict[str, Any], params2, cfg1: ModelConfig,
                      cfg2: ModelConfig, resid, *,
                      use_kernel: Optional[bool] = None) -> Dict[str, Any]:
    """Migrate a decode state across a depth-only hop by replaying *only
    the new layers* over the preserved residual stream.

    ``resid``: (slots, cap, D), the pre-final-norm residual stream the
    engine recorded while serving the old model (positions beyond each
    slot's own length are garbage, exactly like cache padding: masked until
    overwritten). Because the hop keeps the old layers verbatim at the
    bottom of the stack, this stream *is* the input the appended layers see
    during the grown model's own prefill, so one forward through the
    ``L2-L1`` new layers rebuilds their caches. ``use_kernel`` picks their
    attention route as in ``models.layers.full_attention``.

    Old-layer caches are reused as they are (width untouched, so the same
    (KV, dh)), for both the dense rows and the paged block pools.
    """
    from repro_torch.models.layers import paged_targets
    from repro_torch.models.model import DTYPES, _apply_layer, _index
    old_k = state["caches"]["k"]
    h = torch.as_tensor(np.asarray(resid)).to(old_k.device,
                                               DTYPES[cfg2.dtype])
    cap = h.shape[1]
    positions = torch.arange(cap, device=h.device)[None]
    p_stack = params2["layers"][cfg2.blocks[0]]
    rows_k, rows_v = [], []
    for l in range(cfg1.n_layers, cfg2.n_layers):
        h, nc, _ = _apply_layer(_index(p_stack, l), h, cfg2, positions,
                                mode="prefill", use_kernel=use_kernel)
        rows_k.append(nc["k"])
        rows_v.append(nc["v"])
    new_k = torch.stack(rows_k)                 # (L_new, slots, cap, KV, dh)
    new_v = torch.stack(rows_v)
    if "pages" in state:
        table = state["pages"]                  # (slots, P)
        n_pool, bs = old_k.shape[1:3]
        tgt = paged_targets(table, n_pool)

        def rows_to_pool(rows):
            L_new, slots = rows.shape[:2]
            blocks = rows.reshape(L_new, slots, cap // bs, bs,
                                  *rows.shape[3:])
            pool = rows.new_zeros((L_new, n_pool, bs) + rows.shape[3:])
            pool[:, tgt] = blocks
            return pool

        new_k, new_v = rows_to_pool(new_k), rows_to_pool(new_v)
    new_state = {"caches": {
        "k": torch.cat([old_k, new_k.to(old_k.dtype)], 0),
        "v": torch.cat([state["caches"]["v"],
                        new_v.to(state["caches"]["v"].dtype)], 0)},
        "pos": state["pos"]}
    if "pages" in state:
        new_state["pages"] = state["pages"]
    return new_state
