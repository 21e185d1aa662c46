"""Classical growth operators as special cases of LiGO (paper Prop. 1,
App. A), the twin of the JAX package's ``core/operators.py``.

Each constructor returns a LiGO operator tree; ``apply_ligo`` on it is the
classical operator: StackBERT and Interpolation (depth patterns, with
unnormalised direct-copy width when the widths differ), Net2Net (selection
width with count-normalised fan-in) and bert2BERT-FPI (Net2Net width with
the StackBERT depth pattern). Random selections come from a
``torch.Generator``, so they differ from the JAX package's draws for the
same seed; their structure is the same. The LEMON operator (zero-padded
identity) and the MHA→GQA merge operator (group means of the K/V heads)
are deterministic and match the JAX package's exactly.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import spec as S
from repro_torch.core.ligo import _kind_counts, interp_pattern, stack_pattern
from repro_torch.device import resolve_device


def _generator(gen: Optional[torch.Generator], device) -> torch.Generator:
    return gen if gen is not None else torch.Generator(
        device=device).manual_seed(0)


def _identity_width(cfg1: ModelConfig, cfg2: ModelConfig, device) -> Dict:
    d1s, d2s = S.width_dims(cfg1), S.width_dims(cfg2)
    if d1s != d2s:
        raise ValueError("identity width needs equal dims (depth-only growth)")
    return {n: torch.eye(d, device=device) for n, d in d1s.items()}


def _depth(cfg1: ModelConfig, cfg2: ModelConfig, pattern, device) -> Dict:
    """Depth blends keyed by source kind and source leaf; on a
    family-changing hop the target count lives under the mapped kind."""
    c1, c2 = _kind_counts(cfg1), _kind_counts(cfg2)
    hop = S.family_hop(cfg1, cfg2)
    kmap = hop["kind_map"] if hop else {}
    return {kind: {leaf: pattern(c2[kmap.get(kind, kind)], c1[kind], device)
                   for leaf in S.layer_spec(kind, cfg1, cfg2)}
            for kind in c1}


def _selection(gen: torch.Generator, d2: int, d1: int, *, block: int = 1,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selection expander ``[I; S]`` and its count-normalised (in-role)
    version; ``block`` copies whole groups (d_head for head-aligned
    copying, which function preservation through attention needs)."""
    if d2 % block or d1 % block:
        raise ValueError(f"dims {d2}, {d1} are not multiples of {block}")
    n1, n2 = d1 // block, d2 // block
    src = torch.randint(0, n1, (n2 - n1,), generator=gen, device=device)
    units = torch.cat([torch.arange(n1, device=device), src])      # (n2,)
    B_units = torch.nn.functional.one_hot(units, n1).float()      # (n2, n1)
    counts = B_units.sum(dim=0)                                   # copies
    eye = torch.eye(block, device=device)
    return (torch.kron(B_units, eye),
            torch.kron(B_units / counts[None, :], eye))


def _copy_width(gen, cfg1: ModelConfig, cfg2: ModelConfig, normalized: bool,
                device) -> Dict:
    """Selection-copy width expanders (direct copy); with ``normalized``
    fan-in they become Net2Net/FPI (stored untied as ``<name>__in``)."""
    d1s, d2s = S.width_dims(cfg1), S.width_dims(cfg2)
    width = {}
    for name in sorted(d2s):
        if name in ("q", "k", "v") and cfg1.d_head != cfg2.d_head:
            raise ValueError("selection copying needs equal d_head")
        block = cfg1.d_head if name in ("q", "k", "v") else 1
        B, B_norm = _selection(gen, d2s[name], d1s[name], block=block,
                               device=device)
        width[name] = B
        width[f"{name}__in"] = B_norm if normalized else B
    return width


def _pattern_operator(cfg1, cfg2, gen, device, pattern) -> Dict:
    dev = resolve_device(device)
    if S.width_dims(cfg1) == S.width_dims(cfg2):
        width = _identity_width(cfg1, cfg2, dev)
    else:
        width = _copy_width(_generator(gen, dev), cfg1, cfg2, False, dev)
    return {"width": width, "depth": _depth(cfg1, cfg2, pattern, dev)}


def stackbert_operator(cfg1: ModelConfig, cfg2: ModelConfig,
                       gen: Optional[torch.Generator] = None, *,
                       device="cuda") -> Dict:
    """Depth growth by block duplication (Gong et al. 2019), Eq. 1; a wider
    target gets unnormalised direct-copy width."""
    return _pattern_operator(cfg1, cfg2, gen, device, stack_pattern)


def interpolation_operator(cfg1: ModelConfig, cfg2: ModelConfig,
                           gen: Optional[torch.Generator] = None, *,
                           device="cuda") -> Dict:
    """Depth growth by layer interleaving (Chang et al. 2017), Eq. 1."""
    return _pattern_operator(cfg1, cfg2, gen, device, interp_pattern)


def net2net_operator(gen: Optional[torch.Generator], cfg1: ModelConfig,
                     cfg2: ModelConfig, *, depth: Optional[str] = None,
                     device="cuda") -> Dict:
    """Width growth by neuron duplication with normalised fan-in (Net2Net,
    App. A Eq. 11-12); ``depth="stack"`` or ``"interp"`` adds a depth
    pattern (bert2BERT-style FPI), else each layer keeps its own."""
    dev = resolve_device(device)
    width = _copy_width(_generator(gen, dev), cfg1, cfg2, True, dev)
    if depth is None:
        def pattern(L2, L1, device):
            return torch.eye(L1, device=device)
    else:
        pattern = stack_pattern if depth == "stack" else interp_pattern
    return {"width": width, "depth": _depth(cfg1, cfg2, pattern, dev)}


def bert2bert_operator(gen: Optional[torch.Generator], cfg1: ModelConfig,
                       cfg2: ModelConfig, *, device="cuda") -> Dict:
    """bert2BERT (FPI): Net2Net width + StackBERT depth (Chen et al. 2021)."""
    return net2net_operator(gen, cfg1, cfg2, depth="stack", device=device)


def lemon_operator(cfg1: ModelConfig, cfg2: ModelConfig, *,
                   device="cuda") -> Dict:
    """LEMON-style lossless zero-pad expansion ``[I; 0]`` (Wang et al.
    2023): every width expander is the zero-padded identity, so new heads
    and neurons compute exactly 0 and the grown model is bitwise the same
    function.

    Losslessness needs equal ``d_model`` (norm denominators), equal
    ``d_head`` (RoPE and the 1/sqrt(d_head) scale act per head), equal
    ``n_layers`` (depth blends are the identity), and MHA on both sides
    when heads grow (under GQA ``wo``'s in-expander averages query heads
    within a kv group). Breaking any of them is an error.
    """
    S.check_growable(cfg1, cfg2)
    if cfg1.d_model != cfg2.d_model:
        raise ValueError("lemon_operator: d_model must match "
                         f"({cfg1.d_model} vs {cfg2.d_model}) — residual "
                         "widening changes norm denominators")
    if cfg1.d_head != cfg2.d_head:
        raise ValueError("lemon_operator: d_head must match "
                         f"({cfg1.d_head} vs {cfg2.d_head})")
    if cfg1.n_layers != cfg2.n_layers:
        raise ValueError("lemon_operator: depth growth is not lossless "
                         f"({cfg1.n_layers} vs {cfg2.n_layers} layers); "
                         "grow depth separately and re-prefill")
    heads_grow = (cfg1.n_heads != cfg2.n_heads
                  or cfg1.n_kv_heads != cfg2.n_kv_heads)
    if heads_grow and not (cfg1.n_heads == cfg1.n_kv_heads
                           and cfg2.n_heads == cfg2.n_kv_heads):
        raise ValueError("lemon_operator: head growth is lossless only for "
                         "MHA (n_kv_heads == n_heads on both sides)")
    dev = resolve_device(device)
    d1s, d2s = S.width_dims(cfg1), S.width_dims(cfg2)
    # eye(d2, d1) is [I; 0]: zero rows kill new out-features, zero in-rows
    # drop the (all-zero) new in-features
    width = {n: torch.eye(d2s[n], d1s[n], device=dev) for n in d2s}

    def identity(L2, L1, device):
        return torch.eye(L1, device=device)
    return {"width": width, "depth": _depth(cfg1, cfg2, identity, dev)}


def gqa_merge_operator(cfg1: ModelConfig, cfg2: ModelConfig, *,
                       device="cuda") -> Dict:
    """MHA→GQA head merging: each kv group's K/V heads become their mean.

    The k/v width expander is ``kron(M, I_dhead)`` where ``M`` is the
    (KV2, H1) group-mean matrix: row g averages the G = H1/KV2 source heads
    of group g. ``wo``'s in-expander then resolves through ``gamma_expand``
    (G1 = 1, so Γ block-repeats the kv rows over each group's query heads
    with no extra scaling), the grouped-gamma lift whose Σcᵢ² second-moment
    form :func:`repro_torch.optim.grow_adamw_state` carries the AdamW state
    through.

    Head merging is a compression (GQA, Ainslie et al. 2023), not a
    lossless expansion: queries keep their heads, keys and values are
    averaged per group. Everything outside the kv space is the identity.
    ``M`` is built in numpy, as the JAX package builds it, so the two
    operators are equal bit for bit.
    """
    S.check_growable(cfg1, cfg2)
    if cfg1.n_kv_heads != cfg1.n_heads:
        raise ValueError("gqa_merge_operator: source must be MHA "
                         f"(n_kv_heads {cfg1.n_kv_heads} != n_heads "
                         f"{cfg1.n_heads})")
    if cfg2.n_kv_heads >= cfg1.n_kv_heads:
        raise ValueError("gqa_merge_operator: target must merge kv heads "
                         f"({cfg1.n_kv_heads} -> {cfg2.n_kv_heads})")
    for field in ("d_model", "d_head", "n_heads", "n_layers", "d_ff"):
        v1, v2 = getattr(cfg1, field), getattr(cfg2, field)
        if v1 != v2:
            raise ValueError(f"gqa_merge_operator: {field} must match "
                             f"({v1} vs {v2}) — only kv heads merge")
    if cfg1.n_heads % cfg2.n_kv_heads:
        raise ValueError(f"gqa_merge_operator: n_heads {cfg1.n_heads} not "
                         f"divisible by target kv heads {cfg2.n_kv_heads}")
    dev = resolve_device(device)
    KV2, H1, dh = cfg2.n_kv_heads, cfg1.n_heads, cfg1.d_head
    G = H1 // KV2
    M = np.repeat(np.eye(KV2), G, axis=1) / G            # (KV2, H1) group mean
    kv = torch.as_tensor(np.kron(M, np.eye(dh)), dtype=torch.float32,
                         device=dev)                     # (KV2·dh, H1·dh)
    d1s, d2s = S.width_dims(cfg1), S.width_dims(cfg2)
    width = {n: (kv if n in ("k", "v")
                 else torch.eye(d2s[n], d1s[n], device=dev)) for n in d2s}

    def identity(L2, L1, device):
        return torch.eye(L1, device=device)
    return {"width": width, "depth": _depth(cfg1, cfg2, identity, dev)}


def direct_depth_map(stack_params, pattern_idx) -> Dict:
    """``new_stack[i] = stack[pattern_idx[i]]``: direct layer rearrangement
    (the oracle of the Prop.-1 equality tests)."""
    def take(a):
        return a[torch.as_tensor(pattern_idx, dtype=torch.long,
                                 device=a.device)]
    if isinstance(stack_params, dict):
        return {k: direct_depth_map(v, pattern_idx)
                for k, v in stack_params.items()}
    return take(stack_params)
