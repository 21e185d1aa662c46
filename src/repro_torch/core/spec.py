"""LiGO expansion specs: which expander grows which tensor axis.

The paper's tying scheme (§3.3, Alg. 1) assigns every transformer weight an
in-dimension expander ``A`` and out-dimension expander ``B``, most of them
tied to the embedding expander ``B_emb``:

    A^{Q,K,V} = B_emb,  A^O = Γ(B_v),  B^O = B_emb,
    A^{fc1} = B_emb,    A^{fc2} = B_fc1,  B^{fc2} = B_emb,
    norms / biases inherit their module's out-expander,
    tok-embedding out-dim and head in-dim grow with B_emb.

A spec entry is ``(in_expr, out_expr)`` where an expr is None (axis not
grown), a learnable width matrix by name ("emb", "q", "k", "v", "fc", ...),
``("gamma", "v")`` (GQA group-expanded value expander) or ``("seg", [(expr,
n1, n2), ...])`` (block-diagonal over column segments). Vectors use only
``out_expr``. A copy of the JAX package's rules for every block kind (the
dense attention and MoE families, xLSTM's mLSTM and sLSTM, Mamba2 and the
hybrid's shared attention block), and for the one cross-family hop
(dense→MoE upcycling, :func:`family_hop`). The sequence mixers' fused
projections grow block-diagonally (``"seg"``): one expander a segment,
``(None, N, N)`` for the Mamba2 state segments, which are not grown.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig

Expr = Any
Spec = Tuple[Expr, Expr]


def width_dims(cfg: ModelConfig) -> Dict[str, int]:
    """Dimension of each expander's space for a given config."""
    d = {
        "emb": cfg.d_model,
        "q": cfg.n_heads * cfg.d_head,
        "k": cfg.n_kv_heads * cfg.d_head,
        "v": cfg.n_kv_heads * cfg.d_head,
    }
    if cfg.d_ff > 0 or cfg.moe_d_ff > 0:
        d["fc"] = cfg.moe_d_ff if cfg.n_experts else cfg.d_ff
    if cfg.family in ("ssm", "hybrid"):
        d["inner"] = cfg.ssm_expand * cfg.d_model
    if cfg.family == "hybrid":
        d["mheads"] = cfg.mamba_heads
    if cfg.family == "ssm":
        d["xheads"] = cfg.n_heads
    return d


def _attn_spec(cfg1: ModelConfig) -> Dict[str, Spec]:
    s = {
        "ln1/scale": (None, "emb"), "ln1/bias": (None, "emb"),
        "ln2/scale": (None, "emb"), "ln2/bias": (None, "emb"),
        "wq": ("emb", "q"), "bq": (None, "q"),
        "wk": ("emb", "k"), "bk": (None, "k"),
        "wv": ("emb", "v"), "bv": (None, "v"),
        "wo": (("gamma", "v"), "emb"), "bo": (None, "emb"),
    }
    if cfg1.d_ff > 0:
        s.update({
            "mlp/w1": ("emb", "fc"), "mlp/b1": (None, "fc"),
            "mlp/w3": ("emb", "fc"),
            "mlp/w2": ("fc", "emb"), "mlp/b2": (None, "emb"),
        })
    return s


def _moe_spec(cfg1: ModelConfig) -> Dict[str, Spec]:
    s = _attn_spec(cfg1)
    s.update({
        "moe/router": ("emb", None),        # expert count is not grown
        "moe/w1": ("emb", "fc"),            # (E, D, F): E broadcast
        "moe/w3": ("emb", "fc"),
        "moe/w2": ("fc", "emb"),
    })
    return s


def _mlstm_spec(cfg1: ModelConfig, cfg2: ModelConfig) -> Dict[str, Spec]:
    di1, di2 = cfg1.ssm_expand * cfg1.d_model, cfg2.ssm_expand * cfg2.d_model
    H1, H2 = cfg1.n_heads, cfg2.n_heads
    return {
        "ln/scale": (None, "emb"), "ln/bias": (None, "emb"),
        "up": ("emb", ("seg", [("inner", di1, di2), ("inner", di1, di2)])),
        "conv": (None, "inner"),
        "wqkv": ("inner", ("seg", [("inner", di1, di2)] * 3)),
        "gates": ("inner", ("seg", [("xheads", H1, H2)] * 2)),
        "gates_b": (None, ("seg", [("xheads", H1, H2)] * 2)),
        "down": ("inner", "emb"),
    }


def _slstm_spec(cfg1: ModelConfig, cfg2: ModelConfig) -> Dict[str, Spec]:
    D1, D2 = cfg1.d_model, cfg2.d_model
    seg4 = ("seg", [("emb", D1, D2)] * 4)
    return {
        "ln/scale": (None, "emb"), "ln/bias": (None, "emb"),
        "w": ("emb", seg4), "r": ("emb", seg4), "b": (None, seg4),
        "out": ("emb", "emb"),
    }


def _mamba2_spec(cfg1: ModelConfig, cfg2: ModelConfig) -> Dict[str, Spec]:
    di1, di2 = cfg1.ssm_expand * cfg1.d_model, cfg2.ssm_expand * cfg2.d_model
    N = cfg1.ssm_state
    assert N == cfg2.ssm_state, "ssm_state is architectural; not grown"
    H1, H2 = cfg1.mamba_heads, cfg2.mamba_heads
    in_seg = ("seg", [("inner", di1, di2), ("inner", di1, di2),
                      (None, N, N), (None, N, N), ("mheads", H1, H2)])
    conv_seg = ("seg", [("inner", di1, di2), (None, N, N), (None, N, N)])
    return {
        "ln/scale": (None, "emb"), "ln/bias": (None, "emb"),
        "in_proj": ("emb", in_seg),
        "conv": (None, conv_seg),
        "A_log": (None, "mheads"), "Dskip": (None, "mheads"),
        "dt_bias": (None, "mheads"),
        "gn/scale": (None, "inner"),
        "out_proj": ("inner", "emb"),
    }


def layer_spec(kind: str, cfg1: ModelConfig, cfg2: ModelConfig
               ) -> Dict[str, Spec]:
    if kind in ("attn", "shared_attn"):
        return _attn_spec(cfg1)
    if kind == "moe":
        return _moe_spec(cfg1)
    if kind == "mlstm":
        return _mlstm_spec(cfg1, cfg2)
    if kind == "slstm":
        return _slstm_spec(cfg1, cfg2)
    if kind == "mamba2":
        return _mamba2_spec(cfg1, cfg2)
    raise KeyError(kind)


def top_spec() -> Dict[str, Spec]:
    """Specs for non-layer parameters."""
    return {
        "embed/tok": (None, "emb"),          # (V, D): vocab unchanged
        "embed/pos": (None, "emb"),
        "embed/mask_emb": (None, "emb"),
        "embed/cls": (None, "emb"),
        "final_norm/scale": (None, "emb"),
        "final_norm/bias": (None, "emb"),
        "head": ("emb", None),               # (D, V|C): classes unchanged
    }


# Family pairs with a structural growth rule; everything else cross-family is
# rejected at config-load time by check_growable.
ALLOWED_FAMILY_HOPS = (("dense", "moe"),)


def family_hop(cfg1: ModelConfig, cfg2: ModelConfig) -> Optional[Dict]:
    """Structural map of a family-changing hop, or None for same-family.

    ``kind_map`` (source stack kind → target kind), ``renames`` (source leaf
    path → target path), ``broadcast`` (target path → expert count, grown by
    coefficient-1 replication) and ``created`` (target kind → {path:
    (per-layer shape, dtype)} for leaves with no source, made as zeros).
    """
    if cfg1.family == cfg2.family:
        return None
    if (cfg1.family, cfg2.family) == ("dense", "moe"):
        E = cfg2.n_experts
        return {
            "kind_map": {"attn": "moe"},
            "renames": {"mlp/w1": "moe/w1", "mlp/w3": "moe/w3",
                        "mlp/w2": "moe/w2"},
            "broadcast": {"moe/w1": E, "moe/w3": E, "moe/w2": E},
            "created": {"moe": {"moe/router": ((cfg2.d_model, E),
                                               "float32")}},
        }
    return None


def check_growable(cfg1: ModelConfig, cfg2: ModelConfig) -> None:
    """Validate that ``cfg1`` can grow into ``cfg2``, with an error naming
    the pair, instead of a bare KeyError deep inside expander resolution."""
    def fail(msg: str) -> None:
        raise ValueError(
            f"cannot grow {cfg1.name!r} -> {cfg2.name!r}: {msg}")

    hop = family_hop(cfg1, cfg2)
    if cfg1.family != cfg2.family and hop is None:
        fail(f"family hop {cfg1.family!r} -> {cfg2.family!r} has no growth "
             f"rule; supported cross-family hops: "
             f"{[f'{a}->{b}' for a, b in ALLOWED_FAMILY_HOPS]} "
             "(dense→MoE upcycling)")
    kind_map = hop["kind_map"] if hop else {}
    mapped = tuple(kind_map.get(k, k) for k in cfg1.block_pattern)
    if mapped != tuple(cfg2.block_pattern):
        fail(f"block patterns do not map: {tuple(cfg1.block_pattern)} -> "
             f"{tuple(cfg2.block_pattern)}")
    if cfg1.vocab_size != cfg2.vocab_size:
        fail(f"vocab_size differs ({cfg1.vocab_size} vs {cfg2.vocab_size})")
    if cfg1.n_layers > cfg2.n_layers:
        fail(f"growth cannot shrink depth ({cfg1.n_layers} -> "
             f"{cfg2.n_layers} layers)")
    if cfg1.d_model > cfg2.d_model:
        fail(f"growth cannot shrink d_model ({cfg1.d_model} -> "
             f"{cfg2.d_model})")
    if cfg1.objective != cfg2.objective:
        fail(f"objective differs ({cfg1.objective!r} vs {cfg2.objective!r})")
    if cfg1.tie_embeddings != cfg2.tie_embeddings:
        fail("tie_embeddings differs")
    if cfg1.n_experts and cfg1.n_experts != cfg2.n_experts:
        fail(f"expert count is not grown ({cfg1.n_experts} vs "
             f"{cfg2.n_experts})")
    if hop is not None:
        # dense→MoE upcycling structural requirements
        if cfg1.d_ff <= 0:
            fail("upcycling needs a dense FFN to replicate into experts "
                 "(source d_ff == 0)")
        if cfg2.n_experts <= 0:
            fail("MoE target declares no experts")
        if cfg1.act != cfg2.act:
            fail(f"activation changes across the hop ({cfg1.act!r} -> "
                 f"{cfg2.act!r}); experts must compute the dense MLP")
        if cfg1.norm != cfg2.norm:
            fail(f"norm changes across the hop ({cfg1.norm!r} -> "
                 f"{cfg2.norm!r})")
        if cfg1.norm == "layer":
            fail("upcycling needs a bias-free (rms-norm) source — MoE "
                 "experts carry no biases to receive the dense MLP's")
    # Expander-space compatibility: every width space must exist on both sides.
    d1s, d2s = width_dims(cfg1), width_dims(cfg2)
    if set(d1s) != set(d2s):
        fail(f"width expander spaces differ: {sorted(d1s)} vs {sorted(d2s)}")
