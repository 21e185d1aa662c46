"""Config registry: the paper's models, the assigned architectures, and the
reductions derived from them.

The port's registry holds the paper models (``configs/paper_models.py``)
and the JAX package's assigned architectures of the dense family
(llama3-8b, phi4-mini-3.8b, starcoder2-7b, deepseek-coder-33b), the MoE
family (mixtral-8x7b, qwen3-moe-30b-a3b), the xLSTM family (xlstm-125m,
``family="ssm"``), the Mamba2 hybrid (zamba2-2.7b), the audio encoder
(hubert-xlarge) and the VLM backbone with M-RoPE (qwen2-vl-72b): all ten
of the JAX package's assigned architectures, each a copy of its config.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (deepseek_coder_33b, hubert_xlarge,
                                 llama3_8b, mixtral_8x7b, phi4_mini_3_8b,
                                 qwen2_vl_72b, qwen3_moe_30b_a3b,
                                 starcoder2_7b, xlstm_125m, zamba2_2_7b)
from repro_torch.configs.base import MOE, ModelConfig, TrainConfig
from repro_torch.configs.paper_models import GROWTH_PAIRS, PAPER_MODELS

ASSIGNED: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (hubert_xlarge, llama3_8b, phi4_mini_3_8b, starcoder2_7b,
              deepseek_coder_33b, mixtral_8x7b, qwen3_moe_30b_a3b, xlstm_125m,
              zamba2_2_7b, qwen2_vl_72b)
}

REGISTRY: Dict[str, ModelConfig] = {**ASSIGNED, **PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> List[str]:
    return sorted(ASSIGNED)


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (tiny dims, same structure)."""
    n_layers = max(2, 2 * len(cfg.block_pattern))
    return cfg.scaled(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_head=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=128,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_top_k=min(cfg.experts_top_k, 2) if cfg.experts_top_k else 0,
        moe_d_ff=64 if cfg.n_experts else 0,
        capacity_factor=8.0,   # no token dropping in smoke numerics tests
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        window=min(cfg.window, 32) if cfg.window else 0,
        shared_attn_every=2,
        frontend_dim=64 if cfg.frontend_dim else 0,
        num_patches=8 if cfg.num_patches else 0,
        mrope_sections=(2, 3, 3),
        dtype="float32",
        max_seq=256,
    )


def _mrope_for(d_head: int, base=(16, 24, 24)):
    half = d_head // 2
    t = max(1, half * base[0] // sum(base))
    h = (half - t) // 2
    return (t, h, half - t - h)


def grow_target(cfg: ModelConfig, *, layers_mult: int = 2,
                width_mult: float = 1.5) -> ModelConfig:
    """A valid larger same-family config (LiGO growth target) for any arch."""
    d_model = int(cfg.d_model * width_mult)
    d_head = int(cfg.d_head * width_mult)
    return cfg.scaled(
        name=cfg.name + "-grown",
        n_layers=cfg.n_layers * layers_mult,
        d_model=d_model,
        d_head=d_head,
        d_ff=0 if cfg.d_ff == 0 else int(cfg.d_ff * width_mult),
        moe_d_ff=int(cfg.moe_d_ff * width_mult) if cfg.n_experts else 0,
        mrope_sections=_mrope_for(d_head) if cfg.rope == "mrope"
        else cfg.mrope_sections,
    )


def moe_target(cfg: ModelConfig, *, n_experts: int = 4, top_k: int = 2,
               ff_mult: float = 1.0) -> ModelConfig:
    """The MoE twin of a dense config — the dense→MoE upcycling target.

    Same trunk (depth, width, head layout); the dense FFN becomes an
    ``n_experts``-way expert stack with ``moe_d_ff = d_ff * ff_mult``
    (``ff_mult >= 1`` keeps the upcycle lossless: extra expert columns are
    zero-padded). ``capacity_factor`` is inherited, so smoke sources (8.0)
    get drop-free MoE twins for exactness tests."""
    if cfg.family != "dense":
        raise ValueError(f"moe_target needs a dense source, got "
                         f"{cfg.family!r} ({cfg.name})")
    return cfg.scaled(
        name=cfg.name + "-moe",
        family="moe",
        block_pattern=(MOE,),
        n_experts=n_experts,
        experts_top_k=min(top_k, n_experts),
        moe_d_ff=int(cfg.d_ff * ff_mult),
        d_ff=0,
    )


def half_config(cfg: ModelConfig) -> ModelConfig:
    """The smaller pretrained source model for growing into ``cfg`` (the
    paper's setting: the source is roughly half depth / ~2/3 width)."""
    d_head = max(cfg.d_head // 2, 8)
    return cfg.scaled(
        name=cfg.name + "-half",
        n_layers=cfg.n_layers // 2,
        d_model=cfg.d_model // 2,
        d_head=d_head,
        d_ff=0 if cfg.d_ff == 0 else cfg.d_ff // 2,
        moe_d_ff=cfg.moe_d_ff // 2 if cfg.n_experts else 0,
        mrope_sections=_mrope_for(d_head) if cfg.rope == "mrope"
        else cfg.mrope_sections,
        shared_attn_every=cfg.shared_attn_every,
    )


__all__ = ["REGISTRY", "ASSIGNED", "PAPER_MODELS", "GROWTH_PAIRS",
           "ModelConfig", "TrainConfig", "get_config", "list_archs",
           "smoke_config", "grow_target", "moe_target", "half_config"]
