"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.

MoE 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf].
SWA (window=4096) makes the arch sub-quadratic => long_500k decode is runnable.
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=(MOE,),
    n_experts=8,
    experts_top_k=2,
    moe_d_ff=14336,
    window=4096,
    rope="rope",
    rope_theta=1000000.0,
    act="swiglu",
    norm="rms",
    max_seq=524288,
)
