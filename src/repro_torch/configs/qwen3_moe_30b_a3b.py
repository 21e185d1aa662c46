"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) per-expert d_ff=768.

128 experts top-8, vocab=151936 [hf:Qwen/Qwen3-30B-A3B; hf]. d_head=128 (decoupled
from d_model/n_heads, per the HF config).
"""
from repro_torch.configs.base import MOE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=768,
    vocab_size=151936,
    block_pattern=(MOE,),
    n_experts=128,
    experts_top_k=8,
    moe_d_ff=768,
    rope="rope",
    rope_theta=1000000.0,
    act="swiglu",
    norm="rms",
    max_seq=524288,
)
