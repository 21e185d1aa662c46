"""phi4-mini-3.8b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.

RoPE SwiGLU GQA [arXiv:2412.08905; hf]. Tied embeddings.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    block_pattern=(ATTN,),
    rope="rope",
    rope_theta=10000.0,
    act="swiglu",
    norm="rms",
    tie_embeddings=True,
    max_seq=524288,
)
