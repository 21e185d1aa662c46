"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.

GQA, RoPE [arXiv:2402.19173; hf]. GeLU MLP + LayerNorm (starcoder2 lineage).
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    block_pattern=(ATTN,),
    rope="rope",
    rope_theta=1000000.0,
    act="gelu",
    norm="layer",
    max_seq=524288,
)
