"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE, dynamic resolution [arXiv:2409.12191; hf]. The vision tower is a STUB:
``dummy_batch`` provides precomputed patch embeddings (already merged to d_model)
plus 3-channel (t, h, w) M-RoPE position ids; the backbone is the transformer here.
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    block_pattern=(ATTN,),
    rope="mrope",
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    act="swiglu",
    norm="rms",
    modality="vlm",
    frontend_dim=8192,
    num_patches=256,
    max_seq=524288,
)
