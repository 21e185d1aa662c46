"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240 ssm_state=64.

Mamba2 backbone + shared attention blocks [arXiv:2411.15242; hf]. A single shared
(parameter-tied) attention+MLP block is interleaved every ``shared_attn_every``
Mamba2 layers. Constant-size SSM state => long_500k decode is runnable.
"""
from repro_torch.configs.base import MAMBA2, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=(MAMBA2,),
    ssm_state=64,
    ssm_expand=2,
    conv_kernel=4,
    shared_attn_every=6,
    rope="rope",
    rope_theta=10000.0,
    act="gelu",
    norm="rms",
    max_seq=524288,
)
