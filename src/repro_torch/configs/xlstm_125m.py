"""xlstm-125m [ssm] — 12L d_model=768 4H (kv=4) d_ff=0 vocab=50304.

sLSTM + mLSTM blocks, alternating [arXiv:2405.04517; unverified]. d_ff=0: xLSTM
blocks carry their own up/down projections; there is no separate FFN.
Recurrent state => sub-quadratic => long_500k decode is runnable.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=(MLSTM, SLSTM),
    rope="none",
    act="gelu",
    norm="layer",
    ssm_expand=2,
    max_seq=524288,
)
