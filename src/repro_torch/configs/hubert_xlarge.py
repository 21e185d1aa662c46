"""hubert-xlarge [audio] — encoder-only transformer backbone.

48L d_model=1280 16H (GQA kv=16) d_ff=5120 vocab=504 [arXiv:2106.07447; unverified].
The conv waveform frontend is a STUB: ``dummy_batch`` provides precomputed frame
embeddings; the backbone predicts masked-frame cluster targets (504 classes).
"""
from repro_torch.configs.base import ATTN, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(ATTN,),
    encoder_only=True,
    causal=False,
    rope="none",
    act="gelu",
    norm="layer",
    modality="audio",
    frontend_dim=1280,
    objective="mlm",
    max_seq=32768,
)
