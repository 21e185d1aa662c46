"""The paper's own model families (Table 4) — growth sources and targets.

BERT-Small/Base/Large, RoBERTa-Small/Base, GPT2-Base/Medium/1.5B, DeiT-S/B,
CaiT-XS/S, exactly as the JAX package defines them.
"""
from repro_torch.configs.base import ATTN, ModelConfig

_COMMON_BERT = dict(
    family="dense", block_pattern=(ATTN,), encoder_only=True, causal=False,
    rope="learned", act="gelu", norm="layer", objective="mlm", max_seq=512,
)

BERT_SMALL = ModelConfig(name="bert-small", n_layers=6, d_model=512, n_heads=8,
                         n_kv_heads=8, d_ff=2048, vocab_size=30522, **_COMMON_BERT)
BERT_BASE = ModelConfig(name="bert-base", n_layers=12, d_model=768, n_heads=12,
                        n_kv_heads=12, d_ff=3072, vocab_size=30522, **_COMMON_BERT)
BERT_LARGE = ModelConfig(name="bert-large", n_layers=24, d_model=1024, n_heads=16,
                         n_kv_heads=16, d_ff=4096, vocab_size=30522, **_COMMON_BERT)

ROBERTA_SMALL = ModelConfig(name="roberta-small", n_layers=6, d_model=512, n_heads=8,
                            n_kv_heads=8, d_ff=2048, vocab_size=50265, **_COMMON_BERT)
ROBERTA_BASE = ModelConfig(name="roberta-base", n_layers=12, d_model=768, n_heads=12,
                           n_kv_heads=12, d_ff=3072, vocab_size=50265, **_COMMON_BERT)

_COMMON_GPT2 = dict(
    family="dense", block_pattern=(ATTN,), rope="learned", act="gelu",
    norm="layer", objective="clm", tie_embeddings=True, max_seq=1024,
)

GPT2_BASE = ModelConfig(name="gpt2-base", n_layers=12, d_model=768, n_heads=12,
                        n_kv_heads=12, d_ff=3072, vocab_size=50257, **_COMMON_GPT2)
GPT2_MEDIUM = ModelConfig(name="gpt2-medium", n_layers=24, d_model=1024, n_heads=16,
                          n_kv_heads=16, d_ff=4096, vocab_size=50257, **_COMMON_GPT2)
GPT2_XL = ModelConfig(name="gpt2-1.5b", n_layers=48, d_model=1600, n_heads=25,
                      n_kv_heads=25, d_ff=6400, vocab_size=50257, **_COMMON_GPT2)

_COMMON_DEIT = dict(
    family="vision", block_pattern=(ATTN,), encoder_only=True, causal=False,
    rope="learned", act="gelu", norm="layer", objective="cls", modality="vision",
    num_patches=197, max_seq=256,   # 224/16 = 14x14 patches + cls token
)

DEIT_S = ModelConfig(name="deit-s", n_layers=12, d_model=384, n_heads=6,
                     n_kv_heads=6, d_ff=1536, vocab_size=1000, **_COMMON_DEIT)
DEIT_B = ModelConfig(name="deit-b", n_layers=12, d_model=768, n_heads=12,
                     n_kv_heads=12, d_ff=3072, vocab_size=1000, **_COMMON_DEIT)
CAIT_XS = ModelConfig(name="cait-xs", n_layers=24, d_model=288, n_heads=6,
                      n_kv_heads=6, d_ff=1152, vocab_size=1000, **_COMMON_DEIT)
CAIT_S = ModelConfig(name="cait-s", n_layers=24, d_model=384, n_heads=8,
                     n_kv_heads=8, d_ff=1536, vocab_size=1000, **_COMMON_DEIT)

# Growth pairs studied in the paper (Fig. 2/3/4, App. C)
GROWTH_PAIRS = {
    "bert-small->bert-base": (BERT_SMALL, BERT_BASE),
    "bert-small->bert-large": (BERT_SMALL, BERT_LARGE),
    "bert-base->bert-large": (BERT_BASE, BERT_LARGE),
    "roberta-small->roberta-base": (ROBERTA_SMALL, ROBERTA_BASE),
    "gpt2-base->gpt2-medium": (GPT2_BASE, GPT2_MEDIUM),
    "gpt2-medium->gpt2-1.5b": (GPT2_MEDIUM, GPT2_XL),
    "deit-s->deit-b": (DEIT_S, DEIT_B),
    "cait-xs->cait-s": (CAIT_XS, CAIT_S),
}

PAPER_MODELS = {m.name: m for m in [
    BERT_SMALL, BERT_BASE, BERT_LARGE, ROBERTA_SMALL, ROBERTA_BASE,
    GPT2_BASE, GPT2_MEDIUM, GPT2_XL, DEIT_S, DEIT_B, CAIT_XS, CAIT_S,
]}
