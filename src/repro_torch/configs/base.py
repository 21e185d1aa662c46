"""Model configuration dataclass (stdlib only).

A field-for-field copy of the JAX package's ``ModelConfig``: configs are
plain frozen dataclasses, so they hash (the growth-plan cache keys on them),
serialise and diff the same in both packages. The parity tests hold every
registry entry equal to the JAX one. ``TrainConfig`` is the JAX package's
driver-level training configuration, field for field.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Optional, Tuple


# Block kinds understood by repro_torch.models.model
ATTN = "attn"          # (GQA) attention + MLP residual block
MOE = "moe"            # attention + mixture-of-experts block
MLSTM = "mlstm"        # xLSTM matrix-memory block
SLSTM = "slstm"        # xLSTM scalar-memory block
MAMBA2 = "mamba2"      # Mamba2 SSD block
SHARED_ATTN = "shared_attn"  # Zamba2-style shared (parameter-tied) attention block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio | vision
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- head geometry ---
    d_head: Optional[int] = None     # default d_model // n_heads

    # --- block structure ---
    block_pattern: Tuple[str, ...] = (ATTN,)   # tiled over n_layers
    encoder_only: bool = False       # bidirectional attention, no decode step
    causal: bool = True

    # --- MoE ---
    n_experts: int = 0
    experts_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (0 => use d_ff)
    capacity_factor: float = 1.25    # MoE token-dropping capacity
    moe_dispatch_shard: str = "model"  # model | model_data (EP buffer layout)
    moe_weight_gather: bool = False  # FSDP storage + TP compute
    moe_impl: str = "dense"          # dense | shard_map (explicit a2a MoE)

    # --- SSM / xLSTM ---
    ssm_state: int = 0               # Mamba2 N (state dim per head)
    ssm_heads: int = 0               # Mamba2 heads (0 => derived)
    ssm_expand: int = 2              # inner expansion for mamba2
    conv_kernel: int = 4
    shared_attn_every: int = 6       # Zamba2: insert shared attn block every k layers

    # --- attention details ---
    window: int = 0                  # sliding-window size (0 => full attention)
    rope: str = "rope"               # rope | mrope | none | learned
    rope_theta: float = 500000.0
    mrope_sections: Tuple[int, ...] = (16, 24, 24)   # qwen2-vl (t, h, w) half-dims

    # --- MLP / norm ---
    act: str = "swiglu"              # swiglu | gelu
    norm: str = "rms"                # rms | layer
    tie_embeddings: bool = False

    # --- modality frontends ---
    modality: str = "text"           # text | audio | vlm | vision
    frontend_dim: int = 0            # dim of precomputed frame/patch embeddings
    num_patches: int = 0             # vision: patches per image

    # --- numerics ---
    dtype: str = "bfloat16"          # activation / param dtype for full-scale runs
    max_seq: int = 8192

    # --- objective ---
    objective: str = "clm"           # clm | mlm (encoder) | cls (vision)

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_experts and not self.moe_d_ff:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    # ------------------------------------------------------------------
    @property
    def blocks(self) -> Tuple[str, ...]:
        """Per-layer block kinds, tiling block_pattern over n_layers."""
        pat = self.block_pattern
        reps = (self.n_layers + len(pat) - 1) // len(pat)
        return tuple((pat * reps)[: self.n_layers])

    @property
    def q_dim(self) -> int:
        """Query width ``n_heads · d_head``; not ``d_model`` where the head
        size is decoupled (qwen3-moe: 32 · 128 = 4096 against 2048)."""
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch supports O(T·w)/O(T) attention for long context."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window > 0

    def param_count(self) -> int:
        """Exact parameter count (mirrors models.init_params leaf-for-leaf)."""
        D, H, KV, dh, F, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.d_head, self.d_ff, self.vocab_size, self.n_layers)
        bias = self.norm == "layer"
        norm_p = 2 * D if self.norm == "layer" else D     # scale (+ bias)
        total = 0
        if self.modality not in ("audio", "vision"):
            total += V * D                                # tok embedding
        if self.modality == "audio":
            total += D                                    # mask_emb
        if self.modality == "vision":
            total += D                                    # cls token
        if self.rope == "learned":
            total += self.max_seq * D                     # pos table
        total += norm_p                                   # final norm
        tied = self.tie_embeddings and self.modality not in ("audio", "vision")
        if not tied:
            total += D * V                                # head

        def attn_block(with_mlp: bool) -> int:
            n = D * H * dh + 2 * D * KV * dh + H * dh * D
            if bias:
                n += H * dh + 2 * KV * dh + D
            n += 2 * norm_p                               # ln1, ln2
            if with_mlp and F > 0:
                nm = 2 if self.act == "swiglu" else 1
                n += nm * D * F + F * D
                if bias:
                    n += F + D
            return n

        for kind in self.blocks:
            if kind in (ATTN, SHARED_ATTN):
                total += attn_block(True)
            elif kind == MOE:
                E, Fm = self.n_experts, self.moe_d_ff
                nm = 2 if self.act == "swiglu" else 1
                total += attn_block(False)
                total += D * E + E * (nm * D * Fm + Fm * D)
            elif kind == MLSTM:
                di = self.ssm_expand * D
                total += (norm_p + 2 * D * di + self.conv_kernel * di
                          + 3 * di * di + 2 * H * di + 2 * H + di * D)
            elif kind == SLSTM:
                total += norm_p + 2 * (D * 4 * D) + 4 * D + D * D
            elif kind == MAMBA2:
                di = self.ssm_expand * D
                nh = self.mamba_heads
                N = self.ssm_state
                total += (norm_p + D * (2 * di + 2 * N + nh)
                          + self.conv_kernel * (di + 2 * N)
                          + 3 * nh + di + di * D)          # A_log,D,dt_bias; gn
        if self.family == "hybrid":
            total += attn_block(True)                      # shared attn block
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if not self.n_experts:
            return self.param_count()
        E, k, Fm, D = (self.n_experts, self.experts_top_k, self.moe_d_ff,
                       self.d_model)
        nm = 2 if self.act == "swiglu" else 1
        per_expert = nm * D * Fm + Fm * D
        n_moe = sum(1 for b in self.blocks if b == MOE)
        return self.param_count() - n_moe * (E - k) * per_expert

    @property
    def mamba_heads(self) -> int:
        if self.ssm_heads:
            return self.ssm_heads
        return (self.ssm_expand * self.d_model) // max(self.d_head, 1)

    def config_hash(self) -> str:
        return hashlib.sha1(
            json.dumps(dataclasses.asdict(self), sort_keys=True, default=str).encode()
        ).hexdigest()[:12]

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


@dataclass(frozen=True)
class TrainConfig:
    """End-to-end training hyper-parameters (driver-level).

    The fields are the JAX package's. The port's trainer reads the schedule,
    AdamW, clip, ``microbatches`` and ``remat`` fields; ``seed``,
    ``ligo_*``, ``checkpoint_every`` and ``keep_checkpoints`` are kept for
    parity (the launcher takes them from its flags), and
    ``grad_compression`` belongs to the multi-chip trainer, which is not
    ported.
    """
    seq_len: int = 128
    global_batch: int = 32
    steps: int = 1000
    warmup_steps: int = 100
    lr: float = 2e-4
    end_lr_frac: float = 0.1
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: float = 1.0
    seed: int = 0
    # LiGO growth phase
    ligo_steps: int = 100
    ligo_lr: float = 1e-3
    ligo_momentum: float = 0.9
    # infra
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    microbatches: int = 1            # gradient accumulation
    grad_compression: str = "none"   # none | int8_ef
    remat: str = "block"             # none | block
