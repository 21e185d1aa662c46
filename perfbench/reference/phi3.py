"""Phi-3 / Phi-4-mini (arXiv:2412.08905; HF ``Phi3ForCausalLM``): RoPE,
grouped-query attention, pre-norm RMSNorm, a SwiGLU MLP, no biases, tied
embeddings. The rotation covers the whole head and takes no LongRoPE
factors: the configuration file lists both as changed from the published
model, which rotates three quarters of each head."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import common


def geometry(hf: Dict) -> Dict:
    """The model's sizes from Phi-3's ``config.json`` keys."""
    if hf.get("partial_rotary_factor", 1.0) != 1.0 or hf.get("rope_scaling"):
        raise ValueError("the reference rotates the whole head without "
                         "rescaled frequencies")
    if hf.get("hidden_act", "silu") != "silu":
        raise ValueError("the reference computes Phi-3's SiLU-gated MLP")
    d = hf["hidden_size"]
    H = hf["num_attention_heads"]
    return {"n_layers": hf["num_hidden_layers"], "d_model": d, "n_heads": H,
            "n_kv_heads": hf["num_key_value_heads"],
            "d_head": hf.get("head_dim") or d // H,
            "d_ff": hf["intermediate_size"], "vocab": hf["vocab_size"],
            "positions": "rope", "max_pos": hf["max_position_embeddings"],
            "rope_theta": float(hf["rope_theta"]), "act": "swiglu",
            "norm": "rms", "eps": hf["rms_norm_eps"],
            "tied": bool(hf["tie_word_embeddings"]),
            "dtype": hf["torch_dtype"]}


def norm(geom: Dict):
    def apply(x, p, name):
        q = p[name] if name else p
        return common.rms_norm(x, q["scale"], geom["eps"])
    return apply


def mlp(x, p, num: common.Numerics):
    gate = torch.nn.functional.silu(num.mm(x, p["w1"]))
    return num.mm(gate * num.mm(x, p["w3"]), p["w2"])
