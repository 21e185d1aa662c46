"""GPT-2 (Radford et al. 2019; HF ``GPT2LMHeadModel``): learned
positions, pre-norm LayerNorm with bias, biased projections, a GELU MLP
(the tanh form, ``gelu_new``), tied embeddings. No dropout."""
from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference import common


def geometry(hf: Dict) -> Dict:
    """The model's sizes from GPT-2's ``config.json`` keys."""
    if hf.get("activation_function", "gelu_new") != "gelu_new":
        raise ValueError("the reference computes GPT-2's gelu_new only")
    if not hf.get("tie_word_embeddings", True):
        raise ValueError("the reference ties the unembedding to the "
                         "embedding, as GPT-2 does")
    d = hf["n_embd"]
    return {"n_layers": hf["n_layer"], "d_model": d, "n_heads": hf["n_head"],
            "n_kv_heads": hf["n_head"], "d_head": d // hf["n_head"],
            "d_ff": hf.get("n_inner") or 4 * d, "vocab": hf["vocab_size"],
            "positions": "learned", "max_pos": hf["n_positions"],
            "rope_theta": 0.0, "act": "gelu_tanh", "norm": "layer",
            "eps": hf["layer_norm_epsilon"], "tied": True,
            "dtype": hf["torch_dtype"]}


def norm(geom: Dict):
    def apply(x, p, name):
        q = p[name] if name else p
        return common.layer_norm(x, q["scale"], q["bias"], geom["eps"])
    return apply


def mlp(x, p, num: common.Numerics):
    h = num.mm(x, p["w1"]) + p["b1"]
    h = torch.nn.functional.gelu(h, approximate="tanh")
    return num.mm(h, p["w2"]) + p["b2"]
