"""Residual blocks: attention + MLP (the dense family) and attention +
mixture-of-experts (the MoE family).

``init_attn(gen, cfg, ...)`` returns one layer's params (or a stack of them
with ``lead=(L,)``); ``apply_attn(p, x, cfg, positions, mode=...)`` runs one
layer in three modes:

- ``train``: full-sequence mixing (kernel K3 on the card where autograd
  records nothing, as in an eval step; the chunked attention otherwise, see
  ``layers.full_attention``);
- ``prefill``: the same, and returns the layer's K/V cache contribution in
  the ring-buffer layout decode continues (token t at slot t % S);
- ``decode``: a single-token step against the dense cache
  ``{"k", "v"}: (B, S, KV, dh)``, which it updates **in place** (the JAX
  package returns a new cache; writing into the old one saves a copy of
  every layer's cache per token). ``cur_len`` is an int (the batch in lock
  step) or a (B,) tensor (each row writes at its own position: continuous
  batching). With a page table ``pages`` (B, P) the cache leaves are
  block pools ``(n_blocks + 1, block_size, KV, dh)`` the slots share
  (``serving.kv_pages``), written through the table, also in place.

``init_moe_block`` / ``apply_moe_block`` are the same attention sub-block
followed by ``models.moe``'s expert layer in place of the MLP; the block
also returns the layer's router auxiliary loss. The xLSTM and Mamba2
blocks come with their model families.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models.layers import (apply_mlp, apply_norm, apply_rope,
                                       decode_attention, dense_init,
                                       full_attention, init_mlp, init_norm,
                                       paged_decode_attention,
                                       write_token_paged)
from repro_torch.models.moe import apply_moe, init_moe


def _use_bias(cfg) -> bool:
    return cfg.norm == "layer"


def init_attn(gen, cfg, *, dtype=torch.float32, device=None,
              lead: Tuple[int, ...] = (), mlp: bool = True):
    """One attention layer's params (a stack with ``lead=(L,)``), with its
    dense MLP when ``cfg.d_ff > 0`` and ``mlp``."""
    D, H, KV, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {
        "ln1": init_norm(cfg.norm, D, **kw),
        "wq": dense_init(gen, D, H * dh, **kw),
        "wk": dense_init(gen, D, KV * dh, **kw),
        "wv": dense_init(gen, D, KV * dh, **kw),
        "wo": dense_init(gen, H * dh, D, 1.0 / math.sqrt(2 * cfg.n_layers),
                         **kw),
        "ln2": init_norm(cfg.norm, D, **kw),
    }
    if _use_bias(cfg):
        for name, n in (("bq", H * dh), ("bk", KV * dh), ("bv", KV * dh),
                        ("bo", D)):
            p[name] = torch.zeros(tuple(lead) + (n,), dtype=dtype,
                                  device=device)
    if mlp and cfg.d_ff > 0:
        p["mlp"] = init_mlp(gen, D, cfg.d_ff, cfg.act, _use_bias(cfg),
                            cfg.n_layers, **kw)
    return p


def _qkv(p, h, cfg, positions):
    B, T, _ = h.shape
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = h @ p["wq"] + (p["bq"] if "bq" in p else 0.0)
    k = h @ p["wk"] + (p["bk"] if "bk" in p else 0.0)
    v = h @ p["wv"] + (p["bv"] if "bv" in p else 0.0)
    q = q.reshape(B, T, H, dh)
    k = k.reshape(B, T, KV, dh)
    v = v.reshape(B, T, KV, dh)
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        raise NotImplementedError("M-RoPE is not ported yet")
    return q, k, v


def apply_attn(p, x, cfg, positions, *, mode: str = "train",
               cache: Optional[dict] = None, cur_len=None,
               use_kernel: Optional[bool] = None,
               pages: Optional[torch.Tensor] = None):
    """Returns (x_out, new_cache_or_None). ``use_kernel`` picks the train
    and prefill attention route (``layers.full_attention``).

    ``pages`` (decode only): the (B, P) int64 page table of the paged
    layout, which needs a (B,) int64 ``cur_len`` and full-context
    attention. A row whose page is unmapped (-1: a free slot) writes into
    the pool's spare block (``layers.write_token_paged``)."""
    B, T, D = x.shape
    h = apply_norm(p["ln1"], x, cfg.norm)
    new_cache = None
    q, k, v = _qkv(p, h, cfg, positions)
    if mode == "decode" and pages is not None:
        if cfg.window:
            raise ValueError("paged KV requires full-context attention")
        write_token_paged(cache["k"], pages, cur_len - 1, k)
        write_token_paged(cache["v"], pages, cur_len - 1, v)
        o = paged_decode_attention(q, cache["k"], cache["v"], pages, cur_len)
        new_cache = cache
    elif mode == "decode":
        S = cache["k"].shape[1]
        ring = bool(cfg.window) and S == cfg.window
        slot = (cur_len - 1) % S if ring else cur_len - 1
        if isinstance(slot, torch.Tensor) and slot.dim():
            rows = torch.arange(B, device=x.device)
            cache["k"][rows, slot] = k[:, 0]
            cache["v"][rows, slot] = v[:, 0]
        else:
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
        o = decode_attention(q, cache["k"], cache["v"], cur_len,
                             window=cfg.window, ring=ring)
        new_cache = cache
    else:
        o = full_attention(q, k, v,
                           causal=cfg.causal and not cfg.encoder_only,
                           window=cfg.window, use_kernel=use_kernel)
        if mode == "prefill":
            S = cfg.window if (cfg.window and cfg.window < T) else T
            # ring-buffer layout: token t lives at slot t % S (so decode's
            # `(cur_len-1) % S` slot assignment continues seamlessly)
            new_cache = {"k": torch.roll(k[:, -S:], T % S, dims=1),
                         "v": torch.roll(v[:, -S:], T % S, dims=1)}
    o = o.reshape(B, T, -1) @ p["wo"] + (p["bo"] if "bo" in p else 0.0)
    x = x + o
    if "mlp" in p:
        h2 = apply_norm(p["ln2"], x, cfg.norm)
        x = x + apply_mlp(p["mlp"], h2, cfg.act)
    return x, new_cache


# ---------------------------------------------------------------------------
# MoE block (attention + expert MLP)
# ---------------------------------------------------------------------------
def init_moe_block(gen, cfg, *, dtype=torch.float32, device=None,
                   lead: Tuple[int, ...] = ()):
    """The attention sub-block's params (no dense MLP, even where the
    config carries a ``d_ff``, as mixtral's does) and ``"moe"``."""
    p = init_attn(gen, cfg, dtype=dtype, device=device, lead=lead, mlp=False)
    p["moe"] = init_moe(gen, cfg, dtype=dtype, device=device, lead=lead)
    return p


def apply_moe_block(p, x, cfg, positions, *, mode: str = "train",
                    cache: Optional[dict] = None, cur_len=None,
                    use_kernel: Optional[bool] = None,
                    pages: Optional[torch.Tensor] = None):
    """Returns (x_out, new_cache_or_None, aux): :func:`apply_attn`'s
    attention sub-block, then the expert layer on the ``ln2``-normed
    stream."""
    p_attn = {k: v for k, v in p.items() if k != "moe"}
    x, new_cache = apply_attn(p_attn, x, cfg, positions, mode=mode,
                              cache=cache, cur_len=cur_len,
                              use_kernel=use_kernel, pages=pages)
    h = apply_norm(p["ln2"], x, cfg.norm)
    y, aux = apply_moe(p["moe"], h, cfg)
    return x + y, new_cache, aux
