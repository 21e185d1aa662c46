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
also returns the layer's router auxiliary loss.

The sequence-mixer blocks, on ``models.seqmix``: ``init_mlstm`` /
``apply_mlstm`` (xLSTM's matrix memory), ``init_slstm`` / ``apply_slstm``
(its scalar memory) and ``init_mamba2`` / ``apply_mamba2`` (Mamba2's SSD,
whose ``A_log``, ``Dskip`` and ``dt_bias`` stay float32 in a bf16 model).
Each runs ``train``, ``prefill`` (from a zero state; returns the layer's
recurrent state) and ``decode`` (one token from ``cache``) and returns
``(x_out, new_cache)``; in train mode the cache is built all the same and
the caller drops it. :data:`INIT` maps every block kind to its init.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_mlp, apply_mrope, apply_norm,
                                       apply_rope, decode_attention,
                                       dense_init, full_attention, init_mlp,
                                       init_norm, paged_decode_attention,
                                       write_token_paged)
from repro_torch.models import seqmix
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
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
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


# ---------------------------------------------------------------------------
# mLSTM block (xLSTM matrix memory)
# ---------------------------------------------------------------------------
def init_mlstm(gen, cfg, *, dtype=torch.float32, device=None,
               lead: Tuple[int, ...] = ()):
    D = cfg.d_model
    di = cfg.ssm_expand * D
    H = cfg.n_heads
    kw = dict(dtype=dtype, device=device, lead=lead)
    lead = tuple(lead)
    gates_b = torch.cat([torch.zeros((H,), device=device),
                         torch.linspace(3.0, 6.0, H, device=device)])
    return {
        "ln": init_norm(cfg.norm, D, **kw),
        "up": dense_init(gen, D, 2 * di, **kw),
        "conv": (torch.randn(lead + (cfg.conv_kernel, di), generator=gen,
                             device=device) * 0.02).to(dtype),
        "wqkv": dense_init(gen, di, 3 * di, **kw),
        "gates": dense_init(gen, di, 2 * H, **kw),
        "gates_b": gates_b.to(dtype).expand(lead + (2 * H,)).clone(),
        "down": dense_init(gen, di, D, 1.0 / math.sqrt(2 * cfg.n_layers),
                           **kw),
    }


def apply_mlstm(p, x, cfg, *, mode: str = "train",
                cache: Optional[dict] = None):
    """Returns (x_out, new_cache): ``{"conv", "S", "n"}``, the front conv's
    last K-1 inputs and the GLA state."""
    B, T, D = x.shape
    di = cfg.ssm_expand * D
    H = cfg.n_heads
    dh = di // H
    h = apply_norm(p["ln"], x, cfg.norm)
    xi, z = torch.chunk(h @ p["up"], 2, dim=-1)          # (B, T, di) each
    xi, conv_new = seqmix.causal_conv(xi, p["conv"],
                                      cache.get("conv") if cache else None)
    xi = F.silu(xi)
    q, k, v = torch.chunk(xi @ p["wqkv"], 3, dim=-1)
    q = q.reshape(B, T, H, dh)
    k = k.reshape(B, T, H, dh) / math.sqrt(dh)
    v = v.reshape(B, T, H, dh)
    g = xi @ p["gates"] + p["gates_b"]                   # (B, T, 2H)
    log_i = F.logsigmoid(g[..., :H])
    log_f = F.logsigmoid(g[..., H:])
    if mode == "decode":
        state = seqmix.GLAState(cache["S"], cache["n"])
        o, new_state = seqmix.gla_step(q[:, 0], k[:, 0], v[:, 0],
                                       log_f[:, 0], log_i[:, 0], state,
                                       normalize=True)
        o = o[:, None]                                   # (B, 1, H, dh)
    else:
        state = seqmix.GLAState(cache["S"], cache["n"]) if cache else None
        o, new_state = seqmix.gla_chunked(q, k, v, log_f, log_i, state,
                                          normalize=True)
    o = o.reshape(B, T, di) * F.silu(z)
    new_cache = {"conv": conv_new, "S": new_state.S, "n": new_state.n}
    return x + o @ p["down"], new_cache


# ---------------------------------------------------------------------------
# sLSTM block (xLSTM scalar memory)
# ---------------------------------------------------------------------------
def init_slstm(gen, cfg, *, dtype=torch.float32, device=None,
               lead: Tuple[int, ...] = ()):
    D = cfg.d_model
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "ln": init_norm(cfg.norm, D, **kw),
        "w": dense_init(gen, D, 4 * D, **kw),
        "r": dense_init(gen, D, 4 * D, **kw),
        "b": torch.zeros(tuple(lead) + (4 * D,), dtype=dtype, device=device),
        "out": dense_init(gen, D, D, 1.0 / math.sqrt(2 * cfg.n_layers), **kw),
    }


def apply_slstm(p, x, cfg, *, mode: str = "train",
                cache: Optional[dict] = None):
    """Returns (x_out, new_cache): ``{"h", "c", "n", "m"}``, float32."""
    B, T, D = x.shape
    h = apply_norm(p["ln"], x, cfg.norm)
    if cache is not None:
        state = seqmix.SLSTMState(cache["h"], cache["c"], cache["n"],
                                  cache["m"])
    else:
        state = seqmix.slstm_init_state(B, D, device=x.device)
    if mode == "decode":
        o, new_state = seqmix.slstm_cell((h @ p["w"])[:, 0], p, state)
        o = o[:, None]
    else:
        o, new_state = seqmix.slstm_seq(h, p, state)
    new_cache = {"h": new_state.h, "c": new_state.c, "n": new_state.n,
                 "m": new_state.m}
    return x + o @ p["out"], new_cache


# ---------------------------------------------------------------------------
# Mamba2 block (SSD)
# ---------------------------------------------------------------------------
def init_mamba2(gen, cfg, *, dtype=torch.float32, device=None,
                lead: Tuple[int, ...] = ()):
    D = cfg.d_model
    di = cfg.ssm_expand * D
    H = cfg.mamba_heads
    N = cfg.ssm_state
    kw = dict(dtype=dtype, device=device, lead=lead)
    lead = tuple(lead)
    conv_ch = di + 2 * N                                 # conv over [x, B, C]

    def f32(v):
        return v.expand(lead + (H,)).clone()
    return {
        "ln": init_norm(cfg.norm, D, **kw),
        "in_proj": dense_init(gen, D, 2 * di + 2 * N + H, **kw),
        "conv": (torch.randn(lead + (cfg.conv_kernel, conv_ch), generator=gen,
                             device=device) * 0.02).to(dtype),
        "A_log": f32(torch.log(torch.linspace(1.0, 16.0, H, device=device))),
        "Dskip": f32(torch.ones((H,), device=device)),
        "dt_bias": f32(torch.log(torch.expm1(
            torch.full((H,), 0.01, device=device)))),
        "gn": init_norm("rms", di, **kw),
        "out_proj": dense_init(gen, di, D, 1.0 / math.sqrt(2 * cfg.n_layers),
                               **kw),
    }


def apply_mamba2(p, x, cfg, *, mode: str = "train",
                 cache: Optional[dict] = None):
    """Returns (x_out, new_cache): ``{"conv", "S", "n"}``. The gates run in
    float32 (``dt`` from the float32 ``dt_bias``), the values in the
    model's dtype, as in the JAX package."""
    B, T, D = x.shape
    di = cfg.ssm_expand * D
    H = cfg.mamba_heads
    N = cfg.ssm_state
    dh = di // H
    h = apply_norm(p["ln"], x, cfg.norm)
    u = h @ p["in_proj"]                                 # (B, T, 2di+2N+H)
    z, xbc, dt = u[..., :di], u[..., di:2 * di + 2 * N], u[..., 2 * di + 2 * N:]
    xbc, conv_new = seqmix.causal_conv(xbc, p["conv"],
                                       cache.get("conv") if cache else None)
    xbc = F.silu(xbc)
    xs, Bc, Cc = xbc[..., :di], xbc[..., di:di + N], xbc[..., di + N:]
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, T, H)
    log_f = -torch.exp(p["A_log"]) * dt                  # ≤ 0
    v = xs.reshape(B, T, H, dh) * dt[..., None].to(xs.dtype)
    k = Bc[:, :, None].expand(B, T, H, N)
    q = Cc[:, :, None].expand(B, T, H, N)
    log_i = torch.zeros_like(log_f)
    if mode == "decode":
        state = seqmix.GLAState(cache["S"], cache["n"])
        o, new_state = seqmix.gla_step(q[:, 0], k[:, 0], v[:, 0],
                                       log_f[:, 0], log_i[:, 0], state)
        o = o[:, None]
    else:
        state = seqmix.GLAState(cache["S"], cache["n"]) if cache else None
        o, new_state = seqmix.gla_chunked(q, k, v, log_f, log_i, state)
    xs_h = xs.reshape(B, T, H, dh)
    if mode == "decode":
        xs_h = xs_h[:, :1]
    o = o + xs_h * p["Dskip"][:, None].to(o.dtype)       # D·x skip
    o = o.reshape(B, T, di) * F.silu(z)
    o = apply_norm(p["gn"], o, "rms")
    new_cache = {"conv": conv_new, "S": new_state.S, "n": new_state.n}
    return x + o @ p["out_proj"], new_cache


INIT = {"attn": init_attn, "moe": init_moe_block, "mlstm": init_mlstm,
        "slstm": init_slstm, "mamba2": init_mamba2, "shared_attn": init_attn}
