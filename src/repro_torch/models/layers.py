"""Core neural-net layers: inits, norms, RoPE / M-RoPE, attention, MLP.

All weights use the ``y = x @ W`` convention, i.e. ``W`` has shape
``(in_dim, out_dim)``, exactly as in the JAX package, so parameter trees
carry over leaf for leaf. Attention is the same chunked online-softmax
(flash-style) computation with the block loop unrolled in Python: causal
blocks that are entirely masked are skipped, and the full ``T×S`` score
matrix never exists. :func:`full_attention` routes the train and prefill
attention to kernel K3 where autograd records nothing.

Inits take a ``torch.Generator`` and a ``lead`` shape: a stack of L layers is
drawn in one call with ``lead=(L,)``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Initialisers
# ---------------------------------------------------------------------------
def _trunc_normal(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal truncated to [-3, 3], by inverse CDF (float32)."""
    lo, hi = (0.5 * (1.0 + math.erf(c / math.sqrt(2.0))) for c in (-3.0, 3.0))
    u = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
    return torch.special.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)


def dense_init(gen, in_dim: int, out_dim: int, scale: float = 1.0, *,
               dtype=torch.float32, device=None,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    std = scale / math.sqrt(in_dim)
    return (_trunc_normal(gen, tuple(lead) + (in_dim, out_dim), device) * std
            ).to(dtype)


def embed_init(gen, vocab: int, dim: int, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    return (_trunc_normal(gen, (vocab, dim), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(kind: str, dim: int, *, dtype=torch.float32, device=None,
              lead: Tuple[int, ...] = ()):
    shape = tuple(lead) + (dim,)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layer":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6
               ) -> torch.Tensor:
    xf = x.float()
    if kind == "rms":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (y * p["scale"].float()).to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (d_head // 2,), float32."""
    ar = torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., T, H, dh); positions: broadcastable to (..., T) integers."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                        # (dh/2,)
    ang = positions[..., None].float() * inv                     # (..., T, dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (..., T, H, dh); positions3: (..., T, 3) integers — the (t, h, w)
    position ids. ``sections`` splits the dh/2 frequency channels among the
    three id streams, in order: channel c takes the stream
    ``repeat(arange(3), sections)[c]`` (built by slices, so the shapes do
    not depend on tensor values).
    """
    dh = x.shape[-1]
    if sum(sections) != dh // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not split "
                         f"d_head / 2 = {dh // 2}")
    inv = rope_freqs(dh, theta, x.device)                        # (dh/2,)
    p3 = positions3.float()
    pos = torch.cat([p3[..., i:i + 1].expand(p3.shape[:-1] + (n,))
                     for i, n in enumerate(sections)], -1)   # (..., T, dh/2)
    ang = pos * inv
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked flash-style attention (GQA-native)
# ---------------------------------------------------------------------------
def _block_pair(q_blk, k_blk, v_blk, m, l, acc, scale, mask):
    """One (q-block, kv-block) online-softmax update.

    q_blk: (B, Cq, KV, G, dh); k_blk/v_blk: (B, Ck, KV, dh);
    m, l: (B, KV, G, Cq); acc: (B, Cq, KV, G, dh); mask: (Cq, Ck) bool or None.
    """
    s = torch.einsum("bqkgd,bskd->bkgqs", q_blk.float(),
                     k_blk.float()) * scale                      # (B,KV,G,Cq,Ck)
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + torch.sum(p, dim=-1)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p, v_blk.float())
    acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l, acc


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0, q_offset: int = 0,
              chunk_q: int = 2048, chunk_k: int = 2048) -> torch.Tensor:
    """Multi-(grouped-)head attention without materialising T×S scores.

    q: (B, T, H, dh); k, v: (B, S, KV, dh) with H % KV == 0.
    ``q_offset``: absolute position of q[0] relative to k[0].
    Returns (B, T, H, dh) in q.dtype.
    """
    B, T, H, dh = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, T, KV, G, dh)
    dev = q.device

    cq = min(chunk_q, T)
    ck = min(chunk_k, S)
    # pad to multiples (masked out below)
    Tp, Sp = -(-T // cq) * cq, -(-S // ck) * ck
    if Tp != T:
        qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, Tp - T))
    if Sp != S:
        k = F.pad(k, (0, 0, 0, 0, 0, Sp - S))
        v = F.pad(v, (0, 0, 0, 0, 0, Sp - S))

    nq, nk = Tp // cq, Sp // ck
    out_blocks = []
    for iq in range(nq):
        q_blk = qg[:, iq * cq:(iq + 1) * cq]
        m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, cq, KV, G, dh), dtype=torch.float32, device=dev)
        q_lo, q_hi = q_offset + iq * cq, q_offset + (iq + 1) * cq - 1
        for ik in range(nk):
            k_lo, k_hi = ik * ck, (ik + 1) * ck - 1
            if causal and k_lo > q_hi:
                continue                      # entirely masked
            if window and k_hi < q_lo - window + 1 - (cq - 1):
                continue                      # beyond the window
            full = (not causal) and window == 0 and Sp == S
            mask = None
            if not full:
                qpos = q_offset + iq * cq + torch.arange(cq, device=dev)
                kpos = ik * ck + torch.arange(ck, device=dev)
                mask = torch.ones((cq, ck), dtype=torch.bool, device=dev)
                if causal:
                    mask &= qpos[:, None] >= kpos[None, :]
                if window:
                    mask &= kpos[None, :] > qpos[:, None] - window
                if Sp != S:
                    mask &= kpos[None, :] < S
            k_blk = k[:, ik * ck:(ik + 1) * ck]
            v_blk = v[:, ik * ck:(ik + 1) * ck]
            m, l, acc = _block_pair(q_blk, k_blk, v_blk, m, l, acc, scale,
                                    mask)
        l_t = l.permute(0, 3, 1, 2)[..., None]                   # (B,cq,KV,G,1)
        out_blocks.append(acc / torch.clamp(l_t, min=1e-30))
    out = torch.cat(out_blocks, dim=1)[:, :T]
    return out.reshape(B, T, H, dh).to(q.dtype)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0,
                   use_kernel: Optional[bool] = None) -> torch.Tensor:
    """The attention of the train and prefill modes.

    q: (B, T, H, dh); k, v: (B, T, KV, dh) → (B, T, H, dh) in q.dtype.
    ``use_kernel=None`` routes by mode: kernel K3 (``ops.flash_attention``,
    through transposed views, no copy) when the tensors are on CUDA and
    autograd records nothing (grad disabled, or none of q, k, v requires
    grad); the chunked :func:`attention` otherwise, which autograd
    differentiates (K3 has no backward). ``False`` asks for the chunked
    attention on any device, ``True`` for K3, which raises on CPU tensors
    and on tensors autograd records.
    """
    if use_kernel is None:
        records = torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad)
        use_kernel = q.is_cuda and not records
    if not use_kernel:
        return attention(q, k, v, causal=causal, window=window)
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            use_kernel=True)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, *, window: int = 0,
                     ring: bool = False) -> torch.Tensor:
    """Single-step attention over a KV cache.

    q: (B, 1, H, dh); k_cache/v_cache: (B, S, KV, dh); cur_len: number of
    valid cache entries *including* the current token, an int (every row
    of the batch at one length) or a (B,) integer tensor (each row at its
    own length: continuous batching). With ``ring=True`` the cache is a ring
    buffer of size S == window (masking by validity only).
    """
    B, _, H, dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(B, KV, G, dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                     k_cache.float()) * scale                    # (B,KV,G,S)
    idx = torch.arange(S, device=q.device)
    if isinstance(cur_len, torch.Tensor) and cur_len.dim():
        cl = cur_len.reshape(-1, 1)                              # (B, 1)
        valid = idx[None, :] < cl                                # (B, S)
        if window and not ring:
            valid &= idx[None, :] > cl - 1 - window
        valid = valid[:, None, None, :]
    else:
        valid = idx < cur_len
        if window and not ring:
            valid &= idx > cur_len - 1 - window
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, 1, H, dh).to(q.dtype)


def paged_targets(pages: torch.Tensor, n_pool: int) -> torch.Tensor:
    """Block ids of ``pages`` with every unmapped (-1) page sent to the
    spare block, the last of a pool of ``n_pool`` blocks: the paged
    layout's write targets (``serving.kv_pages``). The JAX package sends
    such a write one past the pool, where XLA drops it; on CUDA an index
    past the pool is a device-side assert."""
    return torch.where(pages >= 0, pages, n_pool - 1)


def write_token_paged(pool: torch.Tensor, pages: torch.Tensor,
                      pos: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
    """Write one token per slot at its own position through the page table,
    in place, and return the pool.

    pool: (n_blocks + 1, bs, KV, dh), the spare block last; pages: (B, P)
    int64; pos: (B,) int64; kv: (B, 1, KV, dh). A write through an
    unmapped page lands in the spare block.
    """
    bs = pool.shape[1]
    page = torch.gather(pages, 1, (pos // bs)[:, None])[:, 0]
    pool[paged_targets(page, pool.shape[0]), pos % bs] = kv[:, 0]
    return pool


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, pages: torch.Tensor,
                           cur_len: torch.Tensor) -> torch.Tensor:
    """Single-step attention over a *paged* KV cache.

    q: (B, 1, H, dh); k_pool/v_pool: (n_blocks, block_size, KV, dh), the
    block pool the slots share; pages: (B, P) integer page table (-1 =
    unmapped); cur_len: (B,). The gather materialises each slot's
    (P * block_size) view, then the math is :func:`decode_attention`'s
    (full context only: windowed caches stay on the dense ring layout).
    An unmapped page indexes -1, the pool's last block, as the JAX gather
    wraps it: every position it covers is ``>= cur_len``, so masked.
    """
    B, P = pages.shape
    bs = k_pool.shape[1]
    k = k_pool[pages].reshape(B, P * bs, *k_pool.shape[2:])
    v = v_pool[pages].reshape(B, P * bs, *v_pool.shape[2:])
    return decode_attention(q, k, v, cur_len)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, act: str, use_bias: bool,
             n_layers: int, *, dtype=torch.float32, device=None,
             lead: Tuple[int, ...] = ()):
    kw = dict(dtype=dtype, device=device, lead=lead)
    p = {"w1": dense_init(gen, d_model, d_ff, **kw),
         "w2": dense_init(gen, d_ff, d_model, 1.0 / math.sqrt(2 * n_layers),
                          **kw)}
    if act == "swiglu":
        p["w3"] = dense_init(gen, d_model, d_ff, **kw)
    if use_bias:
        p["b1"] = torch.zeros(tuple(lead) + (d_ff,), dtype=dtype,
                              device=device)
        p["b2"] = torch.zeros(tuple(lead) + (d_model,), dtype=dtype,
                              device=device)
    return p


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w1"]
    if "b1" in p:
        h = h + p["b1"]
    if act == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    y = h @ p["w2"]
    if "b2" in p:
        y = y + p["b2"]
    return y
