"""Sequence-mixing engines for the SSM-family blocks (the twin of the JAX
package's ``models/seqmix.py``).

One chunkwise-parallel **gated linear attention** (GLA) engine serves both
xLSTM's mLSTM (matrix memory) and Mamba2's SSD, which run the same
recurrence

    S_t = f_t · S_{t-1} + i_t · k_t v_tᵀ        (state:   H × dk × dv)
    n_t = f_t · n_{t-1} + i_t · k_t             (normaliser, mLSTM only)
    h_t = q_tᵀ S_t   [/ max(|q_t·n_t|, 1)]

with per-(token, head) scalar gates ``f_t = exp(log_f)``, ``i_t =
exp(log_i)``, ``log_f, log_i ≤ 0``, so no running-max stabiliser is needed
in the chunked form. :func:`gla_chunked` is the within-chunk quadratic,
across-chunk recurrent decomposition (SSD), its chunks a Python loop where
the JAX package scans; all of its math is float32.

Where the JAX package takes ``exp`` of the whole intra-chunk decay matrix
and then zeroes the entries above the diagonal, this module sets those
entries to ``-inf`` before the ``exp``. The forward values are the same;
the backward pass differs where it matters: above the diagonal the
exponent ``Lf_t - Lf_s + log_i_s`` is positive and, for Mamba2's decays
(up to ``-16·dt`` a token), can overflow to ``inf``, and autograd then
gives ``0 · inf = NaN`` through the zeroed entries.

sLSTM (scalar memory) is sequential: :func:`slstm_seq` steps
:func:`slstm_cell`, with the exponential-gate max-stabiliser of the xLSTM
paper, in float32 throughout.

These are plain PyTorch, as the JAX package's are plain jnp: none of them
is a Pallas kernel there.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

F32 = torch.float32


class GLAState(NamedTuple):
    S: torch.Tensor       # (B, H, dk, dv)
    n: torch.Tensor       # (B, H, dk)


def gla_init_state(batch: int, heads: int, dk: int, dv: int,
                   dtype=F32, device=None) -> GLAState:
    return GLAState(torch.zeros((batch, heads, dk, dv), dtype=dtype,
                                device=device),
                    torch.zeros((batch, heads, dk), dtype=dtype,
                                device=device))


def gla_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                log_f: torch.Tensor, log_i: torch.Tensor,
                state: Optional[GLAState] = None, *, chunk: int = 128,
                normalize: bool = False) -> Tuple[torch.Tensor, GLAState]:
    """Chunkwise-parallel gated linear attention.

    q, k: (B, T, H, dk); v: (B, T, H, dv); log_f, log_i: (B, T, H), both
    ≤ 0. Returns (out (B, T, H, dv) in v's dtype, final float32
    GLAState). T is padded to a multiple of the chunk with ``log_f = 0``
    (the state is frozen) and ``log_i = -1e30`` (nothing is injected).
    """
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    C = min(chunk, T)
    pad = (-T) % C
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        log_f = F.pad(log_f, (0, 0, 0, pad))
        log_i = F.pad(log_i, (0, 0, 0, pad), value=-1e30)
    NC = (T + pad) // C
    qc = q.reshape(B, NC, C, H, dk).to(F32)
    kc = k.reshape(B, NC, C, H, dk).to(F32)
    vc = v.reshape(B, NC, C, H, dv).to(F32)
    lf = log_f.reshape(B, NC, C, H).to(F32)
    li = log_i.reshape(B, NC, C, H).to(F32)
    if state is None:
        state = gla_init_state(B, H, dk, dv, device=q.device)
    S, n = state.S.to(F32), state.n.to(F32)
    above = ~torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    hs, norms = [], []
    for c in range(NC):
        qb, kb, vb, lfb, lib = qc[:, c], kc[:, c], vc[:, c], lf[:, c], li[:, c]
        Lf = torch.cumsum(lfb, dim=1)               # inclusive decay (B,C,H)
        Lf_tot = Lf[:, -1]                          # (B, H)
        # state contribution: exp(Lf_t) q_t · S_in
        q_dec = qb * torch.exp(Lf)[..., None]
        h_state = torch.einsum("bchk,bhkv->bchv", q_dec, S)
        n_state = torch.einsum("bchk,bhk->bch", q_dec, n)
        # intra-chunk: D[t, s] = exp(Lf_t - Lf_s + li_s) for s ≤ t, masked
        # before the exp (the module docstring says why)
        diff = Lf[:, :, None] - Lf[:, None, :] + lib[:, None, :]  # (B,Ct,Cs,H)
        Dm = torch.exp(diff.masked_fill(above, float("-inf")))
        A = torch.einsum("bthk,bshk->btsh", qb, kb) * Dm
        h_intra = torch.einsum("btsh,bshv->bthv", A, vb)
        n_inner = torch.sum(A, dim=2)                             # (B,Ct,H)
        # S' = exp(Lf_tot) S + Σ_s exp(Lf_tot - Lf_s + li_s) k_s v_sᵀ
        w = torch.exp(Lf_tot[:, None] - Lf + lib)                 # (B,C,H)
        k_w = kb * w[..., None]
        S = S * torch.exp(Lf_tot)[..., None, None] + torch.einsum(
            "bchk,bchv->bhkv", k_w, vb)
        n = n * torch.exp(Lf_tot)[..., None] + torch.sum(k_w, dim=1)
        hs.append(h_state + h_intra)
        norms.append(n_state + n_inner)
    h = torch.stack(hs, dim=1).reshape(B, NC * C, H, dv)[:, :T]
    if normalize:
        norm = torch.stack(norms, dim=1).reshape(B, NC * C, H)[:, :T]
        h = h / torch.clamp(torch.abs(norm), min=1.0)[..., None]
    return h.to(v.dtype), GLAState(S, n)


def gla_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             log_f: torch.Tensor, log_i: torch.Tensor, state: GLAState, *,
             normalize: bool = False) -> Tuple[torch.Tensor, GLAState]:
    """Single-token recurrent GLA step (the decode path).

    q, k: (B, H, dk); v: (B, H, dv); log_f, log_i: (B, H).
    """
    f = torch.exp(log_f.to(F32))[..., None]
    i = torch.exp(log_i.to(F32))[..., None]
    kf, vf, qf = k.to(F32), v.to(F32), q.to(F32)
    S = state.S * f[..., None] + i[..., None] * kf[..., None] * vf[..., None, :]
    n = state.n * f + i * kf
    h = torch.einsum("bhk,bhkv->bhv", qf, S)
    if normalize:
        norm = torch.einsum("bhk,bhk->bh", qf, n)
        h = h / torch.clamp(torch.abs(norm), min=1.0)[..., None]
    return h.to(v.dtype), GLAState(S, n)


def gla_recurrent_ref(q, k, v, log_f, log_i, state=None, normalize=False):
    """Naive recurrent GLA, one :func:`gla_step` a token: the oracle of
    :func:`gla_chunked`."""
    B, T, H, dk = q.shape
    dv = v.shape[-1]
    if state is None:
        state = gla_init_state(B, H, dk, dv, device=q.device)
    hs = []
    for t in range(T):
        h, state = gla_step(q[:, t], k[:, t], v[:, t], log_f[:, t],
                            log_i[:, t], state, normalize=normalize)
        hs.append(h)
    return torch.stack(hs, dim=1), state


# ---------------------------------------------------------------------------
# Causal depthwise conv (the Mamba2 / mLSTM front conv)
# ---------------------------------------------------------------------------
def causal_conv(x: torch.Tensor, w: torch.Tensor,
                conv_state: Optional[torch.Tensor] = None):
    """x: (B, T, C); w: (K, C) depthwise kernel. Returns (y, new_conv_state).

    ``conv_state``: (B, K-1, C) trailing context for decode; None in
    training and prefill (zero history). The K taps are summed in the JAX
    package's order, one shifted product at a time, so float32 sums agree.
    """
    B, T, C = x.shape
    K = w.shape[0]
    if conv_state is None:
        conv_state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xx = torch.cat([conv_state, x], dim=1)              # (B, T+K-1, C)
    y = torch.zeros_like(x)
    for j in range(K):
        y = y + xx[:, j:j + T] * w[j]
    return y, xx[:, T:T + K - 1]


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential, exp gates with a max-stabiliser)
# ---------------------------------------------------------------------------
class SLSTMState(NamedTuple):
    h: torch.Tensor   # (B, D)
    c: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor


def slstm_init_state(batch: int, dim: int, dtype=F32,
                     device=None) -> SLSTMState:
    z = torch.zeros((batch, dim), dtype=dtype, device=device)
    return SLSTMState(z, z, z, torch.full((batch, dim), -1e30, dtype=dtype,
                                          device=device))


def slstm_cell(x_gates: torch.Tensor, p, state: SLSTMState
               ) -> Tuple[torch.Tensor, SLSTMState]:
    """One sLSTM step. x_gates: (B, 4D), the input contributions [z, i, f,
    o]. The state and the gate math are float32; the output takes
    x_gates' dtype."""
    h, c, n, m = (s.to(F32) for s in state)
    r = h @ p["r"].to(F32) + p["b"].to(F32)          # (B, 4D) recurrent part
    g = x_gates.to(F32) + r
    zt, it, ft, ot = torch.chunk(g, 4, dim=-1)
    z = torch.tanh(zt)
    o = torch.sigmoid(ot)
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c_new = f_p * c + i_p * z
    n_new = f_p * n + i_p
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return h_new.to(x_gates.dtype), SLSTMState(h_new, c_new, n_new, m_new)


def slstm_seq(x: torch.Tensor, p, state: Optional[SLSTMState] = None):
    """x: (B, T, D). Returns (out (B, T, D), final state)."""
    B, T, D = x.shape
    if state is None:
        state = slstm_init_state(B, D, device=x.device)
    x_gates = x @ p["w"]                                # (B, T, 4D)
    if "wb" in p:
        x_gates = x_gates + p["wb"]
    # the recurrent weights in float32 once for the whole sequence, not
    # once a step (a bf16 model would otherwise make, and autograd keep, a
    # float32 copy of r at every token)
    pf = {"r": p["r"].to(F32), "b": p["b"].to(F32)}
    hs = []
    for t in range(T):
        h, state = slstm_cell(x_gates[:, t], pf, state)
        hs.append(h)
    return torch.stack(hs, dim=1), state
