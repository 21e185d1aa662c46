"""The plain reference: a dense causal transformer, LiGO's growth operator,
SGD with momentum and AdamW, in float32 PyTorch operations.

Nothing here imports the program under test. The model is written from
its published description (the family modules ``gpt2.py`` and ``phi3.py``
say which parts each family takes), LiGO from the paper (arXiv:2303.00980,
Eq. 8 and the tying of §3.3), the optimizers from their definitions.

Precision. Every product runs in float32 with TF32 off, from parameters
upcast from the type the configuration stores them in. Parameters that a
step updates are stored back in that type, as the configuration states
(bfloat16 weights, float32 optimizer moments). ``Numerics("fp8")`` is the
control: every matmul's operands, and in the backward pass its incoming
gradient, are rounded to float8 (e4m3, scaled per tensor to its largest
magnitude) before the float32 product: the precision below the
configuration's bfloat16.

Memory. Each layer is checkpointed and the loss is taken over blocks of
rows, so that the float32 reference fits on the card beside nothing else.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from perfbench.weights import flatten, unflatten

F32 = torch.float32
FP8_MAX = 448.0


def strict_float32() -> None:
    """No TF32 anywhere: the reference's products are float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = _fp8(a), _fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = _fp8(g)
        ga = g8 @ b8.transpose(-1, -2)
        gb = a8.transpose(-1, -2) @ g8
        # broadcast operands: sum the gradient over the broadcast dims
        while ga.dim() > a8.dim():
            ga = ga.sum(0)
        while gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb


class Numerics:
    """The precision of the reference's products: ``"float32"`` (the
    reference) or ``"fp8"`` (the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _FP8MatMul.apply(a, b)
        return a @ b


# -- the model ---------------------------------------------------------------
def layer_norm(x, scale, bias, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """RoPE over the whole head, halves rotated (x: B, H, T, dh)."""
    dh = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=F32,
                                       device=x.device) / dh)
    ang = positions.to(F32)[:, None] * inv[None]            # (T, dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def causal_attention(q, k, v, num: Numerics):
    """Softmax attention with a causal mask; q (B, H, T, dh), k and v
    (B, KV, T, dh) shared by H / KV query heads each."""
    B, H, T, dh = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    s = num.mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    mask = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    return num.mm(torch.softmax(s, dim=-1), v)


def block(p: Dict, x: torch.Tensor, geom: Dict, positions, num: Numerics,
          norm: Callable, mlp: Callable) -> torch.Tensor:
    """One pre-norm residual block: attention, then the MLP."""
    B, T, D = x.shape
    H, KV, dh = geom["n_heads"], geom["n_kv_heads"], geom["d_head"]
    h = norm(x, p, "ln1")

    def proj(w, b=None):
        y = num.mm(h, p[w])
        return y + p[b] if b and b in p else y
    q = proj("wq", "bq").view(B, T, H, dh).transpose(1, 2)
    k = proj("wk", "bk").view(B, T, KV, dh).transpose(1, 2)
    v = proj("wv", "bv").view(B, T, KV, dh).transpose(1, 2)
    if geom["positions"] == "rope":
        q = rotary(q, positions, geom["rope_theta"])
        k = rotary(k, positions, geom["rope_theta"])
    o = causal_attention(q, k, v, num).transpose(1, 2).reshape(B, T, H * dh)
    o = num.mm(o, p["wo"])
    if "bo" in p:
        o = o + p["bo"]
    x = x + o
    return x + mlp(norm(x, p, "ln2"), p["mlp"], num)


def forward_loss(params: Dict, geom: Dict, batch: Dict, num: Numerics,
                 norm: Callable, mlp: Callable, *,
                 rows: Optional[slice] = None,
                 loss_rows: int = 1) -> torch.Tensor:
    """Summed cross entropy of ``batch`` (tokens, targets) over the rows
    ``rows`` (all when None); parameters upcast to float32 here, each
    layer checkpointed, the logits taken ``loss_rows`` rows at a time."""
    tok, tgt = batch["tokens"], batch["targets"]
    if rows is not None:
        tok, tgt = tok[rows], tgt[rows]
    f = {k: v.to(F32) for k, v in flatten(params).items()}
    emb = f["embed/tok"]
    T = tok.shape[1]
    positions = torch.arange(T, device=tok.device)
    x = emb[tok.long()]
    if geom["positions"] == "learned":
        x = x + f["embed/pos"][:T]
    layer_keys = [k for k in f if k.startswith("layers/attn/")]
    for i in range(geom["n_layers"]):
        p = unflatten({k[len("layers/attn/"):]: f[k][i] for k in layer_keys})
        x = checkpoint(block, p, x, geom, positions, num, norm, mlp,
                       use_reentrant=False)
    x = norm(x, unflatten({k[len("final_norm/"):]: v for k, v in f.items()
                           if k.startswith("final_norm/")}), None)
    total = torch.zeros((), dtype=F32, device=x.device)
    for r0 in range(0, x.shape[0], loss_rows):
        total = total + checkpoint(_ce_sum, x[r0:r0 + loss_rows], emb,
                                   tgt[r0:r0 + loss_rows], num,
                                   use_reentrant=False)
    return total


def _ce_sum(h, emb, tgt, num):
    logits = num.mm(h, emb.T)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1).long(),
        reduction="sum")


def mean_loss_and_grads(loss_of: Callable, leaves: Dict[str, torch.Tensor],
                        batch: Dict, n_tokens: int, block_rows: int
                        ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean loss over the batch and its gradient with respect to
    ``leaves`` (float32), accumulated over blocks of ``block_rows`` rows."""
    rows = batch["tokens"].shape[0]
    grads = {k: torch.zeros_like(v, dtype=F32) for k, v in leaves.items()}
    total = 0.0
    for r0 in range(0, rows, block_rows):
        req = {k: v.detach().requires_grad_(True) for k, v in leaves.items()}
        loss = loss_of(req, slice(r0, r0 + block_rows)) / n_tokens
        gs = torch.autograd.grad(loss, list(req.values()), allow_unused=True)
        for (k, _), g in zip(req.items(), gs):
            if g is not None:
                grads[k] += g.to(F32)
        total += float(loss.detach())
        del loss, gs, req
    return total, grads


# -- LiGO (arXiv:2303.00980 Eq. 8, the tying of §3.3) ------------------------
# leaf -> (in-expander, out-expander): A^{Q,K,V} = B_emb, A^O = Γ(B_v),
# B^O = B_emb, A^{fc1} = B_emb, A^{fc2} = B_fc1, B^{fc2} = B_emb; norms and
# biases take their module's out-expander; the embeddings grow with B_emb.
LIGO_TYING = {
    "ln1/scale": (None, "emb"), "ln1/bias": (None, "emb"),
    "ln2/scale": (None, "emb"), "ln2/bias": (None, "emb"),
    "wq": ("emb", "q"), "bq": (None, "q"), "wk": ("emb", "k"),
    "bk": (None, "k"), "wv": ("emb", "v"), "bv": (None, "v"),
    "wo": ("gamma_v", "emb"), "bo": (None, "emb"),
    "mlp/w1": ("emb", "fc"), "mlp/b1": (None, "fc"), "mlp/w3": ("emb", "fc"),
    "mlp/w2": ("fc", "emb"), "mlp/b2": (None, "emb"),
}


def gamma(Bv: torch.Tensor, g1: Dict, g2: Dict) -> torch.Tensor:
    """The value expander lifted from KV-head space to query-head space:
    query head h2 of the large model reads kv head h2 // G2's rows of B_v,
    averaged over the G1 source query heads that share a source kv head.
    With one query head a kv head (MHA) it is B_v itself."""
    H1, KV1, d1 = g1["n_heads"], g1["n_kv_heads"], g1["d_head"]
    H2, KV2, d2 = g2["n_heads"], g2["n_kv_heads"], g2["d_head"]
    if (H1, KV1, d1) == (H2, KV2, d2) and H1 != KV1:
        raise NotImplementedError("an unchanged GQA head layout")
    G1, G2 = H1 // KV1, H2 // KV2
    B4 = Bv.reshape(KV2, d2, KV1, d1)
    big = B4[torch.arange(H2, device=Bv.device) // G2][
        :, :, torch.arange(H1, device=Bv.device) // G1] / G1
    return big.reshape(H2 * d2, H1 * d1)


def grow(op: Dict[str, torch.Tensor], small: Dict, g1: Dict, g2: Dict,
         num: Numerics) -> Dict:
    """Θ_large from Θ_small: each leaf ``E_in · W · E_outᵀ`` (weights are
    (in, out)), then each stacked leaf blended over depth,
    ``Ω[k] = Σ_l w[k, l] Ω_l``. ``op`` is the operator's flat tree
    (``width/<space>``, ``depth/attn/<leaf>``). Float32; returns the flat
    large tree."""
    E = {k[len("width/"):]: v for k, v in op.items()
         if k.startswith("width/")}
    E["gamma_v"] = gamma(E["v"], g1, g2)
    out = {}
    for path, W in flatten(small).items():
        W = W.to(F32)
        if path.startswith("layers/attn/"):
            leaf = path[len("layers/attn/"):]
            e_in, e_out = LIGO_TYING[leaf]
            x = W
            if e_in is not None:                       # (L1, a, b) -> I rows
                x = num.mm(E[e_in], x)
            x = num.mm(x, E[e_out].T)                  # -> J columns
            w = op[f"depth/attn/{leaf}"]               # (L2, L1)
            L1 = x.shape[0]
            x = num.mm(w, x.reshape(L1, -1)).reshape((w.shape[0],)
                                                     + x.shape[1:])
        else:                                          # embeddings, norm
            x = num.mm(W, E["emb"].T) if W.dim() == 2 else \
                num.mm(E["emb"], W[:, None])[:, 0]
        out[path] = x
    return out


# -- optimizers --------------------------------------------------------------
def warmup_cosine(step: int, base_lr: float, warmup: int, total: int,
                  end_frac: float) -> float:
    if step < warmup:
        return base_lr * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * (end_frac + (1 - end_frac) * 0.5
                      * (1 + math.cos(math.pi * prog)))


def decays(name: str, leaf: torch.Tensor) -> bool:
    """Whether AdamW decays a leaf: weight matrices and embeddings, not
    norm scales or biases, whose stacked ``layers/`` leaves are (L, d)."""
    return leaf.dim() >= (3 if name.startswith("layers/") else 2)


def adamw(p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor],
          m: Dict, v: Dict, count: int, *, lr: float, b1: float, b2: float,
          eps: float, wd: float, clip: float, store_dtype
          ) -> Dict[str, float]:
    """One AdamW step (Loshchilov & Hutter, decoupled decay) after clipping
    the gradient to global norm ``clip``; decay on weight matrices and
    embeddings only. Moments float32; the parameters computed in float32
    and stored in ``store_dtype``. Updates ``p``, ``m`` and ``v`` in place,
    consumes ``g``, and returns the norm of each clipped gradient leaf."""
    norm = torch.sqrt(sum(x.square().sum() for x in g.values()))
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    norms = {}
    for k in list(p):
        gk = g.pop(k) * scale
        norms[k] = float(gk.to(torch.float64).norm())
        m[k] = b1 * m[k] + (1 - b1) * gk
        v[k] = b2 * v[k] + (1 - b2) * gk * gk
        del gk
        step = (m[k] / c1) / (torch.sqrt(v[k] / c2) + eps)
        if decays(k, p[k]):
            step = step + wd * p[k].to(F32)
        p[k] = (p[k].to(F32) - lr * step).to(store_dtype)
    return norms


# -- readings ------------------------------------------------------------
def leaf_norms(flat: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.to(torch.float64).norm()) for k, v in flat.items()}


__all__: List[str] = ["Numerics", "strict_float32", "forward_loss", "grow",
                      "decays", "adamw", "warmup_cosine",
                      "mean_loss_and_grads", "leaf_norms"]
