"""Objectives: causal LM, masked LM and image classification (the twin of
the JAX package's ``models/losses.py``).

The LM losses can compute logits in sequence chunks (``loss_chunk``), so the
whole ``(B, T, V)`` logits tensor need not exist at once; softmax and CE run
in float32. The classification objective (``cls``, the vision models)
pools the cls token's hidden state. The JAX ``loss_fn``'s attention
chunk sizes, ``act_spec`` and ``p_bf16`` are knobs of its TPU attention and
mesh, which the port's forward does not take.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import _check_ported, forward, unembed

F32 = torch.float32


class _GradCastBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_cast_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity whose cotangent is cast to bf16, so that the float32 loss
    math does not make the backbone's backward run in float32."""
    return _GradCastBF16.apply(x)


def _ce_fp32(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy; logits (..., V) any dtype, labels (...)."""
    lf = logits.to(F32)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def chunked_lm_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
                    labels: torch.Tensor, weights: torch.Tensor, *,
                    loss_chunk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ w·CE over (B, T); returns (sum_loss, sum_weight).

    ``loss_chunk=0`` disables chunking (one unembed matmul)."""
    T = hidden.shape[1]
    if not loss_chunk or loss_chunk >= T:
        ce = _ce_fp32(unembed(params, cfg, hidden), labels)
        return torch.sum(ce * weights), torch.sum(weights)
    if T % loss_chunk:
        raise ValueError(f"loss_chunk {loss_chunk} does not divide T={T}")
    s = torch.zeros((), dtype=F32, device=hidden.device)
    n = torch.zeros((), dtype=F32, device=hidden.device)
    for t0 in range(0, T, loss_chunk):
        sl = slice(t0, t0 + loss_chunk)
        ce = _ce_fp32(unembed(params, cfg, hidden[:, sl]), labels[:, sl])
        s = s + torch.sum(ce * weights[:, sl])
        n = n + torch.sum(weights[:, sl])
    return s, n


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = False, loss_chunk: int = 0,
            aux_weight: float = 0.01, bf16_cotangent: bool = False,
            use_kernel: Optional[bool] = None,
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Scalar training loss ``loss + aux_weight · aux`` and metrics
    ``{"loss", "aux"}``: ``aux`` is the MoE layers' summed router loss (0
    for the dense family). ``use_kernel`` picks the attention route as in
    :func:`repro_torch.models.model.forward`."""
    _check_ported(cfg)
    hidden, _, aux = forward(params, cfg, batch, mode="train", remat=remat,
                             use_kernel=use_kernel, return_aux=True)
    if bf16_cotangent and hidden.dtype == torch.bfloat16:
        hidden = grad_cast_bf16(hidden)
    if cfg.objective == "clm":
        # predict token t+1 from position t
        labels = batch["targets"]
        weights = batch.get("weights")
        weights = (torch.ones(labels.shape, dtype=F32, device=labels.device)
                   if weights is None else weights.to(F32))
    elif cfg.objective == "mlm":
        labels = batch["labels"]
        weights = batch["mask"].to(F32)
    elif cfg.objective == "cls":
        logits = unembed(params, cfg, hidden[:, 0])       # CLS pooling
        loss = torch.mean(_ce_fp32(logits, batch["labels"]))
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}
    else:
        raise ValueError(cfg.objective)
    s, n = chunked_lm_loss(params, cfg, hidden, labels, weights,
                           loss_chunk=loss_chunk)
    loss = s / torch.clamp(n, min=1.0)
    return loss + aux_weight * aux, {"loss": loss, "aux": aux}
