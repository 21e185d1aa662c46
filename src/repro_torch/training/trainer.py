"""Train and eval steps (the twin of the JAX package's
``training/trainer.py``).

``make_train_step`` closes over (ModelConfig, TrainConfig) and returns
``(params, opt_state, batch, step) -> (params, opt_state, metrics)``:
schedule → (optionally microbatched) loss and gradients, with per-layer
activation checkpointing when ``remat == "block"`` → global-norm clip →
AdamW. The step is functional: it returns new parameter and moment trees.
The JAX package's mesh machinery (``train_state_shardings``,
``pjit_train_step``) is not ported: the port trains on one card.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.losses import loss_fn
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               warmup_cosine)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = Any


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch (``data.batch_for_step``) as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def value_and_grad(fn: Callable, params: Params, *args
                   ) -> Tuple[Tuple[torch.Tensor, Any], Params]:
    """``((value, aux), grads)`` of ``(value, aux) = fn(params, *args)``
    with respect to every leaf of ``params``; a leaf the value does not use
    gets a zero gradient, as under ``jax.value_and_grad``."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        value, aux = fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = tree_map(lambda x: x.detach(), aux)
    return (value.detach(), aux), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    loss_chunk: int = 0,
                    bf16_cotangent: bool = False) -> Callable:
    remat = tcfg.remat == "block"

    def compute_loss(params, batch):
        return loss_fn(params, cfg, batch, remat=remat, loss_chunk=loss_chunk,
                       bf16_cotangent=bf16_cotangent)

    def grads_of(params, batch):
        if tcfg.microbatches <= 1:
            (loss, metrics), grads = value_and_grad(compute_loss, params,
                                                    batch)
            return loss, metrics, grads
        M = tcfg.microbatches
        b = next(iter(batch.values())).shape[0]
        if b % M:
            raise ValueError(f"batch {b} does not split into {M} microbatches")
        loss = metrics = grads = None
        for i in range(M):
            mb = {k: v[i * (b // M):(i + 1) * (b // M)]
                  for k, v in batch.items()}
            (l_i, m_i), g_i = value_and_grad(compute_loss, params, mb)
            if grads is None:
                loss, metrics, grads = l_i, m_i, g_i
            else:
                loss = loss + l_i
                metrics = tree_map(torch.add, metrics, m_i)
                grads = tree_map(torch.add, grads, g_i)
        inv = 1.0 / M
        return (loss * inv, tree_map(lambda x: x * inv, metrics),
                tree_map(lambda g: (g.float() * inv).to(g.dtype), grads))

    def train_step(params: Params, opt_state, batch, step: int):
        lr = warmup_cosine(step, base_lr=tcfg.lr,
                           warmup_steps=tcfg.warmup_steps,
                           total_steps=tcfg.steps, end_frac=tcfg.end_lr_frac)
        loss, metrics, grads = grads_of(params, batch)
        grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        params, opt_state = adamw_update(
            grads, opt_state, params, lr=lr, b1=tcfg.b1, b2=tcfg.b2,
            weight_decay=tcfg.weight_decay)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr, total=loss)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, *, loss_chunk: int = 0) -> Callable:
    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, cfg, batch, loss_chunk=loss_chunk)
        return metrics

    return eval_step


def init_train_state(cfg: ModelConfig, gen: torch.Generator, *,
                     device="cuda") -> Tuple[Params, Any]:
    from repro_torch.models.model import init_params
    with torch.no_grad():
        params = init_params(cfg, gen, device=device)
    return params, adamw_init(params)
