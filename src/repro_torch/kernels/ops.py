"""Dispatch between the port's kernels and their plain versions.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. The choice follows the
device of the tensors alone: there is no ``try`` and no environment switch,
and on a CUDA tensor the kernel launches or raises.

:func:`ligo_blend_expand_grouped_vjp` is the differentiable entry point the
GrowthPlan uses (:mod:`repro_torch.core.plan`), the twin of the JAX
package's ``custom_vjp``: a ``torch.autograd.Function`` whose forward is
kernel K1 and whose backward is kernel K2, which emits all three cotangents
(dw, dB, dW) of one leaf group in one call.

:func:`flash_attention` is kernel K3 (forward only: it serves the attention
of every forward that records no autograd graph, see
:func:`repro_torch.models.layers.full_attention`).

:func:`launch_counts` reads the kernels' plain-integer launch counters (the
port's stand-in for the JAX package's ``LAUNCH_COUNTS``) and
:func:`reset_launch_counts` sets them to 0.

K1 and K2 are registered as the custom operators
``torch.ops.repro_torch.ligo_blend_expand_grouped`` and
``torch.ops.repro_torch.ligo_blend_expand_bwd_fused``, each with a fake
(shape-only) implementation and its operation count as a
``torch.utils.flop_counter`` formula: the measured-cost pass
(:mod:`repro_torch.obs.costs`) runs a step on fake tensors under
``FlopCounterMode`` and counts the kernels' work without launching them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (flash_attention as _flash,
                                 ligo_expand, ligo_expand_bwd, ref)


def ligo_blend_expand_grouped(w: torch.Tensor, B: torch.Tensor,
                              W: torch.Tensor) -> torch.Tensor:
    """Grouped ``P[g,k,e] = B @ (Σ_l w[g,k,l] W[g,l,e])``.

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).
    """
    if W.is_cuda:
        return ligo_expand.ligo_blend_expand_grouped(w, B, W)
    return ref.ligo_blend_expand_grouped_ref(w, B, W)


def _dims(w, B, W):
    """(G, L2, L1, E, I, A, Bd) of K1's operands, given as tensors or, as
    a flop formula gets them, as shapes."""
    (G, L2, L1), (I, A), Ws = (tuple(getattr(x, "shape", x))
                               for x in (w, B, W))
    return G, L2, L1, Ws[2], I, A, Ws[4]


@torch.library.custom_op("repro_torch::ligo_blend_expand_grouped",
                         mutates_args=())
def _k1(w: torch.Tensor, B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Kernel K1 (raises on tensors that are not on CUDA)."""
    return ligo_expand.ligo_blend_expand_grouped(w, B, W)


@_k1.register_fake
def _k1_fake(w, B, W):
    G, L2, _, E, I, _, Bd = _dims(w, B, W)
    return W.new_empty((G, L2, E, I, Bd))


@register_flop_formula(torch.ops.repro_torch.ligo_blend_expand_grouped)
def _k1_flops(w, B, W, *args, **kwargs) -> int:
    return ligo_expand.operation_count(*_dims(w, B, W))


@torch.library.custom_op("repro_torch::ligo_blend_expand_bwd_fused",
                         mutates_args=())
def _k2(w: torch.Tensor, B: torch.Tensor, W: torch.Tensor,
        dP: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel K2: dw (float32), dB, dW (raises off CUDA)."""
    return ligo_expand_bwd.ligo_blend_expand_bwd(w, B, W, dP)


@_k2.register_fake
def _k2_fake(w, B, W, dP):
    return (w.new_empty(w.shape, dtype=torch.float32), torch.empty_like(B),
            torch.empty_like(W))


@register_flop_formula(torch.ops.repro_torch.ligo_blend_expand_bwd_fused)
def _k2_flops(w, B, W, dP, *args, **kwargs) -> int:
    return ligo_expand_bwd.operation_count(*_dims(w, B, W))


#: the custom operators of the kernels, as ``FlopCounterMode`` keys them
KERNEL_OPS = (torch.ops.repro_torch.ligo_blend_expand_grouped,
              torch.ops.repro_torch.ligo_blend_expand_bwd_fused)


class _BlendExpandGrouped(torch.autograd.Function):
    """K1 forward and K2 backward, or both plain versions (``plain``)."""

    @staticmethod
    def forward(ctx, w, B, W, plain: bool):
        ctx.save_for_backward(w, B, W)
        ctx.plain = plain
        # the raw kernel wrapper refuses tensors that require grad
        w, B, W = w.detach(), B.detach(), W.detach()
        if plain:
            return ref.ligo_blend_expand_grouped_ref(w, B, W)
        return _k1(w, B, W)

    @staticmethod
    @once_differentiable
    def backward(ctx, dP):
        w, B, W = (x.detach() for x in ctx.saved_tensors)
        # dP arrives strided after the plan's slicing and right expansion
        dP = dP.contiguous()
        if ctx.plain:
            dw, dB, dW = ref.ligo_blend_expand_bwd_ref(w, B, W, dP)
        else:
            dw, dB, dW = _k2(w, B, W, dP)
            dw = dw.to(w.dtype)
        need = ctx.needs_input_grad
        return (dw if need[0] else None, dB if need[1] else None,
                dW if need[2] else None, None)


def ligo_blend_expand_grouped_vjp(w: torch.Tensor, B: torch.Tensor,
                                  W: torch.Tensor, *,
                                  use_kernel: Optional[bool] = None
                                  ) -> torch.Tensor:
    """Differentiable grouped ``P[g,k,e] = B @ (Σ_l w[g,k,l] W[g,l,e])``.

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).
    ``use_kernel=None`` follows the tensors' device (CUDA: K1 forward, K2
    backward; CPU: their plain versions); ``False`` asks for the plain
    versions on any device; ``True`` asks for the kernels, which raise on
    CPU tensors.
    """
    if use_kernel is None:
        use_kernel = W.is_cuda
    return _BlendExpandGrouped.apply(w, B, W, not use_kernel)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """(B, H, T, dh) × (B, KV, S, dh)² → (B, H, T, dh); GQA by index.

    ``use_kernel=None`` follows the tensors' device (CUDA: kernel K3; CPU:
    its plain version); ``False`` asks for the plain version on any device;
    ``True`` asks for the kernel, which raises on CPU tensors.
    """
    plain = (not q.is_cuda) if use_kernel is None else not use_kernel
    if plain:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _flash.flash_attention(q, k, v, causal=causal, window=window)


def launch_counts() -> Dict[str, int]:
    return {"ligo_blend_expand_grouped": ligo_expand.LAUNCHES,
            "ligo_blend_expand_bwd_fused": ligo_expand_bwd.LAUNCHES,
            "flash_attention": _flash.LAUNCHES}


def reset_launch_counts() -> None:
    ligo_expand.LAUNCHES = 0
    ligo_expand_bwd.LAUNCHES = 0
    _flash.LAUNCHES = 0
