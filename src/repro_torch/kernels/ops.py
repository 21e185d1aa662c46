"""Dispatch between the port's kernels and their plain versions.

A CUDA tensor goes to the hand-written kernel, a CPU tensor to the plain
PyTorch version in :mod:`repro_torch.kernels.ref`. The choice follows the
device of the tensors alone: there is no ``try`` and no environment switch,
and on a CUDA tensor the kernel launches or raises.

:func:`launch_counts` reads the kernels' plain-integer launch counters (the
port's stand-in for the JAX package's ``LAUNCH_COUNTS``) and
:func:`reset_launch_counts` sets them to 0.

Serving needs no gradient, and the backward kernel K2 comes with the
training slice: until then the CUDA path raises on inputs that require grad.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ligo_expand, ref


def ligo_blend_expand_grouped(w: torch.Tensor, B: torch.Tensor,
                              W: torch.Tensor) -> torch.Tensor:
    """Grouped ``P[g,k,e] = B @ (Σ_l w[g,k,l] W[g,l,e])``.

    w: (G, L2, L1); B: (I, A); W: (G, L1, E, A, Bd) → (G, L2, E, I, Bd).
    """
    if W.is_cuda:
        return ligo_expand.ligo_blend_expand_grouped(w, B, W)
    return ref.ligo_blend_expand_grouped_ref(w, B, W)


def launch_counts() -> Dict[str, int]:
    return {"ligo_blend_expand_grouped": ligo_expand.LAUNCHES}


def reset_launch_counts() -> None:
    ligo_expand.LAUNCHES = 0

