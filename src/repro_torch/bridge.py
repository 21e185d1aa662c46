"""Carry parameter and LiGO-operator trees between the two packages.

Both packages keep one tree layout (nested dicts, layer stacks with a leading
L dim, weights ``(in, out)``), so a bridge is a leaf-for-leaf copy: no
transposes, no renames. :func:`to_torch` takes any tree of array-likes that
``numpy.asarray`` accepts (numpy arrays, or JAX arrays, which the caller
hands over without this module importing JAX); :func:`to_numpy` goes back.
numpy has no bfloat16, so bf16 leaves cross as float32 on the way back
(exact), and bf16 leaves coming in (``ml_dtypes.bfloat16``) are taken bit for
bit. Every leaf keeps its own dtype: an MoE tree's float32 router and
Mamba2's float32 ``A_log``, ``Dskip`` and ``dt_bias`` ride beside bf16
weights in both packages, and a ``dtype`` cast passes them by. Tuples
(the recurrent families' decode caches) cross as tuples.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch


def _leaf_to_torch(x, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.array(x)            # a writable copy: never alias the source
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


# Leaves that are float32 in a model of any dtype (``models/moe.py``,
# ``models/blocks.py``'s Mamba2 block).
FLOAT32_LEAVES = ("router", "A_log", "Dskip", "dt_bias")


def to_torch(tree: Any, device="cpu", dtype: Optional[torch.dtype] = None):
    """A nested dict (or tuple) of arrays → the same tree of tensors on
    ``device``.

    ``dtype`` casts floating leaves, except the float32 ones the models
    keep in any dtype (:data:`FLOAT32_LEAVES`); integer leaves keep
    theirs."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device,
                            None if k in FLOAT32_LEAVES else dtype)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_torch(v, device, dtype) for v in tree)
    return _leaf_to_torch(tree, device, dtype)


def to_numpy(tree: Any):
    """A nested dict (or tuple) of tensors → the same tree of numpy arrays
    (host)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
