"""Carry parameter and LiGO-operator trees between the two packages.

Both packages keep one tree layout (nested dicts, layer stacks with a leading
L dim, weights ``(in, out)``), so a bridge is a leaf-for-leaf copy: no
transposes, no renames. :func:`to_torch` takes any tree of array-likes that
``numpy.asarray`` accepts (numpy arrays, or JAX arrays, which the caller
hands over without this module importing JAX); :func:`to_numpy` goes back.
numpy has no bfloat16, so bf16 leaves cross as float32 on the way back
(exact), and bf16 leaves coming in (``ml_dtypes.bfloat16``) are taken bit for
bit. Every leaf keeps its own dtype: an MoE tree's float32 router rides
beside bf16 experts in both packages, and a ``dtype`` cast passes it by.
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


# Leaves that are float32 in a model of any dtype (``models/moe.py``).
FLOAT32_LEAVES = ("router",)


def to_torch(tree: Any, device="cpu", dtype: Optional[torch.dtype] = None):
    """A nested dict of arrays → the same dict of tensors on ``device``.

    ``dtype`` casts floating leaves, except the float32 ones the models
    keep in any dtype (:data:`FLOAT32_LEAVES`); integer leaves keep
    theirs."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device,
                            None if k in FLOAT32_LEAVES else dtype)
                for k, v in tree.items()}
    return _leaf_to_torch(tree, device, dtype)


def to_numpy(tree: Any):
    """A nested dict of tensors → the same dict of numpy arrays (host)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
