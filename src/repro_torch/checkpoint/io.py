"""Checkpoint serialisation: tensor tree ↔ npz + JSON metadata (the twin of
the JAX package's ``checkpoint/io.py``, in its on-disk format).

Format: ``<dir>/step_<N>/arrays.0.npz`` (flattened path → array) and
``meta.json`` (the caller's metadata plus ``step`` and ``_dtypes``). A step
is written to a ``.tmp_ckpt_`` directory and renamed into place, so a crash
mid-write never leaves a torn checkpoint.

Keys are the tree paths joined with ``|``, in the order JAX flattens a
tree: dict keys sorted, NamedTuple fields (``AdamWState``: ``m``, ``v``,
``count``) by name in field order. The depth-blend keys of a LiGO operator
hold ``/``, so ``|`` is the only separator. ``AdamWState.count`` is stored
as a 0-d int32 array, as the JAX package keeps it. numpy has no bfloat16:
a bf16 leaf is stored as its ``uint16`` bits and tagged in ``_dtypes``, and
read back with ``torch.from_numpy(u16).view(torch.bfloat16)``, so a
checkpoint of either package loads bit for bit in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

Params = Any
SEP = "|"

# dtype tag -> (torch dtype, unsigned numpy view of the same width)
_TAGGED = {"bfloat16": (torch.bfloat16, np.uint16)}


def _items(tree: Params, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in JAX's flatten order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), prefix + (name,))
    elif tree is not None:
        yield prefix, tree


def _host(leaf) -> torch.Tensor:
    """A CPU copy of the leaf (a tensor, a numpy array or a Python int: an
    int is a step count, stored as int32 as JAX stores it). Always a copy,
    so a later in-place update of the leaf cannot reach it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(leaf.copy())
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int32)
    raise TypeError(f"not a checkpointable leaf: {type(leaf).__name__}")


def flatten_tree(tree: Params) -> Dict[str, torch.Tensor]:
    """``{path: CPU tensor}`` in JAX's flatten order (a host copy)."""
    return {SEP.join(path): _host(leaf) for path, leaf in _items(tree)}


def unflatten_into(template: Params, flat: Dict[str, torch.Tensor]
                   ) -> Params:
    """A tree of ``template``'s structure with the leaves of ``flat``.

    Leaves are checked against the template's shapes and left on the host
    in the checkpoint's dtype; :meth:`CheckpointManager.restore` places and
    casts them. An int template leaf (a step count) comes back as an int.
    """
    def build(t, path):
        if isinstance(t, dict):
            return {k: build(v, path + (str(k),)) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, n), path + (n,))
                             for n in t._fields))
        key = SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        arr = flat[key]
        if isinstance(t, int):
            if arr.dim() != 0:
                raise ValueError(f"{key}: ckpt {tuple(arr.shape)} is not a "
                                 f"scalar count")
            return int(arr)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: ckpt {tuple(arr.shape)} != expected "
                             f"{tuple(t.shape)}")
        return arr
    return build(template, ())


def _to_numpy(t: torch.Tensor, key: str, dtypes: Dict[str, str]
              ) -> np.ndarray:
    for tag, (tdt, view) in _TAGGED.items():
        if t.dtype == tdt:
            dtypes[key] = tag
            return t.contiguous().view(torch.int16).numpy().view(view)
    return t.contiguous().numpy()


def save_step(directory: str, step: int, tree: Params,
              meta: Optional[Dict] = None, *, process_index: int = 0) -> str:
    """Write one step. ``tree`` is a tensor tree or an already-flattened
    ``{path: tensor or ndarray}`` dict (:func:`flatten_tree`)."""
    if isinstance(tree, dict) and tree and all(
            isinstance(v, (torch.Tensor, np.ndarray)) for v in tree.values()):
        flat = tree
    else:
        flat = flatten_tree(tree)
    dtypes: Dict[str, str] = {}
    save = {k: (_to_numpy(v, k, dtypes) if isinstance(v, torch.Tensor)
                else v) for k, v in flat.items()}
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, f"arrays.{process_index}.npz"), **save)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            # reserved keys last: a caller round-tripping a restored meta
            # dict must never override the authoritative step/_dtypes
            json.dump({**(meta or {}), "step": step, "_dtypes": dtypes}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def list_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def load_meta(directory: str, step: int) -> Dict:
    """The ``meta.json`` of one checkpoint, without reading the arrays (a
    resume reads the stage and config identity before it builds the
    template to restore into)."""
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "meta.json")) as f:
        return json.load(f)


def load_step(directory: str, step: int
              ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """``({path: CPU tensor}, meta)`` of one checkpoint; tagged leaves come
    back in their own dtype, bit for bit."""
    d = os.path.join(directory, f"step_{step:08d}")
    meta = load_meta(directory, step)
    tags = meta.get("_dtypes", {})
    flat: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("arrays.") and name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                for k in z.files:
                    arr = z[k]
                    if k in tags:
                        if tags[k] not in _TAGGED:
                            raise TypeError(f"{k}: checkpoint dtype "
                                            f"{tags[k]!r} is not supported")
                        tdt, view = _TAGGED[tags[k]]
                        flat[k] = torch.from_numpy(
                            arr.view(view).view(np.int16)).view(tdt)
                    else:
                        flat[k] = torch.from_numpy(arr)
    return flat, meta
