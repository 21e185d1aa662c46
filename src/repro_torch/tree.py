"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

Parameter trees, LiGO operators and optimizer moments are nested dicts whose
leaves are tensors; a decode state nests dicts in tuples (the recurrent
families' ``(mLSTM, sLSTM)`` and ``(Mamba2, attention)`` blocks). Keys may
hold ``/`` (the depth blends are keyed by leaf paths such as ``"mlp/w1"``),
so these helpers walk the dicts and tuples themselves instead of flattening
to path strings. Leaves come in insertion order; tuple and list items in
theirs.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List


def _is_seq(tree: Any) -> bool:
    return type(tree) in (tuple, list)      # a NamedTuple stays a leaf


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_seq(tree):
        return type(tree)(tree_map(fn, *xs)
                          for xs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if _is_seq(tree):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def sorted_leaves(tree: Any) -> List[Any]:
    """Leaves with dict keys sorted at every level: JAX's flatten order,
    the same for any insertion order (a reduction over leaves in this order
    gives the same bits for a grown tree and for the same tree restored
    from a checkpoint)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if _is_seq(tree):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """A tree with the structure of ``like`` and the given leaves, in
    :func:`tree_leaves` order."""
    it: Iterator[Any] = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def same_structure(a: Any, b: Any) -> bool:
    if isinstance(a, dict) != isinstance(b, dict) or _is_seq(a) != _is_seq(b):
        return False
    if _is_seq(a):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same_structure(x, y) for x, y in zip(a, b)))
    if not isinstance(a, dict):
        return True
    return a.keys() == b.keys() and all(same_structure(a[k], b[k])
                                        for k in a)
