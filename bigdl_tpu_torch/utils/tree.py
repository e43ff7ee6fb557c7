"""Nested-dict trees of tensors — the part of ``jax.tree_util`` the port's
training path uses.

A tree is a dict, list or tuple of trees, or a leaf. :func:`tree_leaves`
walks dict keys in sorted order, as ``jax.tree_util.tree_leaves`` does,
so the port's flat lists of weights line up with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """The tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    return _build(like, iter(leaves))


def _build(t: Any, it) -> Any:
    # module level, not a closure: a recursive closure is a reference
    # cycle (function -> cell -> function) that would keep the leaves'
    # iterator, and so every leaf, alive until the cyclic collector runs
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)
