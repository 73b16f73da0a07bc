"""Nested dicts/lists of tensors, walked in the JAX pytree leaf order.

Dict keys are visited sorted, as ``jax.tree.leaves`` does, so leaf counts,
byte counts and global-norm sums follow the reference's order.
"""

from __future__ import annotations

from typing import Any, Callable

PyTree = Any


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leafwise over trees of one structure, in leaf order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *items) for items in zip(tree, *rest))
    return fn(tree, *rest)


def tree_map_with_names(fn: Callable[[tuple[str, ...], Any], Any], tree: PyTree,
                        names: tuple[str, ...] = ()) -> PyTree:
    """``fn(names, leaf)`` over every leaf, ``names`` the dict keys on the
    way down (list positions add none), as the reference's sharding rules
    read a ``tree_flatten_with_path`` path."""
    if isinstance(tree, dict):
        return {k: tree_map_with_names(fn, tree[k], (*names, str(k))) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_names(fn, item, names) for item in tree)
    return fn(names, tree)
