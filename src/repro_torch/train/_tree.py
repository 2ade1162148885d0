"""Nested dicts, lists and tuples of leaves: the trees the training
substrate maps over (params, gradients, optimizer state).  Dict keys are
walked in sorted order, as ``jax.tree_util`` flattens them."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in leaves(c)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest`` (each has ``tree``'s structure down to its leaves, where it
    may hold a whole subtree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, c, *[r[i] for r in rest])
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def unzip(tree, like, n: int):
    """A tree of ``n``-tuples (``like``'s structure, a tuple at each of its
    leaves) -> ``n`` trees."""
    return tuple(tree_map(lambda _, t: t[i], like, tree) for i in range(n))
