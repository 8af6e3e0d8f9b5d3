"""Trees of tensors: nested dicts, lists, tuples and NamedTuples (the
parameter dicts, optimizer and training states), walked in one fixed order,
dict keys sorted as ``jax.tree.leaves`` sorts them."""
from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in a fixed order."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of ``tree``, the structure kept."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub) for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        subs = [tree_map(fn, sub) for sub in tree]
        return type(tree)(*subs) if hasattr(tree, "_fields") else \
            type(tree)(subs)
    return fn(tree)


def unflatten(like, flat):
    """A tree shaped as ``like`` whose leaves are ``flat``, taken in the
    order :func:`leaves` walks ``like``."""
    it = iter(flat)

    def build(sub):
        if isinstance(sub, dict):
            return {key: build(sub[key]) for key in sorted(sub)}
        if isinstance(sub, (list, tuple)):
            subs = [build(s) for s in sub]
            return type(sub)(*subs) if hasattr(sub, "_fields") else \
                type(sub)(subs)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
