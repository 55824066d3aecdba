"""Parameter trees: nested dicts, lists, tuples and NamedTuples whose leaves
are tensors (the part of ``jax.tree_util`` the training path uses).

Leaves come in ``jax.tree_util``'s order: a dict's values by sorted key, a
list's or tuple's in order, a NamedTuple's by field; ``None`` is an empty
subtree.  :func:`tree_paths` names each leaf as ``jax.tree_util.keystr``
does (``.field``, ``['key']``, ``[i]``).
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_leaves", "tree_map", "tree_paths"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """[(key text, child)] of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", x) for i, x in enumerate(tree)]
    return None


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf)]`` in leaf order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for key, child in kids for pl in tree_paths(child,
                                                           prefix + key)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), called in leaf order; returns
    a tree of the same structure as ``tree``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)
