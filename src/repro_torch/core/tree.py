"""Params trees of the port: nested dicts (and lists/tuples) of tensors
and packed leaves, walked the way ``jax.tree_util`` walks the reference's
— dict keys in sorted order, paths '/'-joined — so a leaf has the same
path, and the leaves the same order, in both packages."""
from __future__ import annotations

from typing import Callable, Iterator

__all__ = ["leaves_with_path", "map_with_path", "map_leaves", "leaves",
           "unflatten_like"]


def _children(tree):
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    return [(str(i), v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_path(tree, prefix: str = "") -> Iterator[tuple[str, object]]:
    """``(path, leaf)`` pairs in flatten order; ``None`` is no leaf."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for key, child in _children(tree):
        yield from leaves_with_path(child, f"{prefix}/{key}" if prefix
                                    else key)


def map_with_path(fn: Callable[[str, object], object], tree,
                  prefix: str = ""):
    """A tree of the same structure with every leaf replaced by
    ``fn(path, leaf)``, called in :func:`leaves_with_path` order."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(prefix, tree)

    def sub(key, child):
        return map_with_path(fn, child, f"{prefix}/{key}" if prefix
                             else key)

    if isinstance(tree, dict):         # visited in flatten order
        return {k: sub(str(k), tree[k]) for k in sorted(tree)}
    return type(tree)(sub(str(i), v) for i, v in enumerate(tree))


def map_leaves(fn: Callable[[object], object], tree):
    """:func:`map_with_path` without the path."""
    return map_with_path(lambda _, leaf: fn(leaf), tree)


def leaves(tree) -> list:
    """The leaves of ``tree`` in flatten order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten_like(tree, new_leaves) -> object:
    """A tree of ``tree``'s structure holding ``new_leaves`` (in flatten
    order) — ``jax.tree_util.tree_unflatten`` over ``tree``'s treedef."""
    it = iter(new_leaves)
    out = map_leaves(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
