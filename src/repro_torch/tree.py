"""Nested dict and list parameter trees: the port's stand-in for JAX pytrees.

Leaves are tensors, ``ProtectedTensor``s or any value that is neither a
dict nor a list. Dict keys are visited in sorted order and list items in
index order, as ``jax.tree_util`` flattens them, so plans, leaf lists and
per-leaf fault seeds line up with the reference's. A list index stays an
``int`` in a path (sorted as strings, ``"10"`` would come before ``"2"``).
"""
from __future__ import annotations

from typing import Callable, Iterator


def path_str(path) -> str:
    """('stages', 0, 1, 'c1', 'w') -> 'stages/0/1/c1/w', as the reference's
    ``path_str`` joins dict keys and sequence indices."""
    return "/".join(str(p) for p in path)


def _children(tree):
    """``(key, child)`` pairs of a dict (keys sorted) or a list (in order),
    else None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, list):
        return list(enumerate(tree))
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """Yield ``(path tuple, leaf)`` over a nested dict/list in
    ``jax.tree_util`` order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, child in kids:
        yield from leaves_with_path(child, prefix + (k,))


def map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """New tree of the same dicts and lists with ``fn(path, leaf)`` at every
    leaf, called in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [map_with_path(fn, x, prefix + (i,))
                for i, x in enumerate(tree)]
    return fn(prefix, tree)


def unflatten_like(tree, leaves) -> object:
    """A tree shaped as ``tree`` whose leaves are ``leaves`` (an iterable in
    :func:`leaves_with_path` order)."""
    it = iter(leaves)
    return map_with_path(lambda _p, _x: next(it), tree)


def get_path(tree, path: tuple):
    """The leaf of a nested dict/list at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree: dict, path: tuple, value) -> None:
    """Set the leaf at ``path``, creating the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
