"""Nested dict, list and tuple trees: the port's stand-in for JAX pytrees.

Leaves are tensors, ``ProtectedTensor``s or any value that is not a dict,
a list or a tuple. Dict keys are visited in sorted order, list and tuple
items in index order and a NamedTuple's fields in their declared order, as
``jax.tree_util`` flattens them, so plans, leaf lists, checkpoints and
per-leaf fault seeds line up with the reference's. A list or tuple index
stays an ``int`` in a path (sorted as strings, ``"10"`` would come before
``"2"``); a NamedTuple field is a :class:`Field`.
"""
from __future__ import annotations

from typing import Callable, Iterator


def path_str(path) -> str:
    """('stages', 0, 1, 'c1', 'w') -> 'stages/0/1/c1/w', as the reference's
    ``path_str`` joins dict keys and sequence indices."""
    return "/".join(str(p) for p in path)


class Field(str):
    """A NamedTuple field's key in a path: its name (``path_str`` prints
    it). ``jax.tree_util`` keys such a field by a ``GetAttrKey``, which has
    no ``key`` or ``idx``, so the reference's ``is_protected_weight`` reads
    its name as ``""``: ``wot.is_protected_weight`` does the same."""


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree):
    """``(key, child)`` pairs of a dict (keys sorted), a NamedTuple (fields
    in order) or a list or tuple (in order), else None for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(Field(f), getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """Yield ``(path tuple, leaf)`` over a nested dict/list/tuple in
    ``jax.tree_util`` order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, child in kids:
        yield from leaves_with_path(child, prefix + (k,))


def map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """New tree of the same dicts, lists and tuples with ``fn(path, leaf)``
    at every leaf, called in ``jax.tree_util`` order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    out = [map_with_path(fn, x, prefix + (k,)) for k, x in kids]
    if _is_namedtuple(tree):
        return type(tree)(*out)
    return type(tree)(out)


def unflatten_like(tree, leaves) -> object:
    """A tree shaped as ``tree`` whose leaves are ``leaves`` (an iterable in
    :func:`leaves_with_path` order)."""
    it = iter(leaves)
    return map_with_path(lambda _p, _x: next(it), tree)


def get_path(tree, path: tuple):
    """The leaf of a nested dict/list/tuple at ``path``."""
    for k in path:
        tree = getattr(tree, k) if isinstance(k, Field) else tree[k]
    return tree


def set_path(tree: dict, path: tuple, value) -> None:
    """Set the leaf at ``path``, creating the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
