"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Leaves are tensors, ``ProtectedTensor``s or any non-dict value. Keys are
visited in sorted order, as ``jax.tree_util`` visits dict keys, so plans
and leaf lists line up with the reference's.
"""
from __future__ import annotations

from typing import Callable, Iterator


def path_str(path) -> str:
    """('layers', 'attn', 'wq') -> 'layers/attn/wq'."""
    return "/".join(str(p) for p in path)


def leaves_with_path(tree, prefix: tuple = ()) -> Iterator[tuple]:
    """Yield ``(path tuple, leaf)`` over a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def map_with_path(fn: Callable, tree, prefix: tuple = ()):
    """New nested dict with ``fn(path, leaf)`` at every leaf, called in
    sorted key order."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    return fn(prefix, tree)


def get_path(tree, path: tuple):
    """The leaf of a nested dict at ``path``."""
    for k in path:
        tree = tree[k]
    return tree


def set_path(tree: dict, path: tuple, value) -> None:
    """Set the leaf at ``path``, creating the dicts on the way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value
