"""Trees of tensors: a tensor (or array), or a tuple / list / dict of
trees.  The training loop's data, the input pipeline's items and the
multi-process helpers' arguments are such trees."""

from __future__ import annotations

from typing import Any, Callable, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in order (dicts in insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)
