"""Minimal pytree utilities over nested dicts / lists / tuples.

They follow ``jax.tree_util``'s conventions, not ``torch.utils._pytree``'s:
dict children are visited in SORTED key order (torch's pytree uses insertion
order), lists and tuples in index order, and ``None`` is an empty subtree.
Every flat-plane offset depends on this order, so the port's planes line up
with the JAX package's element for element.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple


class DictKey(NamedTuple):
    key: Any


class SequenceKey(NamedTuple):
    idx: int


class _Leaf:
    """Placeholder marking a leaf position inside a treedef."""


_LEAF = _Leaf()


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``(path, leaf)`` pairs in jax flatten order, plus a treedef that
    :func:`tree_unflatten` rebuilds the structure from."""
    out: List[Tuple[tuple, Any]] = []

    def rec(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(node[k], path + (DictKey(k),))
                    for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            kids = [rec(c, path + (SequenceKey(i),))
                    for i, c in enumerate(node)]
            return tuple(kids) if isinstance(node, tuple) else kids
        out.append((path, node))
        return _LEAF

    treedef = rec(tree, ())
    return out, treedef


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    flat, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in flat], treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def rec(node):
        if node is _LEAF:
            return next(it)
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        kids = [rec(c) for c in node]
        return tuple(kids) if isinstance(node, tuple) else kids

    return rec(treedef)


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(x, *ys) for x, *ys in zip(leaves, *others)])
