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


# The recursions are module-level functions, not closures: a nested
# function that calls itself is a reference cycle, which would keep the
# leaves it saw (plane and gradient tensors) alive until the cyclic garbage
# collector happens to run.
def _flatten(node, path, out):
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _flatten(node[k], path + (DictKey(k),), out)
                for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        kids = [_flatten(c, path + (SequenceKey(i),), out)
                for i, c in enumerate(node)]
        return tuple(kids) if isinstance(node, tuple) else kids
    out.append((path, node))
    return _LEAF


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[tuple, Any]], Any]:
    """``(path, leaf)`` pairs in jax flatten order, plus a treedef that
    :func:`tree_unflatten` rebuilds the structure from."""
    out: List[Tuple[tuple, Any]] = []
    treedef = _flatten(tree, (), out)
    return out, treedef


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    flat, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in flat], treedef


def tree_leaves(tree) -> List[Any]:
    return tree_flatten(tree)[0]


def _unflatten(node, it):
    if node is _LEAF:
        return next(it)
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _unflatten(v, it) for k, v in node.items()}
    kids = [_unflatten(c, it) for c in node]
    return tuple(kids) if isinstance(node, tuple) else kids


def tree_unflatten(treedef, leaves) -> Any:
    return _unflatten(treedef, iter(leaves))


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef,
                          [fn(x, *ys) for x, *ys in zip(leaves, *others)])
