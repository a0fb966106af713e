"""Nested dict/list trees of tensors: the port's stand-in for JAX pytrees.

Params and caches keep the JAX package's tree shape (dicts, lists, stacked
``[L, ...]`` leaves), so leaf names and paths line up one for one.  Paths are
spelled like ``jax.tree_util.keystr`` (``[0]['attn']['k_pool']``).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

__all__ = ["tree_map", "map_with_name", "leaves_with_path"]


def _key(k) -> str:
    return f"[{k!r}]"


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """Apply ``fn`` leaf-wise over one or more trees of the same shape;
    ``is_leaf(node)`` true stops the descent there (a partition spec is a
    tuple, and a leaf)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def map_with_name(fn: Callable, tree, *rest):
    """``fn(leaf_name, leaf, *rest_leaves)`` over every leaf of one or more
    trees of the same shape; the name is the leaf's last dict key."""
    def go(name, t, *r):
        if isinstance(t, dict):
            return {k: go(k, v, *(x[k] for x in r)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(go(name, v, *(x[i] for x in r)) for i, v in enumerate(t))
        return fn(name, t, *r)

    return go("", tree, *rest)


def leaves_with_path(tree, _path: str = "", _name: str = "") -> Iterator[Tuple[str, str, object]]:
    """Yield ``(path, leaf_name, leaf)`` in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, _path + _key(k), k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, _path + _key(i), _name)
    else:
        yield _path, _name, tree
