"""Minimal pytrees: nested dicts, lists and tuples of leaves.

The reference flattens parameter and gradient trees with ``jax.tree``;
the port needs the same leaf order (dict keys sorted) to stage a tree
into one buffer and to carry trees across from the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

TreeDef = Any   # nested tuples describing the containers; None marks a leaf


def flatten(tree, is_leaf: Optional[Callable] = None
            ) -> Tuple[List[Any], TreeDef]:
    """Leaves in ``jax.tree`` order and a definition to rebuild the tree;
    ``is_leaf(node)`` true stops the walk at a container (a shape tuple)."""
    leaves: List[Any] = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return None
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, None, tuple(walk(c) for c in t))
        leaves.append(t)
        return None

    return leaves, walk(tree)


def unflatten(treedef: TreeDef, leaves) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, children = d
        built = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, built))
        return built if kind == "list" else tuple(built)

    return build(treedef)


def tree_map(fn: Callable, tree):
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(leaf) for leaf in leaves])
