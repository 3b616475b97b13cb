"""Minimal pytrees: nested dicts, lists and tuples of leaves.

The reference flattens parameter and gradient trees with ``jax.tree``;
the port needs the same leaf order (dict keys sorted) to stage a tree
into one buffer and to carry trees across from the JAX package.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

TreeDef = Any   # nested tuples describing the containers; None marks a leaf


def _walk(t, leaves: list, is_leaf):
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return None
    if isinstance(t, dict):
        keys = sorted(t)
        return ("dict", tuple(keys), tuple(_walk(t[k], leaves, is_leaf)
                                          for k in keys))
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, None, tuple(_walk(c, leaves, is_leaf)
                                              for c in t))
    leaves.append(t)
    return None


def flatten(tree, is_leaf: Optional[Callable] = None
            ) -> Tuple[List[Any], TreeDef]:
    """Leaves in ``jax.tree`` order and a definition to rebuild the tree;
    ``is_leaf(node)`` true stops the walk at a container (a shape tuple).

    The walks here are module-level functions, not closures that call
    themselves: such a closure is a reference cycle, which would keep
    the leaves it saw (multi-GB gradient stacks) alive until the cyclic
    garbage collector runs."""
    leaves: List[Any] = []
    treedef = _walk(tree, leaves, is_leaf)
    return leaves, treedef


def _build(d, it):
    if d is None:
        return next(it)
    kind, keys, children = d
    built = [_build(c, it) for c in children]
    if kind == "dict":
        return dict(zip(keys, built))
    return built if kind == "list" else tuple(built)


def unflatten(treedef: TreeDef, leaves) -> Any:
    return _build(treedef, iter(leaves))


def tree_map(fn: Callable, tree):
    leaves, treedef = flatten(tree)
    return unflatten(treedef, [fn(leaf) for leaf in leaves])


def _paths(t, prefix: tuple, out: List[str]) -> None:
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], prefix + (str(k),), out)
    elif isinstance(t, (list, tuple)):
        for i, c in enumerate(t):
            _paths(c, prefix + (str(i),), out)
    else:
        out.append(".".join(prefix))


def leaf_paths(tree) -> List[str]:
    """Each leaf's dotted path (``blocks.attn.wq``), in ``flatten`` order."""
    out: List[str] = []
    _paths(tree, (), out)
    return out
