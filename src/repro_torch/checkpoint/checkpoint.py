"""Minimal pytree checkpointing (``repro.checkpoint.checkpoint``).

The reference's format, so a file written by either package restores in
the other: one ``.npz`` of the tree's leaves keyed by their ``/``-joined
paths (dict keys; list and tuple indices; ``.field`` for a NamedTuple
field, as JAX names a field's path entry), and ``<path>.meta.json``
with the step.  bfloat16 leaves are stored widened to float32 (numpy
has no bfloat16 of its own); ``restore`` casts every leaf to the dtype
of the template's.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _items(tree, prefix=()):
    """(path tuple, leaf) in ``jax.tree`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _items(v, prefix + ("." + name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {"/".join(path): _to_numpy(leaf) for path, leaf in _items(tree)}


def save(path: str, tree, step: int | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))
    if step is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({"step": int(step)}, f)


def _rebuild(like, data, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(like[k], data, prefix + (str(k),)) for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, data, prefix + ("." + n,))
                            for n, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, data, prefix + (str(i),))
                          for i, v in enumerate(like))
    key = "/".join(prefix)
    arr = data[key]
    if isinstance(like, torch.Tensor):
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                             f"{tuple(like.shape)}")
        return torch.from_numpy(np.array(arr)).to(dtype=like.dtype,
                                                  device=like.device)
    return type(like)(arr) if np.ndim(arr) == 0 else arr


def restore(path: str, like) -> Any:
    """Restore into the structure of ``like`` (a template pytree): every
    tensor leaf with the template leaf's shape, dtype and device."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return _rebuild(like, data)


def latest_step(path: str) -> int | None:
    meta = path + ".meta.json"
    if not os.path.exists(meta):
        return None
    with open(meta) as f:
        return json.load(f)["step"]
