"""Carry state across from the JAX package.

``from_numpy_tree(tree, device)`` turns a pytree of the reference's
arrays, already converted with ``np.asarray`` (agent models W (K, M),
combination matrices, weight vectors, ``w_star``, gradient stacks), into
tensors of the same structure and dtypes on ``device``.

bfloat16: ``np.asarray`` of a JAX bf16 array is an ``ml_dtypes.bfloat16``
array, which ``torch.from_numpy`` refuses, so it crosses as its 16
bits (``view(np.int16)``) and is reinterpreted with ``Tensor.view(torch.bfloat16)``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import devices, pytree


def _to_tensor(leaf, device: torch.device) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def from_numpy_tree(tree, device="cuda"):
    """Same structure, same dtypes, tensors on ``device``."""
    dev = devices.resolve(device)
    return pytree.tree_map(lambda leaf: _to_tensor(leaf, dev), tree)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as a float32 numpy array (bf16 is widened exactly)."""
    return t.detach().to("cpu", torch.float32).numpy()
