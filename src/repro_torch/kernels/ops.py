"""The aggregation engine: one entry point for every MM aggregation.

Counterpart of ``repro.kernels.ops``.  ``AggregationEngine`` puts the
Hopper kernels (``backend="pallas"``, the reference's name for its fused
kernel) or the plain estimator of ``core.location`` (``backend="jnp"``)
behind one API:

  aggregate(x, a=None)          -- (K, ...) tensor -> (...)
  aggregate_batched(x, A)       -- (K, ...) x (K, N) weight columns -> (N, ...)
  aggregate_tree(tree, a=None)  -- whole gradient pytree, ONE kernel launch

Tree path: every leaf is copied into one preallocated (K, M_total) f32
staging buffer, one kernel launch aggregates it, and the (M_total,)
estimate is split back into views shaped like the leaves, cast to each
leaf's dtype.  The kernel masks its ragged last tile, so the staging
buffer is the only copy of the tree that the launch makes.

Inside a ``record_workloads()`` scope every launch appends its resolved
workload (K, M, N, dtype, backend, block sizes, path) once; the scenario
runner builds its launch audit from those records.  ``lower_launch``,
``lower_tree`` and leaf donation wait for the serving slice.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

from repro_torch import pytree
from repro_torch.core import location, mestimators
from repro_torch.kernels import mm_aggregate as _k

BACKENDS = ("pallas", "jnp")

_ACTIVE_RECORDERS: list = []


@contextlib.contextmanager
def record_workloads():
    """Collect {k, m, n, dtype, backend, block_m, block_k, path} dicts for
    every distinct engine workload launched inside the scope."""
    records: list = []
    _ACTIVE_RECORDERS.append(records)
    try:
        yield records
    finally:
        for i, r in enumerate(_ACTIVE_RECORDERS):
            if r is records:
                del _ACTIVE_RECORDERS[i]
                break


def _record_workload(entry: dict) -> None:
    for records in _ACTIVE_RECORDERS:
        if entry not in records:
            records.append(dict(entry))


class AggregationEngine:
    """Weighted, batched MM aggregation around the Hopper kernels.

    ``block_m``/``block_k``/``path`` of None resolve per launch through
    ``mm_aggregate.launch_plan`` (the tuning cache or its heuristic, and
    ``auto_path``).  The engine runs on whatever device its inputs are
    on: CUDA tensors launch the kernels, CPU tensors take their plain
    versions.
    """

    def __init__(self, *, num_iters: int = 10,
                 c: float = mestimators.TUKEY_C95,
                 block_m: Optional[int] = None,
                 block_k: Optional[int] = None,
                 backend: str = "pallas",
                 path: Optional[str] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if path is not None and path not in _k.PATHS:
            raise ValueError(f"unknown kernel path {path!r}; known: {_k.PATHS}")
        self.num_iters = num_iters
        self.c = c
        self.block_m = block_m
        self.block_k = block_k
        self.backend = backend
        self.path = path

    def _record(self, x: torch.Tensor, k: int, m: int, n: int = 1) -> None:
        entry = {"k": int(k), "m": int(m), "n": int(n),
                 "dtype": _k.dtype_name(x.dtype), "backend": self.backend}
        if self.backend == "pallas":
            plan = _k.launch_plan(k, m, n, dtype=x.dtype,
                                  block_m=self.block_m, block_k=self.block_k,
                                  path=self.path)
            entry.update(block_m=plan.block_m, block_k=plan.block_k,
                         path=plan.path)
        else:
            entry.update(block_m=None, block_k=None, path=None)
        _record_workload(entry)

    def _kernel_opts(self) -> dict:
        return dict(num_iters=self.num_iters, c=self.c, block_m=self.block_m,
                    block_k=self.block_k, path=self.path)

    # -- tensors -----------------------------------------------------------

    def aggregate(self, x: torch.Tensor,
                  a: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MM location estimate along axis 0: (K, ...) -> (...)."""
        k = x.shape[0]
        m = x.numel() // max(k, 1)
        self._record(x, k, m)
        if self.backend == "jnp":
            af = None if a is None else a.to(torch.float32)
            out = location.mm_estimate(
                x.to(torch.float32), a=af, loss=mestimators.tukey(self.c),
                num_iters=self.num_iters).estimate
            return out.to(x.dtype)
        out = _k.mm_aggregate_2d(x.reshape(k, -1), a, **self._kernel_opts())
        return out.reshape(x.shape[1:])

    def aggregate_batched(self, x: torch.Tensor,
                          a: torch.Tensor) -> torch.Tensor:
        """(K, ...) values x (K, N) weight columns -> (N, ...): every
        neighborhood of a combination matrix in one kernel launch."""
        k = x.shape[0]
        n = a.shape[1]
        flat = x.reshape(k, -1)
        self._record(x, k, flat.shape[1], n)
        if self.backend == "jnp":
            xb = flat.to(torch.float32).unsqueeze(1).expand(k, n, flat.shape[1])
            out = location.mm_estimate(
                xb, a=a.to(torch.float32), loss=mestimators.tukey(self.c),
                num_iters=self.num_iters).estimate.to(x.dtype)
        else:
            out = _k.mm_aggregate_batched_2d(flat, a, **self._kernel_opts())
        return out.reshape((n,) + tuple(x.shape[1:]))

    # -- pytrees -----------------------------------------------------------

    def aggregate_tree(self, tree, a: Optional[torch.Tensor] = None):
        """Aggregate a pytree of stacked (K, ...) leaves in ONE launch."""
        leaves, treedef = pytree.flatten(tree)
        if not leaves:
            return tree
        agg = self.aggregate(stage_leaves(leaves), a)
        outs, off = [], 0
        for leaf in leaves:
            n = leaf[0].numel()
            outs.append(agg[off:off + n].reshape(leaf.shape[1:]).to(leaf.dtype))
            off += n
        return pytree.unflatten(treedef, outs)


def stage_leaves(leaves) -> torch.Tensor:
    """Copy stacked (K, ...) leaves into one preallocated (K, M_total) f32
    buffer, leaf after leaf along M (the tree path's staging layout)."""
    k = leaves[0].shape[0]
    sizes = [leaf.numel() // k for leaf in leaves]
    buf = torch.empty((k, sum(sizes)), dtype=torch.float32,
                      device=leaves[0].device)
    off = 0
    for leaf, n in zip(leaves, sizes):
        buf[:, off:off + n].copy_(leaf.reshape(k, n))
        off += n
    return buf


@functools.lru_cache(maxsize=None)
def get_engine(**kwargs) -> AggregationEngine:
    """Shared engines, memoized by configuration."""
    return AggregationEngine(**kwargs)


def _engine(num_iters, c, block_m, block_k, backend, path):
    return get_engine(num_iters=num_iters, c=c, block_m=block_m,
                      block_k=block_k, backend=backend, path=path)


def mm_aggregate(x: torch.Tensor, a: Optional[torch.Tensor] = None, *,
                 num_iters: int = 10, c: float = mestimators.TUKEY_C95,
                 block_m: Optional[int] = None, block_k: Optional[int] = None,
                 backend: str = "pallas",
                 path: Optional[str] = None) -> torch.Tensor:
    """MM location estimate along axis 0: (K, ...) -> (...)."""
    return _engine(num_iters, c, block_m, block_k, backend,
                   path).aggregate(x, a)


def mm_aggregate_batched(x: torch.Tensor, a: torch.Tensor, *,
                         num_iters: int = 10,
                         c: float = mestimators.TUKEY_C95,
                         block_m: Optional[int] = None,
                         block_k: Optional[int] = None,
                         backend: str = "pallas",
                         path: Optional[str] = None) -> torch.Tensor:
    """Batched weighted aggregation: (K, ...) x (K, N) -> (N, ...)."""
    return _engine(num_iters, c, block_m, block_k, backend,
                   path).aggregate_batched(x, a)


def mm_aggregate_tree(tree, a: Optional[torch.Tensor] = None, *,
                      num_iters: int = 10, c: float = mestimators.TUKEY_C95,
                      block_m: Optional[int] = None,
                      block_k: Optional[int] = None,
                      backend: str = "pallas", path: Optional[str] = None):
    """Aggregate a pytree of stacked (K, ...) leaves in ONE kernel launch."""
    return _engine(num_iters, c, block_m, block_k, backend,
                   path).aggregate_tree(tree, a)
