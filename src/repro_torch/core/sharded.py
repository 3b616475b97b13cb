"""Distributed robust aggregation collectives (``repro.core.sharded``).

Mean aggregation lowers to an all-reduce.  An MM/median aggregator is a
*non-linear* reduction: every coordinate needs all K per-agent values,
so it cannot ride a reduction tree.  Three lowerings, each a drop-in
for a mean all-reduce over the agents of an ``launch.mesh.AgentMesh``
(one agent a rank, ``torch.distributed`` underneath):

  gather_mm  (paper-faithful baseline)
      all-gather (K x M) on every rank, the full MM estimate everywhere.
  rs_mm      robust aggregation is elementwise, so it commutes with
      sharding: all-to-all re-shards the K vectors so each rank owns the
      full K column of an M/K slice, runs MM on it, then all-gathers the
      estimates.  The wire cost of a mean all-reduce, 1/K of the MM work,
      and the same output as gather_mm, bit for bit.
  hier_mm    MM within each pod's ``data`` axis, then the mean across
      the ``pod`` axis (per-pod breakdown point: an ablation).

Each takes the axis to reduce over where the reference takes an axis
name: an ``Axis`` of the mesh, the ``AgentMesh`` itself (all agents), a
process group, or None (the default group); ``hier_mm`` takes two.  The
aggregator resolves through ``engine_aggregator``, so ``mm_pallas``
launches the Hopper single-pass kernel on a CUDA rank's local (K, M/K)
block (its plain version on a CPU tensor) and ``mm_tukey`` runs the
plain estimator.

Transport: the collectives used are ``all_gather_into_tensor``,
``all_to_all_single``, ``reduce_scatter_tensor`` (or their newer
``*_single`` names) and ``all_reduce``.
NCCL and gloo both take CUDA tensors for each of them (gloo copies
through host memory itself; checked on an H100 with torch 2.11), so no
collective is staged through host buffers here: ``transport`` names
what ran for the record.  ``TRAFFIC`` counts the bytes this rank sends
to the others, per collective.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.core import aggregators
from repro_torch.launch import mesh as mesh_lib

# MM-family names and the engine backend each defaults to: ``mm_pallas``
# launches the Hopper kernels (their plain versions on CPU tensors),
# ``mm_tukey`` / ``ref`` run the plain PyTorch estimator
_ENGINE_BACKENDS = {"mm_tukey": "jnp", "ref": "jnp", "mm_pallas": "pallas"}

# bytes this rank sent to the other ranks, by collective (a ring's share
# for the reductions): {"all_gather": n, "all_to_all": n, ...}
TRAFFIC = {"all_gather": 0, "all_to_all": 0, "reduce_scatter": 0,
           "all_reduce": 0}


def engine_aggregator(aggregator="mm_tukey", *, backend: Optional[str] = None,
                      **kwargs) -> Callable:
    """Resolve an aggregator name to a ``(stacked, a) -> estimate`` fn.

    MM-family names route through the one engine entry point
    (``kernels.ops.mm_aggregate``); ``backend`` overrides the name's
    default (``mm_tukey`` -> jnp, ``mm_pallas`` -> pallas).  Other names
    come from the core registry unchanged.
    """
    if isinstance(aggregator, str):
        default_backend = _ENGINE_BACKENDS.get(aggregator)
        if default_backend is not None:
            from repro_torch.kernels import ops  # deferred: avoid import cycle
            b = backend or default_backend

            def agg(x, a, _backend=b, _kw=kwargs):
                return ops.mm_aggregate(x, a, backend=_backend, **_kw)

            return agg
        return aggregators.get_aggregator(aggregator, **kwargs)
    return functools.partial(aggregator, **kwargs) if kwargs else aggregator


def _get_agg(aggregator, **kwargs) -> Callable:
    return engine_aggregator(aggregator, **kwargs)


def transport(axis=None) -> str:
    """How the collectives over ``axis`` move CUDA tensors: the backend
    and ``direct`` (every collective here takes the device tensors)."""
    ax = mesh_lib.resolve_axis(axis)
    return f"{dist.get_backend(ax.group)}:direct"


# ---------------------------------------------------------------------------
# the four primitives (contiguous tensors in, new tensors out)
# ---------------------------------------------------------------------------

# the single-tensor forms under their newer names where torch has them
# (the older ones warn there), else the older ones
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_gather(x: torch.Tensor, axis) -> torch.Tensor:
    """(K, *x.shape): row l is rank l's ``x``."""
    ax = mesh_lib.resolve_axis(axis)
    x = x.contiguous()
    out = torch.empty((ax.size * x.numel(),), dtype=x.dtype, device=x.device)
    # gloo wants the output flat: K blocks of x's elements
    _ALL_GATHER(out, x.reshape(-1), group=ax.group)
    TRAFFIC["all_gather"] += (ax.size - 1) * _nbytes(x)
    return out.reshape((ax.size,) + tuple(x.shape))


def all_to_all(x: torch.Tensor, axis) -> torch.Tensor:
    """x (K, ...) -> (K, ...): row l of the result is row ``index`` of
    rank l's ``x``."""
    ax = mesh_lib.resolve_axis(axis)
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ax.group)
    TRAFFIC["all_to_all"] += _nbytes(x) * (ax.size - 1) // ax.size
    return out


def reduce_scatter_sum(x: torch.Tensor, axis) -> torch.Tensor:
    """x (K * n, ...) -> (n, ...): this rank's block of the sum over
    ranks."""
    ax = mesh_lib.resolve_axis(axis)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _REDUCE_SCATTER(out, x, group=ax.group)
    TRAFFIC["reduce_scatter"] += _nbytes(x) * (ax.size - 1) // ax.size
    return out


def all_reduce_sum(x: torch.Tensor, axis) -> torch.Tensor:
    ax = mesh_lib.resolve_axis(axis)
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=ax.group)
    TRAFFIC["all_reduce"] += 2 * _nbytes(x) * (ax.size - 1) // ax.size
    return out


# ---------------------------------------------------------------------------
# the robust all-reduces
# ---------------------------------------------------------------------------

def gather_mm(x: torch.Tensor, axis, *, aggregator="mm_tukey",
              **agg_kwargs) -> torch.Tensor:
    """Paper-faithful robust all-reduce: all-gather + full local MM."""
    agg = _get_agg(aggregator, **agg_kwargs)
    return agg(all_gather(x, axis), None)


def rs_mm(x: torch.Tensor, axis, *, aggregator="mm_tukey",
          **agg_kwargs) -> torch.Tensor:
    """Reduce-scatter-style robust all-reduce: all-to-all -> local MM on
    M/K coordinates -> all-gather.

    When dim 0 of ``x`` divides K the split runs along dim 0 and the
    trailing dims stay intact (the reference keeps model-axis sharding
    that way); otherwise ``x`` is flattened and zero-padded to a
    multiple of K."""
    agg = _get_agg(aggregator, **agg_kwargs)
    k = mesh_lib.resolve_axis(axis).size

    if x.dim() >= 2 and x.shape[0] % k == 0:
        chunks = x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))
        local_est = agg(all_to_all(chunks, axis), None)    # (d0/K, ...)
        return all_gather(local_est, axis).reshape(x.shape)

    shape = x.shape
    flat = x.reshape(-1)
    m = flat.shape[0]
    pad = (-m) % k
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype,
                                            device=flat.device)])
    # after the all-to-all, row l is this rank's slice as agent l sent
    # it: axis 0 is the agent axis of our slice
    local_est = agg(all_to_all(flat.reshape(k, -1), axis), None)  # (M'/K,)
    out = all_gather(local_est, axis).reshape(-1)
    if pad:
        out = out[:m]
    return out.reshape(shape)


def hier_mm(x: torch.Tensor, inner_axis, outer_axis, *,
            aggregator="mm_tukey", inner_method: str = "rs_mm",
            **agg_kwargs) -> torch.Tensor:
    """Two-level aggregation: robust within ``inner_axis`` (a pod's data
    ranks), the arithmetic mean across ``outer_axis`` (pods).
    Approximate: breakdown guarantees hold per pod."""
    inner = rs_mm if inner_method == "rs_mm" else gather_mm
    pod_est = inner(x, inner_axis, aggregator=aggregator, **agg_kwargs)
    return mean_all_reduce(pod_est, outer_axis)


def mean_all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    """The non-robust baseline (classical data-parallel mean)."""
    return all_reduce_sum(x, axis) / mesh_lib.resolve_axis(axis).size


_METHODS = {
    "gather_mm": gather_mm,
    "rs_mm": rs_mm,
    "mean": mean_all_reduce,
}


def robust_all_reduce(x: torch.Tensor, axis, *, method: str = "rs_mm",
                      aggregator="mm_tukey", **agg_kwargs) -> torch.Tensor:
    """Dispatch by method name.  ``mean`` ignores aggregator kwargs;
    ``hier_mm`` takes ``axis=(outer, inner)``."""
    if method == "mean":
        return mean_all_reduce(x, axis)
    if method == "hier_mm":
        if not (isinstance(axis, (tuple, list)) and len(axis) == 2):
            raise ValueError("hier_mm needs axis=(outer, inner)")
        outer, inner = axis
        return hier_mm(x, inner, outer, aggregator=aggregator, **agg_kwargs)
    try:
        fn = _METHODS[method]
    except KeyError:
        raise ValueError(
            f"unknown method {method!r}; known: {sorted(_METHODS) + ['hier_mm']}"
        ) from None
    return fn(x, axis, aggregator=aggregator, **agg_kwargs)


def robust_all_reduce_tree(tree, axis, *, method: str = "rs_mm",
                           aggregator="mm_tukey", **agg_kwargs):
    """Leaf-wise robust all-reduce over a gradient pytree."""
    return pytree.tree_map(
        lambda g: robust_all_reduce(g, axis, method=method,
                                    aggregator=aggregator, **agg_kwargs),
        tree)
