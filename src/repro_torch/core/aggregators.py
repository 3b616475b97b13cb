"""Aggregator registry: the paper's MM aggregator plus every baseline.

Counterpart of ``repro.core.aggregators``.  An aggregator maps
``(K, ...) -> (...)``: K agent tensors stacked on axis 0 to one
aggregate, optionally weighted by combination weights ``a`` of shape
(K,).  The weight-aware aggregators (mean, median, m_huber, mm_tukey)
also take ``a`` of shape (K, N) against x of shape (K, N, ...): one
weight column per batch entry, the batch axis the reference gets from
``vmap`` over the columns of a combination matrix.

Registry (get_aggregator):
  mean               -- Eq. (7), the classical weighted average
  median             -- elementwise median [Yin et al., 2018]
  trimmed_mean       -- elementwise beta-trimmed mean [Yin et al., 2018]
  geometric_median   -- Weiszfeld iterations on Eq. (8) [Pillutla et al., 2019]
  krum               -- Blanchard et al., 2017 (needs num_malicious)
  m_huber            -- monotone M-estimate (Huber), median/MAD standardized
  mm_tukey (ref)     -- THE PAPER: MM estimate, median/MAD init + Tukey IRLS
  mm_pallas          -- mm_tukey computed by the Hopper kernel
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch import pytree
from repro_torch.core import location, mestimators

Aggregator = Callable[..., torch.Tensor]


def _normalize_weights(a: Optional[torch.Tensor], x: torch.Tensor
                       ) -> torch.Tensor:
    k = x.shape[0]
    if a is None:
        return torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device)
    return location.normalize_weights(a, dtype=x.dtype)


def mean(x: torch.Tensor, a: Optional[torch.Tensor] = None) -> torch.Tensor:
    a = _normalize_weights(a, x)
    return torch.sum(location.as_column(a, x) * x, dim=0)


def median(x: torch.Tensor, a: Optional[torch.Tensor] = None) -> torch.Tensor:
    if a is None:
        return location.median(x, axis=0)
    return location.weighted_median(x, a, axis=0)


def trimmed_mean(x: torch.Tensor, a: Optional[torch.Tensor] = None,
                 *, beta: float = 0.25) -> torch.Tensor:
    """Remove the floor(beta*K) smallest and largest values per coordinate
    (at least one row survives)."""
    del a  # rank-based: combination weights are not meaningful
    if not 0.0 <= beta <= 0.5:
        raise ValueError(f"trimmed_mean needs beta in [0, 0.5], got {beta}")
    k = x.shape[0]
    t = min(int(beta * k), (k - 1) // 2)
    xs = torch.sort(x, dim=0).values
    kept = xs[t:k - t] if t > 0 else xs
    return torch.mean(kept, dim=0)


def geometric_median(x: torch.Tensor, a: Optional[torch.Tensor] = None,
                     *, num_iters: int = 32, eps: float = 1e-8
                     ) -> torch.Tensor:
    """Weiszfeld fixed point for the spatial median of K vectors (Eq. 8);
    all trailing axes form one flat vector per agent.  A (K, N) weight
    matrix runs one spatial median per column."""
    if a is not None and a.dim() == 2:
        return torch.stack([geometric_median(x[:, j], a[:, j],
                                             num_iters=num_iters, eps=eps)
                            for j in range(a.shape[1])])
    k = x.shape[0]
    a = _normalize_weights(a, x)
    flat = x.reshape(k, -1)
    z = torch.sum(a[:, None] * flat, dim=0)
    for _ in range(num_iters):
        d = torch.sqrt(torch.sum((flat - z[None]) ** 2, dim=1) + eps)
        w = a / d
        z = torch.sum(w[:, None] * flat, dim=0) / torch.sum(w)
    return z.reshape(x.shape[1:])


def krum(x: torch.Tensor, a: Optional[torch.Tensor] = None,
         *, num_malicious: int = 1, multi: int = 1) -> torch.Tensor:
    """(Multi-)Krum: the vector(s) with the smallest sum of squared
    distances to their K - f - 2 nearest neighbors [Blanchard et al. 2017]."""
    del a
    k = x.shape[0]
    flat = x.reshape(k, -1)
    sq = torch.sum((flat[:, None, :] - flat[None, :, :]) ** 2, dim=-1)
    sq = sq + torch.diag(torch.full((k,), float("inf"), dtype=sq.dtype,
                                    device=sq.device))
    n_near = max(k - num_malicious - 2, 1)
    scores = torch.sum(torch.sort(sq, dim=1).values[:, :n_near], dim=1)
    # index_select, not x[tensor]: a 0-d index tensor would be read on
    # the host, which a CUDA graph capture refuses
    if multi <= 1:
        return torch.index_select(x, 0, torch.argmin(scores).reshape(1))[0]
    sel = torch.argsort(scores)[:multi]
    return torch.mean(torch.index_select(x, 0, sel), dim=0)


def m_huber(x: torch.Tensor, a: Optional[torch.Tensor] = None,
            *, num_iters: int = 10) -> torch.Tensor:
    return location.mm_estimate(x, a=a, loss=mestimators.HUBER,
                                num_iters=num_iters).estimate


def mm_tukey(x: torch.Tensor, a: Optional[torch.Tensor] = None,
             *, num_iters: int = 10, c: float = mestimators.TUKEY_C95
             ) -> torch.Tensor:
    """The paper's REF aggregator (Algorithm 1, steps 2-3)."""
    return location.mm_estimate(x, a=a, loss=mestimators.tukey(c),
                                num_iters=num_iters).estimate


def mm_pallas(x: torch.Tensor, a: Optional[torch.Tensor] = None,
              *, num_iters: int = 10, c: float = mestimators.TUKEY_C95
              ) -> torch.Tensor:
    """The REF aggregator computed by the Hopper kernel (its plain
    version for CPU tensors); weighted calls run inside the kernel."""
    from repro_torch.kernels import ops  # deferred: keep core import-light
    return ops.mm_aggregate(x, a, num_iters=num_iters, c=c)


_REGISTRY: dict[str, Aggregator] = {
    "mean": mean,
    "median": median,
    "trimmed_mean": trimmed_mean,
    "geometric_median": geometric_median,
    "krum": krum,
    "m_huber": m_huber,
    "mm_tukey": mm_tukey,
    "mm_pallas": mm_pallas,
}
_REGISTRY["ref"] = mm_tukey


def names() -> list[str]:
    return sorted(_REGISTRY)


def get_aggregator(name: str, **kwargs) -> Aggregator:
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown aggregator {name!r}; known: {names()}") from None
    return functools.partial(fn, **kwargs) if kwargs else fn


def aggregate_pytree(tree, name_or_fn, a: Optional[torch.Tensor] = None,
                     **kwargs):
    """Apply an aggregator leaf-wise to a pytree of stacked (K, ...) leaves."""
    fn = get_aggregator(name_or_fn, **kwargs) if isinstance(name_or_fn, str) \
        else name_or_fn
    return pytree.tree_map(lambda leaf: fn(leaf, a), tree)
