"""Plain-PyTorch oracle for MM aggregation (``repro.kernels.ref``).

The estimator written with ``core.location`` (its conventions are the
estimator's definition), computed in float32 whatever the input dtype.
It differs from the kernels' plain versions in ``mm_aggregate`` only
where the reference's kernel differs from its oracle: the weighted
median's crossing epsilon and, on the two-pass path with several K
blocks, the approximate init.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import location, mestimators


def mm_aggregate_ref(x: torch.Tensor, a: Optional[torch.Tensor] = None, *,
                     num_iters: int = 10,
                     c: float = mestimators.TUKEY_C95) -> torch.Tensor:
    """MM location estimate along axis 0 of ``x`` (K, ...) -> (...)."""
    af = None if a is None else a.to(torch.float32)
    out = location.mm_estimate(x.to(torch.float32), a=af,
                               loss=mestimators.tukey(c),
                               num_iters=num_iters).estimate
    return out.to(x.dtype)


def mm_aggregate_batched_ref(x: torch.Tensor, a: torch.Tensor, *,
                             num_iters: int = 10,
                             c: float = mestimators.TUKEY_C95) -> torch.Tensor:
    """(K, M) values x (K, N) weight columns -> (N, M): the weight-column
    batch written out as a leading batch axis of x."""
    k, m = x.shape
    xb = x.to(torch.float32).unsqueeze(1).expand(k, a.shape[1], m)
    out = location.mm_estimate(xb, a=a.to(torch.float32),
                               loss=mestimators.tukey(c),
                               num_iters=num_iters).estimate
    return out.to(x.dtype)


def paired_sort_ref(x: torch.Tensor, w: torch.Tensor):
    """Stable-argsort oracle for a paired sort: sorts x (K, M) along axis
    0 and permutes w -- (K, M) or (K, N, M) -- with the same order."""
    order = torch.argsort(x, dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    if w.dim() == x.dim():
        return xs, torch.take_along_dim(w, order, dim=0)
    return xs, torch.take_along_dim(w, order[:, None, :], dim=0)
