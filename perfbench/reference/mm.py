"""The MM location estimate along the agent axis, in plain PyTorch.

Per coordinate: the (weighted) median starts the estimate, the
consistent MAD around it is the scale, and ``num_iters`` Tukey IRLS
steps refine it (the paper's Eq. 10/13 with c = 4.685):

  median    unweighted: the midpoint of the two middle order
            statistics; weighted: the first sorted value whose
            cumulative normalised weight reaches 1/2
  scale     1.4826 x the midpoint-median of |x - median|, floored at
            1e-12 (unweighted also when the start is weighted)
  IRLS      mu <- sum_k a_k u_k^2 x_k / sum_k a_k u_k^2 with
            u_k = clamp(1 - ((x_k - mu) / (c scale))^2, 0, 1); mu is
            kept where the denominator is below 1e-12

``dtype`` is the precision every step computes in (float32 for the
reference, bfloat16 for its control).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

MAD_CONSISTENCY = 1.4826022185056018
SCALE_FLOOR = 1e-12
TUKEY_C = 4.685
NUM_ITERS = 10


def _mid(sorted_x: torch.Tensor) -> torch.Tensor:
    k = sorted_x.shape[0]
    return 0.5 * (sorted_x[(k - 1) // 2] + sorted_x[k // 2])


def estimate(x: torch.Tensor, a: Optional[torch.Tensor] = None, *,
             num_iters: int = NUM_ITERS, c: float = TUKEY_C,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (K, M) -> (M,), in ``dtype``; ``a`` (K,) positive weights or
    None for the unweighted estimate."""
    x = x.to(dtype)
    k = x.shape[0]
    xs, order = torch.sort(x, dim=0, stable=True)
    if a is None:
        med = _mid(xs)
        w = torch.full((k, 1), 1.0 / k, dtype=dtype, device=x.device)
    else:
        a = a.to(device=x.device, dtype=dtype).reshape(-1)
        if not bool(torch.all(a > 0)):
            raise ValueError("the reference takes positive weights")
        w = (a / torch.sum(a))[:, None]
        cw = torch.cumsum(w[:, 0][order], dim=0)
        first = torch.argmax((cw >= 0.5).to(torch.int8), dim=0)
        med = torch.gather(xs, 0, first[None]).squeeze(0)
    del xs, order
    dev = torch.sort(torch.abs(x - med), dim=0).values
    scale = torch.clamp(MAD_CONSISTENCY * _mid(dev), min=SCALE_FLOOR)
    del dev
    mu = med
    c2 = c * c
    for _ in range(num_iters):
        y = (x - mu) / scale
        u = torch.clamp(1.0 - y * y / c2, 0.0, 1.0)
        b = w * (u * u)
        num = torch.sum(b * x, dim=0)
        den = torch.sum(b, dim=0)
        safe = den > SCALE_FLOOR
        mu = torch.where(safe, num / torch.where(safe, den,
                                                 torch.ones_like(den)), mu)
    return mu


def estimate_blocks(rows: Callable[[int, int], torch.Tensor], m: int,
                    a: Optional[torch.Tensor] = None, *, block: int,
                    dtype: torch.dtype = torch.float32,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The estimate over M columns, ``block`` columns at a time:
    ``rows(lo, hi)`` gives the (K, hi - lo) slice.  Returns (M,) f32."""
    if out is None:
        out = torch.empty((m,), dtype=torch.float32,
                          device=rows(0, 1).device)
    for lo in range(0, m, block):
        hi = min(m, lo + block)
        out[lo:hi] = estimate(rows(lo, hi), a, dtype=dtype).float()
    return out
