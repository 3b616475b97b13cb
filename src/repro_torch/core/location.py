"""Elementwise (weighted) robust location estimation (PyTorch).

Counterpart of ``repro.core.location``, with the same conventions:
everything operates on a tensor ``x`` of shape ``(K, ...)`` whose
leading axis indexes the K agents of a neighborhood, with optional
non-negative combination weights ``a`` of shape ``(K,)`` (uniform if
omitted).  All trailing axes are independent coordinates m (Eq. 10).

Conventions that matter for parity with the reference:
  * ``median`` is the midpoint of the two middle order statistics
    (``torch.median`` returns the lower one and is not used);
  * ``weighted_median`` takes the first sorted row whose cumulative
    weight reaches 0.5 - 1e-12 (compared in x's dtype);
  * MAD is the *unweighted* median of |x - center| times 1.4826, also
    for weighted estimates;
  * ``normalize_weights`` replaces an invalid column by uniform 1/K;
  * the scale floor is 1e-12, and IRLS keeps mu where sum(w) <= 1e-12.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import mestimators

MAD_CONSISTENCY = 1.4826022185056018  # 1 / Phi^{-1}(3/4)
_SCALE_FLOOR = 1e-12


def median(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Exact elementwise median along ``axis`` (mean of middle pair if even)."""
    k = x.shape[axis]
    xs = torch.sort(x, dim=axis).values
    lo = xs.select(axis, (k - 1) // 2)
    hi = xs.select(axis, k // 2)
    return 0.5 * (lo + hi)


def mad(x: torch.Tensor, center: Optional[torch.Tensor] = None,
        axis: int = 0, consistent: bool = True) -> torch.Tensor:
    """Median absolute deviation along ``axis``."""
    if center is None:
        center = median(x, axis=axis)
    dev = torch.abs(x - center.unsqueeze(axis))
    s = median(dev, axis=axis)
    if consistent:
        s = s * MAD_CONSISTENCY
    return s


def normalize_weights(a: torch.Tensor, dtype=None) -> torch.Tensor:
    """Validate + column-normalize combination weights.

    ``a`` is (K,) or (K, N) with the agent axis first.  A column is
    invalid if it holds a non-finite or negative entry or sums to
    (numerically) zero, and then falls back to uniform 1/K.
    """
    if dtype is not None:
        a = a.to(dtype)
    k = a.shape[0]
    ok = torch.all(torch.isfinite(a) & (a >= 0), dim=0, keepdim=True)
    s = torch.sum(a, dim=0, keepdim=True)
    ok = ok & (s > _SCALE_FLOOR)
    uniform = torch.full_like(a, 1.0 / k)
    return torch.where(ok, a / torch.where(ok, s, torch.ones_like(s)),
                       uniform)


def as_column(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Weights (K, *batch) shaped to broadcast against x (K, *batch, ...)."""
    return a.reshape(tuple(a.shape) + (1,) * (x.dim() - a.dim()))


def weighted_median(x: torch.Tensor, a: torch.Tensor,
                    axis: int = 0) -> torch.Tensor:
    """Weighted median along axis 0: smallest x with cumweight >= 1/2.

    ``a`` has shape (K,), or (K, *batch) where ``batch`` leads x's
    trailing axes (one weight column per batch entry: the batch axis
    written out where the reference vmaps over weight columns).  It is
    normalized internally (invalid columns fall back to uniform).
    """
    if axis != 0:
        raise NotImplementedError("weighted_median supports axis=0")
    a = normalize_weights(a, dtype=x.dtype)
    order = torch.argsort(x, dim=0, stable=True)
    xs = torch.take_along_dim(x, order, dim=0)
    ws = torch.take_along_dim(as_column(a, x).expand(x.shape), order, dim=0)
    cw = torch.cumsum(ws, dim=0)
    ge = cw >= 0.5 - 1e-12
    idx = torch.argmax(ge.to(torch.int32), dim=0)
    return torch.take_along_dim(xs, idx.unsqueeze(0), dim=0).squeeze(0)


class MEstimateResult(NamedTuple):
    estimate: torch.Tensor       # (...,) location per coordinate
    weights: torch.Tensor        # (K, ...) effective abar_{lk}(m), sum_l = 1
    scale: torch.Tensor          # (...,) scale used for standardization


def m_estimate(
    x: torch.Tensor,
    *,
    loss: mestimators.LossFamily = mestimators.TUKEY,
    a: Optional[torch.Tensor] = None,
    init: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
    num_iters: int = 10,
) -> MEstimateResult:
    """IRLS fixed point for the weighted M-estimate of location (Eq. 13).

    ``a`` is (K,) or (K, *batch) as in ``weighted_median``.
    """
    k = x.shape[0]
    if a is None:
        a = torch.full((k,), 1.0 / k, dtype=x.dtype, device=x.device)
    else:
        a = normalize_weights(a, dtype=x.dtype)
    a_col = as_column(a, x)

    mu = median(x, axis=0) if init is None else init
    if scale is None:
        scale = mad(x, center=mu, axis=0)
    scale = torch.clamp(scale, min=_SCALE_FLOOR)

    for _ in range(num_iters):
        y = (x - mu.unsqueeze(0)) / scale.unsqueeze(0)
        b = loss.weight(y)
        num = torch.sum(a_col * b * x, dim=0)
        den = torch.sum(a_col * b, dim=0)
        # a redescending loss that zeroes every agent keeps the estimate
        safe = den > _SCALE_FLOOR
        mu = torch.where(safe, num / torch.where(safe, den,
                                                 torch.ones_like(den)), mu)

    # effective convex weights abar (Eq. 14), from the converged estimate
    y = (x - mu.unsqueeze(0)) / scale.unsqueeze(0)
    raw = a_col * loss.weight(y)
    den = torch.sum(raw, dim=0, keepdim=True)
    safe = den > _SCALE_FLOOR
    abar = torch.where(safe, raw / torch.where(safe, den, torch.ones_like(den)),
                       a_col.expand_as(raw))
    return MEstimateResult(estimate=mu, weights=abar, scale=scale)


def mm_estimate(
    x: torch.Tensor,
    *,
    a: Optional[torch.Tensor] = None,
    loss: mestimators.LossFamily = mestimators.TUKEY,
    num_iters: int = 10,
) -> MEstimateResult:
    """The paper's aggregator: (weighted) median/MAD init + Tukey M-step."""
    mu0 = median(x, axis=0) if a is None else weighted_median(x, a, axis=0)
    s = mad(x, center=mu0, axis=0)
    return m_estimate(x, loss=loss, a=a, init=mu0, scale=s,
                      num_iters=num_iters)
