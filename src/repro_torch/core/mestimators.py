"""M-estimator loss families for robust location estimation (PyTorch).

Counterpart of ``repro.core.mestimators``: the rho / psi / weight
triple for the quadratic loss (-> mean), absolute loss (-> median),
Huber's monotone loss and Tukey's redescending biweight.  Every
function is elementwise on standardized residuals y = (x - mu) / sigma.

For a loss rho the fixed-point weight function is

    b(y) = psi(y) / y      (y != 0),      b(0) = psi'(0)        (Eq. 12)

Tuning constants follow Maronna/Martin/Yohai (2006):
  huber  c = 1.345  -> 95% Gaussian efficiency
  tukey  c = 4.685  -> 95% Gaussian efficiency
  tukey  c = 1.547  -> 50% breakdown point
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

HUBER_C95 = 1.345
TUKEY_C95 = 4.685
TUKEY_C50 = 1.547


@dataclasses.dataclass(frozen=True)
class LossFamily:
    """A rho/psi/weight triple for M-estimation."""

    name: str
    rho: Callable[[torch.Tensor], torch.Tensor]
    psi: Callable[[torch.Tensor], torch.Tensor]
    weight: Callable[[torch.Tensor], torch.Tensor]  # b(y) = psi(y)/y
    redescending: bool


def _sq_rho(y):
    return 0.5 * y * y


def _sq_psi(y):
    return y


def _sq_weight(y):
    return torch.ones_like(y)


QUADRATIC = LossFamily("quadratic", _sq_rho, _sq_psi, _sq_weight, False)


def _abs_rho(y):
    return torch.abs(y)


def _abs_psi(y):
    return torch.sign(y)


def _abs_weight(y, eps: float = 1e-8):
    return 1.0 / torch.clamp(torch.abs(y), min=eps)


ABSOLUTE = LossFamily("absolute", _abs_rho, _abs_psi, _abs_weight, False)


def make_huber(c: float = HUBER_C95) -> LossFamily:
    def rho(y):
        a = torch.abs(y)
        return torch.where(a <= c, 0.5 * y * y, c * a - 0.5 * c * c)

    def psi(y):
        return torch.clamp(y, -c, c)

    def weight(y):
        a = torch.abs(y)
        return torch.where(a <= c, torch.ones_like(y),
                           c / torch.clamp(a, min=1e-30))

    return LossFamily(f"huber(c={c:g})", rho, psi, weight, False)


HUBER = make_huber()


def make_tukey(c: float = TUKEY_C95) -> LossFamily:
    c2 = c * c

    def rho(y):
        u = torch.clamp(1.0 - (y * y) / c2, 0.0, 1.0)
        return (c2 / 6.0) * (1.0 - u * u * u)

    def psi(y):
        u = torch.clamp(1.0 - (y * y) / c2, 0.0, 1.0)
        return y * u * u

    def weight(y):
        u = torch.clamp(1.0 - (y * y) / c2, 0.0, 1.0)
        return u * u

    return LossFamily(f"tukey(c={c:g})", rho, psi, weight, True)


TUKEY = make_tukey()
TUKEY_HIGH_BREAKDOWN = make_tukey(TUKEY_C50)


_REGISTRY = {
    "quadratic": QUADRATIC,
    "absolute": ABSOLUTE,
    "huber": HUBER,
    "tukey": TUKEY,
}


def get_loss(name: str) -> LossFamily:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown loss family {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def tukey(c: float) -> LossFamily:
    """The shared TUKEY instance at the default constant, else a new one."""
    return TUKEY if c == TUKEY_C95 else make_tukey(c)
