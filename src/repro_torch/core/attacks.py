"""Byzantine attack models (``repro.core.attacks``).

An attack transforms the *honest* updates agents would have sent into
the corrupted values they send:

    attack(honest: (K, ...) stacked updates, mask: (K,) bool malicious,
           generator: torch.Generator, step: int) -> (K, ...)

so attacks may collude (see ALIE).  Only ``gaussian`` draws random
numbers, from the generator it is given.

Registry:
  additive   -- the paper's attack (Eq. 34): phi + delta * 1
  sign_flip  -- send -gamma * phi
  gaussian   -- replace with N(0, sigma^2)
  zero       -- send zeros (free-rider / dropout)
  scale      -- send gamma * phi
  alie       -- "A Little Is Enough": mean + z * std of honest updates
  scm        -- sensitivity-curve maximization [Schroth et al. 2024]:
                median + zeta * c * MADN of the benign updates

``apply_local`` is the per-rank form (one agent a process, as in the
collectives and the Mode B step): additive, sign_flip, zero and scale
applied to this rank's own values when it is malicious.

``ByzantineConfig.schedule`` makes the malicious set a function of the
step: ``static`` (the last ``num_malicious`` agents), ``intermittent``
(the set attacks every other ``period`` steps) and ``rotating`` (the set
slides around the agent ring every ``period`` steps).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import torch

from repro_torch import devices, pytree
from repro_torch.core import location, mestimators

Attack = Callable[..., torch.Tensor]


def _apply_mask(honest, corrupted, mask):
    m = mask.reshape((mask.shape[0],) + (1,) * (honest.dim() - 1))
    return torch.where(m, corrupted, honest)


def additive(honest, mask, generator=None, step=0, *, delta: float = 1000.0):
    """The paper's perturbation: Delta = delta * 1 added to the update."""
    return _apply_mask(honest, honest + delta, mask)


def sign_flip(honest, mask, generator=None, step=0, *, gamma: float = 1.0):
    return _apply_mask(honest, -gamma * honest, mask)


def gaussian(honest, mask, generator, step=0, *, sigma: float = 10.0):
    noise = sigma * torch.randn(honest.shape, generator=generator,
                                dtype=honest.dtype, device=honest.device)
    return _apply_mask(honest, noise, mask)


def zero(honest, mask, generator=None, step=0):
    return _apply_mask(honest, torch.zeros_like(honest), mask)


def scale(honest, mask, generator=None, step=0, *, gamma: float = 50.0):
    return _apply_mask(honest, gamma * honest, mask)


def alie(honest, mask, generator=None, step=0, *, z: Optional[float] = None):
    """'A Little Is Enough' [Baruch et al. 2019]: colluders send
    mean + z*std of the benign updates."""
    k = honest.shape[0]
    m = mask.reshape((k,) + (1,) * (honest.dim() - 1)).to(honest.dtype)
    n_b = torch.clamp(torch.sum(1.0 - m), min=1.0)
    mu = torch.sum(honest * (1.0 - m), dim=0) / n_b
    var = torch.sum(((honest - mu[None]) ** 2) * (1.0 - m), dim=0) / n_b
    std = torch.sqrt(var + 1e-12)
    target = mu + (1.0 if z is None else z) * std
    return _apply_mask(honest, target.expand_as(honest), mask)


def scm(honest, mask, generator=None, step=0, *, zeta: float = 0.9,
        c: float = mestimators.TUKEY_C95):
    """Sensitivity-curve maximization: colluders sit just inside the
    Tukey rejection region of the benign median/MADN."""
    k = honest.shape[0]
    flat = honest.reshape(k, -1)
    b = (~mask).to(flat.dtype)
    med = location.weighted_median(flat, b, axis=0)
    dev = torch.abs(flat - med[None])
    madn = location.weighted_median(dev, b, axis=0) * location.MAD_CONSISTENCY
    target = (med + zeta * c * madn).reshape(honest.shape[1:])
    return _apply_mask(honest, target.expand_as(honest), mask)


def apply_local(g, is_malicious, kind: str, kwargs: Optional[dict] = None):
    """Per-rank attack (one agent a rank, as in the collectives and Mode
    B): ``is_malicious`` says whether *this* rank attacks (a bool or a
    scalar bool tensor); ``g`` is a pytree of its honest values.
    Collusion attacks (alie, scm) and gaussian have no local form."""
    kwargs = kwargs or {}
    if kind == "additive":
        delta = kwargs.get("delta", 1000.0)
        fn = lambda x: x + delta
    elif kind == "sign_flip":
        gamma = kwargs.get("gamma", 1.0)
        fn = lambda x: -gamma * x
    elif kind == "zero":
        fn = torch.zeros_like
    elif kind == "scale":
        gamma = kwargs.get("gamma", 50.0)
        fn = lambda x: gamma * x
    else:
        raise ValueError(f"attack {kind!r} has no local form")
    if isinstance(is_malicious, torch.Tensor):
        return pytree.tree_map(
            lambda x: torch.where(is_malicious.to(x.device), fn(x), x), g)
    return pytree.tree_map(fn, g) if is_malicious else g


_REGISTRY: dict[str, Attack] = {
    "additive": additive,
    "sign_flip": sign_flip,
    "gaussian": gaussian,
    "zero": zero,
    "scale": scale,
    "alie": alie,
    "scm": scm,
}


def names() -> list[str]:
    return sorted(_REGISTRY)


def get_attack(name: str, **kwargs) -> Attack:
    try:
        fn = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown attack {name!r}; known: {names()}") from None
    return functools.partial(fn, **kwargs) if kwargs else fn


SCHEDULES = ("static", "intermittent", "rotating")


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    """Which agents are malicious, how they behave, and *when*."""

    num_malicious: int = 0
    attack: str = "additive"
    attack_kwargs: tuple = ()    # (key, value) pairs, hashable
    schedule: str = "static"
    schedule_kwargs: tuple = ()  # e.g. (("period", 4),)

    def malicious_mask(self, k: int, step: Optional[int] = None,
                       device="cuda") -> torch.Tensor:
        """(K,) bool mask at ``step``; ``step=None`` (or the static
        schedule) gives the base set, the *last* num_malicious agents."""
        base = torch.arange(k, device=devices.resolve(device)) >= (
            k - self.num_malicious)
        if self.schedule == "static" or step is None:
            return base
        period = int(dict(self.schedule_kwargs).get("period", 2))
        t = int(step) // period
        if self.schedule == "intermittent":
            return base & ((t % 2) == 0)
        if self.schedule == "rotating":
            return torch.roll(base, t % k)
        raise ValueError(
            f"unknown schedule {self.schedule!r}; known: {SCHEDULES}")

    def apply(self, honest: torch.Tensor, generator=None,
              step: int = 0) -> torch.Tensor:
        if self.num_malicious == 0:
            return honest
        fn = get_attack(self.attack, **dict(self.attack_kwargs))
        mask = self.malicious_mask(honest.shape[0], step, honest.device)
        return fn(honest, mask, generator, step)

    def apply_tree(self, tree, generator=None, step: int = 0):
        """Leaf-wise corruption of a pytree of stacked (K, ...) leaves
        (per-agent gradient stacks in the train steps), every leaf with
        the same generator and step, in the tree's leaf order.  A list
        is corrupted in place, one entry after another: each honest
        stack is dropped as soon as its corrupted copy replaces it, so
        a caller that holds the stacks in a list never holds both copies
        of more than one leaf."""
        if self.num_malicious == 0:
            return tree
        if isinstance(tree, list):
            for i in range(len(tree)):
                tree[i] = self.apply_tree(tree[i], generator, step)
            return tree
        return pytree.tree_map(lambda g: self.apply(g, generator, step), tree)
