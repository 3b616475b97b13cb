"""Paradigm adapter registry (``repro.scenarios.registry``).

An adapter lowers a ``ScenarioSpec`` to what the runner's loop needs,
in one of two forms:

    adapter(spec, device) -> (state0, step_fn)                 # legacy tuple
    adapter(spec, device) -> Lowering(state0, step_fn, ...)

    step_fn(state, generator, step_index) -> (state, {metric: scalar, ...})

``finalize`` is a post-run hook over the numpy history dict (where
``loss`` is derived) and ``breakdown_level`` overrides the
attack-success threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

Adapter = Callable


@dataclasses.dataclass
class Lowering:
    """Everything the runner needs from a paradigm adapter."""

    state0: Any
    step_fn: Callable                        # (state, gen, i) -> (state, metrics)
    finalize: Optional[Callable] = None      # history dict -> history dict
    breakdown_level: Optional[float] = None  # attack_summary threshold


def as_lowering(out) -> Lowering:
    """Normalize an adapter result (legacy tuple or Lowering)."""
    if isinstance(out, Lowering):
        return out
    state0, step_fn = out
    return Lowering(state0=state0, step_fn=step_fn)


_PARADIGMS: Dict[str, Adapter] = {}


def register_paradigm(name: str) -> Callable[[Adapter], Adapter]:
    def deco(fn: Adapter) -> Adapter:
        _PARADIGMS[name] = fn
        return fn
    return deco


def paradigm_names() -> list:
    return sorted(_PARADIGMS)


def get_paradigm(name: str) -> Adapter:
    try:
        return _PARADIGMS[name]
    except KeyError:
        raise ValueError(
            f"unknown paradigm {name!r}; known: {paradigm_names()}") from None
