"""Bounded retry with jittered exponential backoff and a deadline budget.

Counterpart of ``repro.serve.retry``.  ``call`` wraps a callable with
two bounds:

  * at most ``max_attempts`` tries,
  * exponential backoff ``base * multiplier**(attempt-1)`` capped at
    ``max_delay_s``, with multiplicative jitter drawn from the caller's
    ``numpy`` generator (deterministic under a seeded rng, and the same
    draws as the reference's under the same seed),
  * a total ``budget_s`` deadline measured on the caller's clock -- if
    the next backoff would sleep past the budget, the retry loop gives
    up immediately instead of blowing the admission deadline.

Exhaustion raises ``RetryError`` (carrying the attempt count and the
last underlying exception); the service catches it and degrades
(carry-forward).

One deliberate difference from the reference: only ``FaultInjected``
-- the synthetic fault of the chaos harness -- is retried by default.
The reference retries any ``Exception``, so a real launch failure would
end, after the retries, as a quiet carry-forward.  Here a CUDA error or
a kernel wrapper's ``RuntimeError`` propagates on its first occurrence:
the service never hides a device or kernel fault behind a degraded
commit.  ``FaultInjected`` lives in this module, which imports nothing
of the package, so the service and the chaos harness both import it
without a cycle.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from repro_torch.serve.clock import WallClock


class FaultInjected(RuntimeError):
    """An injected (synthetic) fault; retryable by construction."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape + bounds; frozen so it can ride in ServeConfig."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5          # delay *= 1 - jitter * U[0,1)
    budget_s: float = 30.0       # total wall budget across all attempts

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.base_delay_s < 0 or self.max_delay_s < 0 or self.budget_s < 0:
            raise ValueError("delays and budget must be non-negative")

    def delay(self, attempt: int, rng: Optional[np.random.Generator] = None
              ) -> float:
        """Backoff before retry number ``attempt`` (1-based: the delay
        slept after the ``attempt``-th failure)."""
        d = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                self.max_delay_s)
        if rng is not None and self.jitter > 0:
            d *= 1.0 - self.jitter * float(rng.random())
        return d


class RetryError(RuntimeError):
    """All attempts failed (or the budget ran out)."""

    def __init__(self, msg: str, *, attempts: int, last: BaseException):
        super().__init__(msg)
        self.attempts = attempts
        self.last = last


def call(fn: Callable, *, policy: RetryPolicy,
         clock=None, rng: Optional[np.random.Generator] = None,
         retryable: tuple = (FaultInjected,),
         on_retry: Optional[Callable] = None) -> Tuple[object, int]:
    """Run ``fn()`` under ``policy``; returns ``(result, attempts)``.

    ``on_retry(attempt, exc, delay)`` is invoked before each backoff
    sleep (telemetry hook).  Non-``retryable`` exceptions -- by default
    everything but ``FaultInjected`` -- propagate unwrapped on the first
    occurrence.
    """
    clock = clock if clock is not None else WallClock()
    deadline = clock.now() + policy.budget_s
    last: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        try:
            return fn(), attempt
        except retryable as exc:
            last = exc
            if attempt >= policy.max_attempts:
                break
            delay = policy.delay(attempt, rng)
            if clock.now() + delay > deadline:
                raise RetryError(
                    f"retry budget {policy.budget_s}s exhausted after "
                    f"{attempt} attempt(s): {exc!r}",
                    attempts=attempt, last=exc) from exc
            if on_retry is not None:
                on_retry(attempt, exc, delay)
            clock.sleep(delay)
    raise RetryError(
        f"all {policy.max_attempts} attempt(s) failed: {last!r}",
        attempts=policy.max_attempts, last=last) from last
