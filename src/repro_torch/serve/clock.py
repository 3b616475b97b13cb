"""Clock abstraction: wall time for deployments, simulated time for
deterministic tests and the chaos harness.

Counterpart of ``repro.serve.clock``, unchanged.  Everything in
``repro_torch.serve`` that needs "now" or "sleep" takes a clock
object instead of calling ``time`` directly, so the whole service loop
-- deadlines, backoff delays, latency measurement -- runs bit-for-bit
reproducibly under ``SimClock`` while staying a drop-in real service
under ``WallClock``.
"""

from __future__ import annotations

import time


class WallClock:
    """Real time: monotonic ``now``, blocking ``sleep``."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)


class SimClock:
    """Deterministic simulated time.

    ``sleep`` advances the clock instantly (nothing blocks), so retry
    backoff and admission deadlines are exercised in microseconds of
    real time; ``advance_to`` jumps to an absolute timestamp (the event
    loop of the chaos harness drives it monotonically).
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self._t += float(dt)

    def advance_to(self, t: float) -> None:
        if t < self._t:
            raise ValueError(
                f"SimClock cannot run backwards: at {self._t}, asked for {t}")
        self._t = float(t)
