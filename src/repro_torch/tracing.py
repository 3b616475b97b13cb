"""One phase tracer for the port: device phases from CUDA events.

``PhaseTimer`` times named phases of a train step or of the service's
rounds.  Each phase is a pair of CUDA events recorded on the current
stream around the phase's work; ``phase_ms()`` sums their device
milliseconds by name.  The event pairs come from a pool and go back to
it on ``reset``, so a phase makes no new events once the pool has grown
to a round's size.  Nothing is recorded while a stream capture is under
way: an event recorded into a capture would become a graph node.  Off
the card (``enabled`` False) nothing is recorded.

The tracer keeps no host spans: the benchmark labels the card's idle
gaps with its own ``record_function`` ranges around the program.  It
never calls ``torch.profiler.record_function`` or NVTX: a range of
either shows on the profiler's device timeline too, where it would be
taken for device work.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch


class _Slot:
    """A pooled pair of timing events and the phase it last timed."""

    __slots__ = ("start", "end", "name", "seq")

    def __init__(self):
        # ``torch.Event`` records on the current stream without the
        # Python stream lookup of ``torch.cuda.Event.record``: the
        # admission phase is timed once per update, so its cost counts
        self.start = torch.Event("cuda", enable_timing=True)
        self.end = torch.Event("cuda", enable_timing=True)
        self.name: str = ""
        self.seq = 0


class PhaseTimer:
    """Device phases (``enabled``: CUDA-event pairs, on the card).
    ``begin``/``end`` bracket a phase (``phase`` is the same as a context
    manager); ``phase_totals`` sums the ended phases' device time by name
    and counts them; ``reset`` drops them."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._pool: List[_Slot] = []
        self._done: List[_Slot] = []
        self._seq = 0

    def begin(self, name: str) -> Optional[_Slot]:
        """Open a phase: record its start event.  Returns the token
        ``end`` takes, None when there is nothing to record (off the card,
        or during a stream capture)."""
        if not self.enabled or torch.cuda.is_current_stream_capturing():
            return None
        slot = self._pool.pop() if self._pool else _Slot()
        slot.name = name
        slot.start.record()
        return slot

    def end(self, token: Optional[_Slot]) -> None:
        """Close what ``begin`` opened: the end event is recorded here,
        before the caller waits for the phase's result."""
        if token is None:
            return
        token.end.record()
        token.seq = self._seq
        self._seq += 1
        self._done.append(token)

    @contextlib.contextmanager
    def phase(self, name: str):
        token = self.begin(name)
        try:
            yield
        finally:
            self.end(token)

    def mark(self) -> int:
        """A position in the ended phases: ``reset(since=)`` and
        ``phase_ms(before=)`` split them there."""
        return self._seq

    def reset(self, since: Optional[int] = None) -> None:
        """Drop the ended phases (those before the mark ``since``, when
        given), returning their events to the pool."""
        keep = []
        for slot in self._done:
            if since is not None and slot.seq >= since:
                keep.append(slot)
            else:
                self._pool.append(slot)
        self._done = keep

    def phase_totals(self, before: Optional[int] = None) -> dict:
        """{phase: [device ms, count]} over the ended phases (those before
        the mark ``before``, when given); waits for their end events.
        Empty off the card."""
        out: dict = {}
        for slot in self._done:
            if before is not None and slot.seq >= before:
                continue
            slot.end.synchronize()
            total = out.setdefault(slot.name, [0.0, 0])
            total[0] += slot.start.elapsed_time(slot.end)
            total[1] += 1
        return out

    def phase_ms(self, before: Optional[int] = None) -> dict:
        """{phase: device ms}: ``phase_totals``' sums."""
        totals = self.phase_totals(before)
        return {name: ms for name, (ms, _) in totals.items()}
