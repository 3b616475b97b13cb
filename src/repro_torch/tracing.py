"""One phase tracer for the port: device phases from CUDA events and,
when asked for, host spans.

``PhaseTimer`` times named phases of a train step or of the service's
rounds.  Each phase is a pair of CUDA events recorded on the current
stream around the phase's work; ``phase_ms()`` sums their device
milliseconds by name.  The event pairs come from a pool and go back to
it on ``reset``, so a phase makes no new events once the pool has grown
to a round's size.  Nothing is recorded while a stream capture is under
way: an event recorded into a capture would become a graph node.

With ``spans=True`` every phase, and every host-only span
(``begin(..., device=False)``), is also kept as a ``Span``: its name,
the span open around it, the round it belongs to, and its start and end
from ``time.time_ns()``.  That is the clock ``torch.profiler`` stamps
its events with (Unix-epoch nanoseconds), so a program span can be laid
on a profiler trace.  Spans stay in memory until ``spans()`` drains
them.  Off (the default) no span is made and no list of them grows.

The tracer never calls ``torch.profiler.record_function`` or NVTX: a
range of either shows on the profiler's device timeline too, where it
would be taken for device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional, Union

import torch


@dataclasses.dataclass
class Span:
    """One host span: ``parent`` is the id of the span open around it
    (None at the top), ``round`` the round it belongs to (inherited from
    the parent when not given), ``end_ns`` None while it is open;
    ``attrs`` what the caller attached (the ``replay`` span's launch
    record)."""

    id: int
    name: str
    parent: Optional[int]
    round: Optional[int]
    start_ns: int
    end_ns: Optional[int] = None
    attrs: Optional[dict] = None


class _Slot:
    """A pooled pair of timing events and the phase it last timed."""

    __slots__ = ("start", "end", "name", "seq", "span")

    def __init__(self):
        # ``torch.Event`` records on the current stream without the
        # Python stream lookup of ``torch.cuda.Event.record``: the
        # admission phase is timed once per update, so its cost counts
        self.start = torch.Event("cuda", enable_timing=True)
        self.end = torch.Event("cuda", enable_timing=True)
        self.name: str = ""
        self.seq = 0
        self.span: Optional[Span] = None


Token = Union[_Slot, Span, None]


class PhaseTimer:
    """Device phases (``enabled``: CUDA-event pairs, on the card) and,
    with ``spans``, host spans.  ``begin``/``end`` bracket a phase
    (``phase`` is the same as a context manager); ``phase_totals`` sums
    the ended phases' device time by name and counts them; ``reset``
    drops them; ``spans`` drains the host spans."""

    def __init__(self, enabled: bool, *, spans: bool = False):
        self.enabled = enabled
        self.spans_on = spans
        self._pool: List[_Slot] = []
        self._done: List[_Slot] = []
        self._seq = 0
        self._spans: List[Span] = []
        self._open: List[Span] = []
        self._next_id = 0

    def begin(self, name: str, *, device: bool = True,
              round: Optional[int] = None,
              attrs: Optional[dict] = None) -> Token:
        """Open a phase: its start event (``device`` and on the card) and
        its span (with ``spans``).  Returns the token ``end`` takes, None
        when there is nothing to record."""
        timed = device and self.enabled
        if timed and torch.cuda.is_current_stream_capturing():
            return None
        span = self._open_span(name, round, attrs) if self.spans_on else None
        if not timed:
            return span
        slot = self._pool.pop() if self._pool else _Slot()
        slot.name, slot.span = name, span
        slot.start.record()
        return slot

    def end(self, token: Token) -> None:
        """Close what ``begin`` opened: the end event is recorded here,
        before the caller waits for the phase's result."""
        if token is None:
            return
        if isinstance(token, Span):
            self._close_span(token)
            return
        token.end.record()
        token.seq = self._seq
        self._seq += 1
        self._done.append(token)
        if token.span is not None:
            self._close_span(token.span)
            token.span = None

    @contextlib.contextmanager
    def phase(self, name: str, **kw):
        token = self.begin(name, **kw)
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

    def spans(self) -> List[Span]:
        """The spans recorded since the last call, in the order they
        opened (one still open has ``end_ns`` None)."""
        out, self._spans = self._spans, []
        return out

    def _open_span(self, name: str, round: Optional[int],
                   attrs: Optional[dict]) -> Span:
        parent = self._open[-1] if self._open else None
        if round is None and parent is not None:
            round = parent.round
        span = Span(self._next_id, name,
                    parent.id if parent is not None else None, round,
                    time.time_ns(), attrs=attrs)
        self._next_id += 1
        self._spans.append(span)
        self._open.append(span)
        return span

    def _close_span(self, span: Span) -> None:
        span.end_ns = time.time_ns()
        # spans an exception left open inside it leave the stack with it
        while self._open:
            if self._open.pop() is span:
                break
