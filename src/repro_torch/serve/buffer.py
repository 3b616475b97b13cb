"""FedBuff-style admission buffer for per-agent update streams.

Counterpart of ``repro.serve.buffer``: the same policy and verdict
strings; a payload is a 1-D ``torch.Tensor`` (the service moves it to
its own device at ``submit``).

The buffer is the service's first robustness line: it decides which
delivered updates are even *eligible* for the next cohort, before any
robust statistics run.

Admission policy (one verdict string per ``add``):

  buffered         eligible; waiting for cohort admission
  superseded       a newer update from the same agent replaced the
                   pending one (one slot per agent -- a cohort can
                   never contain a duplicate agent id by construction)
  duplicate        delivery replay: sequence number not newer than the
                   last accepted one for this agent -- dropped
  rejected_stale   older than the staleness window (``round age`` =
                   current server round - the round the update was
                   computed from)
  rejected_invalid non-finite payload (NaN/Inf never reaches the
                   estimator)
  rejected_full    backpressure: the buffer is at capacity

``take`` pops the oldest pending entries FIFO by arrival, so cohort
admission is deterministic under the simulated clock.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.tracing import PhaseTimer


@dataclasses.dataclass(frozen=True, eq=False)
class AgentUpdate:
    """One delivered update.

    ``round`` tags the server round of the base model the update was
    computed from (its ``round age`` at admission is the staleness);
    ``seq`` is the agent's monotone delivery sequence number, used for
    duplicate-delivery detection; ``weight`` is the client-side
    combination weight (e.g. local dataset size, Eq. 4's p_k).
    """

    agent_id: int
    round: int
    payload: torch.Tensor        # (M,) flat update / locally-trained model
    weight: float = 1.0
    seq: int = 0
    sent_at: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class Pending:
    update: AgentUpdate
    arrival_t: float
    staleness: int               # round age at admission time


class CohortBuffer:
    """One pending slot per agent + duplicate/staleness gating.
    ``timer`` times the finiteness check as the phase ``admit``."""

    def __init__(self, *, max_staleness: int = 4, max_buffer: int = 4096,
                 timer: Optional[PhaseTimer] = None):
        self.max_staleness = max_staleness
        self.max_buffer = max_buffer
        self.timer = timer if timer is not None else PhaseTimer(False)
        self._pending: Dict[int, Pending] = {}
        self._last_seq: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._pending)

    @property
    def oldest_arrival(self) -> Optional[float]:
        """Arrival time of the oldest pending update (deadline anchor)."""
        if not self._pending:
            return None
        return min(p.arrival_t for p in self._pending.values())

    def add(self, update: AgentUpdate, *, now: float,
            current_round: int) -> str:
        last = self._last_seq.get(update.agent_id)
        if last is not None and update.seq <= last:
            return "duplicate"
        staleness = current_round - update.round
        if staleness > self.max_staleness:
            # the sequence number is still consumed: a replay of this
            # stale delivery must not be re-considered later
            self._last_seq[update.agent_id] = update.seq
            return "rejected_stale"
        # the check's end event goes before the host waits for its answer
        token = self.timer.begin("admit")
        nonfinite = ops.any_nonfinite(update.payload)
        self.timer.end(token)
        if bool(nonfinite):
            self._last_seq[update.agent_id] = update.seq
            return "rejected_invalid"
        superseding = update.agent_id in self._pending
        if not superseding and len(self._pending) >= self.max_buffer:
            return "rejected_full"
        self._last_seq[update.agent_id] = update.seq
        self._pending[update.agent_id] = Pending(
            update=update, arrival_t=now, staleness=max(staleness, 0))
        return "superseded" if superseding else "buffered"

    def take(self, n: int) -> List[Pending]:
        """Pop the ``n`` oldest pending entries (FIFO by arrival)."""
        order = sorted(self._pending.values(),
                       key=lambda p: (p.arrival_t, p.update.agent_id))
        taken = order[:n]
        for p in taken:
            del self._pending[p.update.agent_id]
        return taken

    def discard(self, agent_ids) -> None:
        """Drop pending entries by agent id (recovery applying a
        journaled commit's consumed cohort); missing ids are fine --
        the corresponding delivery may have been superseded."""
        for aid in agent_ids:
            self._pending.pop(aid, None)

    def export_state(self):
        """The buffer's durable state: ``(last_seq, pending)`` --
        exactly what a journal snapshot must capture for the seq gates
        and in-flight entries to survive a restart."""
        return dict(self._last_seq), list(self._pending.values())

    def restore_state(self, last_seq, pending) -> None:
        self._last_seq = {int(k): int(v) for k, v in last_seq.items()}
        self._pending = {p.update.agent_id: p for p in pending}

    def refresh_staleness(self, current_round: int) -> List[Pending]:
        """Re-evaluate pending entries against the window after the
        server round advanced: entries that aged out are evicted and
        returned (the service counts them as stale rejections)."""
        evicted = []
        for aid, p in list(self._pending.items()):
            staleness = current_round - p.update.round
            if staleness > self.max_staleness:
                evicted.append(p)
                del self._pending[aid]
            else:
                self._pending[aid] = dataclasses.replace(
                    p, staleness=max(staleness, 0))
        return evicted
