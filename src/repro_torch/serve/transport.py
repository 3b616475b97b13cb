"""The concurrent transport front: bounded per-agent inbound channels,
backpressure verdicts, and a dispatcher routing updates to per-tenant
``AggregationService`` instances that share one ``ExecutableCache``.

Counterpart of ``repro.serve.transport``, host-side and unchanged but
for ``device``: every tenant the front creates holds its model and runs
its launches there, and all of them share the front's cache (one
capture per cohort geometry in total).

A production fusion center is not one service on one thread: many
cohort geometries / model shards serve at once, behind a network
boundary that can flood, stall, or reorder.  ``TransportFront`` is that
boundary:

  * **per-agent bounded channels** -- every ``(tenant, agent)`` pair
    gets its own FIFO lane of ``channel_capacity`` slots.  ``offer``
    returns the backpressure verdict *to the sender* (``enqueued`` |
    ``backpressure``) instead of silently dropping, and a slow-loris
    agent trickling bytes (an entry with a future ``ready_t``) blocks
    only its own lane's head -- its channel fills, its own later sends
    bounce, and every other agent's lane is untouched.
  * **dispatcher** -- ``pump`` drains the globally oldest *ready*
    entries (deterministic order: enqueue time, then tenant, then
    agent) into the owning tenant's ``submit``, then ticks every
    tenant's admission deadline.  Under ``SimClock`` the whole front is
    bit-for-bit replayable; under a wall clock ``run_async`` pumps the
    same loop from asyncio.
  * **shared executable cache** -- ``add_tenant`` hands every service
    the front's ``ExecutableCache``: N tenants running the same cohort
    geometry compile once *total*.  The multi-tenant no-retrace
    contract (one compile per distinct geometry, never one per tenant)
    is checked against ``exec_cache.compiles``.

Crash recovery composes: ``replace_tenant`` swaps in a service restored
from its journal and clears the tenant's channels (in-flight entries
die with the process; the journal's seq gates make their re-delivery
safe -- see serve/journal.py).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import devices
from repro_torch.serve.buffer import AgentUpdate
from repro_torch.serve.clock import WallClock
from repro_torch.serve.journal import Journal
from repro_torch.serve.service import (AggregationService, CommitResult,
                                 ExecutableCache, ServeConfig)
from repro_torch.serve.telemetry import ServeTelemetry


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Front-side policy: channel bounds and pump batching."""

    channel_capacity: int = 16    # per-(tenant, agent) inbound slots
    pump_max: int = 256           # max deliveries drained per pump call

    def __post_init__(self):
        if self.channel_capacity < 1:
            raise ValueError(
                f"channel_capacity must be >= 1, "
                f"got {self.channel_capacity}")
        if self.pump_max < 1:
            raise ValueError(f"pump_max must be >= 1, got {self.pump_max}")


@dataclasses.dataclass(frozen=True, eq=False)
class _Entry:
    update: AgentUpdate
    enqueued_t: float
    ready_t: float                # > enqueued_t for trickling deliveries


@dataclasses.dataclass(frozen=True, eq=False)
class Receipt:
    """One pumped delivery's outcome, surfaced back to the harness."""

    tenant: str
    agent_id: int
    seq: int
    verdict: str
    waited_s: float               # enqueue -> submit (channel residency)


class InboundChannel:
    """One agent's bounded FIFO lane into one tenant."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._q: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def offer(self, entry: _Entry) -> bool:
        if len(self._q) >= self.capacity:
            return False
        self._q.append(entry)
        return True

    def head(self) -> Optional[_Entry]:
        return self._q[0] if self._q else None

    def pop(self) -> _Entry:
        return self._q.popleft()

    def clear(self) -> int:
        n = len(self._q)
        self._q.clear()
        return n


class TransportFront:
    """See module docstring."""

    def __init__(self, *, clock=None,
                 config: TransportConfig = TransportConfig(),
                 exec_cache: Optional[ExecutableCache] = None,
                 device="cuda"):
        self.clock = clock if clock is not None else WallClock()
        self.device = devices.resolve(device)
        self.config = config
        self.exec_cache = exec_cache if exec_cache is not None \
            else ExecutableCache()
        self._tenants: Dict[str, AggregationService] = {}
        self._channels: Dict[Tuple[str, int], InboundChannel] = {}
        self.counters = collections.Counter()
        self.queue_depth_max = 0

    # -- tenants -----------------------------------------------------------

    @property
    def tenants(self) -> Dict[str, AggregationService]:
        return dict(self._tenants)

    def tenant(self, name: str) -> AggregationService:
        return self._tenants[name]

    def add_tenant(self, name: str, model0, *,
                   config: ServeConfig = ServeConfig(), seed: int = 0,
                   fault_hook: Optional[Callable] = None,
                   journal: Optional[Journal] = None,
                   telemetry: Optional[ServeTelemetry] = None
                   ) -> AggregationService:
        """Create a tenant service wired to the front's clock, device
        and shared executable cache."""
        if name in self._tenants:
            raise ValueError(f"tenant {name!r} already exists")
        svc = AggregationService(
            model0, config=config, clock=self.clock, seed=seed,
            fault_hook=fault_hook, exec_cache=self.exec_cache,
            journal=journal, telemetry=telemetry, device=self.device)
        self._tenants[name] = svc
        return svc

    def replace_tenant(self, name: str,
                       service: AggregationService) -> int:
        """Swap in a recovered service (crash restart).  The tenant's
        in-flight channel entries are cleared -- they died with the
        process; re-deliveries land on the recovered seq gates.
        Returns the number of entries lost."""
        if name not in self._tenants:
            raise KeyError(f"unknown tenant {name!r}")
        self._tenants[name] = service
        lost = 0
        for (tenant, _agent), ch in self._channels.items():
            if tenant == name:
                lost += ch.clear()
        if lost:
            self.counters["channel_entries_lost"] += lost
        return lost

    # -- ingress -----------------------------------------------------------

    def offer(self, tenant: str, update: AgentUpdate, *,
              hold_s: float = 0.0) -> str:
        """Deliver one update to a tenant's per-agent channel.  The
        verdict goes back to the *sender*: ``enqueued`` or
        ``backpressure`` (lane full -- re-send later or slow down).
        ``hold_s`` models a trickling (slow-loris) delivery: the entry
        occupies its lane immediately but only becomes pump-able
        ``hold_s`` later."""
        if tenant not in self._tenants:
            raise KeyError(f"unknown tenant {tenant!r}")
        now = self.clock.now()
        key = (tenant, update.agent_id)
        ch = self._channels.get(key)
        if ch is None:
            ch = self._channels[key] = InboundChannel(
                self.config.channel_capacity)
        ok = ch.offer(_Entry(update=update, enqueued_t=now,
                             ready_t=now + max(hold_s, 0.0)))
        if not ok:
            self.counters["backpressure"] += 1
            return "backpressure"
        self.counters["enqueued"] += 1
        self.queue_depth_max = max(self.queue_depth_max, len(ch))
        return "enqueued"

    # -- dispatch ----------------------------------------------------------

    def pump(self) -> List[Receipt]:
        """Drain ready channel heads into their tenants (globally
        oldest first -- deterministic under ``SimClock``), then tick
        every tenant's deadline.  Returns the delivery receipts;
        commits accumulate in each tenant (``drain_commits``)."""
        now = self.clock.now()
        receipts: List[Receipt] = []
        for _ in range(self.config.pump_max):
            best_key = None
            best_entry = None
            for key, ch in self._channels.items():
                head = ch.head()
                if head is None or head.ready_t > now:
                    continue
                order = (head.enqueued_t, key[0], key[1])
                if best_entry is None \
                        or order < (best_entry.enqueued_t,
                                    best_key[0], best_key[1]):
                    best_key, best_entry = key, head
            if best_entry is None:
                break
            self._channels[best_key].pop()
            tenant, _agent = best_key
            verdict = self._tenants[tenant].submit(best_entry.update)
            receipts.append(Receipt(
                tenant=tenant, agent_id=best_entry.update.agent_id,
                seq=best_entry.update.seq, verdict=verdict,
                waited_s=now - best_entry.enqueued_t))
        for svc in self._tenants.values():
            svc.tick()
        return receipts

    def drain_commits(self) -> Dict[str, List[CommitResult]]:
        return {name: svc.drain_commits()
                for name, svc in self._tenants.items()}

    # -- observability -----------------------------------------------------

    def queue_depth(self) -> int:
        """Current total entries across all channels."""
        return sum(len(ch) for ch in self._channels.values())

    def stats(self) -> dict:
        row = {
            "channel_capacity": self.config.channel_capacity,
            "queue_depth_max": int(self.queue_depth_max),
            "queue_depth_now": self.queue_depth(),
            "enqueued_total": int(self.counters["enqueued"]),
            "backpressure_total": int(self.counters["backpressure"]),
            "channel_entries_lost": int(
                self.counters["channel_entries_lost"]),
            "tenants": len(self._tenants),
        }
        row.update(self.exec_cache.stats())
        return row

    # -- asyncio -----------------------------------------------------------

    async def offer_async(self, tenant: str, update: AgentUpdate, *,
                          hold_s: float = 0.0) -> str:
        """``offer`` from a coroutine (the verdict is the sender's
        backpressure signal; callers decide whether to back off)."""
        return self.offer(tenant, update, hold_s=hold_s)

    async def run_async(self, *, interval_s: float = 0.01,
                        stop=None, max_pumps: Optional[int] = None) -> int:
        """Pump the dispatcher from an asyncio loop (wall-clock
        deployments; the chaos harness calls ``pump`` directly under
        ``SimClock``).  Stops when ``stop.is_set()`` or after
        ``max_pumps`` iterations; returns the number of pumps run."""
        import asyncio
        n = 0
        while True:
            if stop is not None and stop.is_set():
                break
            self.pump()
            n += 1
            if max_pumps is not None and n >= max_pumps:
                break
            await asyncio.sleep(interval_s)
        return n
