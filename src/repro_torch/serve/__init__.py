"""`repro_torch.serve`: fault-tolerant streaming aggregation service.

Counterpart of ``repro.serve``, module for module:

  clock       -- wall vs. deterministic simulated time
  retry       -- jittered exponential backoff with a deadline budget;
                 retries only ``FaultInjected`` (see below)
  buffer      -- FedBuff-style admission buffer (dedup, supersede,
                 staleness window, backpressure)
  service     -- the aggregation loop: buffered cohorts, one launch
                 program per cohort geometry (on the card a CUDA graph
                 captured once over a static cohort buffer, replaying
                 the Hopper kernel), staleness- and health-weighted
                 admission, circuit breaker, graceful degradation
  journal     -- write-ahead journal + snapshots in the reference's byte
                 format: exactly-once admission across crash/restart
  transport   -- concurrent front: bounded per-agent channels with
                 backpressure verdicts, dispatcher over multiple
                 tenant services sharing one executable cache
  telemetry   -- latency percentiles, throughput, histograms, recovery
                 counters, queue depth, replays, deterministic views
  chaos       -- deterministic fault injection, drawn from the same
                 numpy streams as the reference
  scenario    -- replay a federated ``ScenarioSpec``'s traffic through
                 the transport-fronted service under a simulated clock

Entry points take ``device`` and default to ``"cuda"``.  Unlike the
reference, a launch error other than the chaos harness's
``FaultInjected`` is never retried or carried forward: it propagates.
"""

from repro_torch.serve.buffer import AgentUpdate, CohortBuffer
from repro_torch.serve.chaos import (CHAOS_PROFILES, ChaosConfig,
                                     FaultInjected, NetworkModel)
from repro_torch.serve.clock import SimClock, WallClock
from repro_torch.serve.journal import Journal, JournalCorrupt
from repro_torch.serve.retry import RetryError, RetryPolicy
from repro_torch.serve.scenario import ServeResult, replay
from repro_torch.serve.service import (AggregationService, CommitResult,
                                       ExecutableCache, ServeConfig)
from repro_torch.serve.transport import TransportConfig, TransportFront

__all__ = [
    "AgentUpdate", "AggregationService", "CHAOS_PROFILES", "ChaosConfig",
    "CohortBuffer", "CommitResult", "ExecutableCache", "FaultInjected",
    "Journal", "JournalCorrupt", "NetworkModel", "RetryError", "RetryPolicy",
    "ServeConfig", "ServeResult", "SimClock", "TransportConfig",
    "TransportFront", "WallClock", "replay",
]
