"""Service telemetry: latency percentiles, throughput, histograms,
recovery counters, executable-cache statistics.

Counterpart of ``repro.serve.telemetry``, host-side as there.  One
addition: ``launch_replays`` counts the launch programs the service
ran (on the card, replays of a captured CUDA graph, which the kernel
wrappers' Python launch counts cannot see).  It is kept outside
``counters`` so that the counters of the two packages compare key for
key.

Two latency series are kept deliberately separate and labeled as such:

  request latency   clock-based (simulated seconds under ``SimClock``):
                    update arrival in the buffer -> the commit that
                    included it.  This is the per-request number the
                    bench reports as p50/p95/p99.
  launch wall       real seconds around the launch program: a graph
                    replay and the synchronize after it (always wall
                    time, even under a simulated clock).

``snapshot`` renders everything as a strict-JSON-able dict for
BENCH_serve.json (non-finite values become ``None``).

Two additions for the transport front / chaos harness:

  * queue depth + per-fault-mode recovery counters: the front's
    bounded-channel high-water mark (``record_queue_depth``) and the
    harness's "how many times did the service recover from fault mode
    X" counters (``record_recovery``) render into the snapshot, where
    ``bench_audit.audit_serve`` gates on them (queue depth must stay
    bounded by the channel capacity; a crash-chaos row must show a
    nonzero ``crash`` recovery count).
  * ``deterministic_view`` strips every wall-clock-derived field from a
    snapshot, leaving exactly the fields two identical SimClock runs
    must reproduce bit-for-bit (the determinism regression test
    compares these views, and the journals, across runs).

``merged`` folds several tenants' telemetry into one (summed counters,
pooled latency series, max queue depth) for the multi-tenant bench row.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional

import numpy as np

PERCENTILES = (50, 95, 99)

# snapshot fields that depend on wall time / host speed -- excluded by
# deterministic_view, everything else must replay bit-identically
NONDETERMINISTIC_KEYS = frozenset({
    "launch_wall_p50", "launch_wall_p95", "launch_wall_p99",
    "compile_s_total", "elapsed_s", "updates_per_sec",
})


def deterministic_view(row: dict) -> dict:
    """The subset of a snapshot two identical SimClock runs must agree
    on exactly (see module docstring)."""
    return {k: v for k, v in row.items() if k not in NONDETERMINISTIC_KEYS}


def _pcts(values: List[float], prefix: str) -> Dict[str, Optional[float]]:
    out: Dict[str, Optional[float]] = {}
    arr = np.asarray(values, dtype=np.float64)
    for p in PERCENTILES:
        if arr.size == 0:
            out[f"{prefix}_p{p}"] = None
        else:
            v = float(np.percentile(arr, p))
            out[f"{prefix}_p{p}"] = v if np.isfinite(v) else None
    return out


class ServeTelemetry:
    """Mutable per-service counters; see module docstring."""

    def __init__(self):
        self.request_latency_s: List[float] = []
        self.launch_wall_s: List[float] = []
        self.cohort_sizes = collections.Counter()     # real members/commit
        self.staleness = collections.Counter()        # per admitted update
        self.counters = collections.Counter()
        # executable-cache bookkeeping: first sight of a geometry is the
        # sanctioned warmup compile; any later miss is a retrace bug
        self._geometries_seen = set()
        self.post_warmup_misses = 0
        self.compile_s_total = 0.0
        self.recoveries = collections.Counter()       # fault mode -> events
        self.queue_depth_max = 0                      # transport high-water
        self.channel_capacity: Optional[int] = None
        self.launch_replays = 0                       # launch programs run

    # -- admission / commit events -----------------------------------------

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def record_recovery(self, mode: str, n: int = 1) -> None:
        """Count ``n`` recovery events for one fault mode (the chaos
        harness maps each injected mode to its observed defense)."""
        self.recoveries[mode] += int(n)

    def record_queue_depth(self, depth: int,
                           capacity: Optional[int] = None) -> None:
        """Track the transport front's bounded-channel high-water mark
        (and the bound itself, so the audit can check depth <= bound)."""
        self.queue_depth_max = max(self.queue_depth_max, int(depth))
        if capacity is not None:
            self.channel_capacity = int(capacity)

    def record_admission(self, staleness: int) -> None:
        self.staleness[int(staleness)] += 1
        if staleness > 0:
            self.counters["stale_downweighted"] += 1

    def record_commit(self, *, cohort_size: int, latencies_s: List[float],
                      launch_wall_s: Optional[float], kind: str) -> None:
        self.counters["commits"] += 1
        self.counters[f"commits_{kind}"] += 1
        self.cohort_sizes[int(cohort_size)] += 1
        self.counters["updates_applied"] += len(latencies_s)
        self.request_latency_s.extend(float(v) for v in latencies_s)
        if launch_wall_s is not None:
            self.launch_wall_s.append(float(launch_wall_s))

    def record_replay(self) -> None:
        """One run of a launch program (one graph replay on the card)."""
        self.launch_replays += 1

    def record_cache(self, key, *, hit: bool, compile_s: float = 0.0) -> None:
        if hit:
            self.counters["exec_cache_hits"] += 1
            return
        self.counters["exec_cache_misses"] += 1
        self.compile_s_total += compile_s
        if key in self._geometries_seen:
            self.post_warmup_misses += 1
        self._geometries_seen.add(key)

    # -- rendering ---------------------------------------------------------

    def snapshot(self, *, elapsed_s: Optional[float] = None) -> dict:
        applied = int(self.counters["updates_applied"])
        row = {
            "counters": {k: int(v) for k, v in sorted(self.counters.items())},
            "cohort_size_hist": {str(k): int(v) for k, v in
                                 sorted(self.cohort_sizes.items())},
            "staleness_hist": {str(k): int(v) for k, v in
                               sorted(self.staleness.items())},
            "compile_s_total": round(self.compile_s_total, 4),
            "post_warmup_misses": int(self.post_warmup_misses),
            "post_warmup_cache_hit": self.post_warmup_misses == 0,
            "n_geometries": len(self._geometries_seen),
            "recoveries": {k: int(v) for k, v in
                           sorted(self.recoveries.items())},
            "queue_depth_max": int(self.queue_depth_max),
            "launch_replays": int(self.launch_replays),
        }
        if self.channel_capacity is not None:
            row["channel_capacity"] = int(self.channel_capacity)
            row["queue_depth_bounded"] = (
                self.queue_depth_max <= self.channel_capacity)
        row.update(_pcts(self.request_latency_s, "latency"))
        row.update(_pcts(self.launch_wall_s, "launch_wall"))
        if elapsed_s is not None and elapsed_s > 0:
            row["elapsed_s"] = round(float(elapsed_s), 6)
            row["updates_per_sec"] = round(applied / float(elapsed_s), 3)
        return row

    # -- multi-tenant merge ------------------------------------------------

    @classmethod
    def merged(cls, tels: Iterable["ServeTelemetry"]) -> "ServeTelemetry":
        """Fold several tenants' telemetry into one aggregate view
        (summed counters, pooled latency series, max queue depth).
        Per-service cache counters keep their meaning: with a shared
        ``ExecutableCache`` the second tenant's first launch of a warm
        geometry is a *hit*, so the merged ``exec_cache_hits`` directly
        witnesses cross-tenant executable sharing."""
        out = cls()
        for t in tels:
            out.request_latency_s.extend(t.request_latency_s)
            out.launch_wall_s.extend(t.launch_wall_s)
            out.cohort_sizes.update(t.cohort_sizes)
            out.staleness.update(t.staleness)
            out.counters.update(t.counters)
            out.recoveries.update(t.recoveries)
            out._geometries_seen |= t._geometries_seen
            out.post_warmup_misses += t.post_warmup_misses
            out.compile_s_total += t.compile_s_total
            out.queue_depth_max = max(out.queue_depth_max,
                                      t.queue_depth_max)
            out.launch_replays += t.launch_replays
            if t.channel_capacity is not None:
                out.channel_capacity = (
                    t.channel_capacity if out.channel_capacity is None
                    else max(out.channel_capacity, t.channel_capacity))
        return out
