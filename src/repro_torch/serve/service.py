"""The long-lived streaming aggregation service.

Counterpart of ``repro.serve.service``: the same admission policy,
verdicts, degradation ladder, health gate, trust-region clip, journal
records and executable cache, around the port's engine.
``AggregationService`` accepts per-agent update streams (``submit``),
buffers them FedBuff-style (admit a cohort when ``buffer >= k_min`` OR
the admission deadline fires, whichever first), and launches the
engine -- one launch program per cohort *geometry*, cached.  On the
card a launch program is a CUDA graph captured once over a static
(k, M) cohort buffer (``AggregationEngine.lower_launch``); every
admitted cohort is copied into that buffer and the graph replays the
Hopper kernel.  The cache is an ``ExecutableCache`` that can be
**shared across services**: the transport front hands every tenant the
same cache, so N tenants running the same geometry capture once in
total.  The only sanctioned captures are the first sight of each
geometry (warmup), and ``telemetry.post_warmup_misses`` counts any
violation.

What lives where: the model, every payload (moved to the service's
device at ``submit``), the cohort buffer, the estimate, the residual
norms of the outlier check and the trust-region clip are on the
service's device; the cohort weights, the thresholds and every verdict
are host-side numpy/Python, computed as the reference computes them.
Nothing of a payload or the model comes back to the host except
through the journal.

Fault tolerance by construction, as in the reference:

  * duplicate / replayed deliveries and non-finite payloads never reach
    the estimator (``CohortBuffer`` admission verdicts);
  * staleness-weighted admission: weight ``w * (1+s)**-staleness_alpha``;
  * health-gated admission with a circuit breaker (see the reference's
    module docstring for the score);
  * graceful degradation below ``k_min`` and a trust-region step clip on
    every commit;
  * crash recovery from a ``serve.journal.Journal``.

One deliberate difference: launch attempts are retried under
``retry.RetryPolicy`` only for ``FaultInjected``, the chaos harness's
synthetic fault, and exhaustion degrades to carry-forward.  Any other
error from a launch -- a CUDA error, a kernel wrapper's
``RuntimeError`` -- propagates out of ``submit`` / ``tick`` /
``admit_now``: the service never turns a real device or kernel fault
into a quiet ``carried_forward``.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import devices
from repro_torch.kernels import mm_aggregate, ops, tuning
from repro_torch.serve import journal as _journal
from repro_torch.serve import retry as _retry
from repro_torch.serve.buffer import AgentUpdate, CohortBuffer, Pending
from repro_torch.serve.clock import WallClock
from repro_torch.serve.telemetry import ServeTelemetry
from repro_torch.tracing import PhaseTimer

DEGRADATIONS = ("partial", "carry")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Admission + degradation policy of one service instance.

    The reference's fields and checks, but for its ``interpret`` and
    ``donate``, which would change nothing here.  ``backend``:
    ``"pallas"`` launches the Hopper kernels (their plain versions on the
    CPU), ``"jnp"`` the plain estimator of ``core.location``."""

    k_min: int = 8                    # cohort admission threshold
    deadline_s: float = 1.0           # admit-by deadline per cohort
    max_staleness: int = 4            # rounds; older updates rejected
    staleness_alpha: float = 0.5      # weight = (1+staleness)**-alpha
    quorum: int = 2                   # below this, never aggregate
    degradation: str = "partial"      # partial | carry (sub-k_min ladder)
    degraded_c_scale: float = 0.5     # widened margin: Tukey c scale
    trust_factor: float = 2.0         # partial step clip vs. EMA step norm
    max_buffer: int = 4096            # backpressure cap
    num_iters: int = 10               # IRLS depth
    backend: str = "pallas"           # engine backend (pallas | jnp)
    retry: _retry.RetryPolicy = _retry.RetryPolicy()
    # -- health-gated admission -------------------------------------------
    health_gate: bool = True
    health_alpha: float = 0.25        # EMA rate of the health score
    health_floor: float = 0.1         # admission-weight multiplier floor
    quarantine_threshold: int = 5     # consecutive rejections -> breaker
    quarantine_rounds: int = 8        # quarantine length (server rounds)
    residual_z: float = 4.0           # estimator-outlier threshold (MADN)
    journal_snapshot_every: int = 64  # snapshot cadence (commits)

    def __post_init__(self):
        if self.k_min < 1:
            raise ValueError(f"k_min must be >= 1, got {self.k_min}")
        if not 1 <= self.quorum <= self.k_min:
            raise ValueError(
                f"quorum must be in [1, k_min={self.k_min}], "
                f"got {self.quorum}")
        if self.degradation not in DEGRADATIONS:
            raise ValueError(
                f"unknown degradation {self.degradation!r}; "
                f"known: {DEGRADATIONS}")
        if not 0.0 < self.degraded_c_scale <= 1.0:
            raise ValueError(
                "degraded_c_scale widens the robustness margin and must "
                f"be in (0, 1], got {self.degraded_c_scale}")
        if self.max_staleness < 0 or self.deadline_s <= 0:
            raise ValueError("max_staleness >= 0 and deadline_s > 0 required")
        if not 0.0 < self.health_alpha <= 1.0:
            raise ValueError(
                f"health_alpha must be in (0, 1], got {self.health_alpha}")
        if not 0.0 <= self.health_floor < 1.0:
            raise ValueError(
                f"health_floor must be in [0, 1), got {self.health_floor}")
        if self.quarantine_threshold < 1 or self.quarantine_rounds < 1:
            raise ValueError(
                "quarantine_threshold and quarantine_rounds must be >= 1")
        if self.residual_z <= 0:
            raise ValueError(
                f"residual_z must be > 0, got {self.residual_z}")
        if self.journal_snapshot_every < 1:
            raise ValueError("journal_snapshot_every must be >= 1")

    def staleness_weight(self, staleness: int) -> float:
        return float((1.0 + max(staleness, 0)) ** -self.staleness_alpha)

    def health_weight(self, score: float) -> float:
        return self.health_floor + (1.0 - self.health_floor) * float(score)


@dataclasses.dataclass(frozen=True, eq=False)
class CommitResult:
    """One admission outcome (committed model round or degradation)."""

    kind: str                 # aggregated | degraded_partial | carried_forward
    round: int                # server round AFTER this commit
    cohort_size: int          # real (non-anchor) members launched
    agent_ids: tuple = ()
    stalenesses: tuple = ()
    seqs: tuple = ()          # (agent, seq) pairs the cohort consumed
    cache_hit: bool = False
    compile_s: float = 0.0    # capture of the launch program (first sight)
    launch_wall_s: float = 0.0
    attempts: int = 0
    clipped: bool = False     # trust-region clip engaged
    outliers: tuple = ()      # agents the estimator-residual check flagged


class _WeightFloor:
    # numerically-zero total cohort mass; matches location._SCALE_FLOOR
    VALUE = 1e-12


class AgentHealth:
    """Mutable per-agent health record (see ServeConfig fields)."""

    __slots__ = ("score", "consecutive_rejections", "quarantined_until")

    def __init__(self, score: float = 1.0, consecutive_rejections: int = 0,
                 quarantined_until: int = -1):
        self.score = float(score)
        self.consecutive_rejections = int(consecutive_rejections)
        self.quarantined_until = int(quarantined_until)

    def as_list(self) -> list:
        return [self.score, self.consecutive_rejections,
                self.quarantined_until]


class ExecutableCache:
    """Shared cache of launch programs, keyed by the full launch
    identity ``(k, m, dtype, engine signature, tuning state, device)``.

    One instance can back many ``AggregationService`` tenants: one
    capture per distinct key across all tenants (``compiles`` counts per
    key).  The static cohort buffers are keyed by geometry alone
    ``(k, m, dtype, device)`` and shared by every program of that
    geometry -- the full-cohort and the degraded engine's programs read
    the same (k, M) buffer, which at a model's full width is most of the
    card.  Each program counts its own replays; the service replays
    them only through the cache.
    """

    def __init__(self):
        self._execs: dict = {}
        self._key_records: Dict[tuple, list] = {}
        self._inputs: Dict[tuple, tuple] = {}
        self.hits = 0
        self.compiles = collections.Counter()

    def get(self, key):
        compiled = self._execs.get(key)
        if compiled is not None:
            self.hits += 1
        return compiled

    def put(self, key, compiled, records) -> None:
        self._execs[key] = compiled
        self._key_records[key] = list(records)
        self.compiles[key] += 1

    def records_for(self, key) -> list:
        return self._key_records.get(key, [])

    def programs(self) -> list:
        """The cached launch programs, in the order they were captured."""
        return list(self._execs.values())

    def static_inputs(self, lowered: ops.LoweredLaunch) -> tuple:
        """The (x (k, m), a (k,)) buffers of ``lowered``'s geometry,
        allocated on first use."""
        key = (lowered.k, lowered.m, str(lowered.dtype), str(lowered.device))
        if key not in self._inputs:
            self._inputs[key] = lowered.static_inputs()
        return self._inputs[key]

    @property
    def n_keys(self) -> int:
        return len(self._execs)

    @property
    def n_compiles(self) -> int:
        return sum(self.compiles.values())

    def stats(self) -> dict:
        return {
            "exec_cache_keys": self.n_keys,
            "exec_cache_compiles": self.n_compiles,
            "exec_cache_hits": int(self.hits),
            "exec_cache_replays": sum(program.replays
                                      for program in self._execs.values()),
            "exec_cache_max_compiles_per_key":
                max(self.compiles.values()) if self.compiles else 0,
        }


def _as_vector(x, device) -> torch.Tensor:
    """A flat contiguous float32 tensor on ``device`` (a view where ``x``
    already is one)."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.asarray(x, dtype=np.float32))
    return t.to(device=device, dtype=torch.float32).reshape(-1).contiguous()


def cohort_weights(entries: List[Pending], config: ServeConfig,
                   health_factors: Optional[Dict[int, float]] = None
                   ) -> np.ndarray:
    """The (k,) float32 weight column: client weight x staleness factor
    x optional per-agent health factor (host-side, as the reference
    computes it, so the refusal and anchor arithmetic match bit for
    bit).  Raises on duplicate agent ids: the buffer's
    one-slot-per-agent invariant makes this unreachable from the service
    loop, but direct callers get a clear error instead of a silently
    double-counted agent."""
    ids = [p.update.agent_id for p in entries]
    if len(set(ids)) != len(ids):
        dup = sorted({i for i in ids if ids.count(i) > 1})
        raise ValueError(
            f"duplicate agent id(s) {dup} in one cohort: each agent "
            "contributes at most one update per cohort (the admission "
            "buffer supersedes, never duplicates)")
    factors = health_factors or {}
    return np.asarray(
        [p.update.weight * config.staleness_weight(p.staleness)
         * factors.get(p.update.agent_id, 1.0)
         for p in entries], dtype=np.float32)


def assemble_cohort(entries: List[Pending], config: ServeConfig,
                    health_factors: Optional[Dict[int, float]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack pending entries into the (k, M) cohort on the payloads'
    device (the service's: ``submit`` moves them there) beside the (k,)
    float32 weight column of ``cohort_weights``.  The service itself
    stages the payloads straight into its launch program's static
    buffer, without this stack."""
    a = cohort_weights(entries, config, health_factors)
    x = torch.stack([p.update.payload.reshape(-1) for p in entries])
    return x, torch.from_numpy(a).to(x.device)


class AggregationService:
    """See module docstring.  ``fault_hook`` (chaos injection) is called
    once per launch *attempt* and may raise ``FaultInjected`` to simulate
    an engine failure; it must never be used to mutate service state.

    ``exec_cache`` shares launch programs across services
    (multi-tenant); ``journal`` makes admission state durable -- pass a
    fresh journal here, or restore a crashed service with
    ``AggregationService.recover(journal, ...)``.  ``device`` holds the
    model, the payloads and the launches (``"cuda"`` by default; raises
    without a card unless the caller asks for ``"cpu"``).  ``timer``
    times the service's phases on the card (``phase_ms``).
    """

    def __init__(self, model0, *, config: ServeConfig = ServeConfig(),
                 clock=None, seed: int = 0,
                 fault_hook: Optional[Callable] = None,
                 exec_cache: Optional[ExecutableCache] = None,
                 journal: Optional[_journal.Journal] = None,
                 telemetry: Optional[ServeTelemetry] = None,
                 device="cuda", timer: Optional[PhaseTimer] = None):
        self.config = config
        self.device = devices.resolve(device)
        self.timer = timer if timer is not None \
            else PhaseTimer(self.device.type == "cuda")
        self.clock = clock if clock is not None else WallClock()
        self._w = _as_vector(model0, self.device).clone()
        if bool(ops.any_nonfinite(self._w)):
            raise ValueError("initial model must be finite")
        self.round = 0
        self.dim = self._w.shape[0]
        self.telemetry = telemetry if telemetry is not None \
            else ServeTelemetry()
        self.buffer = CohortBuffer(max_staleness=config.max_staleness,
                                   max_buffer=config.max_buffer,
                                   timer=self.timer)
        self._rng = np.random.default_rng(seed)
        self._fault_hook = fault_hook
        self.exec_cache = exec_cache if exec_cache is not None \
            else ExecutableCache()
        self._records: list = []
        self._commit_log: List[CommitResult] = []
        self._deadline_t: Optional[float] = None
        self._step_norm_ema: Optional[float] = None
        self._health: Dict[int, AgentHealth] = {}
        self._journal: Optional[_journal.Journal] = None
        self._recovering = False
        # the timer's mark at the first submit after the last launched
        # commit: the admissions from there on belong to the next commit
        self._admit_mark: Optional[int] = None
        c95 = ops.mestimators.TUKEY_C95
        self._engines = {
            False: ops.get_engine(num_iters=config.num_iters,
                                  backend=config.backend),
            True: ops.get_engine(num_iters=config.num_iters,
                                 backend=config.backend,
                                 c=c95 * config.degraded_c_scale),
        }
        if journal is not None:
            self.attach_journal(journal)

    # -- journal -----------------------------------------------------------

    def attach_journal(self, journal: _journal.Journal) -> None:
        """Attach a *fresh* journal (writes the ``init`` base record).
        A journal with history must go through ``recover`` instead."""
        if any(True for _ in journal.records()):
            raise ValueError(
                "journal already holds records; restore the service with "
                "AggregationService.recover(journal, ...) instead")
        journal.append("init", {
            "model": _journal.encode_array(self._w),
            "round": self.round, "dim": self.dim})
        self._journal = journal

    def _health_state(self) -> dict:
        return {str(a): h.as_list() for a, h in sorted(self._health.items())}

    def _journal_commit(self, kind: str, entries: List[Pending]) -> None:
        if self._journal is None or self._recovering:
            return
        self._journal.append("commit", {
            "kind": kind,
            "round": self.round,
            "model": _journal.encode_array(self._w),
            "ema": self._step_norm_ema,
            "taken": [p.update.agent_id for p in entries],
            "seqs": [[p.update.agent_id, p.update.seq] for p in entries],
            "health": self._health_state(),
            "now": self.clock.now()})
        if self._journal.snapshot_due():
            self._write_snapshot()

    def _write_snapshot(self) -> None:
        last_seq, pending = self.buffer.export_state()
        self._journal.append("snapshot", {
            "model": _journal.encode_array(self._w),
            "round": self.round,
            "ema": self._step_norm_ema,
            "last_seq": {str(k): v for k, v in sorted(last_seq.items())},
            "pending": [{
                "agent": p.update.agent_id, "round": p.update.round,
                "seq": p.update.seq, "weight": p.update.weight,
                "payload": _journal.encode_array(p.update.payload),
                "sent_at": p.update.sent_at,
                "arrival_t": p.arrival_t, "staleness": p.staleness,
            } for p in sorted(pending,
                              key=lambda p: (p.arrival_t,
                                             p.update.agent_id))],
            "health": self._health_state(),
            "now": self.clock.now()})

    @classmethod
    def recover(cls, journal: _journal.Journal, *,
                config: ServeConfig = ServeConfig(), clock=None,
                seed: int = 0, fault_hook: Optional[Callable] = None,
                exec_cache: Optional[ExecutableCache] = None,
                telemetry: Optional[ServeTelemetry] = None,
                device="cuda", timer: Optional[PhaseTimer] = None
                ) -> "AggregationService":
        """Rebuild a crashed service from its journal (the reference's
        or this package's: the format is one): load the last snapshot,
        then replay the record tail *through the live gate logic*
        (deliveries re-run ``_gate_and_add``, commits apply their
        journaled post-state -- no relaunch), so the recovered seq gates,
        pending buffer, trust EMA and health map are exactly the crashed
        service's.  ``exec_cache`` re-attaches the shared cache: its
        captured programs outlive the service object."""
        state = _journal.recover_state(journal)
        svc = cls(state.model, config=config, clock=clock, seed=seed,
                  fault_hook=fault_hook, exec_cache=exec_cache,
                  telemetry=telemetry, device=device, timer=timer)
        svc.round = state.round
        svc._step_norm_ema = state.ema
        pending = [Pending(
            update=AgentUpdate(
                agent_id=int(p["agent"]), round=int(p["round"]),
                payload=_as_vector(_journal.decode_array(p["payload"]),
                                  svc.device),
                weight=float(p["weight"]), seq=int(p["seq"]),
                sent_at=float(p.get("sent_at", 0.0))),
            arrival_t=float(p["arrival_t"]), staleness=int(p["staleness"]))
            for p in state.pending]
        svc.buffer.restore_state(state.last_seq, pending)
        svc._health = {int(a): AgentHealth(*v)
                       for a, v in state.health.items()}
        svc._recovering = True
        for kind, rec in state.tail:
            if kind == "delivery":
                svc._gate_and_add(AgentUpdate(
                    agent_id=int(rec["agent"]), round=int(rec["round"]),
                    payload=_as_vector(_journal.decode_array(rec["payload"]),
                                      svc.device),
                    weight=float(rec["weight"]), seq=int(rec["seq"]),
                    sent_at=float(rec.get("sent_at", 0.0))),
                    now=float(rec["now"]))
            elif kind == "commit":
                svc._apply_commit_record(rec)
        svc._recovering = False
        svc._journal = journal
        journal.append("recovered", {
            "round": svc.round, "n_replayed": len(state.tail),
            "pending": len(svc.buffer)})
        if len(svc.buffer) > 0:
            svc._deadline_t = svc.clock.now() + config.deadline_s
        svc.telemetry.count("journal_recoveries")
        return svc

    def _apply_commit_record(self, rec: dict) -> None:
        self.buffer.discard(rec.get("taken") or ())
        if rec["kind"] in ("aggregated", "degraded_partial"):
            self._w = _as_vector(_journal.decode_array(rec["model"]),
                                self.device)
            self.round = int(rec["round"])
            ema = rec.get("ema")
            self._step_norm_ema = None if ema is None else float(ema)
            self.buffer.refresh_staleness(self.round)
        self._health = {int(a): AgentHealth(*v)
                        for a, v in (rec.get("health") or {}).items()}

    # -- public surface ----------------------------------------------------

    @property
    def model(self) -> torch.Tensor:
        """A copy of the committed model, on the service's device."""
        return self._w.clone()

    def submit(self, update: AgentUpdate) -> str:
        """Deliver one update; returns the admission verdict and pumps
        full-cohort admissions.  The payload moves to the service's
        device here."""
        if self._admit_mark is None:
            self._admit_mark = self.timer.mark()
        update = dataclasses.replace(
            update, payload=_as_vector(update.payload, self.device))
        was_empty = len(self.buffer) == 0
        if self._journal is not None:
            # write-ahead: the delivery is durable before it is applied
            self._journal.append("delivery", {
                "agent": update.agent_id, "round": update.round,
                "seq": update.seq, "weight": update.weight,
                "payload": _journal.encode_array(update.payload),
                "sent_at": update.sent_at,
                "now": self.clock.now()})
        verdict = self._gate_and_add(update, now=self.clock.now())
        self.telemetry.count(f"submit_{verdict}")
        if verdict in ("buffered", "superseded"):
            if was_empty and len(self.buffer) > 0:
                self._deadline_t = self.clock.now() + self.config.deadline_s
            self._pump()
        return verdict

    def tick(self) -> List[CommitResult]:
        """Advance time-driven state: fire the admission deadline if it
        expired."""
        before = len(self._commit_log)
        self._pump()
        if (self._deadline_t is not None
                and self.clock.now() >= self._deadline_t):
            self.telemetry.count("deadline_fired")
            self._admit(deadline=True)
        return self._commit_log[before:]

    def admit_now(self) -> CommitResult:
        """Force an admission decision immediately (manual flush /
        drain): same ladder as a fired deadline."""
        return self._admit(deadline=True)

    def drain_commits(self) -> List[CommitResult]:
        out, self._commit_log = self._commit_log, []
        return out

    def health_of(self, agent_id: int) -> AgentHealth:
        """The agent's current health record (a fresh default if the
        agent has never been seen)."""
        return self._health.get(agent_id, AgentHealth())

    def phase_ms(self) -> Dict[str, float]:
        """Device milliseconds of the last launched commit's phases --
        ``admit`` (the finiteness checks of every update submitted since
        the commit before it was launched), ``stage`` (the rows copied
        into the static cohort buffer), ``replay`` (the launch program),
        ``take`` (the estimate copied out of the program's output),
        ``guard`` (the estimate's finiteness check), ``outliers`` (the
        residual norms) and ``clip`` (the trust-region step) -- from
        CUDA-event pairs; empty off the card."""
        return self.timer.phase_ms(before=self._admit_mark)

    def launch_audit(self) -> Optional[dict]:
        """``mm_aggregate.launch_plan`` dicts for every kernel workload
        the service's launch programs resolved (recorded at capture;
        shared-cache hits carry the recording of whichever tenant
        captured the geometry)."""
        pallas = [r for r in self._records if r["backend"] == "pallas"]
        if not pallas:
            return None
        plans = []
        for r in pallas:
            plan = mm_aggregate.launch_plan(
                r["k"], r["m"], r["n"], dtype=r["dtype"],
                block_m=r["block_m"], block_k=r["block_k"],
                path=r.get("path"))
            d = plan._asdict()
            d["grid"] = list(d["grid"])
            plans.append(d)
        if len(plans) == 1:
            return plans[0]
        return {"layouts": plans, "n_layouts": len(plans)}

    # -- admission ---------------------------------------------------------

    def _gate_and_add(self, update: AgentUpdate, *, now: float) -> str:
        """The admission gate: quarantine door, then the buffer's
        verdict, then health bookkeeping.  Shared verbatim between the
        live ``submit`` path and journal recovery."""
        cfg = self.config
        if cfg.health_gate:
            h = self._health.get(update.agent_id)
            if h is not None and self.round < h.quarantined_until:
                return "rejected_quarantined"
        verdict = self.buffer.add(update, now=now,
                                  current_round=self.round)
        if verdict in ("rejected_invalid", "rejected_stale"):
            self._health_hit(update.agent_id)
        return verdict

    def _health_of(self, agent_id: int) -> AgentHealth:
        h = self._health.get(agent_id)
        if h is None:
            h = self._health[agent_id] = AgentHealth()
        return h

    def _health_hit(self, agent_id: int) -> None:
        """One rejection event: decay the score, advance the breaker."""
        if not self.config.health_gate:
            return
        cfg = self.config
        h = self._health_of(agent_id)
        h.score = (1.0 - cfg.health_alpha) * h.score
        h.consecutive_rejections += 1
        self.telemetry.count("health_hits")
        if h.consecutive_rejections >= cfg.quarantine_threshold:
            h.quarantined_until = self.round + cfg.quarantine_rounds
            h.consecutive_rejections = 0
            self.telemetry.count("quarantined")

    def _health_reward(self, agent_id: int) -> None:
        """Clean cohort participation: recover toward 1, reset breaker."""
        if not self.config.health_gate:
            return
        cfg = self.config
        h = self._health_of(agent_id)
        h.score = (1.0 - cfg.health_alpha) * h.score + cfg.health_alpha
        h.consecutive_rejections = 0

    def _health_factors(self, entries: List[Pending]
                        ) -> Optional[Dict[int, float]]:
        if not self.config.health_gate:
            return None
        return {p.update.agent_id:
                self.config.health_weight(
                    self.health_of(p.update.agent_id).score)
                for p in entries}

    def _mark_estimator_outliers(self, r: np.ndarray,
                                 entries: List[Pending]) -> tuple:
        """Residual check after a commit: cohort members the redescending
        loss threw out sit far outside the residual MADN band around the
        committed center; their health takes the hit, everyone else's
        recovers.  ``r`` holds the members' k residual norms
        ``||rows[i] - center||``, made on the device with the step norm
        in one read of each row (``_launch_commit``); the threshold is
        the reference's, on the host.  Anchor rows (degraded path) are
        not agents and are excluded by construction (``entries`` only)."""
        if not self.config.health_gate:
            return ()
        med = float(np.median(r))
        madn = 1.4826 * float(np.median(np.abs(r - med)))
        # identical honest payloads give MADN == 0; the relative floor
        # keeps ordinary sampling noise from being flagged
        floor = max(1e-7, 1e-3 * max(med, 1.0))
        thresh = med + self.config.residual_z * max(madn, floor)
        outliers = []
        for i, p in enumerate(entries):
            if float(r[i]) > thresh:
                outliers.append(p.update.agent_id)
                self._health_hit(p.update.agent_id)
                self.telemetry.count("estimator_outliers")
            else:
                self._health_reward(p.update.agent_id)
        return tuple(outliers)

    def _pump(self) -> None:
        while len(self.buffer) >= self.config.k_min:
            self._admit(deadline=False)

    def _admit(self, *, deadline: bool) -> CommitResult:
        cfg = self.config
        k = min(len(self.buffer), cfg.k_min)
        if deadline and k < cfg.k_min:
            result = self._admit_partial(k)
        else:
            entries = self.buffer.take(cfg.k_min)
            result = self._launch_commit(entries, degraded=False)
        # re-arm / clear the deadline for whatever is still pending
        if len(self.buffer) > 0:
            self._deadline_t = self.clock.now() + cfg.deadline_s
        else:
            self._deadline_t = None
        self._commit_log.append(result)
        return result

    def _admit_partial(self, k: int) -> CommitResult:
        """The sub-``k_min`` degradation ladder (deadline fired)."""
        cfg = self.config
        if k == 0:
            self.telemetry.count("zero_participant_rounds")
            return self._carry(0, ())
        if k < cfg.quorum or cfg.degradation == "carry" \
                or self._step_norm_ema is None:
            # below quorum, explicitly configured, or no trust-region
            # history yet: never aggregate -- carry the model forward
            # (the entries stay buffered for the next cohort)
            self.telemetry.count("partial_carried")
            return self._carry(k, ())
        entries = self.buffer.take(k)
        return self._launch_commit(entries, degraded=True)

    def _carry(self, k: int, agent_ids: tuple,
               consumed: Optional[List[Pending]] = None) -> CommitResult:
        self.telemetry.count("carried_forward")
        res = CommitResult(kind="carried_forward", round=self.round,
                           cohort_size=k, agent_ids=agent_ids)
        if consumed:
            # entries were taken from the buffer and lost (launch
            # failure / refused weight): the consumption must be
            # durable or recovery would re-admit them into a cohort
            self._journal_commit("carried_forward", consumed)
        self.telemetry.record_commit(cohort_size=k, latencies_s=[],
                                     launch_wall_s=None, kind=res.kind)
        return res

    # -- launch ------------------------------------------------------------

    def _launch_commit(self, entries: List[Pending],
                       *, degraded: bool) -> CommitResult:
        cfg = self.config
        rows = [p.update.payload for p in entries]
        a = cohort_weights(entries, cfg, self._health_factors(entries))
        ids = tuple(p.update.agent_id for p in entries)
        if float(a.sum()) <= _WeightFloor.VALUE:
            # total mass numerically zero: normalize_weights would fall
            # back to uniform -- that is "silently averaging garbage",
            # so refuse and carry forward instead
            self.telemetry.count("zero_weight_rejected")
            return self._carry(len(entries), ids, consumed=entries)
        if degraded:
            # pad to the k_min geometry with anchor rows holding the
            # previous model at half the total mass: the widened-margin
            # estimator can reject the entire partial cohort and still
            # land on the previous model
            n_anchor = cfg.k_min - len(rows)
            if n_anchor > 0:
                rows = rows + [self._w] * n_anchor
                a = np.concatenate(
                    [a, np.full((n_anchor,), a.sum() / n_anchor,
                                dtype=np.float32)])
        self.timer.reset(since=self._admit_mark)
        self._admit_mark = None
        try:
            result, wall, attempts, cache_hit, compile_s = \
                self._launch(rows, a, degraded)
        except _retry.RetryError as err:
            self.telemetry.count("launch_failed")
            self.telemetry.count("updates_lost", len(entries))
            self.telemetry.count(
                "launch_attempts_exhausted", err.attempts)
            return self._carry(len(entries), ids, consumed=entries)
        token = self.timer.begin("guard")
        nonfinite = ops.any_nonfinite(result)
        self.timer.end(token)
        if bool(nonfinite):
            self.telemetry.count("nonfinite_rejected")
            return self._carry(len(entries), ids, consumed=entries)

        # the members' residual norms (health gate on) and the step norm
        # ||w - result|| of the trust clip, from one read of each row on
        # the device, the model riding as the last row; one host wait
        gate = cfg.health_gate
        token = self.timer.begin("outliers" if gate else "clip")
        norms = ops.residual_norms(
            [*rows[:len(entries)], self._w] if gate else [self._w],
            result).cpu().numpy()
        self.timer.end(token)
        del rows
        # the estimator's verdict on each member, before the trust clip
        # moves the reference point
        outliers = self._mark_estimator_outliers(norms[:-1], entries)
        norm = float(norms[-1])

        # trust-region step clip, on EVERY commit (see the reference):
        # a byzantine-majority cohort moves the model by at most
        # trust_factor x the EMA of recent (clipped, full-cohort) step
        # norms.  On the device; a clipped step is scaled in place.
        token = self.timer.begin("clip")
        clipped = False
        if self._step_norm_ema is not None:
            clip = cfg.trust_factor * float(self._step_norm_ema)
            if norm > clip > 0.0:
                result.sub_(self._w).mul_(clip / norm).add_(self._w)
                norm = clip
                clipped = True
                self.telemetry.count("step_clipped")
        self.timer.end(token)
        if not degraded:
            self._step_norm_ema = norm if self._step_norm_ema is None \
                else 0.9 * self._step_norm_ema + 0.1 * norm

        self._w = result
        self.round += 1
        kind = "degraded_partial" if degraded else "aggregated"
        self._journal_commit(kind, entries)
        evicted = self.buffer.refresh_staleness(self.round)
        if evicted:
            self.telemetry.count("submit_rejected_stale", len(evicted))
        now = self.clock.now()
        for p in entries:
            self.telemetry.record_admission(p.staleness)
        if attempts > 1:
            self.telemetry.count("launch_recovered")
            self.telemetry.count("launch_retries", attempts - 1)
        self.telemetry.record_commit(
            cohort_size=len(entries),
            latencies_s=[now - p.arrival_t for p in entries],
            launch_wall_s=wall, kind=kind)
        return CommitResult(
            kind=kind, round=self.round, cohort_size=len(entries),
            agent_ids=ids,
            stalenesses=tuple(p.staleness for p in entries),
            seqs=tuple((p.update.agent_id, p.update.seq) for p in entries),
            cache_hit=cache_hit, compile_s=compile_s,
            launch_wall_s=wall, attempts=attempts, clipped=clipped,
            outliers=outliers)

    def _engine_sig(self, degraded: bool) -> tuple:
        cfg = self.config
        return (cfg.backend, cfg.num_iters, bool(degraded),
                cfg.degraded_c_scale if degraded else None)

    def _compiled(self, k_geom: int, degraded: bool):
        """The launch program for one cohort geometry -- captured exactly
        once per (geometry, engine, tuning state, device) across every
        service sharing this ``ExecutableCache``."""
        key = (k_geom, self.dim, "float32", self._engine_sig(degraded),
               tuning.cache_state(), str(self.device))
        cached = self.exec_cache.get(key)
        if cached is not None:
            for r in self.exec_cache.records_for(key):
                if r not in self._records:
                    self._records.append(r)
            self.telemetry.record_cache(key, hit=True)
            return cached, True, 0.0
        t0 = time.perf_counter()
        with ops.record_workloads() as records:
            lowered = self._engines[bool(degraded)].lower_launch(
                k_geom, self.dim, torch.float32, weighted=True,
                device=self.device)
            program = lowered.compile(self.exec_cache.static_inputs(lowered))
        compile_s = time.perf_counter() - t0
        for r in records:
            if r not in self._records:
                self._records.append(r)
        self.exec_cache.put(key, program, records)
        self.telemetry.record_cache(key, hit=False, compile_s=compile_s)
        return program, False, compile_s

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _launch(self, rows: Sequence[torch.Tensor], a: np.ndarray,
                degraded: bool):
        program, cache_hit, compile_s = self._compiled(len(rows), degraded)
        weights = torch.from_numpy(a)

        def attempt():
            if self._fault_hook is not None:
                self._fault_hook()
            # staged on every attempt into the geometry's static buffer,
            # which other programs of the geometry (and other tenants)
            # share, as the reference re-stages its donated buffer
            token = self.timer.begin("stage")
            program.stage(rows, weights)
            self.timer.end(token)
            token = self.timer.begin("replay")
            t0 = time.perf_counter()
            out = program.replay()
            self.timer.end(token)
            self._sync()
            wall = time.perf_counter() - t0
            self.telemetry.record_replay()
            # the graph's output is overwritten by its next replay, by
            # any tenant sharing the cache: take it out first
            token = self.timer.begin("take")
            out = out.clone()
            self.timer.end(token)
            return out, wall

        def on_retry(attempt_i, exc, delay):
            self.telemetry.count("launch_backoffs")

        (result, wall), attempts = _retry.call(
            attempt, policy=self.config.retry, clock=self.clock,
            rng=self._rng, retryable=(_retry.FaultInjected,),
            on_retry=on_retry)
        return result, wall, attempts, cache_hit, compile_s
