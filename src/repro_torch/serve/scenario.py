"""Replay a federated ScenarioSpec's client traffic through the
transport-fronted streaming service under chaos.

Counterpart of ``repro.serve.scenario``.  Every draw of the harness
(roles, send times, participation, delays, drops, reorders,
corruptions, re-sends) comes from the same seeded numpy generator as in
the reference, so one seed schedules the same traffic in both packages.
The agents' local training and attacks run in PyTorch on the replay's
device: each send draws from a ``torch.Generator`` seeded from
``np.random.SeedSequence((spec.seed, agent, counter))`` (the
reference's ``fold_in(fold_in(key, agent), counter)``), so a replay is
bit-deterministic under ``SimClock``, though its payloads are not the
reference's.

The scenario runner (``repro_torch.scenarios``) answers "does the estimator
hold up over T synchronous rounds"; this module answers the serving
question: does the *service* -- transport front, buffering, staleness
weighting, deadlines, retries, degradation, journaling -- hold up when
the same client population talks to it over an unreliable network?
The spec is the single source of truth for the problem (dimension, data
heterogeneity, local-SGD recipe), so a served run is directly
comparable to the runner's band for the same spec:
``metrics.breakdown_threshold(spec)``.

The replay is a discrete-event simulation on ``SimClock`` -- a heap of
(send | deliver | tick) events, every random draw from one seeded
generator, so a chaos run is deterministic given (spec, chaos, serve,
seed, tenants).  Traffic flows the production path end to end:

  agent -> NetworkModel (delay / partition / reorder / corrupt /
  duplicate / trickle) -> TransportFront.offer (bounded per-agent
  channel, backpressure to the sender) -> pump -> tenant
  AggregationService.submit (write-ahead journaled) -> kernel commit.

``tenants > 1`` splits the agent population across N concurrent tenant
services (``agent i -> t{i mod N}``) that share one ``ExecutableCache``
-- same cohort geometry, one compile total.  ``crash_restart_frac``
kills a tenant's service object mid-run and restores it from its
journal via ``AggregationService.recover``; the harness then checks the
exactly-once invariant directly (no (agent, seq) pair admitted twice
across the crash -- ``duplicate_admissions``).
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import devices
from repro_torch.core import federated
from repro_torch.data import synthetic
from repro_torch.scenarios import metrics
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.serve.buffer import AgentUpdate
from repro_torch.serve.chaos import (ChaosConfig, NetworkModel, assign_roles,
                                     make_launch_fault_hook)
from repro_torch.serve.clock import SimClock
from repro_torch.serve.journal import Journal
from repro_torch.serve.service import (AggregationService, CommitResult,
                                       ServeConfig)
from repro_torch.serve.telemetry import ServeTelemetry
from repro_torch.serve.transport import TransportConfig, TransportFront

_MODEL_COMMITS = ("aggregated", "degraded_partial")


@dataclasses.dataclass(frozen=True, eq=False)
class ServeResult:
    """One replay outcome (see ``replay``).  Single-tenant fields
    (``msd``, ``commits``, ``model``) are tenant ``t0``'s, so existing
    single-tenant callers read exactly what they used to; the
    ``*_by_tenant`` maps carry the full picture."""

    spec: ScenarioSpec
    chaos: ChaosConfig
    serve: ServeConfig
    msd: np.ndarray               # tenant t0, per model-updating commit
    summary: dict                 # worst tenant vs. the spec band
    telemetry: dict               # merged ServeTelemetry.snapshot
    recoveries: dict              # fault mode -> recovery event count
    commits: List[CommitResult]   # tenant t0
    commits_by_tenant: Dict[str, List[CommitResult]]
    telemetry_by_tenant: Dict[str, dict]
    journals: Dict[str, Journal]
    transport: dict               # TransportFront.stats()
    tenants: int
    duplicate_admissions: int     # (agent, seq) admitted twice -- MUST be 0
    crash_restarts: int           # restarts actually performed
    rounds_completed: int         # min over tenants
    sim_elapsed_s: float
    wall_s: float
    launch_audit: Optional[dict]
    model: torch.Tensor           # tenant t0, on the replay's device

    def to_row(self) -> dict:
        row = {
            "scenario": self.spec.name or "<unnamed>",
            "backend": self.serve.backend,
            "k_min": self.serve.k_min,
            "num_agents": self.spec.num_agents,
            "dim": self.spec.dim,
            "tenants": int(self.tenants),
            "fault_modes": list(self.chaos.fault_modes()),
            "recoveries": {k: int(v) for k, v in self.recoveries.items()},
            "duplicate_admissions": int(self.duplicate_admissions),
            "crash_restarts": int(self.crash_restarts),
            "rounds_completed": int(self.rounds_completed),
            "sim_elapsed_s": round(float(self.sim_elapsed_s), 3),
            "wall_s": round(float(self.wall_s), 3),
            "transport": dict(self.transport),
        }
        row.update(self.summary)
        row.update(self.telemetry)
        if self.launch_audit is not None:
            row["launch_audit"] = self.launch_audit
        return row


def _make_update_fn(grad_fn, steps: int, mu: float):
    """One agent's local training: (w (M,), agent, generator) -> (M,)."""

    def f(w, agent: int, generator):
        idx = torch.tensor([agent], device=w.device)
        return federated.local_update(w[None], idx, generator,
                                      grad_fn=grad_fn, steps=steps, mu=mu)[0]

    return f


def _generator(device: torch.device, *entropy) -> torch.Generator:
    """A generator on ``device`` seeded from ``SeedSequence(entropy)``."""
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(seed))


def replay(spec: ScenarioSpec, *,
           chaos: ChaosConfig = ChaosConfig(),
           serve: ServeConfig = ServeConfig(),
           rounds: Optional[int] = None,
           seed: int = 0,
           tenants: int = 1,
           transport: TransportConfig = TransportConfig(),
           send_period_s: float = 1.0,
           base_delay_s: float = 0.05,
           max_events: int = 200_000,
           device="cuda") -> ServeResult:
    """Run ``spec``'s client population against ``tenants`` fresh
    tenant services behind one transport front until every tenant lands
    ``rounds`` model-updating commits (default ``spec.num_steps``).

    Only federated specs replay (the service is the fusion center);
    ``spec.participation`` is the per-period send probability.  The
    returned ``summary`` holds ``metrics.attack_summary`` of the
    *worst* tenant's MSD history against
    ``metrics.breakdown_threshold(spec)`` -- the same acceptance band
    the scenario runner uses for this spec, so "the service under chaos
    tracks the synchronous run" is one boolean
    (``not summary["broke_down"]``).  The services, the agents'
    training and the launches run on ``device``.
    """
    if spec.paradigm != "federated":
        raise ValueError(
            f"serve replay needs a federated spec (the service is the "
            f"fusion center), got paradigm {spec.paradigm!r}")
    target_rounds = int(rounds if rounds is not None else spec.num_steps)
    if target_rounds < 1:
        raise ValueError(f"rounds must be >= 1, got {target_rounds}")
    if tenants < 1:
        raise ValueError(f"tenants must be >= 1, got {tenants}")
    if spec.num_agents // tenants < serve.k_min:
        raise ValueError(
            f"{tenants} tenants leave {spec.num_agents // tenants} agents "
            f"per tenant, below k_min={serve.k_min}")

    dev = devices.resolve(device)
    problem = synthetic.LinearModelProblem(
        dim=spec.dim, noise_var=spec.noise_var, seed=spec.data_seed)
    grad_fn = synthetic.make_client_grad_fn(
        problem, spec.num_agents, data=spec.data,
        alpha=spec.dirichlet_alpha, seed=spec.data_seed, device=dev)
    update_fn = _make_update_fn(grad_fn, spec.local_steps, spec.step_size)
    w_star = problem.w_star(dev)

    rng = np.random.default_rng(seed)
    roles = assign_roles(chaos, spec.num_agents, rng)
    net = NetworkModel(chaos, roles, rng, horizon_rounds=target_rounds,
                       base_delay_s=base_delay_s)
    attack_fn = chaos.attack_fn()

    clock = SimClock()
    front = TransportFront(clock=clock, config=transport, device=dev)
    names = [f"t{i}" for i in range(tenants)]
    tels = {name: ServeTelemetry() for name in names}
    journals = {name: Journal.memory(
        snapshot_every=serve.journal_snapshot_every) for name in names}
    hooks = {name: make_launch_fault_hook(chaos, seed=seed + 1 + i)
             for i, name in enumerate(names)}
    for i, name in enumerate(names):
        front.add_tenant(name, torch.zeros_like(w_star), config=serve,
                         seed=seed + i, fault_hook=hooks[name],
                         journal=journals[name], telemetry=tels[name])

    def tenant_of(agent: int) -> str:
        return names[agent % tenants]

    # -- the event heap ----------------------------------------------------
    events: list = []
    eseq = 0

    def push(t: float, kind: str, payload=None):
        nonlocal eseq
        heapq.heappush(events, (t, eseq, kind, payload))
        eseq += 1

    send_counter = {i: 0 for i in range(spec.num_agents)}
    delivery_seq = {i: 0 for i in range(spec.num_agents)}
    prev_update = {}              # agent -> last (round, payload) sent
    dropout_round = max(int(chaos.dropout_after_frac * target_rounds), 1)
    crash_rounds = sorted({max(int(f * target_rounds), 1)
                           for f in chaos.crash_restart_frac})
    next_crash = {name: 0 for name in names}    # index into crash_rounds
    tick_dt = serve.deadline_s / 4.0
    held: list = []               # partition-held (agent, upd, flags)

    for i in range(spec.num_agents):
        push(float(rng.uniform(0, send_period_s)), "send", i)
    push(tick_dt, "tick")

    def progress() -> int:
        return max(svc.round for svc in front.tenants.values())

    def compute_payload(agent: int, server_round: int) -> torch.Tensor:
        entropy = (spec.seed, agent, send_counter[agent])
        phi = update_fn(front.tenant(tenant_of(agent)).model, agent,
                        _generator(dev, *entropy))
        if agent in roles.byzantine and attack_fn is not None:
            phi = attack_fn(phi[None], torch.ones((1,), dtype=torch.bool,
                                                  device=dev),
                            _generator(dev, *entropy, 1), server_round)[0]
        return phi

    def next_seq(agent: int) -> int:
        delivery_seq[agent] += 1
        return delivery_seq[agent]

    def schedule_delivery(agent: int, upd: AgentUpdate, now: float):
        plan = net.plan_delivery(agent, upd.payload,
                                 progress_round=progress())
        if plan.payload is not None:
            upd = dataclasses.replace(upd, payload=plan.payload)
        flags = {"reordered": plan.reordered, "hold_s": plan.hold_s,
                 "released": False}
        if plan.held_by_partition:
            held.append((agent, upd, flags))
            return
        push(now + plan.delay_s, "deliver", (agent, upd, flags))
        if plan.duplicated:
            # transport replay: same sequence number, later arrival
            push(now + plan.delay_s * (1.5 + float(rng.random())),
                 "deliver", (agent, upd, flags))

    def release_held(now: float):
        while held:
            agent, upd, flags = held.pop()
            flags = dict(flags, released=True)
            push(now + base_delay_s + net.heal_jitter(),
                 "deliver", (agent, upd, flags))

    # -- the loop ----------------------------------------------------------
    msd: Dict[str, List[float]] = {name: [] for name in names}
    commits: Dict[str, List[CommitResult]] = {name: [] for name in names}
    seen_seqs: Dict[str, set] = {name: set() for name in names}
    duplicate_admissions = 0
    crash_restarts = 0
    commits_after_dropout = 0
    byz_cohort_commits = 0
    released_processed = 0
    reordered_processed = 0
    loris_processed = 0
    wall_t0 = time.perf_counter()
    n_events = 0

    def maybe_crash(now: float):
        """Kill + journal-restore any tenant that crossed its next
        crash point.  The channels' in-flight entries die with the
        process; heap deliveries are the network and survive."""
        nonlocal crash_restarts
        for name in names:
            i = next_crash[name]
            if i >= len(crash_rounds):
                continue
            if front.tenant(name).round < crash_rounds[i]:
                continue
            next_crash[name] = i + 1
            recovered = AggregationService.recover(
                journals[name], config=serve, clock=clock,
                seed=seed + names.index(name) + 1000 * (i + 1),
                fault_hook=hooks[name], exec_cache=front.exec_cache,
                telemetry=tels[name], device=dev)
            front.replace_tenant(name, recovered)
            crash_restarts += 1

    def absorb():
        nonlocal commits_after_dropout, byz_cohort_commits
        nonlocal duplicate_admissions
        for name, new_commits in front.drain_commits().items():
            svc = front.tenant(name)
            for c in new_commits:
                commits[name].append(c)
                for pair in c.seqs:
                    if pair in seen_seqs[name]:
                        duplicate_admissions += 1
                    seen_seqs[name].add(pair)
                if c.kind not in _MODEL_COMMITS:
                    continue
                msd[name].append(
                    float(torch.sum((svc.model - w_star) ** 2)))
                if c.round > dropout_round:
                    commits_after_dropout += 1
                if any(a in roles.byzantine for a in c.agent_ids):
                    byz_cohort_commits += 1
        maybe_crash(clock.now())

    def all_done() -> bool:
        return all(len(msd[name]) >= target_rounds for name in names)

    while events and not all_done() and n_events < max_events:
        t, _, kind, payload = heapq.heappop(events)
        if t > clock.now():
            # the clock can already be past t: retry backoff *sleeps*
            # on the sim clock, so an event scheduled before the sleep
            # may come due "in the past" -- it runs now, late, exactly
            # like a blocked real service draining its queue
            clock.advance_to(t)
        n_events += 1
        if kind == "tick":
            if held and not net.partition_active(progress()):
                release_held(t)
            front.pump()
            absorb()
            push(t + tick_dt, "tick")
        elif kind == "send":
            agent = payload
            svc_round = front.tenant(tenant_of(agent)).round
            crashed = (agent in roles.dropouts
                       and svc_round >= dropout_round)
            if not crashed:
                if float(rng.random()) < spec.participation:
                    send_counter[agent] += 1
                    r = svc_round
                    phi = compute_payload(agent, r)
                    upd = AgentUpdate(agent_id=agent, round=r, payload=phi,
                                      seq=next_seq(agent), sent_at=t)
                    schedule_delivery(agent, upd, t)
                    if (prev_update.get(agent) is not None
                            and float(rng.random()) < chaos.stale_resend_prob):
                        # re-send the previous (older-round) update with
                        # a fresh sequence number
                        pr, pp = prev_update[agent]
                        schedule_delivery(agent, AgentUpdate(
                            agent_id=agent, round=pr, payload=pp,
                            seq=next_seq(agent), sent_at=t), t)
                    prev_update[agent] = (r, phi)
                push(t + send_period_s * (0.5 + float(rng.random())),
                     "send", agent)
            # crashed agents schedule nothing: they are gone for good
        elif kind == "deliver":
            agent, upd, flags = payload
            verdict = front.offer(tenant_of(agent), upd,
                                  hold_s=flags["hold_s"])
            if verdict == "enqueued":
                if flags["released"]:
                    released_processed += 1
                if flags["reordered"]:
                    reordered_processed += 1
                if flags["hold_s"] > 0:
                    loris_processed += 1
            front.pump()
            absorb()

    if held:
        release_held(clock.now())
        while events and n_events < max_events:
            t, _, kind, payload = heapq.heappop(events)
            if kind != "deliver":
                continue
            if t > clock.now():
                clock.advance_to(t)
            n_events += 1
            agent, upd, flags = payload
            if front.offer(tenant_of(agent), upd,
                           hold_s=flags["hold_s"]) == "enqueued" \
                    and flags["released"]:
                released_processed += 1
            front.pump()
            absorb()
    front.pump()
    absorb()
    wall_s = time.perf_counter() - wall_t0

    # -- per-tenant acceptance vs. the spec band ---------------------------
    level = metrics.breakdown_threshold(spec)

    def summarize(arr: np.ndarray) -> dict:
        if arr.size:
            return metrics.attack_summary(arr, breakdown_level=level)
        return {"steady_msd": float("inf"), "peak_msd": float("inf"),
                "breakdown_level": float(level), "broke_down": True}

    msd_arrs = {name: np.asarray(msd[name], dtype=np.float64)
                for name in names}
    summaries = {name: summarize(msd_arrs[name]) for name in names}
    worst = max(names, key=lambda n: (summaries[n]["broke_down"],
                                      summaries[n]["steady_msd"]))
    summary = dict(summaries[worst])
    summary["worst_tenant"] = worst
    summary["tenants_broke_down"] = sum(
        1 for s in summaries.values() if s["broke_down"])

    # -- recovery accounting (merged across tenants) -----------------------
    merged = ServeTelemetry.merged(tels.values())
    merged.record_queue_depth(front.queue_depth_max,
                              front.config.channel_capacity)
    counters = merged.counters
    for mode in chaos.fault_modes():
        if mode == "straggler":
            merged.record_recovery(mode, counters["stale_downweighted"]
                                   + counters["deadline_fired"])
        elif mode == "dropout":
            merged.record_recovery(mode, commits_after_dropout)
        elif mode == "duplicate":
            merged.record_recovery(mode, counters["submit_duplicate"])
        elif mode == "stale":
            merged.record_recovery(mode, counters["submit_rejected_stale"]
                                   + counters["stale_downweighted"])
        elif mode == "byzantine":
            merged.record_recovery(mode, byz_cohort_commits)
        elif mode == "launch_fault":
            merged.record_recovery(mode, counters["launch_recovered"]
                                   + counters["launch_failed"])
        elif mode == "partition":
            merged.record_recovery(mode, released_processed)
        elif mode == "reorder":
            merged.record_recovery(mode, reordered_processed)
        elif mode == "corrupt":
            merged.record_recovery(
                mode, counters["submit_rejected_invalid"])
        elif mode == "slow_loris":
            merged.record_recovery(
                mode, loris_processed
                + int(front.counters["backpressure"]))
        elif mode == "crash":
            merged.record_recovery(mode, counters["journal_recoveries"])
    recoveries = {k: int(v) for k, v in sorted(merged.recoveries.items())}

    t0_svc = front.tenant(names[0])
    return ServeResult(
        spec=spec, chaos=chaos, serve=serve,
        msd=msd_arrs[names[0]], summary=summary,
        telemetry=merged.snapshot(elapsed_s=wall_s),
        recoveries=recoveries,
        commits=commits[names[0]],
        commits_by_tenant=dict(commits),
        telemetry_by_tenant={n: tels[n].snapshot() for n in names},
        journals=dict(journals),
        transport=front.stats(),
        tenants=tenants,
        duplicate_admissions=duplicate_admissions,
        crash_restarts=crash_restarts,
        rounds_completed=min(len(msd[name]) for name in names),
        sim_elapsed_s=clock.now(), wall_s=wall_s,
        launch_audit=t0_svc.launch_audit(),
        model=t0_svc.model)
