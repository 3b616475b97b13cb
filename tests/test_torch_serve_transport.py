"""The port's transport front (``repro_torch.serve.transport``), as
``test_serve_transport.py`` holds the reference's: bounded channels and
backpressure, slow-loris head-of-line confinement, deterministic pump
order, one launch program per geometry shared by every tenant,
health-gated admission, and the network-chaos planner."""

import asyncio

import numpy as np
import pytest
import torch

from repro.serve import chaos as jchaos
from repro_torch.serve import chaos as schaos
from repro_torch.serve import service as ssvc
from repro_torch.serve import transport as stransport
from repro_torch.serve.buffer import AgentUpdate
from repro_torch.serve.clock import SimClock

DIM = 6


def upd(agent, *, round=0, seq=1, value=1.0, payload=None):
    if payload is None:
        payload = torch.full((DIM,), value)
    return AgentUpdate(agent_id=agent, round=round, payload=payload,
                       seq=seq)


def make_front(tenants=1, *, capacity=3, **cfg_kw):
    defaults = dict(k_min=4, quorum=2, deadline_s=1.0, backend="jnp")
    defaults.update(cfg_kw)
    clock = SimClock()
    front = stransport.TransportFront(
        clock=clock,
        config=stransport.TransportConfig(channel_capacity=capacity),
        device="cpu")
    for i in range(tenants):
        front.add_tenant(f"t{i}", np.zeros(DIM, np.float32),
                         config=ssvc.ServeConfig(**defaults))
    return front, clock


# ===========================================================================
# channels + backpressure
# ===========================================================================

def test_offer_backpressure_at_capacity():
    front, _ = make_front(capacity=2)
    # hold the lane: entries are not ready, so they pile up
    assert front.offer("t0", upd(0, seq=1), hold_s=10.0) == "enqueued"
    assert front.offer("t0", upd(0, seq=2), hold_s=10.0) == "enqueued"
    assert front.offer("t0", upd(0, seq=3), hold_s=10.0) == "backpressure"
    # ...but another agent's lane is untouched
    assert front.offer("t0", upd(1, seq=1)) == "enqueued"
    assert front.stats()["backpressure_total"] == 1
    assert front.queue_depth_max <= 2


def test_queue_depth_bounded_by_capacity():
    front, _ = make_front(capacity=3)
    for seq in range(1, 10):
        front.offer("t0", upd(0, seq=seq), hold_s=60.0)
    assert front.queue_depth_max <= 3
    assert front.stats()["queue_depth_max"] <= \
        front.config.channel_capacity


def test_unknown_tenant_is_an_error():
    front, _ = make_front()
    with pytest.raises(KeyError):
        front.offer("nope", upd(0))
    with pytest.raises(ValueError, match="already exists"):
        front.add_tenant("t0", np.zeros(DIM, np.float32))


def test_loris_hold_blocks_only_its_own_lane():
    front, clock = make_front()
    front.offer("t0", upd(0, seq=1), hold_s=50.0)     # the loris
    for agent in range(1, 5):
        front.offer("t0", upd(agent, seq=1, value=0.5))
    receipts = front.pump()
    # the four clean lanes drained; the loris head did not
    assert sorted(r.agent_id for r in receipts) == [1, 2, 3, 4]
    assert front.queue_depth() == 1
    # once its hold elapses it drains too
    clock.advance_to(60.0)
    (r,) = front.pump()
    assert r.agent_id == 0 and r.waited_s >= 50.0


def test_pump_drains_globally_oldest_first():
    front, clock = make_front(tenants=2)
    clock.advance_to(1.0)
    front.offer("t1", upd(7, seq=1))
    clock.advance_to(2.0)
    front.offer("t0", upd(3, seq=1))
    receipts = front.pump()
    assert [(r.tenant, r.agent_id) for r in receipts] == [
        ("t1", 7), ("t0", 3)]


def test_receipts_surface_admission_verdicts():
    front, _ = make_front()
    front.offer("t0", upd(0, seq=1))
    front.offer("t0", upd(0, seq=1))      # replayed delivery
    verdicts = [r.verdict for r in front.pump()]
    assert verdicts == ["buffered", "duplicate"]


def test_replace_tenant_clears_in_flight_channels():
    front, _ = make_front(tenants=2)
    front.offer("t0", upd(0, seq=1), hold_s=10.0)
    front.offer("t1", upd(1, seq=1), hold_s=10.0)
    svc2 = ssvc.AggregationService(
        np.zeros(DIM, np.float32),
        config=ssvc.ServeConfig(k_min=4, backend="jnp"),
        clock=front.clock, device="cpu")
    lost = front.replace_tenant("t0", svc2)
    assert lost == 1
    assert front.tenant("t0") is svc2
    assert front.queue_depth() == 1       # t1's entry survived


def test_run_async_pumps():
    front, _ = make_front()
    for agent in range(4):
        front.offer("t0", upd(agent, seq=1, value=0.5))
    n = asyncio.run(front.run_async(interval_s=0.001, max_pumps=2))
    assert n == 2
    assert front.tenant("t0").round == 1


# ===========================================================================
# multi-tenant executable sharing
# ===========================================================================

def run_cohorts(front, tenants, cohorts=2):
    seq = 0
    for _ in range(cohorts):
        for i in range(tenants):
            for agent in range(4):
                seq += 1
                front.offer(f"t{i}", upd(
                    agent, round=front.tenant(f"t{i}").round, seq=seq,
                    value=0.5))
            front.pump()


@pytest.mark.parametrize("tenants", [2, 3])
def test_tenants_share_one_compile(tenants):
    front, _ = make_front(tenants=tenants, backend="pallas")
    run_cohorts(front, tenants)
    stats = front.exec_cache.stats()
    assert stats["exec_cache_keys"] == 1
    assert stats["exec_cache_compiles"] == 1          # once, not per tenant
    assert stats["exec_cache_max_compiles_per_key"] == 1
    assert stats["exec_cache_hits"] == 2 * tenants - 1
    assert stats["exec_cache_replays"] == 2 * tenants
    for i in range(tenants):
        assert front.tenant(f"t{i}").round == 2
        assert front.tenant(f"t{i}").telemetry.post_warmup_misses == 0
    assert front.stats()["exec_cache_replays"] == 2 * tenants


def test_per_tenant_caches_show_as_one_compile_per_tenant():
    """The defect the shared cache prevents: each tenant quietly owns a
    private cache, and the same geometry key captures once per tenant --
    visible in the caches' counts."""
    front, _ = make_front(tenants=3)
    for svc in front.tenants.values():
        svc.exec_cache = ssvc.ExecutableCache()   # sever the sharing
    run_cohorts(front, 3)
    compiles = [svc.exec_cache.n_compiles for svc in front.tenants.values()]
    assert compiles == [1, 1, 1]
    assert front.exec_cache.n_compiles == 0


# ===========================================================================
# health-gated admission + circuit breaker
# ===========================================================================

def make_service(**cfg_kw):
    defaults = dict(k_min=4, quorum=2, deadline_s=1.0, backend="jnp")
    defaults.update(cfg_kw)
    clock = SimClock()
    svc = ssvc.AggregationService(
        np.zeros(DIM, np.float32), config=ssvc.ServeConfig(**defaults),
        clock=clock, device="cpu")
    return svc, clock


def test_rejections_decay_health_and_trip_the_breaker():
    svc, _ = make_service(quarantine_threshold=3, max_staleness=0)
    bad = torch.full((DIM,), float("nan"))
    for seq in (1, 2):
        assert svc.submit(upd(9, seq=seq, payload=bad)) \
            == "rejected_invalid"
    h = svc.health_of(9)
    assert h.score == pytest.approx(0.75 ** 2)
    assert h.quarantined_until < 0                    # not tripped yet
    svc.submit(upd(9, seq=3, payload=bad))            # third strike
    assert svc.health_of(9).quarantined_until == \
        svc.round + svc.config.quarantine_rounds
    assert svc.telemetry.counters["quarantined"] == 1
    # the door now rejects without touching the buffer
    assert svc.submit(upd(9, seq=4, value=0.5)) == "rejected_quarantined"


def test_quarantine_expires_half_open():
    svc, _ = make_service(quarantine_threshold=1, quarantine_rounds=2,
                          max_staleness=0)
    svc.submit(upd(9, seq=1, payload=torch.full((DIM,), float("inf"))))
    assert svc.submit(upd(9, seq=2, value=0.5)) == "rejected_quarantined"
    # two committed rounds later the agent re-enters (at decayed weight)
    for seq in (1, 2):
        for agent in range(4):
            svc.submit(upd(agent, round=svc.round, seq=seq, value=0.5))
    assert svc.round == 2
    assert svc.submit(upd(9, round=svc.round, seq=3, value=0.5)) \
        == "buffered"
    assert svc.health_of(9).score < 1.0


def test_health_factor_composes_into_cohort_weights():
    cfg = ssvc.ServeConfig(health_floor=0.1, staleness_alpha=0.5)
    entries = [
        ssvc.Pending(update=upd(0), arrival_t=0.0, staleness=0),
        ssvc.Pending(update=upd(1), arrival_t=0.1, staleness=0),
    ]
    _, a = ssvc.assemble_cohort(
        entries, cfg, health_factors={1: cfg.health_weight(0.5)})
    assert a[0] == pytest.approx(1.0)
    assert a[1] == pytest.approx(0.1 + 0.9 * 0.5)


def test_estimator_outliers_lose_health_honest_agents_recover():
    svc, _ = make_service(k_min=8, residual_z=4.0)
    for agent in range(7):
        svc.submit(upd(agent, seq=1, value=0.5))
    svc.submit(upd(7, seq=1, value=500.0))            # the outlier
    (c,) = svc.drain_commits()
    assert c.kind == "aggregated"
    assert c.outliers == (7,)
    assert svc.health_of(7).score < 1.0
    assert svc.health_of(0).score == pytest.approx(1.0)
    assert svc.telemetry.counters["estimator_outliers"] == 1


def test_health_gate_off_disables_everything():
    svc, _ = make_service(health_gate=False, quarantine_threshold=1,
                          max_staleness=0)
    bad = torch.full((DIM,), float("nan"))
    svc.submit(upd(9, seq=1, payload=bad))
    assert svc.submit(upd(9, seq=2, value=0.5)) == "buffered"
    assert svc.health_of(9).score == 1.0


# ===========================================================================
# network chaos planner
# ===========================================================================

def test_corrupt_payload_is_nonfinite():
    rng = np.random.default_rng(0)
    out = schaos.corrupt_payload(torch.zeros(16), rng)
    assert not bool(torch.isfinite(out).all())


def test_network_model_partition_window():
    cfg = schaos.ChaosConfig(partition_frac=0.5, partition_start_frac=0.2,
                             partition_end_frac=0.6)
    roles = schaos.AgentRoles(partitioned=(0,))
    net = schaos.NetworkModel(cfg, roles, np.random.default_rng(0),
                              horizon_rounds=10, base_delay_s=0.05)
    assert not net.partition_active(1)
    assert net.partition_active(3)
    assert not net.partition_active(6)
    plan = net.plan_delivery(0, torch.zeros(4), progress_round=3)
    assert plan.held_by_partition
    plan = net.plan_delivery(0, torch.zeros(4), progress_round=7)
    assert not plan.held_by_partition


def test_network_model_corrupt_lands_in_invalid_path():
    cfg = schaos.ChaosConfig(corrupt_prob=1.0)
    net = schaos.NetworkModel(cfg, schaos.AgentRoles(),
                              np.random.default_rng(0),
                              horizon_rounds=10, base_delay_s=0.05)
    plan = net.plan_delivery(0, torch.zeros(DIM), progress_round=0)
    assert plan.corrupted and plan.payload is not None
    svc, _ = make_service()
    assert svc.submit(upd(0, payload=plan.payload)) == "rejected_invalid"


def test_crash_frac_validation():
    with pytest.raises(ValueError, match="sorted ascending"):
        schaos.ChaosConfig(crash_restart_frac=(0.7, 0.3))
    with pytest.raises(ValueError, match=r"in \(0, 1\)"):
        schaos.ChaosConfig(crash_restart_frac=(1.5,))


def test_network_plans_draw_as_the_reference():
    """One seed, one delivery schedule: the port's network model makes
    the reference's delay, hold, reorder, corrupt and duplicate
    decisions, and corrupts the same entries."""
    cfg = schaos.CHAOS_PROFILES["mixed"]
    roles = schaos.assign_roles(cfg, 16, np.random.default_rng(2))
    jroles = jchaos.assign_roles(jchaos.CHAOS_PROFILES["mixed"], 16,
                                 np.random.default_rng(2))
    net = schaos.NetworkModel(cfg, roles, np.random.default_rng(7),
                              horizon_rounds=20, base_delay_s=0.05)
    jnet = jchaos.NetworkModel(jchaos.CHAOS_PROFILES["mixed"], jroles,
                               np.random.default_rng(7),
                               horizon_rounds=20, base_delay_s=0.05)
    payload = np.linspace(-1, 1, 32, dtype=np.float32)
    for i in range(200):
        agent, rnd = i % 16, i // 10
        p = net.plan_delivery(agent, torch.from_numpy(payload),
                              progress_round=rnd)
        q = jnet.plan_delivery(agent, payload, progress_round=rnd)
        assert (p.delay_s, p.hold_s, p.held_by_partition, p.reordered,
                p.corrupted, p.duplicated) == \
            (q.delay_s, q.hold_s, q.held_by_partition, q.reordered,
             q.corrupted, q.duplicated)
        if q.payload is not None:
            np.testing.assert_array_equal(p.payload.numpy(), q.payload)
    assert net.heal_jitter() == jnet.heal_jitter()
