"""The port's streaming aggregation service (``repro_torch.serve``) on
the CPU: the counterparts of ``test_serve.py``'s admission buffer,
degradation ladder, executable cache, fault injection and chaos replay,
the engine's ``lower_launch``, and the port's one deliberate difference
from the reference -- a launch error that is not ``FaultInjected``
propagates instead of being carried forward."""

import numpy as np
import pytest
import torch

from repro.serve import chaos as jchaos
from repro_torch.kernels import launches, mm_aggregate, ops, tuning
from repro_torch.scenarios import metrics
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.serve import buffer as sbuf
from repro_torch.serve import chaos as schaos
from repro_torch.serve import retry as sretry
from repro_torch.serve import scenario as sscenario
from repro_torch.serve import service as ssvc
from repro_torch.serve.clock import SimClock

DIM = 6


def upd(agent, *, round=0, seq=1, value=1.0, weight=1.0, payload=None):
    if payload is None:
        payload = torch.full((DIM,), value)
    return sbuf.AgentUpdate(agent_id=agent, round=round, payload=payload,
                            weight=weight, seq=seq)


def make_service(fault_hook=None, **cfg_kw):
    defaults = dict(k_min=4, quorum=2, deadline_s=1.0, backend="jnp",
                    max_staleness=4)
    defaults.update(cfg_kw)
    clock = SimClock()
    svc = ssvc.AggregationService(
        np.zeros(DIM, np.float32), config=ssvc.ServeConfig(**defaults),
        clock=clock, fault_hook=fault_hook, device="cpu")
    return svc, clock


def fill_full_cohort(svc, *, value=0.5, round=None, seq=1):
    """Submit one full cohort of identical honest updates."""
    r = svc.round if round is None else round
    for agent in range(svc.config.k_min):
        svc.submit(upd(agent, round=r, seq=seq, value=value))


# ===========================================================================
# admission buffer
# ===========================================================================

def test_buffer_verdicts():
    b = sbuf.CohortBuffer(max_staleness=2, max_buffer=3)
    assert b.add(upd(0, seq=1), now=0.0, current_round=0) == "buffered"
    assert b.add(upd(0, seq=1), now=0.1, current_round=0) == "duplicate"
    assert b.add(upd(0, seq=2, value=2.0), now=0.2,
                 current_round=0) == "superseded"
    assert len(b) == 1
    assert b.add(upd(1, round=0, seq=1), now=0.3,
                 current_round=3) == "rejected_stale"
    assert b.add(upd(1, round=3, seq=1), now=0.4,
                 current_round=3) == "duplicate"
    bad = torch.full((DIM,), float("nan"))
    assert b.add(upd(2, seq=1, payload=bad), now=0.5,
                 current_round=0) == "rejected_invalid"
    assert b.add(upd(3, seq=1), now=0.6, current_round=0) == "buffered"
    assert b.add(upd(4, seq=1), now=0.7, current_round=0) == "buffered"
    assert b.add(upd(5, seq=1), now=0.8, current_round=0) == "rejected_full"


def test_buffer_take_is_fifo_by_arrival():
    b = sbuf.CohortBuffer()
    for i, t in ((3, 0.3), (1, 0.1), (2, 0.2)):
        b.add(upd(i, seq=1), now=t, current_round=0)
    taken = b.take(2)
    assert [p.update.agent_id for p in taken] == [1, 2]
    assert len(b) == 1


def test_buffer_refresh_evicts_aged_out():
    b = sbuf.CohortBuffer(max_staleness=1)
    b.add(upd(0, round=0, seq=1), now=0.0, current_round=0)
    b.add(upd(1, round=1, seq=1), now=0.1, current_round=1)
    evicted = b.refresh_staleness(2)
    assert [p.update.agent_id for p in evicted] == [0]
    assert len(b) == 1


# ===========================================================================
# staleness weighting + cohort assembly
# ===========================================================================

def test_staleness_weight_composes_into_cohort():
    cfg = ssvc.ServeConfig(staleness_alpha=0.5)
    entries = [
        sbuf.Pending(update=upd(0, weight=2.0, value=1.0), arrival_t=0.0,
                     staleness=0),
        sbuf.Pending(update=upd(1, weight=2.0, value=3.0), arrival_t=0.1,
                     staleness=3),
    ]
    x, a = ssvc.assemble_cohort(entries, cfg)
    assert float(a[0]) == pytest.approx(2.0)
    assert float(a[1]) == pytest.approx(2.0 * (1 + 3) ** -0.5)
    assert x.shape == (2, DIM) and x.device == entries[0].update.payload.device
    assert torch.equal(x[1], torch.full((DIM,), 3.0))


def test_duplicate_agent_id_in_cohort_is_a_clear_error():
    cfg = ssvc.ServeConfig()
    entries = [
        sbuf.Pending(update=upd(7), arrival_t=0.0, staleness=0),
        sbuf.Pending(update=upd(7, seq=2), arrival_t=0.1, staleness=0),
    ]
    with pytest.raises(ValueError, match="duplicate agent id"):
        ssvc.assemble_cohort(entries, cfg)


def test_service_takes_its_device_and_moves_payloads_there():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ssvc.AggregationService(np.zeros(DIM, np.float32))
    svc, _ = make_service()
    svc.submit(upd(0, payload=np.full(DIM, 0.5, np.float32)))
    (pending,) = svc.buffer.export_state()[1]
    assert isinstance(pending.update.payload, torch.Tensor)
    assert pending.update.payload.dtype == torch.float32
    assert isinstance(svc.model, torch.Tensor)


# ===========================================================================
# service: admission + participation edge cases
# ===========================================================================

def test_exact_k_min_boundary_commits():
    svc, _ = make_service()
    for agent in range(svc.config.k_min - 1):
        svc.submit(upd(agent, value=0.5))
        assert svc.drain_commits() == []
    svc.submit(upd(svc.config.k_min - 1, value=0.5))
    (c,) = svc.drain_commits()
    assert c.kind == "aggregated" and c.cohort_size == svc.config.k_min
    assert svc.round == 1
    np.testing.assert_allclose(svc.model.numpy(), 0.5, rtol=1e-5)


def test_zero_participant_round_carries_forward():
    svc, _ = make_service()
    fill_full_cohort(svc, value=0.5)
    w = svc.model
    c = svc.admit_now()
    assert c.kind == "carried_forward" and c.cohort_size == 0
    assert torch.equal(svc.model, w)
    assert svc.telemetry.counters["zero_participant_rounds"] == 1
    assert svc.round == 1


def test_deadline_fires_partial_and_below_quorum_carries():
    svc, clock = make_service()
    svc.submit(upd(0, value=3.0))
    assert svc.tick() == []
    clock.advance_to(1.5)
    (c,) = svc.tick()
    assert c.kind == "carried_forward"
    assert torch.equal(svc.model, torch.zeros(DIM))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_all_malicious_partial_cohort_is_trust_clipped(backend):
    svc, clock = make_service(trust_factor=2.0, backend=backend)
    fill_full_cohort(svc, value=0.5, seq=1)
    fill_full_cohort(svc, value=0.6, seq=2)
    assert svc.round == 2
    w = svc.model
    ema = svc._step_norm_ema
    assert ema is not None and ema > 0
    for agent in range(2):
        svc.submit(upd(agent, round=svc.round, seq=3, value=1000.0))
    clock.advance_to(clock.now() + 2.0)
    (c,) = svc.tick()
    assert c.kind == "degraded_partial" and c.clipped
    step = float(torch.linalg.vector_norm(svc.model - w))
    assert bool(torch.isfinite(svc.model).all())
    assert step <= 2.0 * ema * (1 + 1e-5)
    assert svc.telemetry.counters["step_clipped"] == 1
    # the degraded engine is its own program over the same static buffer
    stats = svc.exec_cache.stats()
    assert stats["exec_cache_keys"] == 2 and stats["exec_cache_compiles"] == 2
    assert len(svc.exec_cache._inputs) == 1


def test_carry_mode_never_aggregates_partials():
    svc, clock = make_service(degradation="carry")
    fill_full_cohort(svc, value=0.5, seq=1)
    w = svc.model
    for agent in range(2):
        svc.submit(upd(agent, round=svc.round, seq=2, value=1000.0))
    clock.advance_to(clock.now() + 2.0)
    (c,) = svc.tick()
    assert c.kind == "carried_forward"
    assert torch.equal(svc.model, w)


def test_nan_payload_never_reaches_the_estimator():
    svc, _ = make_service()
    bad = torch.full((DIM,), float("inf"))
    assert svc.submit(upd(0, payload=bad)) == "rejected_invalid"
    fill_full_cohort(svc, value=0.5, seq=2)
    assert bool(torch.isfinite(svc.model).all())


def test_zero_total_weight_refuses_to_average():
    svc, _ = make_service()
    fill_full_cohort(svc, value=0.5, seq=1)
    svc.drain_commits()
    w = svc.model
    for agent in range(svc.config.k_min):
        svc.submit(upd(agent, round=svc.round, seq=2, value=77.0,
                       weight=0.0))
    (c,) = svc.drain_commits()
    assert c.kind == "carried_forward"
    assert torch.equal(svc.model, w)
    assert svc.telemetry.counters["zero_weight_rejected"] == 1


# ===========================================================================
# executable cache, launch programs + fault injection
# ===========================================================================

@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_exec_cache_hits_on_identical_geometry(backend):
    svc, _ = make_service(backend=backend)
    fill_full_cohort(svc, value=0.5, seq=1)
    fill_full_cohort(svc, value=0.6, seq=2)
    fill_full_cohort(svc, value=0.7, seq=3)
    c = svc.telemetry.counters
    assert c["exec_cache_misses"] == 1
    assert c["exec_cache_hits"] == 2
    assert svc.telemetry.post_warmup_misses == 0
    assert svc.telemetry.launch_replays == 3
    assert svc.exec_cache.stats()["exec_cache_replays"] == 3


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_launch_program_equals_the_eager_aggregate(backend):
    """A compiled program staged with a cohort gives exactly what
    ``aggregate`` gives on the same cohort and weights, and records the
    workload ``aggregate`` resolves."""
    rng = np.random.default_rng(0)
    k, m = 8, 37
    x = torch.from_numpy(rng.normal(size=(k, m)).astype(np.float32))
    x[k - 1] += 1000.0
    a = torch.from_numpy(rng.uniform(0.5, 1.5, size=k).astype(np.float32))
    engine = ops.AggregationEngine(backend=backend)
    with ops.record_workloads() as records:
        program = engine.lower_launch(k, m, torch.float32, weighted=True,
                                      device="cpu").compile()
    want = engine.aggregate(x, a)
    with ops.record_workloads() as eager:
        engine.aggregate(x, a)
    assert records == eager
    assert torch.equal(program(x, a), want)
    # rows staged one by one, as the service stages its payloads
    program.stage(list(x), a)
    assert torch.equal(program.replay(), want)
    assert program.replays == 2
    with pytest.raises(ValueError, match="takes 8 rows"):
        program.stage(list(x)[:3], a)


def test_a_128_agent_cohort_lowers_to_the_two_pass_kernel():
    """The service's launch program for a cohort of 128 plans the
    two-pass kernel in one K block (the serve-cohort128 launch, here over
    DIM columns), and its first commit is the single pass's estimate."""
    k = 128
    svc, _ = make_service(backend="pallas", k_min=k)
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(k, DIM)).astype(np.float32)
    rows[-16:] += 1000.0
    for agent in range(k):
        svc.submit(upd(agent, payload=torch.from_numpy(rows[agent])))
    assert svc.round == 1
    (program,) = svc.exec_cache.programs()
    assert program.plan == mm_aggregate.launch_plan(k, DIM, 1)
    assert program.plan.path == "two_pass"
    assert program.plan.num_k_blocks == 1
    single = mm_aggregate.mm_aggregate_2d(
        torch.from_numpy(rows), torch.ones(k), path="single")
    np.testing.assert_allclose(np.asarray(svc.model), single.numpy(),
                               atol=1e-5, rtol=1e-6)


def test_lower_launch_shares_given_static_inputs_and_checks_them():
    engine = ops.AggregationEngine()
    lowered = engine.lower_launch(4, 10, device="cpu")
    x, a = lowered.static_inputs()
    p1 = lowered.compile((x, a))
    p2 = ops.AggregationEngine(c=2.0).lower_launch(
        4, 10, device="cpu").compile((x, a))
    assert p1.x is p2.x and p1.a is p2.a
    with pytest.raises(ValueError, match="static inputs"):
        lowered.compile((torch.zeros(4, 11), a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.lower_launch(4, 10)


def test_unweighted_program_takes_no_weights():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(5, 9)).astype(np.float32))
    engine = ops.AggregationEngine()
    program = engine.lower_launch(5, 9, weighted=False,
                                  device="cpu").compile()
    assert torch.equal(program(x), engine.aggregate(x))


def test_cpu_launches_count_nothing():
    before = launches.COUNTS.copy()
    svc, _ = make_service(backend="pallas")
    fill_full_cohort(svc, value=0.5)
    assert svc.round == 1 and launches.COUNTS == before


def test_cache_state_fingerprints_the_tuning_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(tuning, "_CACHE", {})
    s0 = tuning.cache_state()
    assert s0 == tuning.cache_state() and hash(s0) is not None
    tuning.set_blocks(8, 64, 1, torch.float32, (64, None))
    s1 = tuning.cache_state()
    assert s1 != s0
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(tmp_path / "t.json"))
    assert tuning.cache_state() != s1


def test_new_tuning_state_captures_a_new_program(monkeypatch):
    monkeypatch.setattr(tuning, "_CACHE", {})
    svc, _ = make_service(backend="pallas")
    fill_full_cohort(svc, value=0.5, seq=1)
    tuning.set_blocks(4, DIM, 1, torch.float32, (64, None))
    fill_full_cohort(svc, value=0.6, seq=2)
    assert svc.exec_cache.n_keys == 2 and svc.exec_cache.n_compiles == 2


def test_launch_fault_recovers_with_retries():
    fails = {"n": 2}

    def hook():
        if fails["n"] > 0:
            fails["n"] -= 1
            raise schaos.FaultInjected("boom")

    svc, _ = make_service(fault_hook=hook)
    fill_full_cohort(svc, value=0.5)
    (c,) = svc.drain_commits()
    assert c.kind == "aggregated" and c.attempts == 3
    assert svc.telemetry.counters["launch_recovered"] == 1
    assert svc.telemetry.counters["launch_retries"] == 2
    assert svc.telemetry.launch_replays == 1


def test_launch_fault_exhaustion_degrades_but_service_lives():
    def hook():
        raise schaos.FaultInjected("always")

    svc, _ = make_service(
        fault_hook=hook,
        retry=sretry.RetryPolicy(max_attempts=2, base_delay_s=0.01))
    fill_full_cohort(svc, value=0.5)
    (c,) = svc.drain_commits()
    assert c.kind == "carried_forward"
    assert svc.telemetry.counters["launch_failed"] == 1
    assert torch.equal(svc.model, torch.zeros(DIM))
    svc._fault_hook = None
    fill_full_cohort(svc, value=0.5, seq=2)
    (c2,) = svc.drain_commits()
    assert c2.kind == "aggregated"


@pytest.mark.parametrize("where", ["hook", "kernel"])
def test_a_launch_error_that_is_not_injected_propagates(monkeypatch, where):
    """A CUDA or kernel error is never retried or carried forward: it
    leaves submit / admit_now / tick, and the service state it would
    have committed stays as it was."""
    def cuda_error(*args, **kwargs):
        raise RuntimeError("mm_single_pass (warp) launch failed: "
                           "cudaError 700")

    hook = cuda_error if where == "hook" else None
    if where == "kernel":
        monkeypatch.setattr(mm_aggregate, "_launch", cuda_error)
    svc, clock = make_service(fault_hook=hook, backend="pallas")
    for agent in range(svc.config.k_min - 1):
        svc.submit(upd(agent, value=0.5))
    with pytest.raises(RuntimeError, match="cudaError 700"):
        svc.submit(upd(svc.config.k_min - 1, value=0.5))
    assert svc.round == 0 and svc.drain_commits() == []
    assert torch.equal(svc.model, torch.zeros(DIM))
    c = svc.telemetry.counters
    assert c["launch_failed"] == 0 and c["carried_forward"] == 0
    assert svc.telemetry.launch_replays == 0
    # a later flush and a fired deadline raise just the same
    for agent in range(3):
        svc.submit(upd(agent, seq=2, value=0.5))
    svc._step_norm_ema = 1.0            # let the partial ladder launch
    with pytest.raises(RuntimeError, match="cudaError 700"):
        svc.admit_now()
    for agent in range(3):
        svc.submit(upd(agent, seq=3, value=0.5))
    clock.advance_to(clock.now() + 2.0)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        svc.tick()


# ===========================================================================
# chaos config + replay
# ===========================================================================

def test_chaos_rejects_collusion_attacks_per_agent():
    with pytest.raises(ValueError, match="not applicable per-agent"):
        schaos.ChaosConfig(byzantine_frac=0.3, attack="alie")


def test_chaos_fault_modes_and_profiles_match_the_reference():
    assert schaos.ChaosConfig().fault_modes() == ()
    assert set(schaos.CHAOS_PROFILES) == set(jchaos.CHAOS_PROFILES)
    for name, cfg in schaos.CHAOS_PROFILES.items():
        assert cfg.fault_modes() == jchaos.CHAOS_PROFILES[name].fault_modes()
    assert issubclass(schaos.FaultInjected, RuntimeError)
    assert schaos.FaultInjected is sretry.FaultInjected


def test_roles_and_corruption_draw_as_the_reference():
    cfg = schaos.CHAOS_PROFILES["mixed"]
    r1 = schaos.assign_roles(cfg, 40, np.random.default_rng(4))
    r2 = jchaos.assign_roles(jchaos.CHAOS_PROFILES["mixed"], 40,
                             np.random.default_rng(4))
    assert r1 == schaos.AgentRoles(**r2.__dict__)
    payload = np.arange(64, dtype=np.float32)
    got = schaos.corrupt_payload(torch.from_numpy(payload),
                                 np.random.default_rng(9))
    want = jchaos.corrupt_payload(payload, np.random.default_rng(9))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not bool(torch.isfinite(got).all())


def _replay_spec(rounds, name="serve-test", agents=16):
    return ScenarioSpec(name=name, paradigm="federated", num_agents=agents,
                        dim=8, num_steps=rounds, step_size=0.05,
                        local_steps=3)


def test_replay_rejects_non_federated_specs():
    spec = ScenarioSpec(paradigm="diffusion", num_agents=5, dim=4,
                        num_steps=2)
    with pytest.raises(ValueError, match="federated"):
        sscenario.replay(spec, device="cpu")


@pytest.mark.parametrize("profile, tenants", [("clean", 1), ("mixed", 2)])
def test_chaos_replay_stays_in_band(profile, tenants):
    """serve_bench's rows (16 agents a tenant, dim 8, k_min 8, 30
    rounds) on the kernel backend: in the spec's band, every round, no
    duplicate admission, every injected fault mode recovered, and one
    capture per cohort geometry however many tenants share it."""
    rounds = 30
    spec = _replay_spec(rounds, name=f"serve-{profile}", agents=16 * tenants)
    chaos = schaos.CHAOS_PROFILES[profile]
    res = sscenario.replay(
        spec, chaos=chaos,
        serve=ssvc.ServeConfig(k_min=8, deadline_s=1.0, backend="pallas"),
        rounds=rounds, seed=0, tenants=tenants, device="cpu")
    assert res.rounds_completed == rounds
    assert np.isfinite(res.msd).all()
    assert not res.summary["broke_down"]
    assert res.summary["steady_msd"] <= metrics.breakdown_threshold(spec)
    assert res.duplicate_admissions == 0
    for mode in chaos.fault_modes():
        assert res.recoveries[mode] > 0, (mode, res.recoveries)
    assert res.telemetry["post_warmup_cache_hit"]
    assert res.telemetry["updates_per_sec"] > 0
    for p in (50, 95, 99):
        assert res.telemetry[f"latency_p{p}"] is not None
    t = res.transport
    assert t["tenants"] == tenants
    assert t["exec_cache_compiles"] == t["exec_cache_keys"] >= 1
    assert t["exec_cache_max_compiles_per_key"] == 1
    assert t["exec_cache_replays"] == res.telemetry["launch_replays"]
    # launch_failed counts only exhausted injected faults
    if "launch_fault" not in chaos.fault_modes():
        assert res.telemetry["counters"].get("launch_failed", 0) == 0
    assert res.launch_audit is not None
    assert res.launch_audit.get("k_pad", 8) >= 8
    assert isinstance(res.model, torch.Tensor)
