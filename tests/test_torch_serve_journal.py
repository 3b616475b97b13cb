"""The port's write-ahead journal and crash recovery: the counterparts
of ``test_serve_journal.py`` (record format, torn tail, snapshot
cadence, exactly-once admission across restart, bit-identical journals
on rerun), and journals that cross between the packages: one byte
format, so a journal the JAX service writes recovers in the port and
one the port writes parses and recovers in the JAX package."""

import numpy as np
import pytest
import torch

from repro.serve import journal as jjournal
from repro.serve import service as jsvc
from repro.serve.buffer import AgentUpdate as JAgentUpdate
from repro.serve.clock import SimClock as JSimClock
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.serve import chaos as schaos
from repro_torch.serve import journal as sjournal
from repro_torch.serve import scenario as sscenario
from repro_torch.serve import service as ssvc
from repro_torch.serve.buffer import AgentUpdate
from repro_torch.serve.clock import SimClock
from repro_torch.serve.telemetry import deterministic_view

DIM = 6


def upd(agent, *, round=0, seq=1, value=1.0):
    return AgentUpdate(agent_id=agent, round=round,
                       payload=torch.full((DIM,), value), seq=seq)


def make_service(journal=None, **cfg_kw):
    defaults = dict(k_min=4, quorum=2, deadline_s=1.0, backend="jnp")
    defaults.update(cfg_kw)
    svc = ssvc.AggregationService(
        np.zeros(DIM, np.float32), config=ssvc.ServeConfig(**defaults),
        clock=SimClock(), journal=journal, device="cpu")
    return svc


def recover(journal, **cfg_kw):
    defaults = dict(k_min=4, backend="jnp")
    defaults.update(cfg_kw)
    return ssvc.AggregationService.recover(
        journal, config=ssvc.ServeConfig(**defaults), clock=SimClock(),
        device="cpu")


# ===========================================================================
# record format
# ===========================================================================

def test_array_codec_roundtrip_and_matches_the_reference():
    x = torch.arange(7, dtype=torch.float32) * 0.5
    s = sjournal.encode_array(x)
    assert s == jjournal.encode_array(x.numpy())
    np.testing.assert_array_equal(sjournal.decode_array(s), x.numpy())
    assert sjournal.encode_array(x.numpy()) == s


def test_append_records_roundtrip():
    j = sjournal.Journal.memory()
    j.append("init", {"model": "x", "round": 0})
    j.append("delivery", {"agent": 3, "seq": 1})
    assert list(j.records()) == [("init", {"model": "x", "round": 0}),
                                 ("delivery", {"agent": 3, "seq": 1})]


def test_torn_tail_is_dropped_not_fatal():
    j = sjournal.Journal.memory()
    j.append("init", {"round": 0})
    j.append("delivery", {"agent": 1})
    j._backend._buf.write(b"deadbeef {\"t\":\"deliv")
    assert [k for k, _ in j.records()] == ["init", "delivery"]
    with pytest.raises(sjournal.JournalCorrupt):
        list(j.records(strict_tail=True))


def test_mid_file_corruption_raises():
    j = sjournal.Journal.memory()
    j.append("init", {"round": 0})
    j.append("delivery", {"agent": 1})
    raw = bytearray(j.dump())
    raw[20] ^= 0xFF
    j2 = sjournal.Journal.memory()
    j2._backend._buf.write(bytes(raw))
    with pytest.raises(sjournal.JournalCorrupt):
        list(j2.records())


def test_unknown_record_kind_rejected():
    with pytest.raises(ValueError, match="unknown record kind"):
        sjournal.Journal.memory().append("bogus", {})


def test_file_backend_roundtrip(tmp_path):
    path = tmp_path / "svc.journal"
    j = sjournal.Journal.file(path)
    j.append("init", {"round": 0})
    j.append("commit", {"round": 1})
    j2 = sjournal.Journal.file(path)
    assert [k for k, _ in j2.records()] == ["init", "commit"]
    assert j2.dump() == j.dump()


def test_snapshot_cadence():
    j = sjournal.Journal.memory(snapshot_every=2)
    j.append("commit", {"n": 1})
    assert not j.snapshot_due()
    j.append("commit", {"n": 2})
    assert j.snapshot_due()
    j.append("snapshot", {"n": 2})
    assert not j.snapshot_due()


# ===========================================================================
# service-level recovery
# ===========================================================================

def fill_cohort(svc, *, seq, value=0.5):
    for agent in range(svc.config.k_min):
        svc.submit(upd(agent, round=svc.round, seq=seq, value=value))


def test_attach_refuses_used_journal():
    j = sjournal.Journal.memory()
    j.append("init", {"model": sjournal.encode_array(np.zeros(DIM)),
                      "round": 0})
    with pytest.raises(ValueError, match="recover"):
        make_service(journal=j)


def test_recovery_restores_model_round_and_gates():
    j = sjournal.Journal.memory()
    svc = make_service(journal=j)
    fill_cohort(svc, seq=1, value=0.5)
    fill_cohort(svc, seq=2, value=0.7)
    model, rnd = svc.model, svc.round
    del svc

    rec = recover(j)
    assert rec.round == rnd
    assert torch.equal(rec.model, model)
    for agent in range(4):
        for seq in (1, 2):
            assert rec.submit(upd(agent, round=0, seq=seq)) == "duplicate"
    assert rec.drain_commits() == []


def test_exactly_once_across_crash_mid_cohort():
    j = sjournal.Journal.memory()
    svc = make_service(journal=j)
    fill_cohort(svc, seq=1, value=0.5)
    for agent in range(3):
        svc.submit(upd(agent, round=svc.round, seq=2, value=0.9))
    del svc

    rec = recover(j)
    assert rec.round == 1
    for agent in range(3):
        assert rec.submit(upd(agent, round=1, seq=2, value=0.9)) \
            == "duplicate"
    rec.submit(upd(3, round=1, seq=2, value=0.9))
    (c,) = rec.drain_commits()
    assert c.kind == "aggregated" and c.cohort_size == 4
    assert len(c.seqs) == len(set(c.seqs))
    np.testing.assert_allclose(rec.model.numpy(), 0.9, rtol=1e-4)


def test_recovery_from_snapshot_equals_tail_replay():
    cfg = dict(k_min=4, backend="jnp")
    j_snap = sjournal.Journal.memory(snapshot_every=1)
    j_tail = sjournal.Journal.memory(snapshot_every=10_000)
    svc_a = make_service(journal=j_snap, journal_snapshot_every=1, **cfg)
    svc_b = make_service(journal=j_tail, journal_snapshot_every=10_000,
                         **cfg)
    for svc in (svc_a, svc_b):
        fill_cohort(svc, seq=1, value=0.5)
        fill_cohort(svc, seq=2, value=0.7)
        svc.submit(upd(0, round=svc.round, seq=3, value=0.9))
    del svc_a, svc_b

    rec_snap, rec_tail = recover(j_snap), recover(j_tail)
    assert torch.equal(rec_snap.model, rec_tail.model)
    assert rec_snap.round == rec_tail.round
    assert rec_snap.buffer.export_state()[0] \
        == rec_tail.buffer.export_state()[0]
    assert len(rec_snap.buffer) == len(rec_tail.buffer) == 1


def test_recovery_preserves_health_state():
    j = sjournal.Journal.memory()
    svc = make_service(journal=j, quarantine_threshold=2, max_staleness=0)
    fill_cohort(svc, seq=1, value=0.5)
    for seq in (2, 3):
        svc.submit(upd(9, round=0, seq=seq))
    quarantined_until = svc.health_of(9).quarantined_until
    assert quarantined_until > svc.round
    score = svc.health_of(9).score
    del svc

    rec = recover(j, quarantine_threshold=2, max_staleness=0)
    assert rec.health_of(9).quarantined_until == quarantined_until
    assert rec.health_of(9).score == pytest.approx(score)
    assert rec.submit(upd(9, round=rec.round, seq=4)) \
        == "rejected_quarantined"


# ===========================================================================
# journals across the packages
# ===========================================================================

def _traffic(rng):
    """(agent, round offset, seq, payload) deliveries: two full cohorts
    of 4, then 3 stragglers left pending, one stale re-send and one
    NaN; agent 9 goes quarantined."""
    out = []
    for seq in (1, 2):
        for agent in range(4):
            out.append((agent, 0, seq, rng.normal(
                0.5 * seq, 0.1, DIM).astype(np.float32)))
    for agent in range(3):
        out.append((agent, 0, 3, rng.normal(1.5, 0.1, DIM)
                    .astype(np.float32)))
    out.append((9, -2, 1, rng.normal(0, 1, DIM).astype(np.float32)))
    out.append((9, 0, 2, np.full(DIM, np.nan, np.float32)))
    return out


def _drive(svc, deliveries, make_update):
    for agent, back, seq, payload in deliveries:
        svc.submit(make_update(agent_id=agent, round=max(svc.round + back, 0),
                               payload=payload, seq=seq, weight=1.0 + agent))


CFG = dict(k_min=4, quorum=2, backend="jnp", quarantine_threshold=2,
           max_staleness=1, journal_snapshot_every=1)


@pytest.mark.parametrize("snapshot_every", [1, 64])
def test_a_journal_the_reference_writes_recovers_in_the_port(
        tmp_path, snapshot_every):
    path = tmp_path / "jax.journal"
    cfg = dict(CFG, journal_snapshot_every=snapshot_every)
    svc = jsvc.AggregationService(
        np.zeros(DIM, np.float32), config=jsvc.ServeConfig(**cfg),
        clock=JSimClock(),
        journal=jjournal.Journal.file(path, snapshot_every=snapshot_every))
    _drive(svc, _traffic(np.random.default_rng(0)), JAgentUpdate)
    jrec = jsvc.AggregationService.recover(
        jjournal.Journal.file(tmp_path / "jax.journal"),
        config=jsvc.ServeConfig(**cfg), clock=JSimClock())

    rec = ssvc.AggregationService.recover(
        sjournal.Journal.file(path), config=ssvc.ServeConfig(**cfg),
        clock=SimClock(), device="cpu")
    assert rec.round == jrec.round == svc.round == 2
    np.testing.assert_array_equal(rec.model.numpy(), svc.model)
    assert rec._step_norm_ema == jrec._step_norm_ema
    last, pending = rec.buffer.export_state()
    jlast, jpending = jrec.buffer.export_state()
    assert last == jlast
    key = lambda p: p.update.agent_id
    assert [(p.update.agent_id, p.update.seq, p.update.round,
             p.update.weight, p.arrival_t, p.staleness)
            for p in sorted(pending, key=key)] == \
        [(p.update.agent_id, p.update.seq, p.update.round, p.update.weight,
          p.arrival_t, p.staleness) for p in sorted(jpending, key=key)]
    for p, q in zip(sorted(pending, key=key), sorted(jpending, key=key)):
        np.testing.assert_array_equal(p.update.payload.numpy(),
                                      q.update.payload)
    for agent in (0, 1, 2, 9):
        assert rec.health_of(agent).as_list() == \
            jrec.health_of(agent).as_list()
    assert rec.submit(upd(9, round=rec.round, seq=3)) \
        == "rejected_quarantined"


def test_a_journal_the_port_writes_parses_and_recovers_in_the_reference(
        tmp_path):
    path = tmp_path / "torch.journal"
    svc = ssvc.AggregationService(
        np.zeros(DIM, np.float32), config=ssvc.ServeConfig(**CFG),
        clock=SimClock(), journal=sjournal.Journal.file(path, snapshot_every=1),
        device="cpu")
    _drive(svc, _traffic(np.random.default_rng(1)), AgentUpdate)
    kinds = [k for k, _ in jjournal.Journal.file(path).records(
        strict_tail=True)]
    assert kinds[0] == "init" and "snapshot" in kinds and "commit" in kinds
    jrec = jsvc.AggregationService.recover(
        jjournal.Journal.file(path), config=jsvc.ServeConfig(**CFG),
        clock=JSimClock())
    assert jrec.round == svc.round == 2
    np.testing.assert_array_equal(jrec.model, svc.model.numpy())
    assert jrec.buffer.export_state()[0] == svc.buffer.export_state()[0]
    assert sorted(p.update.agent_id for p in jrec.buffer.export_state()[1]) \
        == [0, 1, 2]
    assert jrec.health_of(9).as_list() == svc.health_of(9).as_list()


# ===========================================================================
# determinism regression: chaos replay -> bit-identical journals
# ===========================================================================

def test_chaos_replay_is_bit_deterministic():
    spec = ScenarioSpec(name="det", paradigm="federated", num_agents=16,
                        dim=8, num_steps=8, step_size=0.05, local_steps=2)
    kw = dict(chaos=schaos.CHAOS_PROFILES["mixed"],
              serve=ssvc.ServeConfig(k_min=8, deadline_s=1.0,
                                     backend="pallas"),
              rounds=8, seed=11, tenants=2, device="cpu")
    r1 = sscenario.replay(spec, **kw)
    r2 = sscenario.replay(spec, **kw)
    for name in r1.journals:
        assert r1.journals[name].dump() == r2.journals[name].dump()
        assert len(r1.journals[name].dump()) > 0
    assert deterministic_view(r1.telemetry) == deterministic_view(
        r2.telemetry)
    assert r1.recoveries == r2.recoveries
    assert r1.transport == r2.transport
    np.testing.assert_array_equal(r1.msd, r2.msd)
    for name, j in r1.journals.items():
        for kind, rec in j.records():
            assert "wall" not in rec, (name, kind, rec)


def test_crash_replay_has_no_duplicate_admissions():
    spec = ScenarioSpec(name="crash", paradigm="federated", num_agents=16,
                        dim=8, num_steps=10, step_size=0.05, local_steps=2)
    res = sscenario.replay(
        spec,
        chaos=schaos.ChaosConfig(duplicate_prob=0.2,
                                 crash_restart_frac=(0.4, 0.7)),
        serve=ssvc.ServeConfig(k_min=8, deadline_s=1.0, backend="pallas"),
        rounds=10, seed=5, device="cpu")
    assert res.crash_restarts == 2
    assert res.duplicate_admissions == 0
    assert res.recoveries["crash"] == 2
    assert res.rounds_completed == 10
    assert not res.summary["broke_down"]
    # the recovered services re-attach the shared cache: no new capture
    assert res.transport["exec_cache_compiles"] == \
        res.transport["exec_cache_keys"]
