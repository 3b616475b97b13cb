"""The port's phase tracer (``repro_torch.tracing``) on the CPU: device
phases summed and counted by name over pooled event pairs (CUDA events
stood in for by host counters), the off mode, and the service's phases
in the order a round runs them -- ``admit`` for each update, then
``stage``, ``replay``, ``take``, ``guard``, ``outliers``, ``clip``."""

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.launch import steps
from repro_torch.serve import buffer as sbuf
from repro_torch.serve import service as ssvc
from repro_torch.serve.clock import SimClock

DIM = 6
COMMIT_PHASES = ["stage", "replay", "take", "guard", "outliers", "clip"]


class FakeEvent:
    """A timing event on a host counter: each ``record`` one tick later;
    ``made`` counts the events made."""

    tick = 0
    made = 0

    def __init__(self, device=None, enable_timing=True):
        FakeEvent.made += 1
        self.t = None

    def record(self):
        FakeEvent.tick += 1
        self.t = FakeEvent.tick

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA events and the capture query, on the host."""
    FakeEvent.tick = FakeEvent.made = 0
    state = {"capturing": False}
    monkeypatch.setattr(torch, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    return state


def test_device_phases_sum_and_count_by_name_over_pooled_events(fake_cuda):
    t = tracing.PhaseTimer(True)
    for name in ("a", "b", "a"):
        with t.phase(name):
            FakeEvent.tick += 10          # the phase's device work
    assert t.phase_totals() == {"a": [22.0, 2], "b": [11.0, 1]}
    assert t.phase_ms() == {"a": 22.0, "b": 11.0}
    assert FakeEvent.made == 6
    mark = t.mark()
    t.end(t.begin("a"))
    assert t.phase_ms(before=mark) == {"a": 22.0, "b": 11.0}
    t.reset(since=mark)                   # keeps the phase after the mark
    assert t.phase_totals() == {"a": [1.0, 1]}
    for name in ("c", "c", "c"):
        t.end(t.begin(name))
    assert FakeEvent.made == 8            # the three pooled pairs reused
    t.reset()
    assert t.phase_ms() == {}
    fake_cuda["capturing"] = True         # an event would join the graph
    assert t.begin("a") is None
    t.end(None)
    assert t.phase_ms() == {} and FakeEvent.made == 8


def test_off_mode_keeps_no_spans(fake_cuda):
    off = tracing.PhaseTimer(False)
    assert off.begin("admit") is None
    off.end(None)
    with off.phase("replay"):
        pass
    assert off.phase_totals() == {} and off._done == [] and off._pool == []
    svc = _service(off)
    for agent in range(4):
        _submit(svc, agent)
    assert svc.round == 1 and svc.phase_ms() == {}
    assert FakeEvent.made == 0            # not one event made


def test_train_step_takes_the_one_tracer():
    assert steps.PhaseTimer is tracing.PhaseTimer


def _service(timer, **cfg):
    conf = dict(k_min=4, quorum=2, deadline_s=1.0, backend="pallas")
    conf.update(cfg)
    return ssvc.AggregationService(
        np.zeros(DIM, np.float32), config=ssvc.ServeConfig(**conf),
        clock=SimClock(), device="cpu", timer=timer)


def _submit(svc, agent, seq=1, value=0.5):
    payload = torch.full((DIM,), value) + 0.01 * agent
    return svc.submit(sbuf.AgentUpdate(agent_id=agent, round=svc.round,
                                       payload=payload, seq=seq))


def test_service_spans_cover_a_round_in_order(fake_cuda):
    t = tracing.PhaseTimer(True)
    svc = _service(t)
    for agent in range(4):
        assert _submit(svc, agent) == "buffered"
    (commit,) = svc.drain_commits()
    assert commit.kind == "aggregated"
    totals = t.phase_totals()
    assert list(totals) == ["admit", *COMMIT_PHASES]
    assert totals["admit"][1] == 4
    assert all(totals[name][1] == 1 for name in COMMIT_PHASES)
    slots = t._done
    assert [x.name for x in slots] == ["admit"] * 4 + COMMIT_PHASES
    for a, b in zip(slots, slots[1:]):
        assert a.start.t < a.end.t < b.start.t    # none overlapping


def test_quarantined_submit_does_no_admission_work(fake_cuda):
    t = tracing.PhaseTimer(True)
    svc = _service(t, quarantine_threshold=1)
    bad = sbuf.AgentUpdate(agent_id=7, round=0, seq=1,
                           payload=torch.full((DIM,), float("nan")))
    assert svc.submit(bad) == "rejected_invalid"
    assert svc.submit(sbuf.AgentUpdate(
        agent_id=7, round=0, seq=2, payload=torch.zeros(DIM))
    ) == "rejected_quarantined"
    assert {name: n for name, (_, n) in t.phase_totals().items()} == \
        {"admit": 1}


def test_service_phase_ms_holds_the_last_launched_commit(fake_cuda):
    t = tracing.PhaseTimer(True)
    svc = _service(t)
    assert svc.phase_ms() == {}
    for agent in range(4):
        _submit(svc, agent)
    totals = t.phase_totals()
    assert totals["admit"][1] == 4
    assert {n for n in totals} == {"admit", *COMMIT_PHASES}
    assert all(totals[n][1] == 1 for n in COMMIT_PHASES)
    before = svc.phase_ms()
    _submit(svc, 0, seq=2)                     # the next round's admission
    assert svc.phase_ms() == before
    for agent in range(1, 4):
        _submit(svc, agent, seq=2)
    assert svc.round == 2
    assert t.phase_totals()["admit"][1] == 4   # only this round's four
