"""The port's phase tracer (``repro_torch.tracing``) on the CPU: device
phases summed and counted by name over pooled event pairs (CUDA events
stood in for by host counters), host spans with parents and rounds, the
off mode, and the service's phases and spans -- ``submit`` > ``admit``,
``commit`` > ``stage``, ``replay``, ``take``, ``guard``, ``outliers``,
``clip`` -- laid on ``torch.profiler``'s clock."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

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


def test_spans_nest_with_parents_and_rounds():
    t = tracing.PhaseTimer(False, spans=True)
    outer = t.begin("submit", device=False, round=3)
    inner = t.begin("admit")
    t.end(inner)
    t.end(outer)
    top = t.begin("commit", device=False, round=4, attrs={"k": 8})
    t.end(top)
    s = t.spans()
    assert [(x.name, x.parent, x.round) for x in s] == [
        ("submit", None, 3), ("admit", s[0].id, 3), ("commit", None, 4)]
    assert s[2].attrs == {"k": 8}
    assert s[0].start_ns <= s[1].start_ns <= s[1].end_ns <= s[0].end_ns
    assert t.spans() == []                # drained
    assert t.phase_ms() == {}             # no device phases off the card


def test_an_exception_leaves_no_span_open_behind_it():
    t = tracing.PhaseTimer(False, spans=True)
    outer = t.begin("submit", device=False)
    t.begin("admit")                      # never ended
    t.end(outer)
    t.end(t.begin("next", device=False))
    s = t.spans()
    assert s[2].parent is None and s[1].end_ns is None


def test_off_mode_keeps_no_spans(fake_cuda):
    off = tracing.PhaseTimer(False)
    assert off.begin("admit") is None
    assert off.begin("submit", device=False) is None
    assert off.spans() == [] and off._spans == [] and off._open == []
    timed = tracing.PhaseTimer(True)      # device phases only
    token = timed.begin("admit")
    assert token.span is None
    timed.end(token)
    assert timed._spans == [] and timed.phase_totals()["admit"][1] == 1


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


def test_service_spans_cover_a_round_in_order():
    t = tracing.PhaseTimer(False, spans=True)
    svc = _service(t)
    for agent in range(4):
        assert _submit(svc, agent) == "buffered"
    (commit,) = svc.drain_commits()
    assert commit.kind == "aggregated"
    s = t.spans()
    by_id = {x.id: x for x in s}
    submits = [x for x in s if x.name == "submit"]
    admits = [x for x in s if x.name == "admit"]
    assert len(submits) == len(admits) == 4
    assert all(by_id[a.parent].name == "submit" for a in admits)
    (c,) = [x for x in s if x.name == "commit"]
    assert by_id[c.parent] is submits[-1]      # the last submit pumps it
    kids = [x for x in s if x.parent == c.id]
    assert [x.name for x in kids] == COMMIT_PHASES
    assert {x.round for x in submits + admits + [c] + kids} == {0}
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns          # none overlapping
    assert c.start_ns <= kids[0].start_ns and kids[-1].end_ns <= c.end_ns
    assert kids[1].attrs == {"path": "single", "variant": "warp", "k": 4,
                             "m": DIM, "n": 1}
    assert all(x.end_ns is not None for x in s)
    # the next round's spans carry its own round
    _submit(svc, 0, seq=2)
    assert [x.round for x in t.spans()] == [1, 1]


def test_quarantined_submit_does_no_admission_work():
    t = tracing.PhaseTimer(False, spans=True)
    svc = _service(t, quarantine_threshold=1)
    bad = sbuf.AgentUpdate(agent_id=7, round=0, seq=1,
                           payload=torch.full((DIM,), float("nan")))
    assert svc.submit(bad) == "rejected_invalid"
    assert svc.submit(sbuf.AgentUpdate(
        agent_id=7, round=0, seq=2, payload=torch.zeros(DIM))
    ) == "rejected_quarantined"
    s = t.spans()
    assert [x.name for x in s] == ["submit", "admit", "submit"]


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
    assert t.spans() == []


def test_program_spans_share_the_profilers_clock():
    t = tracing.PhaseTimer(False, spans=True)
    svc = _service(t)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("submit"):
            _submit(svc, 0)
    (ours,) = [x for x in t.spans() if x.name == "submit"]
    (theirs,) = [e for e in prof.profiler.kineto_results.events()
                 if e.name() == "submit"]
    start = theirs.start_ns()
    assert start <= ours.start_ns <= ours.end_ns <= \
        start + theirs.duration_ns()
