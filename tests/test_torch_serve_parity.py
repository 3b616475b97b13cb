"""Lockstep parity: one seeded numpy stream of deliveries drives the JAX
package's ``AggregationService`` and the port's side by side.

The stream holds fresh sends, superseding sends, duplicates (a
delivery replayed with its sequence number), stale re-sends inside and
beyond the staleness window, a NaN payload, a byzantine agent whose
payloads sit 50 above the honest cluster (flagged by the residual check
until its breaker trips), deadline partials that aggregate with anchor
rows, and injected launch faults (the two packages' fault hooks draw
from numpy streams of one seed, so both fail the same attempts; some
launches recover on a retry, some exhaust it and carry forward).

Held equal exactly: every admission verdict, every ``CommitResult``
field but the two times (``compile_s``, ``launch_wall_s``), the round,
the telemetry counters and histograms, and the request-latency
percentiles (simulated time).  Held within the port's stated f32
tolerance (rtol 1e-5, atol 1e-5: sums run in another order): the
models and the health scores.  The verdicts that compare f32 norms (the
residual-outlier threshold and the trust clip) are kept clear of their
thresholds by the traffic: honest payloads spread by 0.05 around a
center that moves by 0.1 a phase, the byzantine agent sits 50 away.
"""

import numpy as np
import pytest
import torch

from repro.serve import chaos as jchaos
from repro.serve import retry as jretry
from repro.serve import service as jsvc
from repro.serve.buffer import AgentUpdate as JUpdate
from repro.serve.clock import SimClock as JClock
from repro_torch.serve import chaos as schaos
from repro_torch.serve import retry as sretry
from repro_torch.serve import service as ssvc
from repro_torch.serve.buffer import AgentUpdate
from repro_torch.serve.clock import SimClock

DIM = 16
HONEST = 8                       # agents 0..7
BYZANTINE = 8
NAN_AGENT = 9
CFG = dict(k_min=4, quorum=2, deadline_s=1.0, max_staleness=2,
           quarantine_threshold=3, quarantine_rounds=4, residual_z=4.0)
TIMES = ("compile_s", "launch_wall_s")
FIELDS = tuple(f for f in jsvc.CommitResult.__dataclass_fields__
               if f not in TIMES)


def make_stream(seed: int, phases: int = 18):
    """[(t, agent, rounds back, seq, payload) | (t, "tick")], from one
    numpy generator."""
    rng = np.random.default_rng(seed)
    events, t = [], 0.0
    seq = {a: 0 for a in range(NAN_AGENT + 1)}
    last = {}
    for phase in range(phases):
        center = 0.1 * phase
        burst = rng.permutation(BYZANTINE + 1)[:int(rng.integers(2, 8))]
        for agent in burst.tolist():
            t += float(rng.uniform(0.01, 0.15))
            kind = rng.choice(["fresh", "dup", "stale", "old"],
                              p=[0.7, 0.1, 0.1, 0.1])
            if kind == "dup" and agent in last:
                events.append((t, agent) + last[agent])
                continue
            seq[agent] += 1
            payload = rng.normal(center, 0.05, DIM).astype(np.float32)
            if agent == BYZANTINE:
                payload += 50.0
            back = {"stale": 1, "old": 3}.get(str(kind), 0)
            last[agent] = (back, seq[agent], payload)
            events.append((t, agent, back, seq[agent], payload))
        if phase in (3, 9):
            seq[NAN_AGENT] += 1
            events.append((t + 0.01, NAN_AGENT, 0, seq[NAN_AGENT],
                           np.full(DIM, np.nan, np.float32)))
        # every third phase ends in a quiet spell: the deadline fires
        t += 1.5 if phase % 3 == 2 else float(rng.uniform(0.0, 0.3))
        events.append((t, "tick"))
    return events


class Pair:
    """The JAX service and the port's, fed the same events."""

    def __init__(self, jax_backend, torch_backend, *, fault_rate,
                 interpret=None, max_attempts=2):
        retry_kw = dict(max_attempts=max_attempts, base_delay_s=0.05)
        self.jclock, self.sclock = JClock(), SimClock()
        chaos_kw = dict(launch_fault_rate=fault_rate)
        self.j = jsvc.AggregationService(
            np.zeros(DIM, np.float32),
            config=jsvc.ServeConfig(backend=jax_backend, interpret=interpret,
                                    retry=jretry.RetryPolicy(**retry_kw),
                                    **CFG),
            clock=self.jclock, seed=3,
            fault_hook=jchaos.make_launch_fault_hook(
                jchaos.ChaosConfig(**chaos_kw), seed=5))
        self.s = ssvc.AggregationService(
            np.zeros(DIM, np.float32),
            config=ssvc.ServeConfig(backend=torch_backend,
                                    retry=sretry.RetryPolicy(**retry_kw),
                                    **CFG),
            clock=self.sclock, seed=3,
            fault_hook=schaos.make_launch_fault_hook(
                schaos.ChaosConfig(**chaos_kw), seed=5),
            device="cpu")
        self.commits = []

    def check_state(self, where):
        j, s = self.j, self.s
        assert j.round == s.round, where
        np.testing.assert_allclose(s.model.numpy(), j.model, rtol=1e-5,
                                   atol=1e-5, err_msg=str(where))
        assert dict(s.telemetry.counters) == dict(j.telemetry.counters), \
            where
        assert len(s.buffer) == len(j.buffer), where
        for agent in range(NAN_AGENT + 1):
            hj, hs = j.health_of(agent), s.health_of(agent)
            assert hs.score == pytest.approx(hj.score, rel=1e-5, abs=1e-5)
            assert (hs.consecutive_rejections, hs.quarantined_until) == \
                (hj.consecutive_rejections, hj.quarantined_until), where

    def check_commits(self, where):
        cj, cs = self.j.drain_commits(), self.s.drain_commits()
        assert len(cj) == len(cs), where
        for a, b in zip(cj, cs):
            assert {f: getattr(b, f) for f in FIELDS} == \
                {f: getattr(a, f) for f in FIELDS}, where
        self.commits.extend(cj)

    def run(self, events):
        verdicts = []
        for i, ev in enumerate(events):
            t = ev[0]
            self.jclock.advance_to(max(t, self.jclock.now()))
            self.sclock.advance_to(max(t, self.sclock.now()))
            if ev[1] == "tick":
                self.j.tick()
                self.s.tick()
            else:
                _, agent, back, seq, payload = ev
                rnd = max(self.j.round - back, 0)
                vj = self.j.submit(JUpdate(agent_id=agent, round=rnd,
                                           payload=payload, seq=seq,
                                           weight=1.0 + 0.25 * agent,
                                           sent_at=t))
                vs = self.s.submit(AgentUpdate(
                    agent_id=agent, round=rnd,
                    payload=torch.from_numpy(payload.copy()), seq=seq,
                    weight=1.0 + 0.25 * agent, sent_at=t))
                assert vs == vj, (i, ev[:4])
                verdicts.append(vj)
            self.check_commits(i)
            self.check_state(i)
        return verdicts


def _snapshot_view(tel):
    row = tel.snapshot()
    row.pop("launch_replays", None)
    return {k: v for k, v in row.items()
            if not k.startswith("launch_wall") and k != "compile_s_total"}


@pytest.mark.parametrize("torch_backend", ["pallas", "jnp"])
def test_lockstep_parity_with_the_reference(torch_backend):
    pair = Pair("jnp", torch_backend, fault_rate=0.3)
    verdicts = pair.run(make_stream(seed=0))
    # the stream reached every path it is meant to
    assert {"buffered", "superseded", "duplicate", "rejected_stale",
            "rejected_invalid", "rejected_quarantined"} <= set(verdicts)
    kinds = {c.kind for c in pair.commits}
    assert kinds == {"aggregated", "degraded_partial", "carried_forward"}
    c = pair.j.telemetry.counters
    assert c["launch_failed"] >= 1 and c["launch_recovered"] >= 1
    assert c["estimator_outliers"] >= 1 and c["quarantined"] >= 1
    assert c["stale_downweighted"] >= 1 and c["deadline_fired"] >= 1
    assert any(BYZANTINE in cm.outliers for cm in pair.commits)
    assert _snapshot_view(pair.s.telemetry) == \
        _snapshot_view(pair.j.telemetry)
    # the port ran its launch program once for every commit a launch
    # made (a carried-forward commit records no attempts)
    launched = sum(1 for cm in pair.commits if cm.attempts)
    assert pair.s.telemetry.launch_replays == launched > 0


def test_lockstep_parity_with_the_pallas_kernel_in_interpret_mode():
    """The JAX package's Pallas kernel (interpret mode) beside the
    port's kernel backend (its plain version on the CPU), on a short
    stream."""
    pair = Pair("pallas", "pallas", fault_rate=0.0, interpret=True)
    verdicts = pair.run(make_stream(seed=1, phases=5))
    assert "buffered" in verdicts
    assert sum(1 for cm in pair.commits if cm.kind == "aggregated") >= 2
    assert pair.s.launch_audit()["k_pad"] == pair.j.launch_audit()["k_pad"]
