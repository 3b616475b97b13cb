"""The port's retry/backoff policy (``repro_torch.serve.retry``) on a
fake clock, as ``test_serve_retry.py`` holds the reference's: backoff
shape, jitter bounds and budget cutoff, with zero real sleeping.  The
port retries only ``FaultInjected`` by default; any other error
propagates on its first occurrence."""

import numpy as np
import pytest

from repro.serve import retry as jretry
from repro_torch.serve import clock as sclock
from repro_torch.serve import retry


def test_policy_validation():
    with pytest.raises(ValueError):
        retry.RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        retry.RetryPolicy(jitter=1.5)
    with pytest.raises(ValueError):
        retry.RetryPolicy(base_delay_s=-1.0)


def test_deterministic_backoff_sequence():
    p = retry.RetryPolicy(base_delay_s=0.1, multiplier=2.0, max_delay_s=0.5,
                          jitter=0.0)
    assert [p.delay(a) for a in (1, 2, 3, 4, 5)] == \
        [0.1, 0.2, 0.4, 0.5, 0.5]


def test_jitter_bounds():
    p = retry.RetryPolicy(base_delay_s=0.1, jitter=0.5)
    rng = np.random.default_rng(0)
    delays = [p.delay(1, rng) for _ in range(200)]
    assert all(0.05 < d <= 0.1 for d in delays)
    assert len(set(delays)) > 1          # jitter actually draws


def test_success_after_transients_counts_attempts():
    clk = sclock.SimClock()
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise retry.FaultInjected("transient")
        return "ok"

    p = retry.RetryPolicy(max_attempts=4, base_delay_s=0.1, jitter=0.0)
    result, attempts = retry.call(fn, policy=p, clock=clk)
    assert result == "ok" and attempts == 3
    # slept the first two backoffs on the fake clock: 0.1 + 0.2
    assert clk.now() == pytest.approx(0.3)


def test_exhaustion_raises_with_chained_last():
    clk = sclock.SimClock()
    boom = retry.FaultInjected("persistent")
    p = retry.RetryPolicy(max_attempts=3, base_delay_s=0.01, jitter=0.0)
    with pytest.raises(retry.RetryError) as ei:
        retry.call(lambda: (_ for _ in ()).throw(boom), policy=p, clock=clk)
    assert ei.value.attempts == 3
    assert ei.value.last is boom
    assert ei.value.__cause__ is boom


def test_budget_cuts_off_without_oversleeping():
    clk = sclock.SimClock()
    p = retry.RetryPolicy(max_attempts=10, base_delay_s=1.0, multiplier=2.0,
                          max_delay_s=100.0, jitter=0.0, budget_s=5.0)
    with pytest.raises(retry.RetryError) as ei:
        retry.call(lambda: (_ for _ in ()).throw(retry.FaultInjected("x")),
                   policy=p, clock=clk)
    # backoffs 1 + 2 slept (t=3); the next (4s) would pass the 5s budget,
    # so the loop gives up at attempt 3 without sleeping it
    assert ei.value.attempts == 3
    assert clk.now() == pytest.approx(3.0)


def test_on_retry_telemetry_hook():
    clk = sclock.SimClock()
    seen = []
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] < 3:
            raise retry.FaultInjected("t")
        return 1

    p = retry.RetryPolicy(base_delay_s=0.1, jitter=0.0)
    retry.call(fn, policy=p, clock=clk,
               on_retry=lambda a, e, d: seen.append((a, d)))
    assert seen == [(1, pytest.approx(0.1)), (2, pytest.approx(0.2))]


def test_non_retryable_propagates_unwrapped():
    with pytest.raises(KeyError):
        retry.call(lambda: (_ for _ in ()).throw(KeyError("k")),
                   policy=retry.RetryPolicy(), clock=sclock.SimClock(),
                   retryable=(RuntimeError,))


def test_simclock_semantics():
    clk = sclock.SimClock(start=5.0)
    clk.sleep(1.5)
    assert clk.now() == 6.5
    clk.advance_to(10.0)
    assert clk.now() == 10.0
    with pytest.raises(ValueError):
        clk.advance_to(9.0)


def test_a_real_error_is_never_retried():
    """A CUDA or kernel error (a plain RuntimeError) propagates on its
    first occurrence, unwrapped, without a backoff sleep."""
    clk = sclock.SimClock()
    calls = {"n": 0}
    cuda_error = RuntimeError("mm_single_pass (regs) launch failed: "
                              "cudaError 700")

    def fn():
        calls["n"] += 1
        raise cuda_error

    with pytest.raises(RuntimeError) as ei:
        retry.call(fn, policy=retry.RetryPolicy(), clock=clk)
    assert ei.value is cuda_error and calls["n"] == 1
    assert clk.now() == 0.0


def test_backoff_draws_match_the_reference():
    """Same policy, same seed: the same jittered delays as the JAX
    package's, so SimClock runs of both services sleep alike."""
    p, q = retry.RetryPolicy(jitter=0.5), jretry.RetryPolicy(jitter=0.5)
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    assert [p.delay(a, r1) for a in range(1, 8)] == \
        [q.delay(a, r2) for a in range(1, 8)]
