"""The port's autotuner (``repro_torch.kernels.tuning.autotune``) and the
engine's ``autotune=True`` on the CPU, where every candidate runs the
kernels' plain versions and is timed by the host clock.

The sweep's winners depend on the clock, so the tests pin candidates
where they need a known winner.  The engine's estimate is held to the
JAX engine (Pallas in interpret mode) on the same numpy inputs at 1e-5
(sums run in another order): the single-pass estimate does not depend
on the tile, and the two-pass one is compared at the winner's K block.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import launches
from repro_torch.kernels import mm_aggregate as TK
from repro_torch.kernels import ops, tuning

BUDGET = 232_448


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch, tmp_path):
    """An empty in-process cache persisting to a file of the test's own."""
    monkeypatch.setattr(tuning, "_CACHE", {})
    monkeypatch.setattr(tuning, "_SWEEPS", {})
    monkeypatch.setattr(tuning, "_persistent_loaded", False)
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(tmp_path / "tune.json"))
    return tmp_path / "tune.json"


def test_pinned_winner_is_cached_persisted_and_read_back(fresh_cache):
    shape = (5, 200, 2)
    choice = tuning.autotune(*shape, reps=1, device="cpu",
                             candidates=((32, None), (64, None)))
    assert choice in ((32, None), (64, None))
    assert tuning.get_blocks(*shape) == choice
    timed = tuning.sweep_times(*shape, device="cpu")
    assert [c.block_m for c, _ in timed] == [32, 64]
    assert all(us > 0 for _, us in timed)
    entries = json.loads(fresh_cache.read_text())["entries"]
    assert [(e["k"], e["m"], e["n"], e["block_m"], e["device"])
            for e in entries] == [(5, 200, 2, choice[0], "cpu")]
    # a fresh process's cache: nothing in memory, the file read lazily
    tuning.clear_cache()
    tuning._persistent_loaded = False
    assert tuning.get_blocks(*shape) == choice
    assert tuning.load_cache() == 0          # already merged


def test_second_call_is_idempotent_and_force_times_again(monkeypatch):
    shape = (8, 96, 1)
    calls = []
    real = tuning._time_call_us

    def counted(fn, **kw):
        calls.append(1)
        return real(fn, **kw)

    monkeypatch.setattr(tuning, "_time_call_us", counted)
    first = tuning.autotune(*shape, reps=1, device="cpu")
    n = len(calls)
    assert n == len(tuning.candidate_choices(*shape))
    assert tuning.autotune(*shape, reps=1, device="cpu") == first
    assert len(calls) == n                      # nothing timed
    tuning.autotune(*shape, reps=1, device="cpu", force=True,
                    candidates=((32, None, "single"),))
    assert len(calls) == n + 1
    assert tuning.get_choice(*shape) == tuning.TuneChoice(32, None, "single")


@pytest.mark.parametrize("k,m,n", [
    (1, 7, 1), (8, 300, 1), (32, 10, 32), (33, 1000, 5), (64, 8192, 1),
    (65, 4099, 1), (96, 200, 1), (128, 15_730_944, 1), (256, 65_536, 256),
    (300, 513, 3), (512, 15_730_944, 1), (1024, 4096, 1),
    (8, 751_894_528, 1), (2048, 1031, 1)])
def test_every_candidate_passes_the_plan_and_the_shared_memory(k, m, n):
    cands = tuning.candidate_choices(k, m, n)
    assert cands and len(set(cands)) == len(cands)
    assert tuning.heuristic_choice(k, m, n) in cands
    for c in cands:
        plan = TK.launch_plan(k, m, n, block_m=c.block_m, block_k=c.block_k,
                              path=c.path)
        assert plan.path == c.path
        assert plan.smem_bytes <= BUDGET, (c, plan.smem_bytes)
        if c.path == "single":
            assert c.block_m % 32 == 0 and c.block_m <= max(32, m + 31)
            assert TK.variant_smem_bytes(plan.variant, k, n, c.block_m) \
                == plan.smem_bytes
        else:
            assert c.block_m in TK.two_pass_block_ms(k, c.block_k)
            assert c.block_k <= 512 and c.block_k >= 16
    # two-pass candidates only from the reference's crossover K on
    paths = {c.path for c in cands}
    assert ("two_pass" in paths) == (k >= 65)


def test_two_pass_candidates_follow_the_heuristic_block():
    """At each K block, the heuristic's block of columns and the next
    narrower: one K block of 128 rows takes up to 32 columns (8 lanes
    each), two blocks of 64 one warp a column, up to 8."""
    cands = tuning.candidate_choices(128, 15_730_944, 1)
    two = [(c.block_m, c.block_k) for c in cands if c.path == "two_pass"]
    assert two == [(32, 128), (16, 128), (8, 64), (4, 64)]
    assert [c.block_m for c in cands if c.path == "single"] == \
        [32, 64, 128, 256]
    # K = 512: the single-pass tile fits only up to 64 columns
    cands = tuning.candidate_choices(512, 15_730_944, 1)
    assert [c.block_m for c in cands if c.path == "single"] == [32, 64]
    assert tuning.heuristic_choice(512, 15_730_944, 1) == \
        tuning.TuneChoice(16, 512, "two_pass") == cands[2]


def test_cache_state_changes_with_a_winner():
    s0 = tuning.cache_state()
    tuning.autotune(8, 64, 1, reps=1, device="cpu",
                    candidates=((64, None, "single"),))
    assert tuning.cache_state() != s0


def test_sweep_leaves_the_launch_counts_as_they_were():
    before = launches.COUNTS.copy()
    tuning.autotune(8, 64, 1, reps=1, device="cpu")
    assert launches.COUNTS == before


@pytest.mark.parametrize("k,m,n", [(8, 300, 1), (8, 300, 3)])
def test_engine_records_the_winner_and_matches_the_jax_engine(k, m, n):
    rng = np.random.default_rng(k + m + n)
    x = rng.normal(size=(k, m)).astype(np.float32)
    x[-2:] += 1000.0
    a = rng.uniform(0.1, 1.0, size=(k, n)).astype(np.float32)
    engine = ops.AggregationEngine(autotune=True)
    with ops.record_workloads() as rec:
        got = engine.aggregate_batched(torch.from_numpy(x),
                                       torch.from_numpy(a))
    winner = tuning.get_choice(k, m, n)
    assert tuning.sweep_times(k, m, n, device="cpu") is not None
    assert (rec[0]["block_m"], rec[0]["path"]) == (winner.block_m,
                                                   winner.path)
    want = jops.AggregationEngine(interpret=True).aggregate_batched(
        jnp.asarray(x), jnp.asarray(a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)
    # a pinned tile skips the sweep
    tuning.clear_cache()
    pinned = ops.AggregationEngine(autotune=True, block_m=32)
    pinned.aggregate(torch.from_numpy(x))
    assert tuning.sweep_times(k, m, 1, device="cpu") is None


def test_engine_launches_a_two_pass_winner_like_the_jax_kernel():
    """The port of the reference's two-pass autotune test: a pinned
    two-pass winner at K = 96 with 32-row K blocks (three of them, the
    approximate median-of-medians start) routes the engine's launch; the
    estimate is held to the JAX two-pass kernel at the same K block, not
    to the exact oracle (the reference kernel's approximation)."""
    shape = (96, 200, 1)
    assert tuning.autotune(*shape, reps=1, device="cpu",
                           candidates=((8, 32, "two_pass"),)) == (8, 32)
    assert tuning.get_choice(*shape).path == "two_pass"
    x = np.random.default_rng(0).normal(size=(96, 200)).astype(np.float32)
    with ops.record_workloads() as rec:
        got = ops.AggregationEngine(autotune=True).aggregate(
            torch.from_numpy(x))
    assert (rec[0]["path"], rec[0]["block_k"], rec[0]["block_m"]) == \
        ("two_pass", 32, 8)
    want = jops.mm_aggregate(jnp.asarray(x), interpret=True,
                             path="two_pass", block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_autotune_asks_for_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tuning.autotune(8, 64, 1)
