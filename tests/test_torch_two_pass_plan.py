"""The two-pass kernel's launch plan and tile choice (CPU): the block of
1, 2, 4 or 8 columns the heuristic picks, what the plan refuses, and
tuning-cache entries written for another kernel."""

import json

import pytest
import torch

from repro_torch.kernels import mm_aggregate as TK
from repro_torch.kernels import tuning

BUDGET = 232_448


@pytest.mark.parametrize("k,m,n,block_m", [
    (512, 15_730_944, 1, 8),    # the layer-wide cohort: 8 columns a block
    (512, 1056, 1, 8),          # 132 tiles of 8: one per SM
    (512, 1048, 1, 4),          # 131 tiles of 8: narrower blocks fill it
    (512, 300, 1, 2),
    (512, 256, 1, 1),           # the large cohort's (512, 256, 1)
    (8192, 10 ** 6, 1, 4),      # a (8192, 8) tile would not fit
    (22_000, 10 ** 6, 1, 1)])
def test_heuristic_picks_the_widest_block_that_fits_and_fills_the_card(
        k, m, n, block_m):
    plan = TK.launch_plan(k, m, n)
    assert plan.path == "two_pass" and plan.block_m == block_m
    assert plan.smem_bytes <= BUDGET
    assert plan.grid == (-(-m // block_m), plan.num_k_blocks)


def test_a_forced_two_pass_path_takes_a_two_pass_tile():
    """K = 64 takes the single pass by itself (bm = 256); forced to
    two-pass, the plan asks the heuristic for that path's block.  K = 128
    takes the two-pass kernel by itself; forced to the single pass, the
    single pass's tile."""
    assert TK.launch_plan(64, 2049, 1).block_m == 256
    plan = TK.launch_plan(64, 2049, 1, path="two_pass")
    assert plan.block_m == 8 and plan.block_k == 64
    plan = TK.launch_plan(128, 2049, 1)
    assert plan.path == "two_pass" and plan.block_m == 8
    plan = TK.launch_plan(128, 2049, 1, path="single")
    assert plan.variant == "smem" and plan.block_m == 256


@pytest.mark.parametrize("n", [1, 3, 32])
def test_auto_two_pass_sorts_one_k_block_up_to_512_agents(n):
    """Every launch with nothing pinned that the crossover sends to the
    two-pass kernel with K <= 512 sorts the whole K axis as one block, so
    its start is the exact weighted median and MAD, not the
    median-of-medians of several blocks; K > 512 keeps 512-row blocks."""
    two = [k for k in range(65, 513) if TK.auto_path(k, n) == "two_pass"]
    assert two == list(range(two[0], 513))
    for k in two:
        bk = TK.next_pow2(k)
        for m in (7, 4096, 15_730_944):
            plan = TK.launch_plan(k, m, n)
            assert plan.path == "two_pass", (k, m, n)
            assert plan.num_k_blocks == 1 and plan.block_k == bk >= k
            assert plan.smem_bytes <= BUDGET
        assert tuning.heuristic_choice(k, 4096, n).block_k == bk
    for k in (513, 1024, 4096):
        plan = TK.launch_plan(k, 4096, n)
        assert plan.path == "two_pass" and plan.block_k == 512
        assert plan.num_k_blocks == -(-k // 512)


@pytest.mark.parametrize("block_m", [0, 3, 16, 32, 64])
def test_two_pass_block_m_must_be_a_block_of_warps(block_m):
    with pytest.raises(ValueError, match="block_m"):
        TK.launch_plan(512, 1000, 1, path="two_pass", block_m=block_m)


@pytest.mark.parametrize("k,n,bk", [(1024, 1, 1024), (30_000, 1, 512),
                                    (20_000, 1, 2)])
def test_shapes_the_kernel_cannot_take_raise_before_launching(k, n, bk):
    """A K block over 512 rows, or a tile past the budget, raises in the
    CUDA wrapper's checks, before any device is touched (the plain
    version still runs on the CPU)."""
    plan = TK.launch_plan(k, 64, n, path="two_pass", block_k=bk)
    x = torch.empty((k, 64), device="meta")
    a = torch.empty((k, n), device="meta")
    with pytest.raises(ValueError, match="rows|shared memory"):
        TK.two_pass(x, a, plan)


def test_cached_tiles_of_another_kernel_are_not_used(tmp_path, monkeypatch):
    """A two-pass entry cached for the first kernel (bm = 64) or with a
    K block over 512 rows falls back to the heuristic; a two-pass entry
    this kernel takes, and any single-pass entry, still apply."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(path))
    monkeypatch.setattr(tuning, "_CACHE", {})
    monkeypatch.setattr(tuning, "_persistent_loaded", False)
    dev = tuning.device_name()
    entries = [
        {"k": 512, "m": 256, "n": 1, "dtype": "float32", "device": dev,
         "block_m": 64, "block_k": 512, "path": "two_pass"},
        {"k": 512, "m": 1024, "n": 1, "dtype": "float32", "device": dev,
         "block_m": 4, "block_k": 256, "path": "two_pass"},
        {"k": 2048, "m": 1024, "n": 1, "dtype": "float32", "device": dev,
         "block_m": 8, "block_k": 1024, "path": None},
        {"k": 32, "m": 4096, "n": 32, "dtype": "float32", "device": dev,
         "block_m": 96, "block_k": None, "path": None}]
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    assert tuning.get_choice(512, 256, 1) == tuning.TuneChoice(1, None)
    assert TK.launch_plan(512, 256, 1).block_m == 1
    assert tuning.get_choice(512, 1024, 1) == tuning.TuneChoice(
        4, 256, "two_pass")
    assert TK.launch_plan(512, 1024, 1).num_k_blocks == 2
    assert tuning.get_choice(2048, 1024, 1) == tuning.TuneChoice(
        *tuning.heuristic_blocks(2048, 1024, 1))
    assert tuning.get_choice(32, 4096, 32) == tuning.TuneChoice(96, None)
