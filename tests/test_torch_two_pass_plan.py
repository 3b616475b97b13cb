"""The two-pass kernel's launch plan and tile choice (CPU): the block of
columns the heuristic picks (one K block: a power of two up to 256 /
lanes, a group of lanes a column; several: 1, 2, 4 or 8, a warp a
column), what the plan refuses, and tuning-cache entries written for
another kernel."""

import json

import pytest
import torch

from repro_torch.kernels import mm_aggregate as TK
from repro_torch.kernels import tuning

BUDGET = 232_448


@pytest.mark.parametrize("k,m,n,block_m", [
    (512, 15_730_944, 1, 16),   # the layer-wide cohort: 16 lanes a column
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


@pytest.mark.parametrize("k,block_k,block_m", [
    (512, None, 0), (512, None, 3), (512, None, 32), (128, None, 128),
    (128, None, 48), (1024, 512, 16), (2048, 32, 64)])
def test_two_pass_block_m_must_be_a_block_of_warps(k, block_k, block_m):
    """One K block takes a power of two of columns up to 256 / lanes (16
    at bk 512, 32 at 128); several K blocks, a warp a column, at most
    8."""
    with pytest.raises(ValueError, match="block_m"):
        TK.launch_plan(k, 1000, 1, path="two_pass", block_k=block_k,
                       block_m=block_m)


@pytest.mark.parametrize("k,m,block_m", [
    (128, 15_730_944, 32),      # the serve cohort's layer: 256 threads
    (128, 4224, 32),            # 132 tiles of 32
    (128, 4192, 16),            # 131 of 32: narrower blocks fill the card
    (128, 256, 1),              # the large-cohort sweep's M
    (69, 2 ** 20, 32), (100, 65_536, 32), (40, 2 ** 20, 64),
    (256, 65_536, 32), (256, 8192, 32), (256, 4096, 16),
    (301, 65_536, 16), (512, 4096, 16), (512, 2112, 16), (512, 2096, 8)])
def test_one_k_block_takes_the_widest_group_block_that_fills_the_card(
        k, m, block_m):
    """One K block: every power of two up to 256 / lanes columns a block
    (16 rows a lane up to bk = 128, 32 above), the widest with one tile
    per SM, from bm 1 at M = 256 to the widest block at 15.7 M columns."""
    plan = TK.launch_plan(k, m, 1, path="two_pass")
    assert plan.num_k_blocks == 1 and plan.block_m == block_m
    bk = plan.block_k
    rows, lanes = TK.two_pass_rows(bk), TK.two_pass_lanes(bk)
    assert rows * lanes == max(bk, rows) and rows == (16 if bk <= 128 else 32)
    assert TK.two_pass_block_ms(k, bk)[0] == 256 // lanes
    assert -(-m // block_m) >= TK.TWO_PASS_MIN_TILES or block_m == 1
    call = TK.kernel_call(plan, k=k, m=m)
    assert call.instantiation == f"mm_two_pass<{rows}, true, float, {lanes}>"
    assert call.threads == max(32, block_m * lanes) <= 256


@pytest.mark.parametrize("n", [1, 32, 256])
def test_every_one_k_block_fits_shared_memory(n):
    """Every K <= 512 at its default K block and every block of columns
    it takes, with the n_chunk the plan stages."""
    for k in range(2, 513):
        bk = TK.two_pass_block_k(k)
        for bm in TK.two_pass_block_ms(k, bk):
            nc = TK.two_pass_n_chunk(k, n, bk, bm)
            assert TK.two_pass_smem_bytes(k, nc, bk, bm) <= \
                TK.SMEM_BUDGET_BYTES, (k, n, bm)


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
