"""The port's launch plan, tuner and engine (CPU).

Launch-plan invariants are those ``repro.analysis.contracts`` checks in
the reference, restated for Hopper: input traffic does not depend on N,
every x element is read once, per-block stats never reach HBM, and every
plan the heuristic and ``auto_path`` pick fits a block's 232,448 B of
shared memory.
"""

import json
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import mm_aggregate as TK
from repro_torch.kernels import ops, ref, tuning

BUDGET = 232_448
GRID = ([(k, n) for k in (2, 3, 8, 32, 33, 64) for n in (1, 5, 32, 64)]
        + [(k, n) for k in (65, 128, 300, 301, 512, 1024, 2048)
           for n in (1, 2, 8)] + [(4096, 1), (4096, 2)])


@pytest.mark.parametrize("m", [7, 300, 10 ** 6, 751_894_528])
def test_every_auto_plan_fits_shared_memory(m):
    for k, n in GRID:
        plan = TK.launch_plan(k, m, n)
        assert plan.smem_bytes <= BUDGET, (k, n, m, plan)
        assert plan.grid[0] < 2 ** 31 - 1
        assert plan.path == TK.auto_path(k, n)
        if plan.path == "single":
            assert plan.block_m % 32 == 0
        else:
            assert plan.block_m in TK.two_pass_block_ms(k, plan.block_k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["single", "two_pass"])
def test_input_traffic_is_n_free_and_reads_each_element_once(dtype, path):
    k, m = (32, 1000) if path == "single" else (512, 1000)
    itemsize = torch.empty((), dtype=dtype).element_size()
    block_m = 32 if path == "single" else 8
    plans = [TK.launch_plan(k, m, n, dtype=dtype, path=path, block_m=block_m)
             for n in (1, 2, 4)]
    assert len({p.input_bytes for p in plans}) == 1
    assert len({p.input_block_fetches for p in plans}) == 1
    for p, n in zip(plans, (1, 2, 4)):
        assert p.input_bytes == k * m * itemsize         # each x read once
        assert p.output_bytes == n * m * itemsize
        # stats live in shared memory: not part of the HBM traffic
        assert p.total_bytes == p.input_bytes + p.weight_bytes + p.output_bytes
        if path == "two_pass":
            assert 0 < p.stats_bytes <= p.smem_bytes


def test_two_pass_reads_x_once_at_k_2048():
    """K = 2048 (four 512-row blocks) keeps every column's whole tile on
    chip: x is read from HBM once, one (bk, bm) block fetch per K block
    and column tile, whatever the IRLS depth."""
    plan = TK.launch_plan(2048, 1024, 1, path="two_pass", block_k=512)
    assert plan.smem_bytes <= BUDGET and plan.num_k_blocks == 4
    assert plan.input_bytes == 2048 * 1024 * 4
    assert plan.input_block_fetches == plan.grid[0] * 4


def test_crossover_follows_the_shared_memory_limit():
    """The crossover is the card's sweep, not the single-pass tile's
    shared memory (which still fits 128 columns up to K = 301 at N = 1):
    from 65 agents the two-pass kernel, at every M, except up to the K
    where the smem variant stayed faster at that N."""
    assert TK.single_pass_smem_bytes(301, 1, 128) <= BUDGET
    for n, last_single in ((1, 68), (8, 80), (32, 112)):
        assert TK.auto_path(64, n) == "single"
        assert TK.auto_path(last_single, n) == "single"
        for k in (last_single + 1, 128, 300, 301, 302, 512):  # 512: the
            assert TK.auto_path(k, n) == "two_pass", (k, n)   # large cohort
    for m in (7, 256, 10 ** 7):
        assert TK.launch_plan(128, m, 1).path == "two_pass"
        assert TK.launch_plan(512, m, 1).path == "two_pass"
    # K=1024: two 512-row blocks, 8 columns a block
    plan = TK.launch_plan(1024, 4096, 1, path="two_pass")
    assert plan.block_k == 512 and plan.num_k_blocks == 2
    assert plan.block_m == 8 and plan.smem_bytes <= BUDGET


def test_plan_validation():
    with pytest.raises(ValueError, match="unknown kernel path"):
        TK.launch_plan(8, 10, path="nope")
    with pytest.raises(ValueError, match="power of two"):
        TK.launch_plan(100, 10, path="two_pass", block_k=48)


def test_wrappers_launch_or_raise_off_the_cpu():
    # meta tensors (the dry run) get the estimate's shape, computed by
    # nothing; any other device that is not the card is refused
    x = torch.empty((4, 10), device="meta")
    a = torch.empty((4, 1), device="meta")
    plan = TK.launch_plan(4, 10, 1)
    other = types.SimpleNamespace(shape=(4, 10), dtype=torch.float32,
                                  device=torch.device("xpu"))
    for run in (TK.single_pass, TK.two_pass):
        out = run(x, a, plan)
        assert out.device.type == "meta" and tuple(out.shape) == (1, 10)
        with pytest.raises(ValueError, match="CUDA"):
            run(other, a, plan)


def _tree(seed=0):
    rng = np.random.default_rng(seed)

    def leaf(shape, dtype=torch.float32):
        v = rng.normal(size=(6,) + shape).astype(np.float32)
        v[-1] += 1000.0
        return torch.from_numpy(v).to(dtype)

    return {"w": leaf((5, 7)), "b": leaf((3,), torch.bfloat16),
            "s": leaf(()), "blocks": [leaf((2, 2, 3)), leaf((4,))]}


def test_tree_path_is_one_launch_equal_to_per_leaf(monkeypatch):
    calls = []
    real = TK.single_pass

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(TK, "single_pass", counting)
    tree = _tree()
    eng = ops.AggregationEngine()
    with ops.record_workloads() as records:
        out = eng.aggregate_tree(tree)
    assert calls == [(6, 35 + 3 + 1 + 12 + 4)]            # ONE launch
    assert records == [{"k": 6, "m": 55, "n": 1, "dtype": "float32",
                        "backend": "pallas", "block_m": 64, "block_k": 6,
                        "path": "single"}]
    for name in ("w", "b", "s"):
        want = eng.aggregate(tree[name].float()).to(tree[name].dtype)
        assert out[name].dtype == tree[name].dtype
        assert out[name].shape == tree[name].shape[1:]
        torch.testing.assert_close(out[name], want, atol=1e-6, rtol=0)
    for got, leaf in zip(out["blocks"], tree["blocks"]):
        torch.testing.assert_close(got, eng.aggregate(leaf), atol=1e-6, rtol=0)


def test_backends_agree_on_batched_and_oracle():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(12, 9, 11)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.1, 1, size=(12, 4)).astype(np.float32))
    k_out = ops.mm_aggregate_batched(x, a)
    j_out = ops.mm_aggregate_batched(x, a, backend="jnp")
    assert k_out.shape == (4, 9, 11)
    # the kernel crosses 1/2 with no epsilon, the oracle at 1/2 - 1e-12:
    # on random weights the two agree
    torch.testing.assert_close(k_out, j_out, atol=1e-5, rtol=0)
    torch.testing.assert_close(
        j_out.reshape(4, -1), ref.mm_aggregate_batched_ref(x.reshape(12, -1), a),
        atol=1e-6, rtol=0)
    torch.testing.assert_close(ops.mm_aggregate(x), ref.mm_aggregate_ref(x),
                               atol=1e-5, rtol=0)


def test_record_workloads_scopes_nest_and_dedupe():
    x = torch.randn(5, 40)
    with ops.record_workloads() as outer:
        with ops.record_workloads() as inner:
            ops.mm_aggregate(x)
            ops.mm_aggregate(x)
        ops.mm_aggregate(x, backend="jnp")
    assert len(inner) == 1 and inner[0]["path"] == "single"
    assert len(outer) == 2 and outer[1]["backend"] == "jnp"


def test_engine_validates_its_options():
    with pytest.raises(ValueError, match="backend"):
        ops.AggregationEngine(backend="xla")
    with pytest.raises(ValueError, match="path"):
        ops.AggregationEngine(path="three_pass")


def test_tuning_cache_persists_per_device(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tuning.ENV_CACHE_PATH, str(path))
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tpu.json"))
    monkeypatch.setattr(tuning, "_CACHE", {})
    monkeypatch.setattr(tuning, "_persistent_loaded", False)
    tuning.set_blocks(32, 4096, 32, torch.float32, (64, None, "single"))
    assert tuning.save_cache() == str(path)
    entries = json.loads(path.read_text())["entries"]
    assert entries[0]["device"] == tuning.device_name()
    assert not (tmp_path / "tpu.json").exists()
    # another card's entry never applies here
    entries.append(dict(entries[0], device="another card", m=8192,
                        block_m=224))
    path.write_text(json.dumps({"version": 1, "entries": entries}))
    tuning.clear_cache()
    monkeypatch.setattr(tuning, "_persistent_loaded", False)
    assert tuning.get_choice(32, 4096, 32) == tuning.TuneChoice(64, None,
                                                                "single")
    assert TK.launch_plan(32, 4096, 32).block_m == 64
    assert tuning.get_choice(32, 8192, 32) == tuning.TuneChoice(
        *tuning.heuristic_blocks(32, 8192, 32))
    path.write_text("{not json")
    tuning.clear_cache()
    assert tuning.load_cache() == 0
