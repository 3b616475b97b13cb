"""The port's benchmarks (``repro_torch.benchmarks``) against the
reference's (``benchmarks/*.py``) on the CPU.

The same inputs go through both: the modeled traffic over a grid, the
IRLS-depth sweep on one numpy input (the reference's kernel in interpret
mode), Fig. 1's harness on the same fixed histories (row names, derived
values, claim verdicts and CSV bytes), the roofline's model flops for
every (arch, shape) pair.  Then the port alone: one short Fig. 1 run per
aggregator inside the paper's bands, the roofline's terms on a synthetic
dry-run record, the run.py CSV with its ERROR row, and the API the
figure needs (``grad_fn``, ``msd_stack``, ``cache_size``).
"""

import importlib.util
import itertools
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import diffusion as rdiff
from repro.data import synthetic as rsyn
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels import tuning as rtuning
from repro.scenarios import metrics as rmetrics
from repro_torch.benchmarks import agg_bench, fig1_msd, kernel_bench
from repro_torch.benchmarks import roofline, run
from repro_torch.configs import paper_lsq
from repro_torch.core import diffusion as tdiff
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import tuning as ttuning
from repro_torch.scenarios import metrics as tmetrics

BENCHMARKS = pathlib.Path(__file__).resolve().parents[1] / "benchmarks"


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_bench_{name}", BENCHMARKS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod        # its dataclasses resolve through it
    spec.loader.exec_module(mod)
    return mod


def test_modeled_hbm_bytes_matches_reference():
    ref = _reference("kernel_bench")
    grid = itertools.product((1, 16, 33, 512), (1, 130, 1 << 15), (1, 8, 32),
                             (True, False), (True, False))
    for k, m, n, fused, one in grid:
        assert kernel_bench.modeled_hbm_bytes(k, m, fused, n, one) == \
            ref.modeled_hbm_bytes(k, m, fused, n, one), (k, m, n, fused, one)


def test_irls_sweep_matches_reference():
    """msd_vs_oracle at T = 3, 5, 10 on one (8, 4096) input with a
    contaminated quarter, within rtol 1e-4 of the reference's kernel
    (interpret mode) against its T = 50 oracle.  T = 10 sits at the f32
    floor (the estimates agree to a few ulps, msd ~1e-16), so 1e-14,
    the square of ~1e-7 (an ulp of values near 1), is added absolutely."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 4096)).astype(np.float32)
    x[-2:] += 100.0
    conv = rref.mm_aggregate_ref(jnp.asarray(x), num_iters=50)
    got = agg_bench.irls_sweep(torch.from_numpy(x), depths=(3, 5, 10), reps=1)
    assert [r["num_iters"] for r in got] == [3, 5, 10]
    for row in got:
        out = rops.mm_aggregate(jnp.asarray(x), interpret=True,
                                num_iters=row["num_iters"])
        want = float(jnp.mean((out - conv) ** 2))
        np.testing.assert_allclose(row["msd_vs_oracle"], want, rtol=1e-4,
                                   atol=1e-14)
        assert row["shape"] == "K8_M4096"


def _fake_history(agg, n_mal, delta, iters):
    """A fixed MSD history per setting: mean grows with the attack, the
    median sits 1.5x above the clean mean, the MM estimator near it."""
    base = {"mean": 1e-4, "median": 1.5e-4, "mm_tukey": 1.1e-4}[agg]
    level = base * (1.0 + (delta * n_mal if agg == "mean" else n_mal / 100))
    return level * (1.0 + np.exp(-np.arange(iters, dtype=np.float64) / 7))


def test_fig1_harness_matches_reference(tmp_path, monkeypatch):
    ref = _reference("fig1_msd")

    def fake_run(agg, n_mal, delta, iters, seed=0, device=None):
        return _fake_history(agg, n_mal, delta, iters)

    def fake_diffusion(*, config, num_iters, **_):
        byz = config.byzantine
        delta = dict(byz.attack_kwargs).get("delta", 0.0)
        return None, _fake_history("mm_tukey", byz.num_malicious, delta,
                                   num_iters)

    monkeypatch.setattr(ref, "_run", fake_run)
    monkeypatch.setattr(fig1_msd, "_run", fake_run)
    monkeypatch.setattr(rdiff, "run_diffusion", fake_diffusion)
    monkeypatch.setattr(tdiff, "run_diffusion", fake_diffusion)
    want = ref.main(iters=40, out_dir=str(tmp_path / "ref"))
    got = fig1_msd.main(iters=40, out_dir=str(tmp_path / "port"),
                        device="cpu")
    assert [r[0] for r in got] == [r[0] for r in want]
    assert [r[2] for r in got] == [r[2] for r in want]
    claims = [r for r in got if r[0].startswith("fig1/claim")]
    assert len(claims) == 3 and all(r[2] == 1.0 for r in claims)
    for name in ("fig1_left.csv", "fig1_right.csv"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()


def test_fig1_claims_fail_on_a_broken_estimator():
    s = {"fig1_left/mean/delta=1000": 1.0, "fig1_left/mean/delta=0": 1e-4,
         "fig1_right/median/mal=1": 1e-3, "fig1_left/median/delta=0": 2e-4,
         "fig1_left/mm_tukey/delta=1000": 1e-4,
         "fig1_left/mm_tukey/delta=0": 1.1e-4,
         "fig1_right/mm_tukey/mal=11": 1e-3}
    assert all(fig1_msd.claims(s).values())
    # C3's clean-efficiency clause on the median of the seeds' ratios
    c3 = "fig1/claim_C3_ref_robust_and_efficient"
    assert fig1_msd.claims(s, [1.26, 1.0, 0.87, 1.08])[c3]
    assert not fig1_msd.claims(s, [1.26, 1.3, 0.87, 1.28])[c3]
    s["fig1_left/mm_tukey/delta=0"] = 1.3e-4        # 1.3x the mean's
    assert not fig1_msd.claims(s)[c3]
    s["fig1_left/mm_tukey/delta=0"] = 1.1e-4
    s["fig1_right/mm_tukey/mal=11"] = 1.0           # broke down at 11/32
    verdicts = fig1_msd.claims(s, [1.0] * 4)
    assert not verdicts[c3]
    assert verdicts["fig1/claim_C1_mean_breakdown"]


def test_fig1_clean_ratios_take_seed_0_from_the_rows(monkeypatch):
    seen = []

    def fake_run(agg, n_mal, delta, iters, seed=0, device=None):
        seen.append((agg, n_mal, delta, iters, seed))
        return np.full(iters, 2.0 if agg == "mm_tukey" else 1.0)

    monkeypatch.setattr(fig1_msd, "_run", fake_run)
    s = {"fig1_left/mm_tukey/delta=0": 3.0, "fig1_left/mean/delta=0": 2.0}
    assert fig1_msd.clean_ratios(10, s, device="cpu") == [1.5, 2.0, 2.0, 2.0]
    assert [x[-1] for x in seen] == [1, 1, 2, 2, 3, 3]
    assert {x[:4] for x in seen} == {("mm_tukey", 0, 0.0, 10),
                                     ("mean", 0, 0.0, 10)}


@pytest.mark.parametrize("agg", fig1_msd.AGGS)
def test_fig1_short_run_in_the_papers_bands(agg):
    """One attacker at delta = 1000, 300 iterations: the mean breaks
    down, the median and the MM estimator stay under 1e-2 (C1-C3's
    attacked bands)."""
    h = fig1_msd._run(agg, 1, 1000.0, 300, device="cpu")
    assert h.shape == (300,) and np.isfinite(h).all()
    if agg == "mean":
        assert fig1_msd.steady(h) > 1e3
    else:
        assert fig1_msd.steady(h) < 1e-2


def test_grad_fn_matches_reference():
    """Both packages' Eq. 33 gradient of the same (u, v) draws: each
    package's output equals -u (u^T w* + v - u^T w) on the draws its own
    stream made (u (K, M) first, then v (K,)), and the port's draws are
    make_stacked_grad_fn's."""
    w = np.random.default_rng(0).normal(size=(6, 10)).astype(np.float32)
    rprob, tprob = rsyn.LinearModelProblem(), tsyn.LinearModelProblem()
    np.testing.assert_array_equal(np.asarray(rprob.w_star),
                                  tprob.w_star("cpu").numpy())
    sigma = np.sqrt(rprob.noise_var)

    def eq33(u, v):
        return -u * (u @ np.asarray(rprob.w_star) + v
                     - np.sum(u * w, axis=1))[:, None]

    key = jax.random.key(5)
    ku, kv = jax.random.split(key)
    u = np.asarray(jax.random.normal(ku, (6, 10)))
    v = sigma * np.asarray(jax.random.normal(kv, (6,)))
    np.testing.assert_allclose(np.asarray(rprob.grad_fn()(jnp.asarray(w), key)),
                               eq33(u, v), rtol=1e-5, atol=1e-6)
    g = torch.Generator().manual_seed(5)
    got = tprob.grad_fn("cpu")(torch.from_numpy(w), g).numpy()
    g.manual_seed(5)
    u = torch.randn((6, 10), generator=g).numpy()
    v = sigma * torch.randn((6,), generator=g).numpy()
    np.testing.assert_allclose(got, eq33(u, v), rtol=1e-5, atol=1e-6)
    stacked = tsyn.make_stacked_grad_fn(tprob, 6, device="cpu")
    np.testing.assert_array_equal(
        stacked(torch.from_numpy(w), torch.Generator().manual_seed(5)).numpy(),
        got)


def test_msd_stack_matches_reference():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(7, 10)).astype(np.float32)
    w_star = rng.normal(size=(10,)).astype(np.float32)
    benign = np.arange(7) < 5
    assert tmetrics.msd_stack is tdiff.msd
    want = rmetrics.msd_stack(jnp.asarray(w), jnp.asarray(w_star),
                              jnp.asarray(benign))
    got = tmetrics.msd_stack(torch.from_numpy(w), torch.from_numpy(w_star),
                             torch.from_numpy(benign))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cache_size_matches_reference():
    rtuning.clear_cache()
    ttuning.clear_cache()
    try:
        assert ttuning.cache_size() == rtuning.cache_size() == 0
        for k, m in ((8, 512), (16, 4096), (300, 1024)):
            rtuning.set_blocks(k, m, 1, jnp.float32, (128, None))
            ttuning.set_blocks(k, m, 1, torch.float32, (128, None))
            assert ttuning.cache_size() == rtuning.cache_size()
        ttuning.set_blocks(8, 512, 1, torch.float32, (64, None))   # again
        assert ttuning.cache_size() == 3
    finally:
        rtuning.clear_cache()
        ttuning.clear_cache()


def test_roofline_model_flops_matches_reference():
    ref = _reference("roofline")
    from repro_torch import configs
    pairs = [(a, s) for a in configs.ARCH_IDS for s in configs.INPUT_SHAPES]
    assert len(pairs) == 40
    for arch, shape in pairs:
        assert roofline.model_flops(arch, shape) == \
            ref.analytic_terms(arch, shape).model_flops, (arch, shape)


def _record(**over):
    rec = {"arch": "qwen3_0p6b", "shape": "train_4k", "mesh": "16",
           "ranks": 16, "aggregation": "rs_mm",
           "flops_per_rank": 3 * 10 ** 14,
           "bytes_accessed_per_rank": 2 * 10 ** 12,
           "collectives": {"all_gather": {"count": 3, "bytes": 9 * 10 ** 9},
                           "all_to_all": {"count": 1, "bytes": 10 ** 9}},
           "memory": {"live_peak_bytes": 90 * 10 ** 9}}
    rec.update(over)
    return rec


def test_roofline_terms_are_counts_over_h100_constants(tmp_path):
    t = roofline.terms(_record())
    assert t.compute == 3e14 / 989e12
    assert t.memory == 2e12 / 3.35e12
    assert t.collective == 1e10 / 450e9
    assert t.dominant == "memory" and t.total == t.memory
    assert not t.fits                                 # 90 GB > 80 GB
    assert t.model_flops == roofline.model_flops("qwen3_0p6b", "train_4k")
    assert t.useful_ratio == t.model_flops / 16 / 3e14
    assert roofline.terms(_record(flops_per_rank=10 ** 16)).dominant \
        == "compute"
    assert roofline.terms(_record(collectives={})).collective == 0.0
    # records on disk -> CSV rows and the markdown table
    recs = tmp_path / "dry"
    recs.mkdir()
    for shape in ("train_4k", "decode_32k"):
        (recs / f"qwen3_0p6b_{shape}_16.json").write_text(
            json.dumps(_record(shape=shape)))
    (recs / "qwen3_0p6b_train_4k_2x16.json").write_text(
        json.dumps(_record(mesh="2x16")))             # another mesh
    md = tmp_path / "torch" / "roofline.md"
    rows = roofline.main(str(recs), str(md))
    assert [r[0] for r in rows] == ["roofline/qwen3_0p6b/train_4k/16",
                                    "roofline/qwen3_0p6b/decode_32k/16"]
    assert rows[0][1] == t.total * 1e6 and rows[0][2] == "dom=memory"
    text = md.read_text()
    assert "| qwen3_0p6b | train_4k |" in text and "Not traced (38)" in text
    assert "197e12" not in text and "v5e" not in text


def test_run_prints_rows_and_an_error_row(monkeypatch, capsys):
    def broken():
        raise RuntimeError("suite failed")

    monkeypatch.setattr(run, "suites", lambda wanted, **kw: [
        ("kernel", lambda: [("kernel/x/K8_M16", 1.5, 4096, {"e": 0})]),
        ("roofline", broken),
        ("fig1", lambda: [("fig1/claim_C1_mean_breakdown", 0.0, 1.0)])])
    assert run.main(["--only", "kernel,roofline,fig1", "--device", "cpu"]) \
        == 1
    out = capsys.readouterr().out.splitlines()
    assert out == ["name,us_per_call,derived", "kernel/x/K8_M16,1.50,4096",
                   "roofline,ERROR,see-stderr",
                   "fig1/claim_C1_mean_breakdown,0.00,1.0"]
    with pytest.raises(SystemExit):
        run.main(["--only", "nope"])


def test_run_suites_in_order():
    names = [n for n, _ in run.suites({"roofline", "kernel", "agg", "fig1"},
                                      device="cpu")]
    assert names == list(run.SUITES)


def test_paper_config_is_the_figures():
    assert (paper_lsq.NUM_AGENTS, paper_lsq.DIM, paper_lsq.NUM_ITERS) == \
        (32, 10, 1000)
    assert len(paper_lsq.DELTA_GRID) + len(paper_lsq.RATE_GRID) == 10


def test_substrate_full_config_builds_the_published_model(monkeypatch):
    """agg_bench's full substrate row: ``full_config`` takes the arch's
    published config, its absence the smoke config."""
    from repro_torch import configs, scenarios
    from repro_torch.scenarios import substrate

    class Built(Exception):
        pass

    def init_model(cfg, **_):
        raise Built(cfg)

    monkeypatch.setattr(substrate.M, "init_model", init_model)
    for full, want in ((True, configs.load_arch("qwen3-0.6b").model),
                       (False, configs.load_smoke("qwen3-0.6b"))):
        sp = scenarios.ScenarioSpec(
            paradigm="substrate", model_config="qwen3-0.6b",
            aggregator="mm_tukey", num_agents=8, num_malicious=1,
            paradigm_kwargs=(("full_config", full),))
        with pytest.raises(Built) as got:
            substrate.build_lm_components(sp, torch.device("cpu"))
        assert got.value.args[0] == want
