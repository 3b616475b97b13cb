"""``repro_torch.analysis.bench_audit`` on the CPU: a good agg,
large_cohort and serve record passes, each rule's mutation is caught
(two-pass taken below the crossover, the single pass kept above it, a
launch program captured again after warm-up, ...), the port's file names are
inferred, the CLI's exit codes; and the port's own benchmarks
(``agg_bench --smoke``, ``serve_bench``) pass their audits."""

import copy
import json

import pytest

from repro_torch.analysis import bench_audit
from repro_torch.benchmarks import agg_bench, serve_bench
from repro_torch.kernels import mm_aggregate as mk


@pytest.fixture(scope="module")
def agg_smoke():
    rows, audits, irls, sub = agg_bench.main(smoke=True, device="cpu")
    return rows, audits, irls, sub


@pytest.fixture(scope="module")
def agg_good(agg_smoke, tmp_path_factory):
    path = tmp_path_factory.mktemp("agg") / "BENCH_agg_torch.json"
    agg_bench.write_json(str(path), *agg_smoke, smoke=True, device="cpu")
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def serve_good():
    rows = serve_bench.run(("clean", "mixed"), rounds=12, device="cpu")
    return {"bench": "serve", "rows": rows}


def _cohort_row(k, m=256, n=1, path=None, name=None):
    plan = mk.launch_plan(k, m, n, path=path)
    d = plan._asdict()
    d["grid"] = list(d["grid"])
    return {"name": name or f"K{k}", "launch_audit": d}


def test_agg_smoke_passes_its_audit(agg_smoke, agg_good):
    rows, audits, irls, sub = agg_smoke
    assert bench_audit.audit_agg(agg_good) == []
    assert agg_good["mode"] == "smoke" and agg_good["device"] == "cpu"
    names = [r[0] for r in rows]
    assert "agg/mm_pallas/K8_M4096" in names                # launched rows
    assert not any("interp" in n for n in names)
    tree = [r for r in rows if r[0].startswith("agg/engine_tree_weighted")]
    assert tree and all(r[4] == 1 for r in tree)            # ONE launch
    assert [a["path"] for a in audits] == ["single", "two_pass"]
    assert all("smem_bytes" in a and "vmem_bytes" not in a for a in audits)
    assert audits[1]["single_pass_smem_overflow"] is False  # K=256, N=32
    assert [r["num_iters"] for r in irls] == list(agg_bench.IRLS_DEPTHS)
    assert sub["backend"] == "jnp" and sub["peak_bytes"] is None


def test_agg_audit_catches_each_rule(agg_good):
    b = copy.deepcopy(agg_good)
    b["traffic_audit"] = [a for a in b["traffic_audit"]
                          if a["path"] == "single"]
    b["traffic_audit"][0]["n_independent"] = False
    b["rows"] = [r for r in b["rows"] if "two_pass" not in r["name"]]
    b["irls_sweep"] = []
    joined = "\n".join(bench_audit.audit_agg(b))
    for want in ("paths incomplete", "N-dependent", "K=256", "IRLS"):
        assert want in joined
    b = copy.deepcopy(agg_good)
    two = next(a for a in b["traffic_audit"] if a["path"] == "two_pass")
    two["smem_bytes"] = mk.SMEM_BUDGET_BYTES + 1
    assert any("shared memory" in e for e in bench_audit.audit_agg(b))


def test_large_cohort_audit_good_and_mutations():
    good = {"rows": [_cohort_row(512), _cohort_row(256), _cohort_row(12)]}
    assert [r["launch_audit"]["path"] for r in good["rows"]] == \
        ["two_pass", "two_pass", "single"]
    assert bench_audit.audit_large_cohort(good) == []
    assert bench_audit.audit_large_cohort({"rows": [_cohort_row(64)]}) == \
        ["no two-pass scenario in the large-cohort family"]
    # two-pass taken just below the crossover
    assert mk.auto_path(64, 1) == "single"
    early = _cohort_row(64, path="two_pass")
    errs = bench_audit.audit_large_cohort({"rows": good["rows"] + [early]})
    assert len(errs) == 1 and "auto_path takes single" in errs[0]
    # the single pass kept above it, at the 128-client cohort
    assert mk.auto_path(128, 1) == "two_pass"
    late = _cohort_row(128, path="single")
    errs = bench_audit.audit_large_cohort({"rows": good["rows"] + [late]})
    assert len(errs) == 1 and "auto_path takes two_pass" in errs[0]
    over = copy.deepcopy(good)
    over["rows"][0]["launch_audit"]["smem_bytes"] = mk.SMEM_BUDGET_BYTES + 1
    assert any("over 232448" in e
               for e in bench_audit.audit_large_cohort(over))
    # a multi-layout audit is read layout by layout
    layouts = {"rows": [{"name": "sub", "launch_audit": {
        "layouts": [good["rows"][0]["launch_audit"],
                    early["launch_audit"]], "n_layouts": 2}}]}
    assert len(bench_audit.audit_large_cohort(layouts)) == 1


def test_large_cohort_sweep_passes_its_audit(tmp_path):
    from repro_torch.examples import scenario_sweep
    path = tmp_path / "BENCH_large_cohort_torch.json"
    assert scenario_sweep.main(["--family", "large_cohort", "--smoke",
                                "--steps", "1", "--json", str(path),
                                "--device", "cpu"]) == 0
    assert bench_audit.audit_file(path) == []


def test_serve_bench_passes_its_audit(serve_good):
    rows = serve_good["rows"]
    assert [r["profile"] for r in rows] == ["clean", "mixed"]
    assert bench_audit.audit_serve(serve_good) == []


@pytest.mark.parametrize("mutate, want", [
    (lambda r: r.update(post_warmup_cache_hit=False, post_warmup_misses=1),
     "captured again after warm-up"),
    (lambda r: r.update(latency_p99=float("nan")), "latency_p99 non-finite"),
    (lambda r: r.update(broke_down=True), "broke out of the scenario band"),
    (lambda r: r.update(updates_per_sec=0.0), "zero sustained throughput"),
    (lambda r: r.update(rounds_completed=0), "no committed rounds"),
    (lambda r: r.update(queue_depth_max=10 ** 6), "unbounded queue depth"),
    (lambda r: r.pop("queue_depth_max"), "missing transport queue-depth"),
    (lambda r: r.update(channel_capacity=None), "without a channel capacity"),
    (lambda r: r.update(duplicate_admissions=2), "duplicate admission"),
])
def test_serve_audit_catches_each_row_rule(serve_good, mutate, want):
    b = copy.deepcopy(serve_good)
    mutate(b["rows"][0])
    assert any(want in e for e in bench_audit.audit_serve(b)), want


def test_serve_audit_catches_each_bench_rule(serve_good):
    clean, mixed = serve_good["rows"]
    assert "no chaos profile row" in "\n".join(
        bench_audit.audit_serve({"rows": [clean]}))
    assert "no clean (fault-free) profile row" in \
        bench_audit.audit_serve({"rows": [mixed]})
    lost = copy.deepcopy(mixed)
    lost["recoveries"].pop("crash")
    joined = "\n".join(bench_audit.audit_serve({"rows": [clean, lost]}))
    assert "'crash' shows no recovery" in joined
    assert "zero crash recoveries" in joined
    single = copy.deepcopy(mixed)
    single["tenants"] = 1
    assert any("multi-tenant" in e for e in
               bench_audit.audit_serve({"rows": [clean, single]}))
    assert bench_audit.audit_serve({"rows": []}) == ["no serve rows"]


def test_infer_kind_and_cli(tmp_path, capsys, agg_good):
    for name, kind in (("BENCH_agg_torch.json", "agg"),
                       ("BENCH_large_cohort_torch.json", "large_cohort"),
                       ("BENCH_serve_torch.json", "serve"),
                       ("BENCH_agg.json", "agg")):
        assert bench_audit.infer_kind(tmp_path / name) == kind
    with pytest.raises(ValueError, match="cannot infer"):
        bench_audit.infer_kind("BENCH_other.json")
    good = tmp_path / "BENCH_agg_torch.json"
    good.write_text(json.dumps(agg_good))
    assert bench_audit.main([str(good)]) == 0
    assert "audit ok" in capsys.readouterr().out
    bad = tmp_path / "BENCH_large_cohort_torch.json"
    bad.write_text(json.dumps({"rows": []}))
    assert bench_audit.main([str(good), str(bad)]) == 1
    out = capsys.readouterr().out
    assert "audit ok" in out and "FAIL" in out and "no two-pass" in out
    other = tmp_path / "numbers.json"
    other.write_text(json.dumps(agg_good))
    assert bench_audit.main([str(other), "--kind", "agg"]) == 0
