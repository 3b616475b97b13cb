"""The port's analysis gate (``repro_torch.analysis``): findings and the
baseline against the reference's module case by case, the kernel
contracts on the default workloads and a mutation fixture per rule, the
launch audit clean and mutated, and the CLI's baseline workflow.

Every case here runs on the CPU; the C entry points' queries (``grid-
mismatch`` against the card, ``occupancy``) are fed synthesized query
dicts, and ``chip_smoke.py``'s ``contracts`` phase asks the card."""

import json
import pathlib
import types

import pytest
import torch

from repro_torch.analysis import contracts, launch_audit
from repro_torch.analysis import findings as F
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.kernels import launches
from repro_torch.kernels import mm_aggregate as mk
from repro_torch.kernels import ops

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO_ROOT / "ANALYSIS_BASELINE_TORCH.json"


# ===========================================================================
# findings + baseline: the reference's behaviour, case by case
# ===========================================================================

def _ref():
    from repro.analysis import findings as RF
    return RF


FINDING_CASES = (
    dict(rule="r", path="p", where="w", detail="d"),
    dict(rule="r", path="p", where="w", detail="d", ident="a"),
    dict(rule="one-residency", path="kernel", where="K8xM1024", detail="x",
         ident="refetch", line=12),
    dict(rule="r", path="src/x.py", where="f", detail="long detail", line=900),
)


@pytest.mark.parametrize("case", range(len(FINDING_CASES)))
def test_finding_matches_the_reference(case):
    kw = FINDING_CASES[case]
    got, want = F.Finding(**kw), _ref().Finding(**kw)
    assert got.key == want.key
    assert got.render() == want.render()
    assert got.render(reason="kept") == want.render(reason="kept")
    assert got.to_dict() == want.to_dict()
    assert F.Finding(**dict(kw, line=5)).key == got.key   # no line numbers


BASELINE_CASES = {
    "missing": None,
    "dict": {"findings": [{"key": "r:p:w", "reason": "why"}]},
    "list": [{"key": "r:p:w", "reason": "why"},
             {"key": "r:p:w:i", "reason": "because"}],
    "reasonless": {"findings": [{"key": "r:p:w"}]},
    "blank-reason": [{"key": "r:p:w", "reason": "   "}],
    "duplicate": [{"key": "k", "reason": "x"}, {"key": "k", "reason": "y"}],
    "bad-schema": {"findings": "oops"},
    "no-key": [{"reason": "x"}],
}


def _load(module, path):
    try:
        return ("ok", module.load_baseline(path))
    except module.BaselineError as exc:
        return ("error", str(exc))


@pytest.mark.parametrize("case", sorted(BASELINE_CASES))
def test_load_baseline_matches_the_reference(case, tmp_path):
    path = tmp_path / "b.json"
    if BASELINE_CASES[case] is not None:
        path.write_text(json.dumps(BASELINE_CASES[case]))
    assert _load(F, path) == _load(_ref(), path)


def test_apply_matches_the_reference():
    kw = [dict(rule="r", path="p", where="w", detail="d", ident=i)
          for i in ("a", "b", "c")]
    baseline = {"r:p:w:a": "intentional", "r:gone:w": "stale entry",
                "r:p:w:c": "also"}
    un, base, stale = F.apply([F.Finding(**k) for k in kw], baseline)
    run, rbase, rstale = _ref().apply([_ref().Finding(**k) for k in kw],
                                      baseline)
    assert [f.key for f in un] == [f.key for f in run] == ["r:p:w:b"]
    assert [(f.key, r) for f, r in base] == [(f.key, r) for f, r in rbase]
    assert stale == rstale == ["r:gone:w"]


# ===========================================================================
# kernel contracts: the real launches are clean (bar the reasoned baseline)
# ===========================================================================

def test_contracts_clean_on_default_workloads():
    baseline = F.load_baseline(BASELINE)
    un, base, stale = F.apply(contracts.check_workloads(on_card=False),
                              baseline)
    assert un == [], [f.render() for f in un]
    assert stale == []
    # every baselined finding is the warp variant's, with its reason
    assert base and all("/warp/" in f.where for f, _ in base)


@pytest.mark.parametrize("wl", contracts.DEFAULT_WORKLOADS[7:],
                         ids=lambda wl: f"K{wl[0]}xM{wl[1]}xN{wl[2]}")
def test_full_width_workloads_need_no_baseline(wl):
    assert contracts.check_workload(*wl) == []


@pytest.mark.parametrize("units,blocks,stride,want", [
    (10, 10, 10, (1, 1)), (10, 4, 4, (1, 1)), (10, 4, 2, (1, 2)),
    (10, 4, 6, (0, 1)), (2_936_896, 528, 528, (1, 1)),
    (2_936_896, 528, 264, (1, 2)), (3, 8, 8, (1, 1))])
def test_walk_visits_is_exact(units, blocks, stride, want):
    visits = [0] * units
    for b in range(blocks):
        for u in range(b, units, stride):
            visits[u] += 1
    if units <= 100_000:
        assert (min(visits), max(visits)) == want
    assert contracts.walk_visits(units, blocks, stride) == want


# ===========================================================================
# ...and each mutation fixture trips the rule built for it
# ===========================================================================

def _plan_and_call(k=1024, m=1024, n=4, path="two_pass"):
    # a two-pass plan with two K blocks and several column tiles, so a
    # walk or a tile can go wrong in more than one way
    plan = mk.launch_plan(k, m, n, block_m=4, block_k=512, path=path)
    assert plan.grid[0] > 1 and plan.num_k_blocks > 1
    return plan, mk.kernel_call(plan, k=k, m=m)


def _rules(findings):
    return {(f.rule, f.ident) for f in findings}


def test_clean_fixture_is_clean():
    plan, call = _plan_and_call()
    assert contracts.audit_call(plan, call) == []


def test_mutation_double_visited_tile():
    # the walk steps by half its blocks: every unit is visited twice
    plan, call = _plan_and_call()
    bad = call._replace(stride=call.units // 2)
    assert ("one-residency", "refetch") in _rules(
        contracts.audit_call(plan, bad))


def test_mutation_walk_leaves_tiles_unvisited():
    # 100 resident blocks stepping past each other: units 100.. unvisited
    plan, call = _plan_and_call()
    bad = call._replace(stride=call.units * 2)
    query = _query(call, per_sm=1, sms=100)
    assert query["blocks"] == 100 < call.units
    assert ("one-residency", "coverage") in _rules(
        contracts.audit_call(plan, bad, query=query))


def test_mutation_wrong_tile_shape():
    plan, call = _plan_and_call()
    bad = call._replace(tile=(plan.block_k * 2, plan.block_m))
    got = _rules(contracts.audit_call(plan, bad))
    assert ("one-residency", "block-shape") in got
    assert ("one-residency", "reload") in got


def test_mutation_model_disagrees_with_fetch_count():
    plan, call = _plan_and_call()
    lying = plan._replace(input_block_fetches=plan.input_block_fetches + 1)
    assert any(f.rule == "one-residency" and "fetches" in f.detail
               for f in contracts.audit_call(lying, call))


def test_mutation_model_disagrees_with_operand_bytes():
    plan, call = _plan_and_call()
    lying = plan._replace(input_bytes=plan.input_bytes // 2)
    assert ("one-residency", "bytes") in _rules(
        contracts.audit_call(lying, call))


def test_mutation_hbm_resident_stats():
    # the two-pass block stats surface as a fourth operand and a second
    # HBM output
    plan, call = _plan_and_call()
    stats = mk.Operand("stats", (plan.num_k_blocks, plan.n_out,
                                 plan.block_m), "float32")
    bad = call._replace(operands=call.operands + (stats,),
                        outputs=call.outputs + (stats,))
    got = _rules(contracts.audit_call(plan, bad))
    assert ("hbm-stats", "operands") in got
    assert ("hbm-stats", "stats-output") in got
    assert ("hbm-stats", "") in got          # >1 HBM output at all


def test_mutation_stats_outside_shared_memory():
    plan, call = _plan_and_call()
    lying = plan._replace(stats_bytes=plan.smem_bytes + 1)
    assert ("hbm-stats", "stats-smem") in _rules(
        contracts.audit_call(lying, call))


def test_mutation_inflated_smem():
    plan, call = _plan_and_call()
    bad = call._replace(smem=call.smem + 4 * plan.k_pad * plan.block_m)
    assert ("smem-model", "") in _rules(contracts.audit_call(plan, bad))


def test_mutation_plan_smem_off_its_model():
    plan, call = _plan_and_call()
    lying = plan._replace(smem_bytes=plan.smem_bytes + 4)
    got = _rules(contracts.audit_call(lying, call))
    assert ("smem-model", "plan-model") in got


def test_mutation_n_enters_the_grid():
    # a walk that grows with N: re-planning at 4N + 1 moves it
    plan, call = _plan_and_call()
    real = mk.kernel_call

    def leaky(p, **kw):
        c = real(p, **kw)
        return c._replace(loads=c.loads * p.n_out)

    bad = leaky(plan, k=1024, m=1024)
    mp = pytest.MonkeyPatch()
    mp.setattr(mk, "kernel_call", leaky)
    try:
        got = contracts.audit_call(plan._replace(
            input_block_fetches=bad.loads), bad)
    finally:
        mp.undo()
    assert ("n-independence", "") in _rules(got)


def test_mutation_grid_mismatch_short_circuits():
    plan, call = _plan_and_call()
    bad = call._replace(units=call.units + 1, smem=call.smem + 1)
    assert [f.rule for f in contracts.audit_call(plan, bad)] == \
        ["grid-mismatch"]


def _query(call, **over):
    q = {"instantiation": call.instantiation, "blocks": call.units,
         "threads": call.threads, "smem": call.smem, "per_sm": 4,
         "sms": 132, "smem_model": call.smem}
    q.update(over)
    if "blocks" not in over:
        q["blocks"] = call.blocks(q["per_sm"] * q["sms"])
    return q


def test_card_query_agreeing_is_clean():
    plan, call = _plan_and_call()
    assert contracts.audit_call(plan, call, query=_query(call)) == []


def test_mutation_card_query_disagrees_short_circuits():
    plan, call = _plan_and_call()
    for over in ({"threads": call.threads * 2}, {"smem": call.smem + 8},
                 {"instantiation": "mm_two_pass<8, true, float>"},
                 {"blocks": 1}):
        got = contracts.audit_call(plan, call, query=_query(call, **over))
        assert [(f.rule, f.ident) for f in got] == \
            [("grid-mismatch", "query")], over


def test_mutation_c_smem_model_disagrees():
    plan, call = _plan_and_call()
    got = contracts.audit_call(plan, call,
                               query=_query(call, smem_model=call.smem + 1))
    assert ("smem-model", "c-model") in _rules(got)


def test_mutation_no_resident_block():
    # the card holds no block of this size: the raw occupancy of 0 is a
    # finding, not a grid of one block an SM
    plan, call = _plan_and_call()
    got = contracts.audit_call(plan, call,
                               query=_query(call, per_sm=0, blocks=0))
    assert ("occupancy", "") in _rules(got)


def test_smem_budget_flags_avoidable_overflow_only():
    # K=48 at an absurd pinned smem tile: over the budget, but a narrower
    # tile fits -> avoidable -> flagged
    plan = mk.launch_plan(48, 4096, 64, block_m=2048, path="single",
                          variant="smem")
    call = mk.kernel_call(plan, k=48, m=4096)
    assert plan.smem_bytes > mk.SMEM_BUDGET_BYTES
    assert any(f.rule == "smem-budget"
               for f in contracts.audit_call(plan, call))
    # a small mesh (K=64) whose N=1000 weight tile overflows even at the
    # narrowest tile, below the two-pass crossover -> sanctioned
    plan = mk.launch_plan(64, 128, 1000, block_m=32, path="single",
                          variant="smem")
    assert mk.variant_smem_bytes("smem", 64, 1000, 32) > \
        mk.SMEM_BUDGET_BYTES
    call = mk.kernel_call(plan, k=64, m=128)
    assert not any(f.rule == "smem-budget"
                   for f in contracts.audit_call(plan, call))


def test_mutation_crossover_disagreement(monkeypatch):
    real = mk.launch_plan

    def wrong_path(k, m, n=1, **kw):
        if kw.get("path") is None:
            kw["path"] = "two_pass"
            kw.pop("block_m", None)
        return real(k, m, n, **kw)

    monkeypatch.setattr(mk, "launch_plan", wrong_path)
    got = contracts.check_workload(8, 1000, 1)
    assert ("path-crossover", "") in _rules(got)


# ===========================================================================
# the kernel call is what the wrappers launch
# ===========================================================================

@pytest.mark.parametrize("k,m,n,variant", [
    (8, 70_000, 1, "regs"), (16, 300, 4, "warp"), (40, 300, 3, "warp"),
    (128, 512, 4, "smem"), (20, 100, 1, "regs"), (33, 5000, 2, "smem")])
def test_kernel_call_names_the_c_dispatch(k, m, n, variant):
    plan = mk.launch_plan(k, m, n, variant=variant)
    call = mk.kernel_call(plan, k=k, m=m)
    assert call.args == (plan.block_m, mk.SINGLE_PASS_VARIANTS[variant])
    assert call.smem == plan.smem_bytes
    assert call.units == plan.grid[0]
    want = {"regs": f"mm_regs<{8 if k <= 8 else 16 if k <= 16 else 32}, "
                    "float>",
            "warp": f"mm_warp<{1 if k <= 32 else 2}, float>",
            "smem": "mm_smem<float>"}[variant]
    assert call.instantiation == want
    assert call.threads == (plan.block_m if variant == "regs" else 256)
    assert call.grid_stride == (variant == "regs")


@pytest.mark.parametrize("k,bk,weighted", [(128, None, True),
                                           (1024, 512, False),
                                           (96, 32, True)])
def test_kernel_call_two_pass(k, bk, weighted):
    plan = mk.launch_plan(k, 777, 2, path="two_pass", block_k=bk)
    call = mk.kernel_call(plan, k=k, m=777, dtype=torch.bfloat16,
                          weighted=weighted)
    assert call.args == (plan.block_k, plan.n_chunk, plan.block_m)
    assert call.instantiation == (
        f"mm_two_pass<{max(1, plan.block_k // 32)}, "
        f"{'true' if weighted else 'false'}, bf16>")
    assert call.threads == 32 * plan.block_m
    assert call.loads == plan.input_block_fetches
    assert call.operands[0] == mk.Operand("x", (k, 777), "bfloat16")
    assert call.outputs == (mk.Operand("out", (2, 777), "bfloat16"),)


def test_record_calls_sees_every_device_and_nests():
    x = torch.randn(8, 300)
    with mk.record_calls() as outer:
        ops.mm_aggregate(x)
        with mk.record_calls() as inner:
            out = ops.mm_aggregate(torch.empty(8, 300, device="meta"))
        ops.mm_aggregate_batched(torch.randn(128, 64), torch.rand(128, 3))
    assert out.device.type == "meta" and tuple(out.shape) == (300,)
    assert [c.key for c in inner] == [("warp", 8, 300, 1)]
    assert [c.key for c in outer] == [("warp", 8, 300, 1),
                                      ("warp", 8, 300, 1),
                                      ("two_pass", 128, 64, 3)]
    # the tally counts launches on the card only
    assert launches.total() == 0 or torch.cuda.is_available()


def test_meta_wrappers_return_the_estimate_shape():
    for path, k in (("single", 8), ("two_pass", 300)):
        x = torch.empty((k, 1000), dtype=torch.bfloat16, device="meta")
        a = torch.empty((k, 3), device="meta")
        plan = mk.launch_plan(k, 1000, 3, path=path)
        run = mk.two_pass if path == "two_pass" else mk.single_pass
        with mk.record_calls() as calls:
            out = run(x, a, plan)
        assert out.device.type == "meta" and out.dtype == torch.bfloat16
        assert tuple(out.shape) == (3, 1000)
        assert len(calls) == 1 and calls[0].plan == plan


def test_other_devices_are_still_refused():
    plan = mk.launch_plan(8, 10, 1)
    x = types.SimpleNamespace(shape=(8, 10),
                              device=torch.device("xpu"),
                              dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        mk._check_cuda_operands(x, None, plan, 8)


def test_modeled_ops_counts_the_estimate():
    # per (column, n) and IRLS step 9 per row (+1 weighted) and 2; the
    # start 2K + 2 (+2K weighted) + 3; the sort K log2 K per column
    assert mk.modeled_ops(8, 1, 1, False) == 10 * (9 * 8 + 2) + 16 + 5 \
        + 8 * 3
    assert mk.modeled_ops(8, 10, 2, True, num_iters=1) == \
        2 * 10 * ((10 * 8 + 2) + 16 + 16 + 3) + 10 * 8 * 3
    assert mk.modeled_ops(1024, 1, 1, True, sort_rows=512) == \
        10 * (10 * 1024 + 2) + 4 * 1024 + 3 + 1024 * 9


# ===========================================================================
# launch audit: clean on the real entry points, and mutated
# ===========================================================================

def test_launch_audit_clean():
    assert launch_audit.check_engine() == []
    assert launch_audit.check_scenarios() == []
    assert launch_audit.check_serve() == []
    assert launch_audit.check_serve_multitenant() == []
    assert launch_audit.unchecked() == (
        [] if torch.cuda.is_available() else ["host-sync"])


def test_mutation_launch_count():
    eng = ops.AggregationEngine()
    x = torch.zeros((8, 64))
    got = launch_audit.audit_launches(lambda: None, where="fixture")
    assert [f.rule for f in got] == ["launch-count"]
    # per-leaf launches instead of one over the staged tree
    tree = {"w": torch.zeros((8, 32)), "b": torch.zeros((8, 7))}
    got = launch_audit.audit_launches(
        lambda: [eng.aggregate(v) for v in tree.values()], where="fixture")
    assert [f.rule for f in got] == ["launch-count"]
    assert launch_audit.audit_launches(lambda: eng.aggregate(x),
                                       where="fixture") == []


def test_mutation_bf16_stream_upcast():
    eng = ops.AggregationEngine()
    x16 = torch.zeros((8, 300), dtype=torch.bfloat16)

    def leaky():                  # upcasts the stream before the kernel
        return eng.aggregate(x16.float())

    got = launch_audit.audit_launches(leaky, where="fixture",
                                      stream_dtype=torch.bfloat16)
    assert ("bf16-stream", "input") in _rules(got)
    assert ("bf16-stream", "output") in _rules(got)


def test_mutation_tree_stream_cast_again():
    eng = ops.AggregationEngine()

    class Recast:
        def aggregate_tree(self, tree):
            leaves = [tree[k] for k in sorted(tree)]
            staged = ops.stage_leaves(leaves)
            return eng.aggregate(staged.to(torch.bfloat16))

    got = launch_audit.check_tree_stream(Recast())
    assert ("bf16-stream", "tree") in _rules(got)
    assert launch_audit.check_tree_stream(eng) == []


def test_mutation_scenario_step_without_engine():
    from repro_torch.scenarios.spec import ScenarioSpec
    spec = ScenarioSpec(paradigm="diffusion", backend="jnp", num_agents=5,
                        dim=4, num_steps=2)
    got = launch_audit.check_scenarios([spec])
    assert ("launch-count", "no-workloads") in _rules(got)


def _session(misses, hits, commits, post=0):
    tel = types.SimpleNamespace(
        counters={"commits": commits, "exec_cache_misses": misses,
                  "exec_cache_hits": hits}, post_warmup_misses=post)
    return types.SimpleNamespace(telemetry=tel)


def test_mutation_serve_retrace():
    assert launch_audit.check_serve(_session(1, 2, 3)) == []
    for broken in (_session(3, 0, 3), _session(1, 2, 3, post=1),
                   _session(1, 1, 2)):
        assert [f.rule for f in launch_audit.check_serve(broken)] == \
            ["serve-retrace"]


def test_mutation_serve_per_tenant_caches():
    # each tenant quietly owns its own cache: every geometry captured
    # once per tenant
    from repro_torch.serve.service import ExecutableCache
    front = launch_audit._multitenant_front()
    services = list(front.tenants.values())
    key = next(iter(services[0].exec_cache.compiles))
    own = []
    for _ in services:
        c = ExecutableCache()
        c.compiles[key] += 1
        own.append(c)
    assert launch_audit.check_serve_multitenant(front) == []
    for svc, c in zip(services, own):
        svc.exec_cache = c
    got = _rules(launch_audit.check_serve_multitenant(front))
    assert ("serve-retrace", "per-tenant-compile") in got
    assert ("serve-retrace", "compile-total") in got
    # one tenant only: nothing was shared across tenants
    one = types.SimpleNamespace(tenants={"t0": services[0]})
    assert ("serve-retrace", "no-sharing") in _rules(
        launch_audit.check_serve_multitenant(one))


def test_launch_audit_donation_clean():
    assert launch_audit.check_donation() == []


def _flag_only(donated, engine):
    """An engine whose lowered program reports ``donated`` flags but
    whose calls are ``engine``'s."""
    def lower_tree(tree, a=None):
        low = engine.lower_tree(tree, a)
        return types.SimpleNamespace(donated=donated, compile=low.compile)
    return types.SimpleNamespace(lower_tree=lower_tree,
                                 aggregate_tree=engine.aggregate_tree)


def test_mutation_donation_flags_and_releases():
    plain, donating = ops.AggregationEngine(), \
        ops.AggregationEngine(donate_leaves=True)
    # the flags say donated, the calls release nothing
    got = launch_audit.check_donation(donating=_flag_only((True, True),
                                                          plain))
    assert [(f.where, f.ident) for f in got] == [
        ("lower_tree/donated", "aggregate_tree"),
        ("lower_tree/donated", "program")]
    # the flags do not reach the lowering
    got = launch_audit.check_donation(donating=_flag_only((False, True),
                                                          donating))
    assert [(f.where, f.ident) for f in got] == [("lower_tree/donated", "")]
    # a plain engine that releases the caller's leaves
    got = launch_audit.check_donation(plain=_flag_only((False, False),
                                                       donating))
    assert {f.where for f in got} == {"lower_tree/plain"}
    assert ("donation", "aggregate_tree") in _rules(got)
    assert ("donation", "program") in _rules(got)


def test_mutation_trajectory_launch_count(monkeypatch):
    """A compiled trajectory whose replay launches nothing."""
    from repro_torch.scenarios import runner
    real = runner.trace_spec

    def hollow(spec, **kw):
        program, records = real(spec, **kw)
        program.replay = lambda **_: None
        return program, records

    monkeypatch.setattr(runner, "trace_spec", hollow)
    got = launch_audit.check_scenarios(launch_audit.scenario_specs()[:1])
    assert ("launch-count", "trajectory") in _rules(got)
    assert len(got) == 1


def test_audit_leaves_the_launch_counts_alone():
    before = launches.COUNTS.copy()
    launch_audit.check_engine()
    assert launches.COUNTS == before


# ===========================================================================
# the CLI gate end to end (tmp root -> fail -> baseline -> pass -> stale)
# ===========================================================================

def test_cli_gate_baseline_workflow(tmp_path, capsys):
    assert analysis_main(["--passes", "contracts", "--root",
                          str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "n-independence" in out and "FAIL" in out

    report = tmp_path / "report.json"
    analysis_main(["--passes", "contracts", "--root", str(tmp_path),
                   "--json", str(report)])
    keys = [f["key"] for f in json.loads(report.read_text())["unbaselined"]]
    entries = [{"key": k, "reason": "fixture: kept on purpose"} for k in keys]
    (tmp_path / "ANALYSIS_BASELINE_TORCH.json").write_text(
        json.dumps({"findings": entries}))
    capsys.readouterr()
    assert analysis_main(["--passes", "contracts", "--root",
                          str(tmp_path)]) == 0
    assert "kept on purpose" in capsys.readouterr().out

    # a fixed finding leaves a stale entry: reported, not fatal
    entries.append({"key": "n-independence:kernel:gone", "reason": "old"})
    (tmp_path / "ANALYSIS_BASELINE_TORCH.json").write_text(
        json.dumps({"findings": entries}))
    assert analysis_main(["--passes", "contracts", "--root", str(tmp_path),
                          "--json", str(report)]) == 0
    assert "stale" in capsys.readouterr().out
    assert json.loads(report.read_text())["stale_baseline_keys"] == \
        ["n-independence:kernel:gone"]


def test_cli_rejects_unknown_pass_and_reasonless_baseline(tmp_path):
    with pytest.raises(ValueError, match="unknown pass"):
        analysis_main(["--passes", "lint", "--root", str(tmp_path)])
    (tmp_path / "ANALYSIS_BASELINE_TORCH.json").write_text(
        json.dumps([{"key": "k"}]))
    with pytest.raises(F.BaselineError, match="reason"):
        analysis_main(["--passes", "contracts", "--root", str(tmp_path)])


def test_cli_gate_is_clean_on_the_repo(capsys):
    assert analysis_main(["--root", str(REPO_ROOT)]) == 0
    out = capsys.readouterr().out
    assert "0 new" in out and "0 stale" in out
    if not torch.cuda.is_available():
        assert "[not checked] host-sync" in out
