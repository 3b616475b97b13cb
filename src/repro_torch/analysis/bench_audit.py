"""Audits over the port's benchmark JSON files
(``repro.analysis.bench_audit``).

Each audit takes the parsed JSON dict and returns a list of violation
strings (empty = pass):

  audit_agg           BENCH_agg_torch.json (``benchmarks.agg_bench
                      --json``): the traffic audit must cover both
                      kernels, every audited stream must be
                      N-independent, every two-pass block must fit
                      Hopper's shared memory, and the K=256 two-pass
                      row and the IRLS-depth sweep must be present.
  audit_large_cohort  BENCH_large_cohort_torch.json (``examples.
                      scenario_sweep --family large_cohort --json``): at
                      least one scenario must have run the two-pass
                      kernel, every launch audit's block must fit in
                      ``SMEM_BUDGET_BYTES`` (232,448 B), and every
                      launch must take the path ``auto_path`` gives its
                      (K, N).  The rows' ``launch_audit`` is the
                      launch plan as the scenario runner wrote it; K is
                      input_bytes x n_out / output_bytes.
  audit_serve         BENCH_serve_torch.json (``benchmarks.serve_bench
                      --json``): a clean row AND at least one chaos row;
                      every row finite, within its band, with latency
                      percentiles and positive throughput, and
                      ``post_warmup_cache_hit`` true (no cohort
                      geometry's launch program -- a CUDA graph on the
                      card -- was captured again after its first sight);
                      every injected fault mode shows a nonzero recovery
                      count; queue depth stays bounded by the transport
                      channel capacity; a crash-restart row with nonzero
                      crash recoveries and zero duplicate admissions,
                      and a multi-tenant (>= 2 tenants) row whose shared
                      executable cache took post-warmup hits.

The file kind is inferred from the filename (``--kind`` overrides).

  python -m repro_torch.analysis.bench_audit experiments/bench_torch/*.json
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Callable, Dict, List


def audit_agg(bench: dict) -> List[str]:
    """BENCH_agg_torch.json invariants."""
    from repro_torch.kernels import mm_aggregate as mk
    errors: List[str] = []
    audit = bench.get("traffic_audit") or []
    paths = {a.get("path") for a in audit}
    if not paths >= {"single", "two_pass"}:
        errors.append(f"traffic audit paths incomplete: {sorted(paths)} "
                      "(need both 'single' and 'two_pass')")
    for a in audit:
        if not a.get("n_independent"):
            errors.append(
                f"N-dependent input stream in traffic audit entry "
                f"{a.get('shape', a)}")
        if a.get("path") == "two_pass" and \
                a.get("smem_bytes", 0) > mk.SMEM_BUDGET_BYTES:
            errors.append(
                f"{a.get('shape')}: two-pass block carves {a['smem_bytes']} "
                f"B of shared memory, over {mk.SMEM_BUDGET_BYTES}")
    rows = bench.get("rows") or []
    if not any(str(r.get("name", "")).startswith(
            "agg/mm_pallas_two_pass/K256") for r in rows):
        errors.append("missing K=256 two-pass smoke row")
    if not bench.get("irls_sweep"):
        errors.append("missing IRLS-depth sweep")
    return errors


def _plans(audit: dict) -> list:
    """The launch plans of one row's ``launch_audit`` (one plan, or a
    multi-layout run's ``layouts``)."""
    if not audit:
        return []
    return list(audit.get("layouts") or [audit])


def audit_large_cohort(bench: dict) -> List[str]:
    """BENCH_large_cohort_torch.json invariants."""
    from repro_torch.kernels import mm_aggregate as mk
    errors: List[str] = []
    rows = bench.get("rows") or []
    plans = [(r, p) for r in rows for p in _plans(r.get("launch_audit"))]
    if not any(p.get("path") == "two_pass" for _, p in plans):
        errors.append("no two-pass scenario in the large-cohort family")
    for r, p in plans:
        name = r.get("name")
        if p["smem_bytes"] > mk.SMEM_BUDGET_BYTES:
            errors.append(
                f"{name}: {p['path']} block carves {p['smem_bytes']} B of "
                f"shared memory, over {mk.SMEM_BUDGET_BYTES}")
        k = p["input_bytes"] * p["n_out"] // p["output_bytes"]
        want = mk.auto_path(k, p["n_out"])
        if p["path"] != want:
            errors.append(
                f"{name}: the {p['path']} kernel launched for (K={k}, "
                f"N={p['n_out']}), where auto_path takes {want}")
    return errors


def audit_serve(bench: dict) -> List[str]:
    """BENCH_serve_torch.json invariants (the chaos acceptance surface)."""
    errors: List[str] = []
    rows = bench.get("rows") or []
    if not rows:
        return ["no serve rows"]
    if not any(not r.get("fault_modes") for r in rows):
        errors.append("no clean (fault-free) profile row")
    if not any(r.get("fault_modes") for r in rows):
        errors.append("no chaos profile row")
    for r in rows:
        name = r.get("profile") or r.get("scenario", "<row>")
        for key in ("steady_msd", "latency_p50", "latency_p95",
                    "latency_p99", "updates_per_sec"):
            v = r.get(key)
            if not isinstance(v, (int, float)) or v != v \
                    or v in (float("inf"), float("-inf")):
                errors.append(f"{name}: metric {key} non-finite "
                              f"or missing: {v!r}")
        if r.get("broke_down", True):
            errors.append(f"{name}: served model broke out of the "
                          f"scenario band (steady_msd="
                          f"{r.get('steady_msd')} > "
                          f"{r.get('breakdown_level')})")
        if isinstance(r.get("updates_per_sec"), (int, float)) \
                and not r["updates_per_sec"] > 0:
            errors.append(f"{name}: zero sustained throughput")
        if not r.get("post_warmup_cache_hit", False):
            errors.append(
                f"{name}: post-warmup executable-cache miss "
                f"({r.get('post_warmup_misses')} misses): a cohort "
                "geometry's launch program was captured again after "
                "warm-up")
        if not r.get("rounds_completed"):
            errors.append(f"{name}: no committed rounds")
        recov = r.get("recoveries") or {}
        for mode in r.get("fault_modes") or []:
            if not recov.get(mode):
                errors.append(
                    f"{name}: injected fault mode {mode!r} shows no "
                    f"recovery events (recoveries={recov})")
        if "queue_depth_max" not in r:
            errors.append(f"{name}: missing transport queue-depth "
                          "telemetry (queue_depth_max)")
        else:
            cap = r.get("channel_capacity")
            if not isinstance(cap, int) or cap < 1:
                errors.append(f"{name}: queue depth reported without a "
                              f"channel capacity bound (got {cap!r})")
            elif r["queue_depth_max"] > cap:
                errors.append(
                    f"{name}: unbounded queue depth: high-water "
                    f"{r['queue_depth_max']} exceeds the channel "
                    f"capacity {cap}")
        if r.get("duplicate_admissions"):
            errors.append(
                f"{name}: {r['duplicate_admissions']} duplicate "
                "admission(s): an (agent, seq) pair was admitted twice "
                "(exactly-once across crash/restart is broken)")
    crash_rows = [r for r in rows
                  if "crash" in (r.get("fault_modes") or [])]
    if not crash_rows:
        errors.append("no crash-restart chaos row (zero crash "
                      "recoveries across the bench)")
    elif not any((r.get("recoveries") or {}).get("crash")
                 for r in crash_rows):
        errors.append("crash-restart row(s) present but zero crash "
                      "recoveries: the journal restore path never ran")
    if not any(int(r.get("tenants") or 1) >= 2
               and r.get("post_warmup_cache_hit") for r in rows):
        errors.append("no multi-tenant (>= 2 tenants) row with "
                      "post-warmup executable-cache hits: cross-tenant "
                      "launch-program sharing is unverified")
    return errors


AUDITS: Dict[str, Callable[[dict], List[str]]] = {
    "agg": audit_agg,
    "large_cohort": audit_large_cohort,
    "serve": audit_serve,
}


def infer_kind(path) -> str:
    """The audit kind of a file name (``BENCH_agg_torch.json``,
    ``BENCH_large_cohort_torch.json``, ``BENCH_serve_torch.json``, or
    the reference's names)."""
    name = pathlib.Path(path).name.lower()
    if "large_cohort" in name:
        return "large_cohort"
    if "serve" in name:
        return "serve"
    if "agg" in name:
        return "agg"
    raise ValueError(
        f"cannot infer audit kind from {path!r}; pass --kind "
        f"({sorted(AUDITS)})")


def audit_file(path, kind: str = None) -> List[str]:
    kind = kind or infer_kind(path)
    bench = json.loads(pathlib.Path(path).read_text())
    return AUDITS[kind](bench)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.bench_audit",
        description="Audit a benchmark JSON file of the port")
    ap.add_argument("files", nargs="+", help="BENCH json file(s)")
    ap.add_argument("--kind", choices=sorted(AUDITS), default=None,
                    help="override the filename-inferred audit kind")
    args = ap.parse_args(argv)
    failed = False
    for f in args.files:
        errors = audit_file(f, args.kind)
        if errors:
            failed = True
            print(f"{f}: FAIL")
            for e in errors:
                print(f"  - {e}")
        else:
            print(f"{f}: audit ok")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
