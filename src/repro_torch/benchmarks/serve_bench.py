"""Streaming-service benchmark (``benchmarks/serve_bench.py``): replay a
federated spec's client traffic through ``repro_torch.serve`` under
chaos profiles and record what the service sustained.

Per profile row (``repro_torch.serve.scenario.ServeResult.to_row``):

  * request latency p50/p95/p99 (simulated seconds, arrival -> commit)
    and launch-wall percentiles (real seconds around the launch);
  * sustained throughput: ``updates_per_sec`` of applied updates over
    the real harness wall time;
  * cohort-size and staleness histograms;
  * per-fault-mode recovery counts (the chaos acceptance surface),
    including the network-level modes (partition / reorder / corrupt /
    slow_loris) and journal crash recoveries;
  * transport stats: bounded-channel queue-depth high-water mark vs.
    the channel capacity, backpressure verdicts, tenants;
  * ``duplicate_admissions``: (agent, seq) pairs admitted twice -- must
    be 0 (the exactly-once-across-restart invariant);
  * ``post_warmup_cache_hit``: no cohort geometry's launch program (a
    CUDA graph on the card) was captured again after its first sight --
    the "mixed" row runs 2 concurrent tenants sharing one executable
    cache, so its cache hits witness cross-tenant sharing;
  * the launch audit (the plan the engine actually resolved).

``--json PATH`` writes BENCH_serve_torch.json (audited by
``repro_torch.analysis.bench_audit``); ``--smoke`` shrinks rounds.
Exits non-zero on any non-finite steady MSD, any broken-down profile,
or an under-delivered replay.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.kernels import tuning
from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.serve import CHAOS_PROFILES, ServeConfig, replay

DEFAULT_PROFILES = ("clean", "stragglers", "network", "mixed")
SMOKE_PROFILES = ("clean", "mixed")
# the all-faults profile doubles as the multi-tenant row: two tenant
# services behind one front, agents split between them
PROFILE_TENANTS = {"mixed": 2}


class ProfileFailed(RuntimeError):
    """A profile's row is unacceptable (broke down, under-delivered,
    admitted twice or missed a recovery)."""


def spec_for(profile: str, rounds: int) -> ScenarioSpec:
    tenants = PROFILE_TENANTS.get(profile, 1)
    return ScenarioSpec(
        name=f"serve-{profile}", paradigm="federated",
        num_agents=16 * tenants, dim=8, num_steps=rounds,
        step_size=0.05, local_steps=3)


def run(profiles, *, rounds: int, backend: str = "pallas", seed: int = 0,
        device="cuda", results=None):
    """One row per profile; raises ``ProfileFailed`` on the first
    unacceptable one.  ``results``, a list, receives each
    ``ServeResult``."""
    rows = []
    for profile in profiles:
        tenants = PROFILE_TENANTS.get(profile, 1)
        res = replay(spec_for(profile, rounds),
                     chaos=CHAOS_PROFILES[profile],
                     serve=ServeConfig(k_min=8, deadline_s=1.0,
                                       backend=backend),
                     rounds=rounds, seed=seed, tenants=tenants,
                     device=device)
        if results is not None:
            results.append(res)
        row = res.to_row()
        row["profile"] = profile
        rows.append(row)
        ok = (not row["broke_down"]
              and row["rounds_completed"] == rounds
              and row["duplicate_admissions"] == 0
              and all(v > 0 for v in row["recoveries"].values()))
        print(f"{profile:12s} steady={row['steady_msd']:.5g} "
              f"band={row['breakdown_level']:.3g} "
              f"p50/p95/p99={row['latency_p50']:.3f}/"
              f"{row['latency_p95']:.3f}/{row['latency_p99']:.3f} "
              f"upd/s={row['updates_per_sec']:.1f} "
              f"tenants={row['tenants']} qmax={row['queue_depth_max']} "
              f"cache_hit={row['post_warmup_cache_hit']} ok={ok}")
        if not ok:
            raise ProfileFailed(
                f"profile {profile} row unacceptable: "
                f"broke_down={row['broke_down']} "
                f"rounds={row['rounds_completed']}/{rounds} "
                f"dup_admissions={row['duplicate_admissions']} "
                f"recoveries={row['recoveries']}")
    return rows


def write_json(path: str, rows, *, smoke: bool, backend: str, rounds: int,
               device) -> None:
    payload = {
        "bench": "serve",
        "mode": "smoke" if smoke else "full",
        "device": tuning.device_name(device),
        "engine_backend": backend,
        "rounds": rounds,
        "rows": rows,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds / profiles")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write BENCH_serve_torch.json-style output")
    ap.add_argument("--profiles", default=None,
                    help="comma-separated chaos profiles "
                         f"(default: {','.join(DEFAULT_PROFILES)})")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--backend", default="pallas",
                    choices=("pallas", "jnp"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)

    profiles = (tuple(ns.profiles.split(",")) if ns.profiles
                else SMOKE_PROFILES if ns.smoke else DEFAULT_PROFILES)
    for p in profiles:
        if p not in CHAOS_PROFILES:
            ap.error(f"unknown profile {p!r}; known: "
                     f"{sorted(CHAOS_PROFILES)}")
    rounds = ns.rounds if ns.rounds else (30 if ns.smoke else 60)
    try:
        rows = run(profiles, rounds=rounds, backend=ns.backend, seed=ns.seed,
                   device=ns.device)
    except ProfileFailed as exc:
        print(f"FAIL: {exc}", file=sys.stderr)
        return 1
    if ns.json:
        write_json(ns.json, rows, smoke=ns.smoke, backend=ns.backend,
                   rounds=rounds, device=ns.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
