"""Streaming aggregation service demo: replay a federated scenario's
client traffic through the transport-fronted ``repro_torch.serve`` under
a chaos profile and print what the service survived.

  python -m repro_torch.examples.serve_agg                 # clean
  python -m repro_torch.examples.serve_agg --profile mixed # full chaos
  python -m repro_torch.examples.serve_agg --profile network \
      --tenants 2 --agents 32                       # two tenants, one cache
  python -m repro_torch.examples.serve_agg --crash-at 0.5 \
      --rounds 20                         # kill mid-run, restore from journal
  python -m repro_torch.examples.serve_agg --backend pallas   # the kernel

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.scenarios.spec import ScenarioSpec
from repro_torch.serve import CHAOS_PROFILES, ServeConfig, replay


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default="clean",
                    choices=sorted(CHAOS_PROFILES))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--agents", type=int, default=16)
    ap.add_argument("--dim", type=int, default=8)
    ap.add_argument("--k-min", type=int, default=8)
    ap.add_argument("--deadline-s", type=float, default=1.0)
    ap.add_argument("--backend", default="jnp", choices=("jnp", "pallas"))
    ap.add_argument("--tenants", type=int, default=1,
                    help="concurrent tenant services behind one front "
                         "(agents split between them, launch programs "
                         "shared)")
    ap.add_argument("--crash-at", type=float, action="append", default=None,
                    metavar="FRAC",
                    help="kill the service at FRAC of the run and restore "
                         "it from its journal (repeatable, in (0, 1))")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = ScenarioSpec(
        name=f"serve-demo-{args.profile}", paradigm="federated",
        num_agents=args.agents, dim=args.dim, num_steps=args.rounds,
        step_size=0.05, local_steps=3)
    chaos = CHAOS_PROFILES[args.profile]
    if args.crash_at:
        chaos = dataclasses.replace(
            chaos, crash_restart_frac=tuple(
                sorted(set(chaos.crash_restart_frac)
                       | set(args.crash_at))))
    serve = ServeConfig(k_min=args.k_min, deadline_s=args.deadline_s,
                        backend=args.backend)

    res = replay(spec, chaos=chaos, serve=serve, rounds=args.rounds,
                 seed=args.seed, tenants=args.tenants, device=args.device)
    tel = res.telemetry
    print(f"profile={args.profile}  fault modes: "
          f"{', '.join(chaos.fault_modes()) or '(none)'}")
    print(f"rounds committed : {res.rounds_completed}/{args.rounds} "
          f"(sim {res.sim_elapsed_s:.1f}s, wall {res.wall_s:.2f}s, "
          f"{res.tenants} tenant(s))")
    print(f"steady MSD       : {res.summary['steady_msd']:.5g} "
          f"(band {res.summary['breakdown_level']:.3g}, "
          f"broke_down={res.summary['broke_down']})")
    print(f"latency p50/95/99: {tel['latency_p50']:.3f} / "
          f"{tel['latency_p95']:.3f} / {tel['latency_p99']:.3f} sim-s")
    print(f"throughput       : {tel['updates_per_sec']:.1f} updates/s "
          f"(post-warmup cache hit: {tel['post_warmup_cache_hit']})")
    print(f"transport        : queue depth {res.transport['queue_depth_max']}"
          f"/{res.transport['channel_capacity']} cap, "
          f"{res.transport['backpressure_total']} backpressure verdict(s), "
          f"{res.transport['exec_cache_compiles']} compile(s) for "
          f"{res.transport['exec_cache_keys']} geometry key(s)")
    if res.crash_restarts:
        print(f"crash restarts   : {res.crash_restarts} journal "
              f"restore(s), {res.duplicate_admissions} duplicate "
              "admission(s) across restarts")
    if res.recoveries:
        print("recoveries       :",
              json.dumps(res.recoveries, sort_keys=True))
    print("counters         :",
          json.dumps(tel["counters"], sort_keys=True))

    failures = []
    if res.summary["broke_down"]:
        failures.append("served model broke out of the scenario band")
    if res.duplicate_admissions:
        failures.append(f"{res.duplicate_admissions} duplicate admissions")
    if (chaos.crash_restart_frac
            and not res.recoveries.get("crash")):
        failures.append("crash requested but no journal recovery ran")
    if failures:
        print("FAIL: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
