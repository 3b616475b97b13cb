"""Scenario sweep CLI: one declarative spec per cell of a
paradigm x attack x aggregator (x topology x seed) grid, every cell run
by the same ``scenarios.run`` harness.

  python -m repro_torch.examples.scenario_sweep \
      --paradigm diffusion federated sharded \
      --attack additive alie scm --agg mean mm_tukey --seeds 0 1

  # the LM substrate: the spec drives launch.steps' robust train step
  python -m repro_torch.examples.scenario_sweep --paradigm substrate --smoke

  # production cohort sizes: K in {128, 256, 1024}, low participation,
  # kernel backend -- large meshes take the two-pass K-major kernel
  python -m repro_torch.examples.scenario_sweep --family large_cohort --smoke

``--smoke`` shrinks the problem (tiny K/M, few steps); with no explicit
matrix arguments it runs the CI preset: three kernel-backend specs
covering the three linear paradigms, each carrying the
``mm_aggregate.launch_plan`` audit (the kernel path, variant, modeled
traffic and shared memory).  ``--paradigm substrate`` trains ``--model``
(default the qwen3-0.6b smoke config; ``paper_lsq`` for the linear
substrate) through the launch.steps aggregation path, on the kernel
backend by default so the per-layout launch audit is attached.  Exits
non-zero if ANY scenario produces a non-finite metric.  ``--json PATH``
writes the per-spec rows (``ScenarioResult.to_row``), with
``compile_s`` (lowering and one warm-up step) and ``wall_clock_s``
(every step of the run) apart.  ``--device`` picks the device (default
``cuda``).
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch import scenarios

FULL = dict(num_agents=16, dim=10, num_steps=300, num_malicious=3)
SMOKE = dict(num_agents=8, dim=8, num_steps=25, num_malicious=2)

# large_cohort family: production-scale agent counts at low
# participation on the kernel backend.  The federated cohort
# (clients_per_round = participation * K) is the kernel's K axis, so
# K=1024 @ 0.5 aggregates 512 agents, whose single-pass tile does not
# fit a Hopper block: the two-pass kernel
LARGE_COHORT_DIM = 256
LARGE_COHORT_SMOKE = (("federated", 1024, 0.5), ("sharded", 256, 1.0))
LARGE_COHORT_FULL = tuple(
    [("federated", k, p) for k in (128, 256, 1024) for p in (0.1, 0.5)]
    + [("sharded", 256, 1.0), ("sharded", 1024, 1.0)])

# the substrate trains a real model per step; keep the grids tight
SUBSTRATE_FULL = dict(num_agents=8, num_steps=20, num_malicious=2,
                      paradigm_kwargs=(("batch_per_agent", 2),
                                       ("seq_len", 16)))
SUBSTRATE_SMOKE = dict(num_agents=4, num_steps=3, num_malicious=1,
                       paradigm_kwargs=(("batch_per_agent", 1),
                                        ("seq_len", 8)))

DEFAULT_PARADIGMS = ("diffusion", "federated", "sharded")
DEFAULT_ATTACKS = ("additive", "alie", "scm")
DEFAULT_AGGS = ("mean", "mm_tukey")
SUBSTRATE_DEFAULT_ATTACKS = ("additive",)
SUBSTRATE_DEFAULT_AGGS = ("mm_tukey",)


def _substrate_specs(ns) -> list:
    sizes = dict(SUBSTRATE_SMOKE if ns.smoke else SUBSTRATE_FULL)
    if ns.malicious is not None:
        sizes["num_malicious"] = ns.malicious
    if ns.steps is not None:
        sizes["num_steps"] = ns.steps
    specs = []
    for attack in ns.attack or SUBSTRATE_DEFAULT_ATTACKS:
        for agg in ns.agg or SUBSTRATE_DEFAULT_AGGS:
            for seed in ns.seeds:
                backend = ns.backend or (
                    "pallas" if agg in scenarios.spec.MM_AGGREGATORS
                    else "jnp")
                specs.append(scenarios.ScenarioSpec(
                    paradigm="substrate", model_config=ns.model,
                    attack=attack, aggregator=agg, backend=backend,
                    data=ns.data, dirichlet_alpha=ns.alpha, seed=seed,
                    **sizes))
    return specs


def _large_cohort_specs(ns) -> list:
    steps = ns.steps if ns.steps is not None else (3 if ns.smoke else 10)
    combos = LARGE_COHORT_SMOKE if ns.smoke else LARGE_COHORT_FULL
    specs = []
    for paradigm, k, part in combos:
        nmal = ns.malicious if ns.malicious is not None else k // 8
        specs.append(scenarios.ScenarioSpec(
            paradigm=paradigm, aggregator="mm_tukey",
            backend=ns.backend or "pallas",
            attack=(ns.attack or ["additive"])[0],
            num_agents=k, dim=LARGE_COHORT_DIM, num_steps=steps,
            num_malicious=nmal,
            participation=part if paradigm == "federated" else 1.0,
            data=ns.data, dirichlet_alpha=ns.alpha, seed=ns.seeds[0]))
    return specs


def build_specs(ns) -> list:
    if ns.family == "large_cohort":
        return _large_cohort_specs(ns)
    sizes = SMOKE if ns.smoke else FULL
    if ns.malicious is not None:
        sizes = {**sizes, "num_malicious": ns.malicious}
    if ns.steps is not None:
        sizes = {**sizes, "num_steps": ns.steps}

    def topo_for(paradigm):
        # --topology drives the diffusion combination matrix; the other
        # paradigms' communication pattern is fixed by construction
        return ns.topology if paradigm == "diffusion" else "fully_connected"

    if ns.smoke and not (ns.paradigm or ns.attack or ns.agg):
        # the 3-spec CI preset: every linear paradigm once, on the
        # kernel backend unless --backend says otherwise
        return [
            scenarios.ScenarioSpec(
                paradigm=p, aggregator="mm_tukey",
                backend=ns.backend or "pallas",
                attack="additive", topology=topo_for(p), seed=ns.seeds[0],
                **sizes)
            for p in DEFAULT_PARADIGMS
        ]

    specs = []
    for paradigm in ns.paradigm or DEFAULT_PARADIGMS:
        if paradigm == "substrate":
            specs.extend(_substrate_specs(ns))
            continue
        for attack in ns.attack or DEFAULT_ATTACKS:
            for agg in ns.agg or DEFAULT_AGGS:
                for seed in ns.seeds:
                    backend = ns.backend or "jnp"
                    if backend == "pallas" and \
                            agg not in scenarios.spec.MM_AGGREGATORS:
                        backend = "jnp"   # the kernel computes the MM family
                    specs.append(scenarios.ScenarioSpec(
                        paradigm=paradigm, attack=attack, aggregator=agg,
                        backend=backend, topology=topo_for(paradigm),
                        data=ns.data, dirichlet_alpha=ns.alpha,
                        seed=seed, **sizes))
    return specs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paradigm", nargs="+", default=None,
                    choices=list(scenarios.PARADIGMS))
    ap.add_argument("--attack", nargs="+", default=None)
    ap.add_argument("--agg", nargs="+", default=None)
    ap.add_argument("--topology", default="fully_connected")
    ap.add_argument("--backend", default=None,
                    choices=list(scenarios.BACKENDS),
                    help="engine backend (default: jnp, the plain "
                         "estimator; the --smoke preset and the substrate "
                         "default to pallas, the kernel, for the launch "
                         "audit)")
    ap.add_argument("--model", default="qwen3-0.6b",
                    help="substrate model: 'paper_lsq' or a configs arch "
                         "name (smoke config)")
    ap.add_argument("--data", default="iid", choices=["iid", "dirichlet"])
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="dirichlet concentration for --data dirichlet")
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--malicious", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--family", default=None, choices=["large_cohort"],
                    help="named scenario family: 'large_cohort' sweeps "
                         "K in {128,256,1024} at low participation on "
                         "the kernel backend (two-pass kernel territory)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny K/M and few steps; with no matrix args, "
                         "the 3-spec all-paradigm CI preset")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the per-spec rows as JSON to PATH")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    ns = parser().parse_args(argv)
    specs = build_specs(ns)
    rows = []
    bad = []
    hdr = (f"{'scenario':68s} {'steady MSD':>12s} {'final MSD':>12s} "
           f"{'compile s':>9s} {'wall s':>8s} {'audit':>5s}")
    print(hdr)
    print("-" * len(hdr))
    for sp in specs:
        res = scenarios.run(sp, device=ns.device)
        row = res.to_row()
        rows.append(row)
        if not res.finite():
            bad.append(sp.label())
        print(f"{sp.label():68s} {res.summary['steady_msd']:12.3e} "
              f"{res.final_msd:12.3e} {row['compile_s']:9.2f} "
              f"{row['wall_clock_s']:8.3f} "
              f"{'yes' if row['launch_audit'] else 'no':>5s}")

    if ns.json:
        payload = {
            "bench": "scenarios",
            "mode": "smoke" if ns.smoke else "full",
            "rows": rows,
        }
        with open(ns.json, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")
        print(f"wrote {ns.json}")

    if bad:
        print(f"NON-FINITE metrics in {len(bad)} scenario(s): {bad}",
              file=sys.stderr)
        return 1
    print(f"\n{len(rows)} scenarios, all metrics finite.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
