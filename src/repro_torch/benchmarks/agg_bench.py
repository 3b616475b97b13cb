"""Aggregator micro-benchmark (``benchmarks/agg_bench.py``; the paper
has no timing table, this is the systems-side cost table): time per call
for each aggregator over (K, M), the Hopper kernel, the batched
N-neighborhood kernel and the engine's weighted-pytree path -- with two
structural audits:

  * launch audit: the whole gradient pytree is aggregated by ONE kernel
    launch, not one per leaf (the wrappers' ``record_calls``; on the
    card also ``LAUNCHES``);
  * traffic audit: at fixed tile sizes the batched launch reads the
    SAME number of input tiles (and bytes) from HBM for every N -- the
    one-residency contract, audited for BOTH kernels from their launch
    plans (the two-pass audit also pins the shared memory a block
    carves to Hopper's 232,448 B and the modeled traffic to <= 2x the
    single-pass plan's).  A kernel with N in its grid would stream the
    update matrix once per weight column (N x the bytes).

Also: large-cohort rows timing the two-pass kernel (K >= 256, where
``auto_path`` takes it at any N), an IRLS-depth
sweep (``irls_sweep``: num_iters in {3, 5, 10} at fixed (K, M), time per
call and MSD against a converged T=50 oracle, the data behind the
default T=10), the scenario runner's paradigms, and the LM substrate
row: ``--smoke`` trains the Qwen3-0.6B smoke config on the plain
estimator (``jnp``), the full run the full-size model (751,894,528
parameters) with K = 8 agents on the kernel (``SUBSTRATE_BACKEND``).

Times are CUDA-event times on the card, host times on the CPU
(``kernel_bench.time_us``).  ``--json PATH`` writes the rows and audits
(``repro_torch.analysis.bench_audit`` checks them); ``--smoke`` shrinks
shapes and reps.  Any non-finite kernel output aborts with a non-zero
exit.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch import devices, pytree, scenarios
from repro_torch.benchmarks.kernel_bench import time_us
from repro_torch.core import aggregators
from repro_torch.kernels import mm_aggregate as mk
from repro_torch.kernels import ops, ref, tuning
from repro_torch.scenarios import runner

SHAPES = ((16, 1 << 16), (32, 1 << 18))
SMOKE_SHAPES = ((8, 1 << 12),)
# two-pass territory: meshes of 256 agents and more at any N
LARGE_K_SHAPES = ((256, 1 << 14), (1024, 1 << 13))
SMOKE_LARGE_K_SHAPES = ((256, 1 << 12),)
IRLS_DEPTHS = (3, 5, 10)
AGGS = ("mean", "median", "trimmed_mean", "geometric_median", "krum",
        "m_huber", "mm_tukey")
SMOKE_AGGS = ("mean", "median", "mm_tukey")
# the LM substrate row's engine backend: "jnp" (plain core.location per
# leaf, as the reference's row) for the smoke config; the Hopper kernel
# for full-size Qwen3-0.6B, where the plain estimator's per-leaf
# temporaries (~5 GB each over the (8, 155,713,536) embed stack) beside
# the K = 8 gradient stacks ran out of the card's 80 GB (71.57 GiB held
# when a 4.64 GiB temporary was asked for, on an H100 80GB HBM3)
SUBSTRATE_BACKEND = {True: "jnp", False: "pallas"}   # by smoke


def _grad_tree(k: int, scale: int, device):
    """A small transformer-block-shaped gradient pytree, stacked over K
    agents, drawn from a generator seeded per leaf."""
    g = torch.Generator(device=device)

    def leaf(i, *s):
        return torch.randn((k,) + s, generator=g.manual_seed(i), device=device)

    d = 256 // scale
    return {
        "wq": leaf(0, d, d), "wk": leaf(1, d, 64), "wv": leaf(2, d, 64),
        "wo": leaf(3, d, d), "w_up": leaf(4, d, 4 * d),
        "w_down": leaf(5, 4 * d, d), "ln": leaf(6, d), "bias": leaf(7, d),
    }


def count_launches(fn, *args) -> int:
    """MM kernel launches one call of fn makes: the calls the wrappers
    record (``mm_aggregate.record_calls``, on any device, as
    ``analysis.launch_audit`` counts them); on the card each must also
    be a counted launch (``LAUNCHES``)."""
    before = sum(mk.LAUNCHES.values())
    with mk.record_calls() as calls:
        fn(*args)
    launched = sum(mk.LAUNCHES.values()) - before
    if launched not in (0, len(calls)):          # the CPU launches nothing
        raise AssertionError(f"{len(calls)} wrapper calls but {launched} "
                             "launches counted")
    return len(calls)


def traffic_audit(k: int, m: int, ns=(1, 8, 32), block_m: int = 256,
                  path: str = "single") -> dict:
    """One-residency audit from the kernels' own launch plans: input-tile
    reads and bytes must not depend on N at fixed tile sizes -- for
    either kernel.  The two-pass audit also pins the shared memory a
    block carves to ``SMEM_BUDGET_BYTES`` and the modeled traffic to
    <= 2x the single-pass plan's at equal (K, M, N) (both read the
    update tile once; the per-block statistics stay on chip)."""
    plans = {n: mk.launch_plan(k, m, n, block_m=block_m, path=path)
             for n in ns}
    fetches = {n: p.input_block_fetches for n, p in plans.items()}
    in_bytes = {n: p.input_bytes for n, p in plans.items()}
    ok = len(set(fetches.values())) == 1 and len(set(in_bytes.values())) == 1
    assert ok, f"input stream depends on N: {fetches} / {in_bytes}"
    n_max = max(ns)
    audit = {
        "shape": f"K{k}_M{m}",
        "block_m": block_m,
        "path": path,
        "input_block_fetches_by_n": {str(n): fetches[n] for n in ns},
        "input_bytes_by_n": {str(n): in_bytes[n] for n in ns},
        "n_independent": ok,
        "smem_bytes": max(p.smem_bytes for p in plans.values()),
        # what a kernel with N in its grid would stream at N_max
        "pre_fix_input_bytes_at_n_max": n_max * in_bytes[n_max],
        "traffic_reduction_at_n_max": n_max,
    }
    if path == "two_pass":
        ratio = max(
            plans[n].total_bytes
            / mk.launch_plan(k, m, n, block_m=block_m,
                             path="single").total_bytes
            for n in ns)
        assert ratio <= 2.0, f"two-pass traffic {ratio}x single-pass"
        assert audit["smem_bytes"] <= mk.SMEM_BUDGET_BYTES, \
            f"two-pass block over Hopper's shared memory: {audit['smem_bytes']}"
        audit["total_bytes_vs_single_pass"] = round(ratio, 4)
        audit["single_pass_smem_overflow"] = bool(
            mk.single_pass_smem_bytes(k, n_max, mk.SINGLE_PASS_MIN_BLOCK_M)
            > mk.SMEM_BUDGET_BYTES)
    return audit


def _assert_finite(name: str, out) -> None:
    for leaf in pytree.flatten(out)[0]:
        assert bool(torch.isfinite(leaf).all()), f"non-finite output: {name}"


def irls_sweep(x: torch.Tensor, depths=IRLS_DEPTHS, reps: int = 5) -> list:
    """Time per call and MSD against a converged (T=50) oracle of the
    kernel at each IRLS depth, on x (K, M) on its device."""
    converged = ref.mm_aggregate_ref(x, num_iters=50)
    rows = []
    for t in depths:
        us, out = time_us(lambda: ops.mm_aggregate(x, num_iters=t), x.device,
                          reps)
        _assert_finite(f"irls_depth/T{t}", out)
        rows.append({
            "num_iters": t,
            "shape": f"K{x.shape[0]}_M{x.shape[1]}",
            "us_per_call": round(us, 2),
            "msd_vs_oracle": float(torch.mean((out - converged) ** 2)),
        })
    return rows


def _contaminated(k, m, seed, device):
    x = torch.randn((k, m), generator=torch.Generator(device=device)
                    .manual_seed(seed), device=device)
    x[-k // 4:] += 100.0
    return x


def substrate_row(smoke: bool, device):
    """The LM-substrate scenario: the spec drives launch.steps' robust
    train step (per-agent grads -> stacked MM aggregation -> optimizer);
    steady wall is per-train-step cost.  Full: Qwen3-0.6B's published
    config, K = 8, seq 16, 10 steps.  Returns (its two rows, a record
    with the card's peak memory over the run), on
    ``SUBSTRATE_BACKEND``'s backend."""
    backend = SUBSTRATE_BACKEND[smoke]
    sub = scenarios.ScenarioSpec(
        paradigm="substrate", model_config="qwen3-0.6b",
        aggregator="mm_tukey", backend=backend,
        num_agents=4 if smoke else 8, num_steps=2 if smoke else 10,
        num_malicious=1, attack="additive",
        paradigm_kwargs=(("batch_per_agent", 1),
                         ("seq_len", 8 if smoke else 16),
                         ("full_config", not smoke)))
    card = device.type == "cuda"
    if card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    res = scenarios.run(sub, device=device)
    peak = torch.cuda.max_memory_allocated(device) if card else None
    model = res.final_state[0]
    n_params = sum(p.numel() for p in model.parameters())
    assert res.finite(), res.history
    # coords = aggregated coordinates, consistent with every other row:
    # Mode A aggregates one full-parameter-sized stack per step
    coords = sub.num_steps * n_params
    tag = (f"substrate[qwen3-0.6b]/mm_tukey-{backend}"
           f"/K{sub.num_agents}_T{sub.num_steps}")
    rows = [(f"scenario_wall_steady/{tag}", res.wall_clock_s * 1e6,
             coords / (res.wall_clock_s * 1e6), None, 0),
            (f"scenario_compile/{tag}", res.compile_s * 1e6, 0.0, None, 0)]
    record = {"tag": tag, "backend": backend, "params": n_params,
              "full_config": not smoke, "peak_bytes": peak,
              "final_loss": float(res.history["loss"][-1])}
    # the runner's cached lowering holds the model, its optimizer state
    # and the last step's K gradient stacks: tens of GB at full size
    del res, model
    runner.clear_executable_cache()
    if card:
        torch.cuda.empty_cache()
    return rows, record


def main(smoke: bool = False, device="cuda"):
    """(rows, traffic audits, IRLS sweep, substrate record)."""
    dev = devices.resolve(device)
    card = dev.type == "cuda"
    shapes = SMOKE_SHAPES if smoke else SHAPES
    aggs = SMOKE_AGGS if smoke else AGGS
    reps = (2 if smoke else 5) if not card else (10 if smoke else 20)
    rows = []
    audits = []
    for k, m in shapes:
        x = _contaminated(k, m, 0, dev)
        plan = mk.launch_plan(k, m, 1)
        fused_bytes = plan.input_bytes + plan.weight_bytes + plan.output_bytes
        for name in aggs:
            kw = {"num_malicious": k // 4} if name == "krum" else {}
            agg = aggregators.get_aggregator(name, **kw)
            us, _ = time_us(lambda: agg(x, None), dev, reps)
            # derived: throughput in M coords / s
            rows.append((f"agg/{name}/K{k}_M{m}", us, m / us, None, 0))
        us, out = time_us(lambda: ops.mm_aggregate(x), dev, reps)
        _assert_finite(f"mm_pallas/K{k}_M{m}", out)
        rows.append((f"agg/mm_pallas/K{k}_M{m}", us, m / us, fused_bytes, 1))
        # weighted single-array kernel path (Eq. 13's a_k inside the kernel)
        a = torch.linspace(0.5, 1.5, k, device=dev)
        us, _ = time_us(lambda: ops.mm_aggregate(x, a), dev, reps)
        rows.append((f"agg/mm_pallas_weighted/K{k}_M{m}", us, m / us,
                     fused_bytes, 1))
        # batched diffusion path: all N neighborhoods, one residency
        for n in (4,) if smoke else (8, 32):
            an = torch.rand((k, n), generator=torch.Generator(device=dev)
                            .manual_seed(1), device=dev) * 0.9 + 0.1
            pn = mk.launch_plan(k, m, n)
            launches = count_launches(ops.mm_aggregate_batched, x, an)
            assert launches == 1, launches
            us, _ = time_us(lambda: ops.mm_aggregate_batched(x, an), dev, reps)
            rows.append((f"agg/mm_pallas_batched/K{k}_M{m}_N{n}", us,
                         n * m / us,
                         pn.input_bytes + pn.weight_bytes + pn.output_bytes,
                         launches))
        audits.append(traffic_audit(k, m))

    # large-cohort rows: the two-pass kernel on meshes whose single-pass
    # tile does not fit a block (the K=256 row is the smoke gate;
    # non-finite output aborts the benchmark).  The audit pins
    # N-independent input bytes, shared memory within the block limit,
    # and modeled traffic <= 2x the single-pass plan's.
    for k, m in (SMOKE_LARGE_K_SHAPES if smoke else LARGE_K_SHAPES):
        x = _contaminated(k, m, 2, dev)
        plan = mk.launch_plan(k, m, 1, path="two_pass")
        us, out = time_us(lambda: ops.mm_aggregate(x, path="two_pass"), dev,
                          reps)
        _assert_finite(f"mm_pallas_two_pass/K{k}_M{m}", out)
        rows.append((f"agg/mm_pallas_two_pass/K{k}_M{m}", us, m / us,
                     plan.total_bytes, 1))
        audits.append(traffic_audit(k, m, block_m=plan.block_m,
                                    path="two_pass"))

    # IRLS-depth sweep: the data behind the default T=10
    k_i, m_i = (8, 1 << 12) if smoke else (32, 1 << 16)
    irls_rows = irls_sweep(_contaminated(k_i, m_i, 3, dev), reps=reps)

    # scenario-runner path: one declarative spec -> a whole run per
    # paradigm.  wall_clock_s times every step of the run; compile_s (the
    # lowering and one warm-up step on a cache miss) is its own
    # *_compile row so trajectory tooling never mixes the two
    sc = dict(num_agents=8, dim=8, num_steps=20, num_malicious=2,
              attack="additive") if smoke else \
        dict(num_agents=16, dim=10, num_steps=200, num_malicious=3,
             attack="additive")
    sc_backends = [("diffusion", "pallas"), ("federated", "jnp")] if smoke \
        else [("diffusion", "pallas"), ("diffusion", "jnp"),
              ("federated", "jnp"), ("sharded", "jnp")]
    for paradigm, backend in sc_backends:
        sp = scenarios.ScenarioSpec(paradigm=paradigm, backend=backend,
                                    aggregator="mm_tukey", **sc)
        res = scenarios.run(sp, device=dev)
        coords = sc["num_steps"] * sc["num_agents"] * sc["dim"]
        tag = (f"{paradigm}/mm_tukey-{backend}"
               f"/K{sc['num_agents']}_M{sc['dim']}_T{sc['num_steps']}")
        us = res.wall_clock_s * 1e6
        rows.append((f"scenario_wall_steady/{tag}", us, coords / us, None, 0))
        rows.append((f"scenario_compile/{tag}", res.compile_s * 1e6, 0.0,
                     None, 0))

    sub_rows, substrate = substrate_row(smoke, dev)
    rows.extend(sub_rows)

    # weighted-pytree engine path: the whole gradient tree in ONE launch
    for k in (8,) if smoke else (8, 32):
        tree = _grad_tree(k, 4 if smoke else 1, dev)
        a = torch.linspace(0.5, 1.5, k, device=dev)
        leaves = pytree.flatten(tree)[0]
        m_total = sum(leaf.numel() // k for leaf in leaves)
        eng = ops.AggregationEngine()
        launches = count_launches(eng.aggregate_tree, tree, a)
        assert launches == 1, f"expected ONE kernel launch, got {launches}"
        pt = mk.launch_plan(k, m_total, 1)
        us, _ = time_us(lambda: eng.aggregate_tree(tree, a), dev, reps)
        rows.append((f"agg/engine_tree_weighted/K{k}_leaves{len(leaves)}"
                     f"_M{m_total}_launches{launches}", us, m_total / us,
                     pt.input_bytes + pt.weight_bytes + pt.output_bytes,
                     launches))
    return rows, audits, irls_rows, substrate


def write_json(path: str, rows, audits, irls_rows, substrate, smoke: bool,
               device) -> None:
    payload = {
        "bench": "agg",
        "mode": "smoke" if smoke else "full",
        "device": tuning.device_name(device),
        "rows": [
            {"name": name, "us_per_call": round(us, 2),
             "coords_per_us": round(thru, 6),
             "modeled_hbm_bytes": bytes_, "launches": calls}
            for name, us, thru, bytes_, calls in rows
        ],
        "traffic_audit": audits,
        "irls_sweep": irls_rows,
        "substrate": substrate,
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small shapes / few reps")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write BENCH_agg_torch.json-style output")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    rows_, audits_, irls_, sub_ = main(smoke=ns.smoke, device=ns.device)
    for name, us, thru, bytes_, calls in rows_:
        print(f"{name},{us:.2f},{thru:.6g}")
    for a_ in audits_:
        print(f"audit/{a_['shape']}[{a_['path']}]: fetches_by_n="
              f"{a_['input_block_fetches_by_n']} n_independent="
              f"{a_['n_independent']}")
    for r_ in irls_:
        print(f"irls/T{r_['num_iters']}: {r_['us_per_call']}us "
              f"msd_vs_oracle={r_['msd_vs_oracle']:.3g}")
    print(f"substrate {sub_['tag']}: {sub_['params']} params, peak "
          f"{sub_['peak_bytes']} B")
    if ns.json:
        write_json(ns.json, rows_, audits_, irls_, sub_, ns.smoke, ns.device)
        print(f"wrote {ns.json}")
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
