"""Benchmark harness entry point (``benchmarks/run.py``).

  fig1      -- the paper's only figure (MSD sweeps, claim checks)
  agg       -- aggregator cost table (systems counterpart)
  kernel    -- each Hopper MM kernel against its plain PyTorch version
  roofline  -- per (arch x shape) roofline terms from the dry run

  python -m repro_torch.benchmarks.run [--only fig1,agg,kernel,roofline]
      [--device cuda|cpu] [--smoke] [--agg-json PATH]

Prints the ``name,us_per_call,derived`` CSV; a suite that raises prints
an ``ERROR`` row (its traceback on stderr) and the exit code is 1.
"""

from __future__ import annotations

import argparse
import sys
import traceback

SUITES = ("fig1", "agg", "kernel", "roofline")


def suites(wanted, *, device="cuda", fig1_iters=None, smoke: bool = False,
           agg_json=None) -> list:
    """(name, fn) for each wanted suite, in ``SUITES`` order; fn returns
    rows whose first three fields are (name, us, derived)."""
    out = []
    if "fig1" in wanted:
        from repro_torch.benchmarks import fig1_msd
        out.append(("fig1", lambda: fig1_msd.main(iters=fig1_iters,
                                                  device=device)))
    if "agg" in wanted:
        from repro_torch.benchmarks import agg_bench

        def agg():
            rows, audits, irls, sub = agg_bench.main(smoke=smoke,
                                                     device=device)
            if agg_json:
                agg_bench.write_json(agg_json, rows, audits, irls, sub,
                                     smoke, device)
            return rows
        out.append(("agg", agg))
    if "kernel" in wanted:
        from repro_torch.benchmarks import kernel_bench
        out.append(("kernel", lambda: kernel_bench.main(device)))
    if "roofline" in wanted:
        from repro_torch.benchmarks import roofline
        out.append(("roofline", roofline.main))
    return out


def run(wanted, *, out=None, **opts):
    """Print the CSV of the wanted suites to ``out`` (stdout); (every
    row as its suite returned it, whether a suite failed)."""
    out = out or sys.stdout
    print("name,us_per_call,derived", file=out)
    rows, failed = [], False
    for name, fn in suites(wanted, **opts):
        try:
            for row in fn():
                n, us, derived = row[:3]
                print(f"{n},{us:.2f},{derived}", file=out)
                rows.append(row)
        except Exception:  # noqa: BLE001 -- report the suite, run the rest
            failed = True
            print(f"{name},ERROR,see-stderr", file=out)
            traceback.print_exc()
    return rows, failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(SUITES))
    ap.add_argument("--fig1-iters", type=int, default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="agg_bench's small shapes and few reps")
    ap.add_argument("--agg-json", default=None, metavar="PATH",
                    help="also write agg_bench's rows and audits as JSON")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    wanted = set(args.only.split(","))
    unknown = wanted - set(SUITES)
    if unknown:
        ap.error(f"unknown suites {sorted(unknown)}; known: {SUITES}")
    _, failed = run(wanted, device=args.device, fig1_iters=args.fig1_iters,
                    smoke=args.smoke, agg_json=args.agg_json)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
