"""Reproduce the paper's Fig. 1 (MSD sweeps) and print the claim checks.

  python -m repro_torch.examples.paper_fig1 [--iters 1000] [--device cpu]

Writes experiments/torch/fig1_left.csv / fig1_right.csv (full MSD
curves, one column per aggregator x setting) for plotting.  Exits
non-zero if a claim FAILs.  The last line gives C3's clean ratios, one
per seed of ``fig1_msd.C3_SEEDS``, whose median the claim takes.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.benchmarks import fig1_msd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--out-dir", default=fig1_msd.OUT_DIR)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    detail = {}
    rows = fig1_msd.main(iters=args.iters, out_dir=args.out_dir,
                         device=args.device, detail=detail)
    print(f"{'setting':45s} {'steady MSD':>14s}")
    failed = 0
    for name, _, derived in rows:
        if name.startswith("fig1/claim"):
            verdict = "PASS" if derived else "FAIL"
            failed += not derived
            print(f"{name:45s} {verdict:>14s}")
        else:
            print(f"{name:45s} {derived:14.4e}")
    ratios = detail["c3_clean_ratios"]
    print(f"C3 clean REF/mean steady MSD, seeds {fig1_msd.C3_SEEDS}: "
          + " ".join(f"{r:.4f}" for r in ratios)
          + f" (median {float(np.median(ratios)):.4f}, band 1.25)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
