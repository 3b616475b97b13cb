"""``python -m repro_torch.analysis`` -- run the port's analysis gate.

Runs the two passes (or a subset via ``--passes``), applies the
checked-in baseline, prints every finding, and exits non-zero if any
finding is not baselined.  On a machine with a card the contracts pass
asks the C entry points too and the launch pass runs there; elsewhere it
says which rules it could not check.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from repro_torch.analysis import findings as F

PASSES = ("contracts", "launch")
BASELINE = "ANALYSIS_BASELINE_TORCH.json"


def run_pass(name: str):
    if name == "contracts":
        from repro_torch.analysis import contracts
        return contracts.check_workloads()
    if name == "launch":
        from repro_torch.analysis import launch_audit
        for rule in launch_audit.unchecked():
            print(f"[not checked] {rule}: needs a card")
        return launch_audit.check_all()
    raise ValueError(f"unknown pass {name!r}; known: {PASSES}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="kernel-contract checker and launch audit of the "
                    "PyTorch/CUDA port")
    ap.add_argument("--passes", default="all",
                    help="comma-separated subset of "
                         f"{','.join(PASSES)} (default: all)")
    ap.add_argument("--root", default=".",
                    help=f"repo root (holding {BASELINE})")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <root>/{BASELINE})")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write findings as JSON to this path")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root).resolve()
    baseline_path = pathlib.Path(args.baseline) if args.baseline \
        else root / BASELINE
    baseline = F.load_baseline(baseline_path)

    names = PASSES if args.passes == "all" else \
        tuple(p.strip() for p in args.passes.split(",") if p.strip())
    for name in names:
        if name not in PASSES:
            raise ValueError(f"unknown pass {name!r}; known: {PASSES}")
    all_findings = []
    timings = {}
    for name in names:
        t0 = time.perf_counter()
        all_findings.extend(run_pass(name))
        timings[name] = time.perf_counter() - t0

    unbaselined, baselined, stale = F.apply(all_findings, baseline)
    for f, reason in baselined:
        print(f.render(reason=reason))
    for f in unbaselined:
        print(f.render())
    for key in stale:
        print(f"[stale-baseline] {key}: baseline entry matched no "
              "finding -- delete it")

    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps({
            "unbaselined": [f.to_dict() for f in unbaselined],
            "baselined": [dict(f.to_dict(), reason=r)
                          for f, r in baselined],
            "stale_baseline_keys": stale,
            "timings_s": {k: round(v, 3) for k, v in timings.items()},
        }, indent=2) + "\n")

    per_pass = ", ".join(f"{k} {v:.1f}s" for k, v in timings.items())
    print(f"repro_torch.analysis: {len(all_findings)} finding(s) "
          f"({len(baselined)} baselined, {len(unbaselined)} new, "
          f"{len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'}) "
          f"[{per_pass}]")
    if unbaselined:
        print("FAIL: unbaselined findings -- fix them or add a "
              f"reasoned entry to {baseline_path.name}")
        return 1
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
