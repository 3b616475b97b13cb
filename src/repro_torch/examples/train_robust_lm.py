"""End-to-end run: train a transformer LM with Byzantine-robust
data-parallel gradient aggregation (the paper's technique lifted to the
training framework).

Default: a ~20M-param qwen3-family model, 300 steps, 8 simulated agents
sharing the card, one of which sends additively-corrupted gradients.
Compares mean vs REF (rs_mm on the Hopper kernel) aggregation; each run
is one ``python -m repro_torch.launch.train`` process.

  python -m repro_torch.examples.train_robust_lm            # ~20M
  python -m repro_torch.examples.train_robust_lm --big      # ~100M
  python -m repro_torch.examples.train_robust_lm --device cpu --steps 3
  (the full configs run through the launcher:
   python -m repro_torch.launch.train --full-config)
"""

from __future__ import annotations

import argparse
import os
import pathlib
import subprocess
import sys

SRC = str(pathlib.Path(__file__).resolve().parents[2])


def run(agg, malicious, args):
    cmd = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "qwen3-0.6b",
        "--steps", str(args.steps),
        "--batch", "8",
        "--seq", str(args.seq),
        "--layers", str(args.layers),
        "--d-model", str(args.d_model),
        "--aggregation", agg,
        "--malicious", str(malicious),
        "--delta", "100.0",
        "--lr", "3e-3",
        "--agents", "8",
        "--use-kernel",
        "--device", args.device,
    ]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    print(f"\n=== aggregation={agg} malicious={malicious} ===")
    proc = subprocess.run(cmd, env=env, text=True, capture_output=True)
    print(proc.stdout)
    if proc.returncode != 0:
        print(proc.stderr[-2000:])
        raise SystemExit(proc.returncode)
    last = [l for l in proc.stdout.splitlines() if l.startswith("# first-10")]
    return last[0] if last else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--big", action="store_true",
                    help="~100M params")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.big:
        args.layers, args.d_model, args.seq = 8, 512, 256
    else:
        args.layers, args.d_model, args.seq = 4, 256, 128

    results = {}
    results["mean clean"] = run("mean", 0, args)
    results["mean attacked"] = run("mean", 1, args)
    results["REF attacked"] = run("rs_mm", 1, args)

    print("\n================ summary ================")
    for k, v in results.items():
        print(f"{k:16s} {v}")
    print("\nExpected: 'mean attacked' stalls near the initial loss;"
          "\n'REF attacked' tracks 'mean clean'.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
