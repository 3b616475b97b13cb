"""The readings that a cell's limits are set from, on the card, in one
process: for each seed the program's sound run against the reference
(the lower readings) and, on the first ``--controls`` seeds, the control
and the planted faults against the same reference (the upper readings).

  python3 perfbench/tools/readings.py --workload <cell> --seeds 11 12 ... \
      [--controls 3] [--seconds 3] [--out build/perfbench/readings]

The control is the reference in the program's place, one precision
below the configuration's: float8 (e4m3) matmul operands for the train
cells (the model states bfloat16 activations), bfloat16 for the serve
cells' estimator (float32); the train cells' planted fault is each
agent's loss over half its tokens (a step left unchanged reads 1 and is
not run): each kind's ``Run.controls``.  A train cell's window (one step
at least) runs after the set-up steps the check reads.  One JSON line a
seed, also written to ``--out/<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "perfbench")]

import run as bench_run  # noqa: E402  (sets the caches and the path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="build/perfbench/readings")
    ap.add_argument("--leaves", type=int, default=0,
                    help="print the train cells' N leaves of widest gap")
    ap.add_argument("--act-dtype", default="",
                    help="a witness: run the program's model in this "
                         "activation type instead of the configuration's")
    args = ap.parse_args(argv)
    bench_run._environment()
    import torch
    from harness import common
    cell = common.cell(common.benchmark(), args.workload)
    if args.act_dtype:
        _witness(cell, args.act_dtype)
    device = common.check_device(cell["chips"])
    Run = common.kind(cell).Run
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{args.workload}.jsonl", "a") as sink:
        print(f"readings: {args.workload} on {common.power_limit()}",
              file=sys.stderr, flush=True)
        for n, seed in enumerate(args.seeds):
            t0 = time.perf_counter()
            r = Run(cell, seed, device, False)
            r.setup()
            r.window(args.seconds)
            peak = torch.cuda.max_memory_allocated(device)
            r.free_program()
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            t1 = time.perf_counter()
            row = {"workload": args.workload, "seed": seed,
                   "memory_peak_bytes": peak, "program": r.readings(),
                   "reference_s": time.perf_counter() - t1}
            if args.leaves and cell["traffic"]["kind"] == "train":
                row["leaves"] = _widest(r.program_side(), r.reference(),
                                        args.leaves)
            if n < args.controls:
                row.update(r.controls())
            row["seconds"] = time.perf_counter() - t0
            line = json.dumps(row)
            print(line, flush=True)
            sink.write(line + "\n")
            sink.flush()
            del r
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
    return 0


def _witness(cell: dict, act_dtype: str) -> None:
    """The program's own model in another activation type (a second
    witness beside the reference)."""
    import dataclasses
    from repro_torch import configs
    load = configs.load_arch

    def load_in(name):
        arch = load(name)
        return dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, act_dtype=act_dtype))

    configs.load_arch = load_in
    cell["config"]["activation_dtype"] = act_dtype


def _widest(side: dict, ref: dict, n: int) -> dict:
    """{number: [(leaf, program's, reference's), ...]} of the n leaves
    with the widest gap, and the median leaf's reference value."""
    import statistics
    out = {}
    for key in ("first_grad_norms", "change_norms"):
        a, b = side[key], ref[key]
        med = statistics.median(b.values())
        top = sorted(b, key=lambda k: -abs(a[k] - b[k]) / max(b[k], med,
                                                               1e-30))[:n]
        out[key] = {"median": med,
                    "leaves": [(k, a[k], b[k]) for k in top]}
    return out


if __name__ == "__main__":
    sys.exit(main())
