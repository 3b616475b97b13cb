"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json``, from the root of a checkout:
set-up (``setup_s``: from here until the window opens), ``--seconds`` of
measured work, the check of what that work produced against the plain
reference in ``perfbench/reference``, and one JSON line.  ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer
metrics from a traced sub-window.  The cell's configuration, traffic,
limits and per-layer readers are files found by name under
``perfbench/``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "perfbench"


def _environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    the default kernel path (no tuning cache)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ.pop("REPRO_TORCH_TUNING_CACHE", None)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "perfbench")]


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from harness import main as harness_main
    harness_main.run(args, T_PROCESS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
