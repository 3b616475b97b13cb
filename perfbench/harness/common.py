"""What every cell shares: finding a cell's files by name, the checks
before and after a run, and the result line.

A cell's pieces are files found by the names in ``BENCHMARK.json``:

  configs/<config>.json      the configuration as run (``file``)
  families/<family>.py       the configuration's model family, named by
                             its ``family`` key (see ``portcfg``)
  traffic/<mix>.json         the traffic mix's parameters
  kinds/<kind>.py            the driver of every mix of that ``kind``
                             (see ``harness.main``)
  limits/<cell>.json         the limits ``correct`` holds it to
  metrics/<metric>.py        the reader of one per-layer metric
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import subprocess
import sys
from typing import Optional

PB = pathlib.Path(__file__).resolve().parents[1]      # perfbench/
ROOT = PB.parent                                       # the checkout
FOREIGN = ("jax", "jaxlib", "flax", "repro")           # whole top-level names


class RunError(SystemExit):
    """Ends a run with a non-zero code and no result line."""

    def __init__(self, code: int, msg: str):
        print(f"perfbench: {msg}", file=sys.stderr, flush=True)
        super().__init__(code)


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name`` with its configuration, traffic and limits files
    read, and the metrics it reports."""
    pb = root / "perfbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(2, f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", ())
                 or ("workloads" not in m and m["moves"] in reported)]
    return {
        "name": name, "chips": int(w["chips"]), "root": root,
        "config": load_json(root / conf["file"]),
        "traffic": load_json(pb / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(pb / "limits" / f"{name}.json"),
        "end_to_end": e2e, "per_layer": per_layer,
    }


def _load(root: pathlib.Path, folder: str, name: str):
    """The module ``perfbench/<folder>/<name>.py``, loaded once."""
    path = (root / "perfbench" / folder / f"{name}.py").resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise RunError(2, f"no {path.relative_to(root.resolve())}")
        spec = importlib.util.spec_from_file_location(
            f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


_MODULES: dict = {}


def kind(c: dict):
    """The driver of the cell's traffic: ``kinds/<traffic kind>.py``."""
    return _load(c["root"], "kinds", c["traffic"]["kind"])


def family(c: dict):
    """The cell's model family: ``families/<config family>.py``."""
    return _load(c["root"], "families", c["config"]["family"])


def metric_reader(name: str, root: pathlib.Path = ROOT):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    return _load(root, "metrics", name).read


def check_program(root: pathlib.Path = ROOT) -> None:
    """The program under test is the checkout's own ``src/repro_torch``."""
    try:
        import repro_torch
    except ImportError as exc:
        raise RunError(2, f"the program is not in this checkout ({exc})")
    where = pathlib.Path(repro_torch.__file__).resolve()
    if (root / "src") not in where.parents:
        raise RunError(2, f"repro_torch resolves to {where}, outside "
                          f"{root / 'src'}")


def check_device(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise RunError(3, "no CUDA device")
    if torch.cuda.device_count() < chips:
        raise RunError(3, f"the cell takes {chips} devices, "
                          f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def foreign_modules() -> list:
    return sorted(n for n in sys.modules if n.split(".", 1)[0] in FOREIGN)


def power_limit() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def compare(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every reading at or under
    its limit, none missing and none NaN."""
    out, ok = {}, True
    for name, spec in limits["compared"].items():
        value = readings.get(name)
        limit = spec["limit"]
        good = value is not None and not math.isnan(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


def emit(result: dict, compared: dict) -> None:
    """The compared numbers as the last lines on standard error, then the
    result as the last line on standard output (``compared`` its last
    key).  A run with a foreign module loaded prints no result."""
    found = foreign_modules()
    if found:
        raise RunError(4, "modules of the JAX package or JAX loaded: "
                          + ", ".join(found))
    for name, c in compared.items():
        print(f"compared {name} = {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["compared"] = compared
    print(json.dumps(line), flush=True)
