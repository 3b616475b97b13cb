"""One run of one cell: set-up, the measured window, the check, the
result line.

The cell's traffic names its ``kind``, and ``kinds/<kind>.py`` drives
every mix of that kind through ``Run(cell, seed, device, traced)``:

  setup()                    everything before the window (``setup_s``);
                             ``setup_parts`` {part: seconds} of it
  window(seconds)            the measured window: {name: value}, the
                             cell's end-to-end metrics besides setup_s
  attempted_failed(window)   the result's ``attempted`` and ``failed``
  records                    what the per-layer readers read, its
                             ``trace`` the traced sub-window (reduced
                             by ``harness.trace``)
  layer_record()             {name: value} the readers read besides
  free_program()             drops the program's state
  readings()                 {name: number} of the program's outputs
                             against the plain reference, which
                             ``limits/<cell>.json`` holds
  controls()                 {name: readings} of the control and the
                             planted faults (``tools/readings.py``)

and its module-level ``tiny(cell)`` gives the cell at a size a CPU test
holds.
"""

from __future__ import annotations

import sys
import time

from harness import common, trace


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(cell: dict, seed: int, seconds: float, traced: bool, device,
            t_process: float, parts: dict = None) -> tuple:
    """(result, compared) of one run on ``device``; ``parts`` the
    set-up's parts before the cell's own."""
    import torch
    Run = common.kind(cell).Run
    t_setup = time.perf_counter()
    r = Run(cell, seed, device, traced)
    r.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_process
    parts = dict(parts or {}, cell=time.perf_counter() - t_setup)
    print(f"perfbench: set-up {setup_s!r} s: " + " ".join(
        f"{k}={v!r}" for k, v in {**parts, **r.setup_parts}.items()),
        file=sys.stderr)
    window = r.window(seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if traced:
        trace.finish(r.records["trace"])
    rec = dict(r.layer_record(), kind=cell["traffic"]["kind"], window=window,
               records=r.records, trace=r.records["trace"])
    r.free_program()
    t_check = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = r.readings()
    print(f"perfbench: check {time.perf_counter() - t_check!r} s",
          file=sys.stderr)
    correct, compared = common.compare(readings, cell["limits"])
    print("perfbench: window " + " ".join(
        f"{k}={v!r}" for k, v in window.items()), file=sys.stderr)
    if traced:
        metrics = {}
        for m in cell["per_layer"]:
            value = common.metric_reader(m["name"], cell["root"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(window, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    attempted, failed = r.attempted_failed(window)
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": info}
    if traced:
        tb = rec["trace"]
        info["busy_s"] = tb.get("busy_s")
        info["window_s"] = tb.get("window_s")
        result["breakdown"] = {"device_ops": tb.get("device_ops", []),
                               "idle_gaps": tb.get("idle_gaps", [])}
        print(f"perfbench: trace reduced in {tb.get('reduce_s')!r} s",
              file=sys.stderr)
    return result, compared


def run(args, t_process: float) -> None:
    parts = {"start": time.perf_counter() - t_process}
    bench = common.benchmark()
    cell = common.cell(bench, args.workload)
    t = time.perf_counter()
    import torch
    parts["import_torch"] = time.perf_counter() - t
    t = time.perf_counter()
    device = common.check_device(cell["chips"])
    torch.empty((1,), device=device)
    parts["cuda_init"] = time.perf_counter() - t
    t = time.perf_counter()
    common.check_program()
    parts["import_program"] = time.perf_counter() - t
    print(f"perfbench: {args.workload} seed {args.seed}, torch "
          f"{torch.__version__}", file=sys.stderr, flush=True)
    result, compared = execute(cell, args.seed, args.seconds,
                               args.trace == 1, device, t_process, parts)
    print(f"perfbench: on {common.power_limit()}", file=sys.stderr)
    common.emit(result, compared)
