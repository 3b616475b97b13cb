"""aggregate_ms.train (ms): ``TrainStep.phase_ms()["aggregate"]``,
the CUDA-event time of the per-leaf MM estimates, median over
the window's steps outside the profiler."""

import statistics

PHASE = "aggregate"


def read(rec):
    if rec["kind"] != "train":
        return None
    ms = [p[PHASE] for p, profiled in rec["records"]["phase_ms"]
          if not profiled and PHASE in p]
    return statistics.median(ms) if ms else None
