"""take_ms.serve (ms): ``AggregationService.phase_ms()["take"]``, the
CUDA-event time of copying the estimate out of the launch program's
output, median over the window's commits outside the profiler."""

import statistics

PHASE = "take"


def read(rec):
    if rec["kind"] != "serve":
        return None
    n = rec["records"].get("traced_commits", 0)
    ms = [p[PHASE] for p in rec["records"]["phase_ms"][n:] if PHASE in p]
    return statistics.median(ms) if ms else None
