"""guard_ms.serve (ms): ``AggregationService.phase_ms()["guard"]``, the
CUDA-event time of the estimate's finiteness check, median over the
window's commits outside the profiler."""

import statistics

PHASE = "guard"


def read(rec):
    if rec["kind"] != "serve":
        return None
    n = rec["records"].get("traced_commits", 0)
    ms = [p[PHASE] for p in rec["records"]["phase_ms"][n:] if PHASE in p]
    return statistics.median(ms) if ms else None
