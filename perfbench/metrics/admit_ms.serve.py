"""admit_ms.serve (ms): ``AggregationService.phase_ms()["admit"]``, the
CUDA-event time of the admission gate's finiteness checks over every
update submitted since the commit before (refused ones too), median over
the window's commits outside the profiler."""

import statistics

PHASE = "admit"


def read(rec):
    if rec["kind"] != "serve":
        return None
    n = rec["records"].get("traced_commits", 0)
    ms = [p[PHASE] for p in rec["records"]["phase_ms"][n:] if PHASE in p]
    return statistics.median(ms) if ms else None
