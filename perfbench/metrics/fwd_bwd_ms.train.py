"""fwd_bwd_ms.train (ms): ``TrainStep.phase_ms()["forward_backward"]``,
the CUDA-event time of every agent's forward and backward, median over
the window's steps outside the profiler."""

import statistics

PHASE = "forward_backward"


def read(rec):
    if rec["kind"] != "train":
        return None
    ms = [p[PHASE] for p, profiled in rec["records"]["phase_ms"]
          if not profiled and PHASE in p]
    return statistics.median(ms) if ms else None
