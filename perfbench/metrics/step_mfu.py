"""step_mfu (%, train): the model FLOPs of a step
(``counts.model_flops``: 6 x weights x tokens + the sequence mixer's
term, recomputation not counted) over the median host time of the
window's steps outside the profiler, against the bf16 dense peak."""

import statistics

from counts import peaks


def read(rec):
    if rec["kind"] != "train":
        return None
    steps = [s for s, profiled in rec["records"]["step_s"] if not profiled]
    if not steps:
        return None
    return 100.0 * rec["flops_per_step"] / (statistics.median(steps)
                                            * peaks.BF16_FLOPS)
