"""commit_mfu (%): the frozen roofline bound of one commit's estimate
(``counts.mm_ops``: the larger of the f32 operations over 67 TFLOP/s and
the bytes over 3.35 TB/s, for the weighted (k_min, M, 1) launch at T =
10) over the median host time of the window's commits outside the
profiler (the submit call that pumps the commit)."""

import statistics


def read(rec):
    if rec["kind"] != "serve":
        return None
    n = rec["records"].get("traced_commits", 0)
    walls = rec["records"]["commit_wall_s"][n:]
    return 100.0 * rec["bound_s"] / statistics.median(walls) if walls \
        else None
