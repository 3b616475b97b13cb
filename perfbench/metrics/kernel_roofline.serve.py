"""kernel_roofline.serve (%): the frozen bound of one commit's MM launch
(``counts.mm_ops``: weighted, K = k_min, M = the payload's coordinates)
times the commits in the profiler's window, over the device time of the
MM kernels there, picked by name."""

import re

KERNELS = re.compile(r"\bmm_(regs|warp|smem|two_pass)\b")


def read(rec):
    if rec["kind"] != "serve":
        return None
    t = sum(v[0] for name, v in rec["trace"].get("device_by_name", {}).items()
            if KERNELS.search(name))
    n = rec["records"].get("traced_commits", 0)
    return 100.0 * rec["bound_s"] * n / t if t > 0 and n else None
