"""kernel_roofline.train (%): the frozen bound of the step's MM launches
(``counts.mm_ops``: one unweighted launch per leaf, the larger of its
f32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s, summed)
over the device time of the MM kernels in the traced step, picked by
name."""

import re

KERNELS = re.compile(r"\bmm_(regs|warp|smem|two_pass)\b")


def read(rec):
    if rec["kind"] != "train":
        return None
    t = sum(v[0] for name, v in rec["trace"].get("device_by_name", {}).items()
            if KERNELS.search(name))
    return 100.0 * rec["mm_bound_s"] / t if t > 0 else None
