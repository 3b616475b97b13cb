"""Operations and bytes of one MM-estimate launch over x (K, M) with N
weight columns, frozen here as the yardstick of the kernel rooflines.

``ops`` is a copy of the port's ``kernels.mm_aggregate.modeled_ops`` as
it stood when the benchmark was defined (a test holds the two equal at
each cell's shapes until the program changes its own).  An FMA counts
two, as the peak rate counts it.  Per (column, n) and IRLS step each row
takes 9: r = x - mu, r * r, 1 - r^2 / (c scale)^2 as one FMA against the
folded constant, the clamp at 0, the square, num += w x as an FMA, den
+= w; weights add one multiply.  Each step adds the divide and the test,
and the folded constant costs 3 once.  The start takes 2 per row for the
deviations and compares of the MAD and, weighted, 2 for the cumulative
weight and its compare.  Sorting a column costs K log2 K compares.

``bytes_moved`` counts each input byte read once and each output byte
written once: x, the (K, N) f32 weights, the (N, M) estimate.
"""

from __future__ import annotations

import math

from counts import peaks


def ops(k: int, m: int, n: int, weighted: bool, num_iters: int = 10) -> int:
    per_row = 9 + int(weighted)
    start = 2 * k + (2 * k if weighted else 2) + 3
    sort = k * max(1, math.ceil(math.log2(max(k, 2))))
    return n * m * (num_iters * (per_row * k + 2) + start) + m * sort


def bytes_moved(k: int, m: int, n: int, itemsize: int = 4) -> int:
    return k * m * itemsize + k * n * 4 + n * m * itemsize


def bound_s(k: int, m: int, n: int, weighted: bool) -> tuple:
    """(the least time the chip could take, "ops" or "bytes": which
    bound binds)."""
    t_ops = ops(k, m, n, weighted) / peaks.F32_FLOPS
    t_bytes = bytes_moved(k, m, n) / peaks.HBM_BYTES_PER_S
    return (t_ops, "ops") if t_ops >= t_bytes else (t_bytes, "bytes")
