"""The Hopper MM kernels against their plain PyTorch versions
(``benchmarks/kernel_bench.py``), at the reference's shapes.

On the card each time is one CUDA-event pair around back-to-back calls
after two warm-up calls, divided by their count (as ``chip_smoke.py``
times a kernel); on the CPU, where the wrappers run the plain versions,
it is the host clock.  The structural win is HBM residency, quantified
as modeled bytes moved (``modeled_hbm_bytes``).

The batched rows quantify the one-residency design: a kernel that put
the N weight-column axis in the launch grid would re-stream the whole
(K, M) update matrix once per column (``one_residency=False``); the
kernels batch N inside a block and read each input tile once
(``one_residency=True``) -- an N x input-traffic reduction for
diffusion-sized N.

Each row is ``(name, us, derived, check)``: ``check`` holds, for a
kernel row, the output's max |d| from the plain version on the same
input and the tolerance 1e-5 x max(1, |x|_inf) (sums run in another
order); None for the plain rows.
"""

from __future__ import annotations

import time

import torch

from repro_torch import devices
from repro_torch.core import location
from repro_torch.kernels import mm_aggregate as mk
from repro_torch.kernels import ops

CARD_REPS = 50      # launches in one event pair on the card
PLAIN_REPS = 3


def time_us(fn, device, reps: int = CARD_REPS):
    """(microseconds per call, last result) of ``fn()``: CUDA events
    around ``reps`` back-to-back calls after two warm-up calls on the
    card, the host clock around them on the CPU."""
    out = fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        return (time.perf_counter() - t0) / reps * 1e6, out
    out = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps * 1e3, out


def modeled_hbm_bytes(k: int, m: int, fused: bool, n: int = 1,
                      one_residency: bool = True) -> int:
    """Bytes moved per aggregation of (K, M) f32 against N weight columns.

    fused + one_residency : 1 read of the tile + weights + N-row write
                            (the current batched kernel)
    fused, not one_resid.  : N reads of the tile (pre-fix grid that
                            re-streamed the input per weight column)
    unfused jnp            : per column, two sorts (r+w each) and T=10
                            IRLS passes (r each)
    """
    tile = k * m * 4
    weights = k * n * 4 if n > 1 else 0
    out = n * m * 4
    if fused:
        reads = tile if one_residency else n * tile
        return reads + weights + out
    return n * (2 * 2 * tile + 10 * tile) + weights + out


def plain(x: torch.Tensor, a, *, path=None):
    """The plain PyTorch version of the launch ``ops.mm_aggregate``
    (``a`` None) or ``ops.mm_aggregate_batched`` (``a`` (K, N)) makes
    for x: the same plan, weights normalized as the engine does, on the
    padded operands -> (N, M)."""
    k, m = x.shape
    weighted = a is not None
    a = location.normalize_weights(a, dtype=torch.float32) if weighted \
        else torch.full((k, 1), 1.0 / k, device=x.device)
    plan = mk.launch_plan(k, m, a.shape[1], dtype=x.dtype, path=path)
    xp, ap = mk._pad_inputs(x, a, plan=plan)
    if plan.path == "two_pass":
        out = mk.mm_two_pass_plain(xp, ap, k=k, block_k=plan.block_k,
                                   weighted=weighted)
    else:
        out = mk.mm_single_pass_plain(xp, ap, k=k, weighted=weighted)
    return out[:, :m]


def check(x: torch.Tensor, got: torch.Tensor, want: torch.Tensor) -> dict:
    """The kernel's output ``got`` against the plain version's ``want``:
    max |d| and the tolerance 1e-5 x max(1, |x|_inf)."""
    err = float((got.reshape(want.shape).float() - want.float()).abs().max())
    return {"max_abs_err": err,
            "tol": 1e-5 * max(1.0, float(x.abs().max()))}


def main(device="cuda") -> list[tuple]:
    dev = devices.resolve(device)
    card = dev.type == "cuda"
    reps = CARD_REPS if card else 2
    p_reps = PLAIN_REPS if card else 1
    g = torch.Generator(device=dev)
    rows = []
    for k, m in ((16, 1 << 15), (32, 1 << 15), (64, 1 << 14)):
        x = torch.randn((k, m), generator=g.manual_seed(0), device=dev)
        t_kernel, got = time_us(lambda: ops.mm_aggregate(x), dev, reps)
        t_plain, want = time_us(lambda: plain(x, None), dev, p_reps)
        rows.append((f"kernel/mm_pallas/K{k}_M{m}", t_kernel,
                     modeled_hbm_bytes(k, m, True), check(x, got, want)))
        rows.append((f"kernel/mm_plain/K{k}_M{m}", t_plain,
                     modeled_hbm_bytes(k, m, False), None))
        # batched traffic model: N weight columns against one residency
        for n in sorted({8, min(16, k)}):
            pre = modeled_hbm_bytes(k, m, True, n=n, one_residency=False)
            post = modeled_hbm_bytes(k, m, True, n=n, one_residency=True)
            a = torch.rand((k, n), generator=g.manual_seed(1),
                           device=dev) * 0.9 + 0.1
            t_b, got = time_us(lambda: ops.mm_aggregate_batched(x, a), dev,
                               reps)
            rows.append((f"kernel/mm_pallas_batched/K{k}_M{m}_N{n}"
                         f"_traffic_x{pre / post:.1f}", t_b, post,
                         check(x, got, plain(x, a))))
    # large-cohort single- vs two-pass crossover: the same one-residency
    # traffic model (the two-pass block statistics never touch HBM), the
    # clock decides -- the sort work drops from one next_pow2(K) network
    # to K/bk blocks of bk plus a small combine.
    for k, m in ((256, 1 << 13), (512, 1 << 12)):
        x = torch.randn((k, m), generator=g.manual_seed(2), device=dev)
        for path in ("single", "two_pass"):
            t_p, got = time_us(lambda: ops.mm_aggregate(x, path=path), dev,
                               reps)
            rows.append((f"kernel/mm_pallas_{path}/K{k}_M{m}", t_p,
                         modeled_hbm_bytes(k, m, True),
                         check(x, got, plain(x, None, path=path))))
    return rows


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for name, us, derived, _ in main(ap.parse_args().device):
        print(f"{name},{us:.2f},{derived}")
