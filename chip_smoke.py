#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --phases build parity

Phases, each printing one JSON line (any failure exits nonzero):

  1 build     compile the CUDA kernels from src/repro_torch/kernels/csrc
              (nvcc, sm_90a) and load them; print the card's name and
              power limit as nvidia-smi reports them.
  2 parity    every kernel against its plain PyTorch version on the card,
              f32 and bf16 (f32: max |d| <= 1e-5 * max(1, |x|_inf), since
              sums run in another order; bf16: within 1 ulp).  Every
              single-pass variant (regs, warp, smem), forced through the
              launch plan, meets every edge: K at each template bound
              (1, 2, 5, 8, 9, 16, 17, 32, 33, 64, as far as the variant
              holds), N = 1, 5, 32, narrow, ragged and wide M, weighted
              and unweighted, tie-heavy columns (multiples of 0.5 under
              uniform weights, so crossings fall exactly on 1/2) and
              all-equal columns (the MAD floor).  The two-pass kernel
              meets the first slice's cases; the cohort's (512, 256, 1);
              (K, N) = (200, 200), (256, 256) and (512, 512), weighted, at
              M of 1,031-4,099; (4096, 8); K = 8192 at N = 1 (16 K
              blocks); K = 1100 at block_k 64 (18 blocks); K = 2048 at
              block_k 32 (64 blocks: the combine in shared memory); a
              last block of one row; a massless middle K block; ties,
              the MAD floor and ragged M; blocks of 8, 4, 2 and 1
              columns.  One summary line per kernel, variant and dtype,
              with its first failing cases.
  3 paper     repro_torch.scenarios.run on the paper's C3 spec (diffusion,
              K=32 fully connected, d=10, 1 attacker at delta=1000) on the
              kernel backend: steady MSD < 1e-2; the mean aggregator as the
              breakdown contrast; the Robust-FedAvg MM setting of
              examples/federated.py.  The single-pass kernel must launch.
  4 cohort    the large_cohort family's federated smoke spec (1024 clients
              at participation 0.5: a 512-agent aggregation).  The
              two-pass kernel must launch and the MSD stay finite.
  5 width     K=8 agents' updates shaped like Qwen3-0.6B's parameter tree
              (14 leaves, 751,894,528 coordinates each), made on the card,
              one agent shifted by 1000, through AggregationEngine
              .aggregate_tree: one launch, checked against the plain
              version over every column, timed with CUDA events.
  6 batch     one aggregate_batched launch at (K, M, N) = (32, 2^20, 32),
              the diffusion case, beside its plain version; then the
              same over 256 fully connected agents, (256, 2^16, 256),
              weighted, which takes the two-pass kernel.
  7 cohort_width  the large cohort aggregated over the parameters of one
              Qwen3-0.6B decoder layer: K = 512 clients (the last 64
              shifted by 1000), M = 15,730,944, f32, made on the card
              from a seed (32.2 GB), through AggregationEngine.aggregate:
              one two-pass launch, checked against the plain version
              over every column, timed as the other entries.

  8 serve     the streaming service (repro_torch.serve) through its
              replay harness, as benchmarks/serve_bench.py drives the
              JAX package: the clean, stragglers, network and mixed
              (2 tenants sharing one cache) chaos profiles, 16 agents a
              tenant, dim 8, k_min 8, deadline 1 s, 30 rounds, seed 0,
              on the kernel backend.  Each profile must stay in its
              spec's band, complete every round, admit nothing twice
              and recover from every injected fault mode; each cohort
              geometry is captured once across tenants; launch_failed
              counts injected faults only.  Then a mixed replay with a
              crash at 0.5 (no duplicate admission) and two runs of one
              mixed replay, whose journals must be identical bytes.
  9 serve_width  the service at Qwen3-0.6B's full width (M =
              751,894,528, every layer): 8 agents' payloads made on the
              card, agent 7 shifted by 1000, k_min 8, three full
              cohorts.  One capture, three graph replays; agent 7 an
              outlier each time; the first commit bit-equal to an eager
              AggregationEngine.aggregate of the same cohort and within
              the parity tolerance of the plain version over every
              column.  Per commit: submit-to-commit time and the device
              times of staging, replay, outlier check and clip.
 10 serve_cohort  the service at k_min = 128 over one Qwen3-0.6B decoder
              layer (M = 15,730,944), the last 16 agents shifted by
              1000, two commits: the single-pass smem variant, held to
              its plain version.

The service's launches are CUDA-graph replays: the kernel wrappers
count the warm-up launch before each capture, and each replay adds its
launch to their counts (ops.LaunchProgram.replay); the serve entries of
the kernels line take their launches from the service's own count of
replays.  A serve entry's ``ms`` is one event pair around back-to-back
replays of the service's program, ``call_ms`` one replay at a time.

Then one {"kernels": [...]} line, the nvidia-smi line, and the final
{"ok": true, "device": ...} line.  A kernel's ``ms`` is one CUDA-event
pair around 50 back-to-back launches (10 for the 256-agent batch and
the cohort layer), divided by their count; ``call_ms`` is the median of
three single launches, each inside its own event pair with the wrapper's
host work (the way the first slice timed it); ``profiler_ms`` is a
call's device time by torch.profiler: the sum over every kernel the call
runs of its device time per launch (``profiler_kernels`` gives each
kernel's name and share).  Each entry of the kernels line is one
main-path run (the paper and federated scenarios, the large cohort and
its layer-wide launch, the tree launch, the diffusion batches) and its
launches are that run's own
count: every count is set to 0 just before the run and read just after;
launches made to time a kernel or compare it with its plain version are
not counted.  bound_ms is the larger of the bytes the function must move
over 3.35 TB/s and its f32 operations (mm_ops) over 67 TFLOP/s (H100 SXM
data sheet).  No single PyTorch call computes an MM estimate, so
library_ms is null.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PHASES = ("build", "parity", "paper", "cohort", "width", "batch",
          "cohort_width", "serve", "serve_width", "serve_cohort")

# Qwen3-0.6B (configs/qwen3_0p6b.py) parameter tree: leaf shapes
QWEN3_0P6B_SHAPES = {
    "blocks": {
        "attn": {"k_norm": (28, 128), "q_norm": (28, 128),
                 "wk": (28, 1024, 1024), "wo": (28, 2048, 1024),
                 "wq": (28, 1024, 2048), "wv": (28, 1024, 1024)},
        "ln1": (28, 1024), "ln2": (28, 1024),
        "mlp": {"w_down": (28, 3072, 1024), "w_gate": (28, 1024, 3072),
                "w_up": (28, 1024, 3072)},
    },
    "embed": (152064, 1024),
    "head": (1024, 152064),
    "ln_f": (1024,),
}
WIDTH_AGENTS = 8

# single-pass parity edges: K at each template bound of the variants, and
# (M, N, weighted, kind) so that every variant meets narrow, ragged and
# wide M, N = 1, 5 and 32, both medians, ties and the MAD floor
PARITY_K = (1, 2, 5, 8, 9, 16, 17, 32, 33, 64)
PARITY_KINDS = ("contaminated", "ties", "all_equal", "massless")
PARITY_EDGES = ((10, 1, False, "contaminated"), (10, 5, True, "ties"),
                (4099, 32, True, "contaminated"), (4099, 1, True, "all_equal"),
                (65536, 1, False, "all_equal"), (65536, 5, True, "ties"),
                (65539, 1, True, "contaminated"))
# two-pass parity cases (K, M, N, weighted, block_k, kind): the first
# slice's; the cohort's; the (K, N) the first kernel could not fit; 16,
# 18 and 64 K blocks; a last block of one row; a massless middle block;
# ties, the MAD floor and ragged M; blocks of 8, 4, 2 and 1 columns
TWO_PASS_CASES = (
    (128, 2049, 1, True, None, "contaminated"),
    (300, 513, 3, True, None, "contaminated"),
    (1024, 4096, 1, False, 512, "contaminated"),
    (96, 777, 2, True, 32, "contaminated"),
    (2048, 1024, 1, True, 512, "contaminated"),
    (512, 256, 1, False, None, "contaminated"),
    (200, 1031, 200, True, None, "contaminated"),
    (256, 4099, 256, True, None, "contaminated"),
    (256, 1031, 256, True, None, "ties"),
    (512, 1031, 512, True, None, "contaminated"),
    (4096, 4099, 8, True, None, "contaminated"),
    (4096, 4099, 1, False, None, "all_equal"),
    (8192, 1031, 1, True, None, "contaminated"),
    (8192, 1031, 1, False, None, "ties"),
    (1100, 4099, 1, True, 64, "contaminated"),
    (1100, 4099, 1, False, 64, "all_equal"),
    (2048, 1031, 1, True, 32, "contaminated"),
    (2048, 1031, 1, False, 32, "ties"),
    (513, 4099, 8, True, None, "ties"),
    (1024, 4099, 2, True, 256, "massless"),
    (512, 300, 2, True, None, "all_equal"),
    (70, 4099, 1, True, 32, "ties"),
    (65, 4099, 1, False, None, "all_equal"),
    (300, 65539, 1, True, None, "all_equal"),
)
# the large cohort aggregated layer by layer: 512 participating clients
# (examples/scenario_sweep.py large_cohort, 1024 at participation 0.5)
# over the parameters of one Qwen3-0.6B decoder layer, the last 64
# (12.5%) shifted by 1000
COHORT_K, COHORT_BAD = 512, 64
# the streaming service's cohorts: benchmarks/serve_bench.py's rows (the
# mixed profile with two tenants), and the 128-client cohort that the
# service aggregates over one decoder layer, the last 16 shifted by 1000
SERVE_PROFILES = (("clean", 1), ("stragglers", 1), ("network", 1),
                  ("mixed", 2))
SERVE_ROUNDS = 30
SERVE_COHORT_K, SERVE_COHORT_BAD = 128, 16


def layer_width() -> int:
    """Parameters of one Qwen3-0.6B decoder layer: each blocks.* leaf of
    the table divided by its 28 layers."""
    shapes, _ = qwen3_shapes()
    return sum(math.prod(sh[1:]) for sh in shapes if len(sh) > 1
               and sh[0] == 28)


def qwen3_shapes():
    """(leaf shapes in tree order, tree definition) of the table."""
    from repro_torch import pytree
    return pytree.flatten(QWEN3_0P6B_SHAPES,
                          is_leaf=lambda t: isinstance(t, tuple))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def mm_ops(k: int, m: int, n: int, weighted: bool, num_iters: int = 10,
           sort_rows: int = 0) -> int:
    """f32 operations the MM estimate needs, an FMA counted as two (as the
    peak rate counts it).  Per (column, n) and IRLS step, each row takes
    9: r = x - mu, r * r, 1 - r^2 / (c scale)^2 as one FMA against the
    folded constant, the clamp at 0, the square, num += w x as an FMA,
    den += w; weights add one multiply.  Each step adds the divide and
    the test, and the folded constant costs 3 once.  The start takes 2
    per row for the deviations and compares of the MAD and, weighted, 2
    for the cumulative weight and its compare.  Sorting a column costs
    K log2 K compares (log2 of the sorted block, ``sort_rows``, where
    the column is sorted in blocks)."""
    per_row = 9 + int(weighted)
    start = 2 * k + (2 * k if weighted else 2) + 3
    sort = k * max(1, math.ceil(math.log2(max(sort_rows or k, 2))))
    return n * m * (num_iters * (per_row * k + 2) + start) + m * sort


def ptxas_summary(log: str) -> list:
    """Per compiled kernel of ``nvcc -Xptxas -v`` output: its (mangled)
    name, registers, stack frame and spill bytes."""
    rows, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"fn": ln.split("'")[1]}
            rows.append(cur)
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            cur.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif cur is not None and "Used" in ln and "registers" in ln:
            words = ln.split()
            cur["registers"] = int(words[words.index("Used") + 1])
    return rows


def bound(bytes_moved: int, ops: int) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Smoke:
    def __init__(self, torch, args):
        self.torch = torch
        self.args = args
        self.dev = torch.device("cuda")
        self.kernels = {}          # entry name -> kernels-line dict
        self.parity_err = {"single_pass": 0.0, "two_pass": 0.0}

    # -- helpers -----------------------------------------------------------

    def time_ms(self, fn, reps: int = 3, warmup: int = 1) -> tuple:
        """(median ms over reps, last result), one CUDA-event pair each."""
        torch = self.torch
        out = None
        for _ in range(warmup):
            out = fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times), out

    def kernel_ms(self, fn, launches: int = 50) -> tuple:
        """(ms per launch, last result): one CUDA-event pair around
        ``launches`` back-to-back calls, after two warm-up calls."""
        torch = self.torch
        out = fn()
        out = fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / launches, out

    def profiler_ms(self, fn, launches: int = 10) -> tuple:
        """(device ms of one call of fn, {kernel name: device ms per
        launch}) from torch.profiler over ``launches`` calls: a call's
        time is the sum over every kernel it runs, whatever its name;
        (None, {}) where the profiler reports no device time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
        # per recorded launch: the profiler may drop a window's first one
        by_name = {e.key: e.self_device_time_total * 1e-3 / e.count
                   for e in prof.key_averages()
                   if e.count and getattr(e, "self_device_time_total", 0)}
        return (sum(by_name.values()) if by_name else None), by_name

    @staticmethod
    def _counts():
        from repro_torch.kernels import mm_aggregate as mk
        return (mk.LAUNCHES, mk.LAUNCHES_BY_VARIANT)

    def main_path(self, fn):
        """Run fn with every launch count set to 0; (result, its counts,
        the single-pass launches by variant)."""
        for counts in self._counts():
            for key in counts:
                counts[key] = 0
        result = fn()
        self.torch.cuda.synchronize()
        launches, by_variant = self._counts()
        return result, dict(launches), dict(by_variant)

    def not_counted(self, fn):
        """Run fn (a comparison launch) without touching the counts."""
        saved = [dict(c) for c in self._counts()]
        try:
            return fn()
        finally:
            for counts, old in zip(self._counts(), saved):
                counts.update(old)

    def measure(self, key, label, x, a, plan, counts, by_variant,
                weighted=True, launches=50, chunk=None):
        """Time a kernel (``ms``: ``launches`` back-to-back launches;
        ``call_ms``: one call at a time, as the first slice did;
        ``profiler_ms``: a call's device time) and its plain version on
        the same inputs (``chunk`` columns at a time), compare them, and
        record the kernels-line entry with the launches of the main-path
        run (``counts``, ``by_variant``) that gave the shape.  A
        single-pass entry's plan must name the variant that run
        launched."""
        from repro_torch.kernels import mm_aggregate as mk
        two = plan.path == "two_pass"
        if not two:
            assert by_variant[plan.variant] == counts["single_pass"] > 0, \
                (key, plan.variant, by_variant)
        run = mk.two_pass if two else mk.single_pass
        call = lambda: run(x, a, plan, weighted=weighted)
        call_ms, _ = self.not_counted(lambda: self.time_ms(call))
        ms, got = self.not_counted(lambda: self.kernel_ms(call, launches))
        prof, by_name = self.not_counted(lambda: self.profiler_ms(
            call, launches=3 if ms > 10 else 10))
        pms, err = self.plain_check(x, a, got, plan, weighted, chunk)
        assert err <= 1e-5 * max(1.0, float(x.abs().max())), (key, err)
        t, by = bound(plan.total_bytes,
                      mm_ops(x.shape[0], x.shape[1], plan.n_out, weighted,
                             sort_rows=plan.block_k if two else 0))
        name = "mm_two_pass" if two else "mm_single_pass"
        self.kernels[key] = dict(
            name=key, shape=label, variant=plan.variant or "two_pass",
            launches=counts["two_pass" if two else "single_pass"],
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces="src/repro/kernels/mm_aggregate.py:" +
                     ("306" if two else "243"),
            max_abs_err=err, ms=ms, call_ms=call_ms, profiler_ms=prof,
            profiler_kernels=by_name, plain_ms=pms, bound_ms=t, bound_by=by,
            library_ms=None, block_m=plan.block_m, block_k=plan.block_k,
            n_chunk=plan.n_chunk)
        return self.kernels[key]

    def plain_check(self, x, a, got, plan, weighted, chunk=None):
        """(ms of the plain version over every column, its max |d| from
        the kernel's ``got``), run ``chunk`` columns at a time (all at
        once for None) so its (K, N, M) planes fit the card."""
        from repro_torch.kernels import mm_aggregate as mk
        k, m = x.shape
        chunk = chunk or m
        plain_ms, err = 0.0, 0.0
        for lo in range(0, m, chunk):
            xc = x[:, lo:lo + chunk].contiguous()
            pc = mk.launch_plan(k, xc.shape[1], plan.n_out, path=plan.path,
                                block_k=plan.block_k, variant=plan.variant)
            xp, ap = mk._pad_inputs(xc, a, plan=pc)
            if plan.path == "two_pass":
                plain = lambda: mk.mm_two_pass_plain(
                    xp, ap, k=k, block_k=plan.block_k, weighted=weighted)
            else:
                plain = lambda: mk.mm_single_pass_plain(xp, ap, k=k,
                                                        weighted=weighted)
            t, want = self.time_ms(plain, reps=1, warmup=0)
            plain_ms += t
            err = max(err, float((got[:, lo:lo + chunk]
                                  - want[:, :xc.shape[1]]).abs().max()))
            del xc, xp, want
        return plain_ms, err

    def device_busy_share(self, fn):
        """Share of fn's wall time the card spent in kernels, from
        torch.profiler; None where the profiler reports no device time."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        except Exception as exc:  # the share is reported, never required
            print(f"profiler unavailable: {exc!r}", file=sys.stderr)
            return None
        busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                      for e in prof.key_averages())
        return (busy_us * 1e-6 / wall) if busy_us > 0 else None

    # -- phases ------------------------------------------------------------

    def build(self):
        from repro_torch.kernels import build, mm_aggregate as mk
        t0 = time.perf_counter()
        libs = build.load_all()
        seconds = time.perf_counter() - t0
        # the launch plan's shared-memory model is what the kernels carve
        for variant, code in mk.SINGLE_PASS_VARIANTS.items():
            for k, n, bm in ((5, 1, 256), (32, 32, 128), (64, 1, 256),
                             (8, 4, 64)):
                got = libs["mm_single_pass"].mm_single_pass_smem_bytes(
                    code, k, n, bm)
                assert got == mk.variant_smem_bytes(variant, k, n, bm), \
                    (variant, k, n, bm, got)
        for k, nc, bk, bm in ((512, 1, 512, 8), (1024, 1, 512, 8),
                              (8192, 1, 512, 4), (256, 64, 256, 8),
                              (96, 2, 32, 4), (2048, 1, 32, 8),
                              (65, 1, 128, 1)):
            got = libs["mm_two_pass"].mm_two_pass_smem_bytes(k, nc, bk, bm)
            assert got == mk.two_pass_smem_bytes(k, nc, bk, bm), \
                (k, nc, bk, bm, got)
        ptxas = ptxas_summary(build.build_log())
        assert ptxas and not any(f.get("stack", 0) or f.get("spill_stores", 0)
                                 or f.get("spill_loads", 0) for f in ptxas), ptxas
        emit({"phase": "build", "seconds": seconds,
              "per_library_s": build.BUILD_SECONDS, "ptxas": ptxas,
              "gpu": self.torch.cuda.get_device_name(0)})
        print(nvidia_smi(), flush=True)

    def _parity_case(self, k, m, n, dtype, weighted, path, block_k=None,
                     variant=None, kind="contaminated"):
        """One kernel launch against its plain version on the same inputs;
        the case's row (``ok`` False where it disagrees).  ``kind``:
        contaminated (20% of the rows shifted by 1000), ties (multiples of
        0.5 under uniform weights) or all_equal (every 7th column one
        constant, the MAD floor, beside contaminated columns) or massless
        (contaminated, the second K block's weights 0)."""
        torch = self.torch
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        seed = k * 7919 + m + n + 104729 * PARITY_KINDS.index(kind)
        g = torch.Generator(device=self.dev).manual_seed(seed)
        x = torch.randn((k, m), generator=g, device=self.dev)
        if kind == "ties":
            x = torch.round(x * 2.0) / 2.0 + 0.0       # no -0.0
        else:
            x[k - max(1, k // 5):] += 1000.0            # 20% contamination
        if kind == "all_equal":
            x[:, ::7] = 3.0
        x = x.to(dtype)
        plan = mk.launch_plan(k, m, n, dtype=dtype, block_k=block_k,
                              path=path, variant=variant)
        if not weighted:
            a = torch.full((k, 1), 1.0 / k, device=self.dev)
        elif kind == "ties":
            a = torch.full((k, n), 1.0 / k, device=self.dev)
        else:
            a = torch.rand((k, n), generator=g, device=self.dev) * 0.9 + 0.1
            if kind == "massless":
                a[plan.block_k:2 * plan.block_k] = 0.0
            a = location.normalize_weights(a, dtype=torch.float32)
        run = mk.two_pass if path == "two_pass" else mk.single_pass
        got = self.not_counted(lambda: run(x, a, plan, weighted=weighted))
        xp, ap = mk._pad_inputs(x, a, plan=plan)
        if path == "two_pass":
            want = mk.mm_two_pass_plain(xp, ap, k=k, block_k=plan.block_k,
                                        weighted=weighted)
        else:
            want = mk.mm_single_pass_plain(xp, ap, k=k, weighted=weighted)
        want = want[:, :m]
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(x.float().abs().max()))
        if dtype == torch.float32:
            ok = err <= 1e-5 * scale
        else:
            bits = (got.view(torch.int16).int() - want.view(torch.int16).int()).abs()
            close = (got.float() - want.float()).abs() <= 1e-5 * scale
            ok = bool(((bits <= 1) | close).all())
        name = "two_pass" if path == "two_pass" else "single_pass"
        if dtype == torch.float32:
            self.parity_err[name] = max(self.parity_err[name], err)
        return {"kernel": name, "variant": plan.variant, "kind": kind,
                "k": k, "m": m, "n": n,
                "dtype": str(dtype).replace("torch.", ""), "weighted": weighted,
                "block_m": plan.block_m, "block_k": plan.block_k,
                "n_chunk": plan.n_chunk, "max_abs_err": err,
                "tol": 1e-5 * scale if dtype == torch.float32 else "1 ulp",
                "ok": ok}

    def parity(self):
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk
        single = ((5, 130, 1, False), (32, 4099, 1, True), (32, 4099, 32, True),
                  (33, 1000, 5, True), (64, 8192, 1, False))
        rows = []
        for dtype in (torch.float32, torch.bfloat16):
            for k, m, n, w in single:
                rows.append(self._parity_case(k, m, n, dtype, w, "single"))
            for k, m, n, w, bk, kind in TWO_PASS_CASES:
                rows.append(self._parity_case(k, m, n, dtype, w, "two_pass",
                                              bk, kind=kind))
            # every variant, forced through the plan, at every edge
            for variant in mk.SINGLE_PASS_VARIANTS:
                max_k = mk.VARIANT_MAX_K.get(variant, max(PARITY_K))
                for k in (k for k in PARITY_K if k <= max_k):
                    for m, n, w, kind in PARITY_EDGES:
                        rows.append(self._parity_case(
                            k, m, n, dtype, w, "single", variant=variant,
                            kind=kind))
        groups = {}
        for row in rows:
            g = groups.setdefault((row["kernel"], row["variant"], row["dtype"]),
                                  {"cases": 0, "failed": [], "max_abs_err": 0.0})
            g["cases"] += 1
            g["max_abs_err"] = max(g["max_abs_err"], row["max_abs_err"])
            if not row["ok"]:
                g["failed"].append(row)
        for (kernel, variant, dtype), g in groups.items():
            emit({"phase": "parity", "kernel": kernel, "variant": variant,
                  "dtype": dtype, "cases": g["cases"],
                  "max_abs_err": g["max_abs_err"],
                  "failed": g["failed"][:5], "n_failed": len(g["failed"])})
        bad = sum(len(g["failed"]) for g in groups.values())
        if bad:
            raise AssertionError(f"{bad} parity cases disagree with the "
                                 "plain version")

    def paper(self):
        from repro_torch import scenarios
        from repro_torch.configs import paper_lsq

        def spec(agg, backend):
            return scenarios.ScenarioSpec(
                paradigm="diffusion", num_agents=paper_lsq.NUM_AGENTS,
                dim=paper_lsq.DIM, noise_var=paper_lsq.NOISE_VAR,
                topology="fully_connected", aggregator=agg, backend=backend,
                attack="additive", num_malicious=1,
                attack_kwargs=(("delta", 1000.0),),
                step_size=paper_lsq.STEP_SIZE, num_steps=500, seed=0,
                data_seed=0)

        ref, counts, variants = self.main_path(
            lambda: scenarios.run(spec("mm_tukey", "pallas")))
        steady = ref.summary["steady_msd"]
        assert variants["warp"] == counts["single_pass"] > 0, variants
        assert steady < 1e-2, steady
        mean = scenarios.run(spec("mean", "jnp"))
        fed_spec = scenarios.ScenarioSpec(
            paradigm="federated", num_agents=32, participation=0.5,
            local_steps=5, dim=10, noise_var=0.01, step_size=0.05,
            num_steps=300, attack="additive",
            attack_kwargs=(("delta", 1000.0),), aggregator="mm_tukey",
            num_malicious=6, backend="pallas")
        fed, fcounts, fvariants = self.main_path(lambda: scenarios.run(fed_spec))
        assert fvariants["warp"] == fcounts["single_pass"] > 0, fvariants
        assert fed.finite(), fed.history
        # one diffusion step's launch: (K, M, N) = (32, 10, 32)
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        g = self.torch.Generator(device=self.dev).manual_seed(2)
        x = self.torch.randn((32, 10), generator=g, device=self.dev)
        x[31] += 1000.0
        a = location.normalize_weights(
            self.torch.ones((32, 32), device=self.dev))
        step = self.measure("mm_single_pass (paper diffusion step)",
                            "K=32 M=10 N=32 f32", x, a,
                            mk.launch_plan(32, 10, 32), counts, variants)
        # one federated round's launch: the cohort, unweighted
        kc = fed_spec.clients_per_round()
        xc = self.torch.randn((kc, 10), generator=g, device=self.dev)
        xc[kc - 3:] += 1000.0
        self.measure("mm_single_pass (federated round)",
                     f"K={kc} M=10 N=1 f32", xc,
                     self.torch.full((kc, 1), 1.0 / kc, device=self.dev),
                     mk.launch_plan(kc, 10, 1), fcounts, fvariants,
                     weighted=False)
        busy = self.not_counted(lambda: self.device_busy_share(
            lambda: scenarios.run(spec("mm_tukey", "pallas"))))
        emit({"phase": "paper", "ref_steady_msd": steady,
              "step_launch_ms": step["ms"], "ref_device_busy_share": busy,
              "ref_launches": counts, "ref_variants": variants,
              "ref_compile_s": ref.compile_s,
              "ref_wall_s": ref.wall_clock_s,
              "mean_steady_msd": mean.summary["steady_msd"],
              "mean_broke_down": mean.summary["broke_down"],
              "fed_mm_msd_at_50": float(fed.history["msd"][49]),
              "fed_mm_final_msd": fed.final_msd, "fed_launches": fcounts,
              "fed_variants": fvariants,
              "fed_wall_s": fed.wall_clock_s})

    def cohort(self):
        from repro_torch import scenarios
        sp = scenarios.ScenarioSpec(
            paradigm="federated", aggregator="mm_tukey", backend="pallas",
            attack="additive", num_agents=1024, dim=256, num_steps=3,
            num_malicious=128, participation=0.5, seed=0)
        res, counts, variants = self.main_path(lambda: scenarios.run(sp))
        assert counts["two_pass"] > 0, counts
        assert res.finite(), res.history
        audit = res.launch_audit
        x = self.torch.randn((512, 256), device=self.dev)
        x[448:] += 1000.0
        a = self.torch.full((512, 1), 1.0 / 512, device=self.dev)
        from repro_torch.kernels import mm_aggregate as mk
        plan = mk.launch_plan(512, 256, 1, block_m=audit["block_m"],
                              block_k=audit["block_k"], path="two_pass")
        entry = self.measure("mm_two_pass", "K=512 M=256 N=1 f32 "
                             "(large_cohort)", x, a, plan, counts, variants,
                             weighted=False)
        ms, pms, err = entry["ms"], entry["plain_ms"], entry["max_abs_err"]
        emit({"phase": "cohort", "msd": [float(v) for v in res.history["msd"]],
              "launches": counts, "audit": audit, "ms": ms,
              "call_ms": entry["call_ms"], "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"], "plain_ms": pms,
              "max_abs_err": err, "blocks": mk.two_pass_blocks(
                  plan, 512, weighted=False)})

    def width(self):
        torch = self.torch
        from repro_torch import pytree
        from repro_torch.kernels import mm_aggregate as mk, ops
        leaves_shapes, treedef = qwen3_shapes()
        k = WIDTH_AGENTS
        g = torch.Generator(device=self.dev).manual_seed(0)
        leaves = []
        for shape in leaves_shapes:
            leaf = torch.randn((k,) + tuple(shape), generator=g,
                               device=self.dev)
            leaf[k - 1] += 1000.0                # one byzantine agent
            leaves.append(leaf)
        tree = pytree.unflatten(treedef, leaves)
        m_total = sum(math.prod(s) for s in leaves_shapes)
        engine = ops.AggregationEngine()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, counts, variants = self.main_path(
            lambda: engine.aggregate_tree(tree))
        tree_ms = (time.perf_counter() - t0) * 1e3  # stage + launch + split
        peak = torch.cuda.max_memory_allocated()
        assert counts == {"single_pass": 1, "two_pass": 0}, counts
        assert variants["regs"] == 1, variants
        uniform = torch.full((k, 1), 1.0 / k, device=self.dev)

        def plain(x):
            return mk.mm_single_pass_plain(x.contiguous(), uniform, k=k,
                                           weighted=False)[0]

        windows = {}
        # the first 2^20 coordinates of embed, 2^20 from the middle of
        # w_down (layer 14 of 28), all of ln_f
        checks = (("embed", ("embed",), 0, 2 ** 20),
                  ("blocks.mlp.w_down", ("blocks", "mlp", "w_down"), 0.5,
                   2 ** 20),
                  ("ln_f", ("ln_f",), 0, None))
        for label, path, start, width in checks:
            src, got = tree, out
            for p in path:
                src, got = src[p], got[p]
            lo = int(start * got.numel())
            sl = slice(lo, None if width is None else lo + width)
            want = plain(src.reshape(k, -1)[:, sl])
            err = float((got.reshape(-1)[sl] - want).abs().max())
            assert bool(torch.isfinite(got).all()), label
            assert err <= 1e-5 * 1001.0, (label, err)
            windows[label] = err
        del out, tree
        buf = ops.stage_leaves(leaves)
        del leaves
        plan = mk.launch_plan(k, m_total, 1)
        assert plan.variant == "regs", plan
        call = lambda: mk.single_pass(buf, uniform, plan, weighted=False)[0]
        call_ms, _ = self.not_counted(lambda: self.time_ms(call))
        ms, est = self.not_counted(lambda: self.kernel_ms(call))
        prof, prof_kernels = self.not_counted(
            lambda: self.profiler_ms(call, launches=3))
        # the plain version over every column, in chunks it can hold
        chunk = 2 ** 24
        err, plain_ms = 0.0, 0.0
        for lo in range(0, m_total, chunk):
            x = buf[:, lo:lo + chunk]
            t, want = self.time_ms(lambda: plain(x), reps=1, warmup=0)
            plain_ms += t
            err = max(err, float((est[lo:lo + chunk] - want).abs().max()))
        assert err <= 1e-5 * 1001.0, err
        gbs = plan.total_bytes / (ms * 1e-3) / 1e9
        t_bytes = plan.total_bytes / HBM_BYTES_PER_S * 1e3
        t, by = bound(plan.total_bytes, mm_ops(k, m_total, 1, False))
        self.kernels["mm_single_pass"] = dict(
            name="mm_single_pass",
            shape=f"K={k} M={m_total} N=1 f32 (Qwen3-0.6B tree)",
            variant=plan.variant, launches=counts["single_pass"],
            source="src/repro_torch/kernels/csrc/mm_single_pass.cu",
            replaces="src/repro/kernels/mm_aggregate.py:243", max_abs_err=err,
            ms=ms, call_ms=call_ms, profiler_ms=prof,
            profiler_kernels=prof_kernels, plain_ms=plain_ms,
            bound_ms=t, bound_by=by, library_ms=None)
        emit({"phase": "width", "leaves": len(leaves_shapes),
              "m_total": m_total, "launches": counts, "window_err": windows,
              "max_abs_err_all_columns": err, "tree_ms": tree_ms, "ms": ms,
              "call_ms": call_ms, "profiler_ms": prof, "plain_ms": plain_ms,
              "bound_share": t / ms, "variant": plan.variant,
              "total_bytes": plan.total_bytes, "gb_per_s": gbs,
              "hbm_bound_ms": t_bytes, "hbm_bound_share": t_bytes / ms,
              "bound_ms": t, "bound_by": by, "block_m": plan.block_m,
              "max_memory_allocated": peak})

    def batch(self):
        torch = self.torch
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk, ops
        k, m, n = 32, 2 ** 20, 32
        g = torch.Generator(device=self.dev).manual_seed(1)
        x = torch.randn((k, m), generator=g, device=self.dev)
        x[k - 1] += 1000.0
        a = location.normalize_weights(
            torch.rand((k, n), generator=g, device=self.dev) + 0.1)
        # the engine's batched entry point, as diffusion_step calls it
        out, counts, variants = self.main_path(
            lambda: ops.AggregationEngine().aggregate_batched(x, a))
        assert counts == {"single_pass": 1, "two_pass": 0}, counts
        assert variants["regs"] == 1, variants
        assert out.shape == (n, m) and bool(torch.isfinite(out).all())
        del out
        plan = mk.launch_plan(k, m, n)
        entry = self.measure("mm_single_pass (diffusion batch)",
                             f"K={k} M={m} N={n} f32", x, a, plan, counts,
                             variants)
        ms, pms, err = entry["ms"], entry["plain_ms"], entry["max_abs_err"]
        t, by = entry["bound_ms"], entry["bound_by"]
        emit({"phase": "batch", "k": k, "m": m, "n": n, "ms": ms,
              "call_ms": entry["call_ms"], "profiler_ms": entry["profiler_ms"],
              "variant": plan.variant,
              "plain_ms": pms, "max_abs_err": err, "bound_ms": t,
              "bound_by": by, "block_m": plan.block_m,
              "total_bytes": plan.total_bytes, "launches": counts})
        del x, a
        # fully connected diffusion over 256 agents: (256, 2^16, 256),
        # weighted, on the two-pass kernel (its weights staged 64 columns
        # of N at a time)
        k, m, n = 256, 2 ** 16, 256
        x = torch.randn((k, m), generator=g, device=self.dev)
        x[k - k // 5:] += 1000.0
        a = location.normalize_weights(
            torch.rand((k, n), generator=g, device=self.dev) + 0.1)
        out, counts, variants = self.main_path(
            lambda: ops.AggregationEngine().aggregate_batched(x, a))
        assert counts == {"single_pass": 0, "two_pass": 1}, counts
        assert out.shape == (n, m) and bool(torch.isfinite(out).all())
        del out
        plan = mk.launch_plan(k, m, n)
        entry = self.measure("mm_two_pass (diffusion batch, 256 agents)",
                             f"K={k} M={m} N={n} f32", x, a, plan, counts,
                             variants, launches=10, chunk=4096)
        emit({"phase": "batch", "k": k, "m": m, "n": n, "ms": entry["ms"],
              "call_ms": entry["call_ms"], "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "variant": "two_pass", "plain_ms": entry["plain_ms"],
              "max_abs_err": entry["max_abs_err"],
              "bound_ms": entry["bound_ms"], "bound_by": entry["bound_by"],
              "block_m": plan.block_m, "block_k": plan.block_k,
              "n_chunk": plan.n_chunk, "smem_bytes": plan.smem_bytes,
              "blocks": mk.two_pass_blocks(plan, k),
              "total_bytes": plan.total_bytes, "launches": counts})

    def cohort_width(self):
        torch = self.torch
        from repro_torch.kernels import mm_aggregate as mk, ops
        m = layer_width()
        k = COHORT_K
        torch.cuda.empty_cache()  # the earlier phases' cached blocks
        g = torch.Generator(device=self.dev).manual_seed(3)
        x = torch.randn((k, m), generator=g, device=self.dev)
        x[k - COHORT_BAD:] += 1000.0
        engine = ops.AggregationEngine()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out, counts, variants = self.main_path(lambda: engine.aggregate(x))
        peak = torch.cuda.max_memory_allocated()
        assert counts == {"single_pass": 0, "two_pass": 1}, counts
        assert out.shape == (m,) and bool(torch.isfinite(out).all())
        plan = mk.launch_plan(k, m, 1)
        assert plan.path == "two_pass" and plan.num_k_blocks == 1, plan
        uniform = torch.full((k, 1), 1.0 / k, device=self.dev)
        est = self.not_counted(
            lambda: mk.two_pass(x, uniform, plan, weighted=False))
        assert torch.equal(est[0], out), "the engine and the wrapper disagree"
        del out, est
        entry = self.measure(
            "mm_two_pass (large-cohort layer)",
            f"K={k} M={m} N=1 f32 (one Qwen3-0.6B decoder layer)", x,
            uniform, plan, counts, variants, weighted=False, launches=10,
            chunk=2 ** 20)
        ms, t = entry["ms"], entry["bound_ms"]
        t_bytes = plan.total_bytes / HBM_BYTES_PER_S * 1e3
        emit({"phase": "cohort_width", "k": k, "m": m, "launches": counts,
              "ms": ms, "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "plain_ms": entry["plain_ms"],
              "max_abs_err_all_columns": entry["max_abs_err"],
              "bound_ms": t, "bound_by": entry["bound_by"],
              "bound_share": t / ms, "hbm_bound_ms": t_bytes,
              "gb_per_s": plan.total_bytes / (ms * 1e-3) / 1e9,
              "total_bytes": plan.total_bytes, "block_m": plan.block_m,
              "block_k": plan.block_k, "smem_bytes": plan.smem_bytes,
              "blocks": mk.two_pass_blocks(plan, k, weighted=False),
              "max_memory_allocated": peak})

    # -- the streaming service ---------------------------------------------

    def measure_program(self, key, label, program, launches, plain_err,
                        plain_ms, launches_timed=10):
        """A serve entry of the kernels line: the service's launch
        program (a captured CUDA graph) timed as the other entries time
        their kernel -- ``ms`` over back-to-back replays, ``call_ms`` one
        replay at a time, ``profiler_ms`` torch.profiler's device time
        of a replay -- beside the plain check its phase made
        (``plain_err``, ``plain_ms``) and the launches of the service's
        run (its replays)."""
        plan = program.plan
        k, m = program.x.shape
        call_ms, _ = self.not_counted(lambda: self.time_ms(program.replay))
        ms, _ = self.not_counted(
            lambda: self.kernel_ms(program.replay, launches_timed))
        prof, by_name = self.not_counted(lambda: self.profiler_ms(
            program.replay, launches=3 if ms > 10 else 10))
        if prof is None:
            by_name = {"note": "torch.profiler attributed no device time "
                               "to the graph replay; ms and call_ms are "
                               "CUDA-event times"}
        t, by = bound(plan.total_bytes, mm_ops(k, m, 1, True))
        self.kernels[key] = dict(
            name=key, shape=label, variant=plan.variant, launches=launches,
            source="src/repro_torch/kernels/csrc/mm_single_pass.cu",
            replaces="src/repro/kernels/mm_aggregate.py:243",
            max_abs_err=plain_err, ms=ms, call_ms=call_ms, profiler_ms=prof,
            profiler_kernels=by_name, plain_ms=plain_ms, bound_ms=t,
            bound_by=by, library_ms=None, block_m=plan.block_m,
            block_k=plan.block_k, n_chunk=plan.n_chunk, graph_replay=True)
        return self.kernels[key]

    def plain_over(self, x, a, est, chunk):
        """(plain ms, max |d|) of the single-pass plain version over every
        column of x (K, M) with weights a (K,), ``chunk`` columns at a
        time, against the estimate ``est`` (M,)."""
        from repro_torch.core import location
        from repro_torch.kernels import mm_aggregate as mk
        k, m = x.shape
        aw = location.normalize_weights(a.reshape(k, 1), dtype=self.torch.float32)
        plan = mk.launch_plan(k, m, 1)
        return self.plain_check(x, aw, est.reshape(1, -1), plan, True, chunk)

    def serve(self):
        import dataclasses
        from repro_torch.kernels import mm_aggregate as mk, ops
        from repro_torch.scenarios.spec import ScenarioSpec
        from repro_torch.serve import CHAOS_PROFILES, ServeConfig, replay
        cfg = ServeConfig(k_min=8, deadline_s=1.0, backend="pallas")

        def run(profile, tenants, chaos=None):
            spec = ScenarioSpec(
                name=f"serve-{profile}", paradigm="federated",
                num_agents=16 * tenants, dim=8, num_steps=SERVE_ROUNDS,
                step_size=0.05, local_steps=3)
            return replay(spec, chaos=chaos or CHAOS_PROFILES[profile],
                          serve=cfg, rounds=SERVE_ROUNDS, seed=0,
                          tenants=tenants, device="cuda")

        results, counts, variants = self.main_path(
            lambda: [run(p, t) for p, t in SERVE_PROFILES])
        rows, replays, captures = [], 0, 0
        for (profile, tenants), res in zip(SERVE_PROFILES, results):
            row = res.to_row()
            tr, c = res.transport, row["counters"]
            fault = "launch_fault" in res.chaos.fault_modes()
            ok = (not row["broke_down"]
                  and row["rounds_completed"] == SERVE_ROUNDS
                  and row["duplicate_admissions"] == 0
                  and all(v > 0 for v in row["recoveries"].values())
                  and tr["exec_cache_compiles"] == tr["exec_cache_keys"]
                  and tr["exec_cache_max_compiles_per_key"] == 1
                  and row["post_warmup_cache_hit"]
                  # a launch that fails other than by injection raises;
                  # what is counted failed exhausted injected faults
                  and c.get("launch_attempts_exhausted", 0)
                  == c.get("launch_failed", 0) * cfg.retry.max_attempts
                  and (fault or c.get("launch_failed", 0) == 0))
            replays += tr["exec_cache_replays"]
            captures += tr["exec_cache_compiles"]
            rows.append({
                "profile": profile, "tenants": tenants, "ok": ok,
                "steady_msd": row["steady_msd"],
                "breakdown_level": row["breakdown_level"],
                "rounds_completed": row["rounds_completed"],
                "duplicate_admissions": row["duplicate_admissions"],
                "recoveries": row["recoveries"],
                "latency_p50": row["latency_p50"],
                "latency_p95": row["latency_p95"],
                "latency_p99": row["latency_p99"],
                "launch_wall_p50": row["launch_wall_p50"],
                "updates_per_sec": row["updates_per_sec"],
                "wall_s": row["wall_s"],
                "exec_cache_keys": tr["exec_cache_keys"],
                "exec_cache_compiles": tr["exec_cache_compiles"],
                "exec_cache_hits": tr["exec_cache_hits"],
                "exec_cache_replays": tr["exec_cache_replays"],
                "launch_failed": c.get("launch_failed", 0),
                "launch_recovered": c.get("launch_recovered", 0),
                "launch_audit": res.launch_audit})
        for row in rows:
            emit(dict(row, phase="serve"))
        assert all(r["ok"] for r in rows), [r for r in rows if not r["ok"]]
        # each replay launches the kernel once, each capture warmed it up
        assert counts == {"single_pass": replays + captures,
                          "two_pass": 0}, (counts, replays, captures)
        assert variants["warp"] == counts["single_pass"], variants
        crash = run("mixed", 2, dataclasses.replace(
            CHAOS_PROFILES["mixed"], crash_restart_frac=(0.5,)))
        assert crash.duplicate_admissions == 0 and \
            crash.crash_restarts == 2, crash.to_row()
        again = [run("mixed", 2) for _ in range(2)]
        same = all(again[0].journals[n].dump() == again[1].journals[n].dump()
                   for n in again[0].journals)
        assert same, "two runs of one replay wrote different journals"
        # the cohort's launch program, timed on a seeded cohort
        engine = ops.get_engine(num_iters=cfg.num_iters, backend=cfg.backend)
        program = self.not_counted(lambda: engine.lower_launch(
            8, 8, self.torch.float32, device="cuda").compile())
        g = self.torch.Generator(device=self.dev).manual_seed(4)
        x = self.torch.randn((8, 8), generator=g, device=self.dev)
        x[7] += 1000.0
        a = self.torch.rand((8,), generator=g, device=self.dev) + 0.5
        est = self.not_counted(lambda: program(x, a)).clone()
        pms, err = self.plain_over(x, a, est, None)
        assert err <= 1e-5 * 1001.0, err
        entry = self.measure_program(
            "mm_single_pass (serve replay)",
            "K=8 M=8 N=1 f32 (serve_bench cohorts, graph replay)", program,
            replays, err, pms, launches_timed=50)
        emit({"phase": "serve_replay", "replays": replays,
              "captures": captures, "launches": counts, "variants": variants,
              "crash_duplicate_admissions": crash.duplicate_admissions,
              "crash_restarts": crash.crash_restarts,
              "journals_identical": same, "ms": entry["ms"],
              "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "bound_ms": entry["bound_ms"], "plan_variant": program.plan.variant})

    def _serve_cohorts(self, k, m, bad, cohorts, seed, check):
        """A service at k_min = k over width m on the card: ``cohorts``
        full cohorts of k payloads made on the card (the last ``bad``
        shifted by 1000).  ``check(svc)`` runs (uncounted) after the
        first commit, while the static buffer still holds its cohort.
        Returns (service, per-commit rows, launch counts, variants)."""
        torch = self.torch
        from repro_torch.serve import (AgentUpdate, AggregationService,
                                       ServeConfig, SimClock)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        svc = AggregationService(
            torch.zeros((m,), device=self.dev),
            config=ServeConfig(k_min=k, deadline_s=1.0, backend="pallas"),
            clock=SimClock(), device="cuda")
        g = torch.Generator(device=self.dev).manual_seed(seed)
        out = []

        def run():
            for c in range(cohorts):
                for agent in range(k):
                    payload = torch.randn((m,), generator=g, device=self.dev)
                    if agent >= k - bad:
                        payload += 1000.0
                    if agent == k - 1:
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                    svc.submit(AgentUpdate(agent_id=agent, round=svc.round,
                                           payload=payload, seq=c + 1))
                    del payload
                torch.cuda.synchronize()
                commit_ms = (time.perf_counter() - t0) * 1e3
                (commit,) = svc.drain_commits()
                out.append({"kind": commit.kind, "round": commit.round,
                            "submit_to_commit_ms": commit_ms,
                            "device_ms": svc.phase_ms(),
                            "compile_s": commit.compile_s,
                            "cache_hit": commit.cache_hit,
                            "launch_wall_s": commit.launch_wall_s,
                            "clipped": commit.clipped,
                            "outliers": list(commit.outliers)})
                if c == 0:
                    out[0]["check"] = self.not_counted(lambda: check(svc))

        _, counts, variants = self.main_path(run)
        return svc, out, counts, variants

    def _first_commit_check(self, svc, chunk):
        """The first commit's estimate (the model: no trust history yet,
        so no clip) against an eager AggregationEngine.aggregate of the
        same cohort and weights (bit for bit) and the plain version."""
        torch = self.torch
        from repro_torch.kernels import ops
        (program,) = svc.exec_cache.programs()
        x = program.x
        est = svc.model
        a = torch.ones((x.shape[0],), device=self.dev)
        eager = ops.get_engine(num_iters=10, backend="pallas").aggregate(x, a)
        equal = bool(torch.equal(eager, est))
        del eager
        plain_ms, err = self.plain_over(x, a, est, chunk)
        return {"eager_equal": equal, "plain_ms": plain_ms,
                "max_abs_err_all_columns": err}

    def serve_width(self):
        shapes, _ = qwen3_shapes()
        m = sum(math.prod(s) for s in shapes)
        k = WIDTH_AGENTS
        svc, commits, counts, variants = self._serve_cohorts(
            k, m, 1, 3, 5, lambda s: self._first_commit_check(s, 2 ** 24))
        peak = self.torch.cuda.max_memory_allocated()
        check = commits[0].pop("check")
        stats = svc.exec_cache.stats()
        for c in commits:
            emit(dict(c, phase="serve_width"))
        assert [c["kind"] for c in commits] == ["aggregated"] * 3, commits
        assert svc.telemetry.counters["launch_failed"] == 0  # none injected
        assert all(c["outliers"] == [k - 1] for c in commits), commits
        assert (stats["exec_cache_compiles"], stats["exec_cache_hits"],
                stats["exec_cache_replays"]) == (1, 2, 3), stats
        assert svc.telemetry.launch_replays == 3
        assert counts == {"single_pass": 4, "two_pass": 0}, counts
        assert variants["regs"] == 4, variants
        assert check["eager_equal"], check
        assert check["max_abs_err_all_columns"] <= 1e-5 * 1001.0, check
        (program,) = svc.exec_cache.programs()
        entry = self.measure_program(
            "mm_single_pass (serve, Qwen3-0.6B width)",
            f"K={k} M={m} N=1 f32 (service, graph replay)", program,
            stats["exec_cache_replays"], check["max_abs_err_all_columns"],
            check["plain_ms"])
        emit({"phase": "serve_width", "m": m, "k": k, "stats": stats,
              "launches": counts, "variant": program.plan.variant,
              "eager_equal": check["eager_equal"],
              "max_abs_err_all_columns": check["max_abs_err_all_columns"],
              "ms": entry["ms"], "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
              "bound_by": entry["bound_by"],
              "compile_s": commits[0]["compile_s"],
              "max_memory_allocated": peak})
        del svc, program

    def serve_cohort(self):
        m, k, bad = layer_width(), SERVE_COHORT_K, SERVE_COHORT_BAD
        svc, commits, counts, variants = self._serve_cohorts(
            k, m, bad, 2, 6, lambda s: self._first_commit_check(s, 2 ** 20))
        peak = self.torch.cuda.max_memory_allocated()
        check = commits[0].pop("check")
        stats = svc.exec_cache.stats()
        for c in commits:
            emit(dict(c, phase="serve_cohort"))
        assert [c["kind"] for c in commits] == ["aggregated"] * 2, commits
        assert svc.telemetry.counters["launch_failed"] == 0  # none injected
        assert all(c["outliers"] == list(range(k - bad, k))
                   for c in commits), commits
        assert (stats["exec_cache_compiles"],
                stats["exec_cache_replays"]) == (1, 2), stats
        assert counts == {"single_pass": 3, "two_pass": 0}, counts
        assert variants["smem"] == 3, variants
        assert check["eager_equal"], check
        assert check["max_abs_err_all_columns"] <= 1e-5 * 1001.0, check
        (program,) = svc.exec_cache.programs()
        assert program.plan.variant == "smem", program.plan
        entry = self.measure_program(
            "mm_single_pass (serve, 128-client cohort layer)",
            f"K={k} M={m} N=1 f32 (service, graph replay)", program,
            stats["exec_cache_replays"], check["max_abs_err_all_columns"],
            check["plain_ms"])
        emit({"phase": "serve_cohort", "m": m, "k": k, "stats": stats,
              "launches": counts, "variant": program.plan.variant,
              "block_m": program.plan.block_m,
              "smem_bytes": program.plan.smem_bytes,
              "eager_equal": check["eager_equal"],
              "max_abs_err_all_columns": check["max_abs_err_all_columns"],
              "ms": entry["ms"], "call_ms": entry["call_ms"],
              "profiler_ms": entry["profiler_ms"],
              "profiler_kernels": entry["profiler_kernels"],
              "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
              "bound_by": entry["bound_by"],
              "compile_s": commits[0]["compile_s"],
              "max_memory_allocated": peak})
        del svc, program

    def kernels_line(self) -> None:
        rows = []
        for entry in self.kernels.values():
            kernel = "two_pass" if "two_pass" in entry["name"] else "single_pass"
            assert entry["launches"] > 0, entry
            rows.append(dict(entry, route="cuda",
                             parity_max_abs_err=self.parity_err[kernel]))
        print(json.dumps({"kernels": rows}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", nargs="+", choices=PHASES, default=PHASES)
    args = ap.parse_args(argv)
    if not (HERE / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py drives the port on a GPU",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke(torch, args)
    for phase in PHASES:
        if phase in args.phases:
            getattr(smoke, phase)()
    smoke.kernels_line()
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
