"""A traced sub-window: ``torch.profiler`` over CPU and CUDA, reduced to
what the per-layer metrics and the result's ``breakdown`` read.

* ``busy_s``: the union of the device's operation intervals (kernels,
  copies, sets) inside the window, so operations that overlap count once;
* ``window_s``: from the start of the first benchmark span in the window
  to the end of the last (each span ends after a synchronize);
* ``device_by_name``: {operation name: [device seconds, count]};
* ``idle_gaps``: every gap between busy intervals, labelled by the
  benchmark span the host was in and the innermost host operator running
  when the gap began, summed by label.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Optional

SPANS = ("step", "submit", "commit")
TOP = 10


def _events(prof):
    """(cpu, device): lists of (start_ns, end_ns, name, thread), read from
    the profiler's raw Kineto events, without building the operator tree
    of ``prof.events()``."""
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CPU"):
            cpu.append((start, end, name, e.start_thread_id()))
        elif name not in SPANS:
            dev.append((start, end, name, 0))
    return cpu, dev


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _Covering:
    """The innermost host operator running at a time, per thread: ops
    sorted by start with each one's enclosing op."""

    def __init__(self, cpu):
        self.threads = {}
        by_thread = collections.defaultdict(list)
        for ev in cpu:
            if ev[2] not in SPANS:
                by_thread[ev[3]].append(ev)
        for tid, evs in by_thread.items():
            evs.sort(key=lambda e: (e[0], -e[1]))
            parent, stack = [], []
            for i, (s, e, _, _) in enumerate(evs):
                while stack and evs[stack[-1]][1] < e:
                    stack.pop()
                parent.append(stack[-1] if stack else -1)
                stack.append(i)
            self.threads[tid] = (evs, [ev[0] for ev in evs], parent)

    def at(self, t) -> Optional[tuple]:
        best = None
        for evs, starts, parent in self.threads.values():
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and evs[i][1] <= t:
                i = parent[i]
            if i >= 0 and (best is None or evs[i][0] > best[0]):
                best = evs[i]
        return best


def reduce(prof) -> dict:
    """The window's numbers from the profiler's trace, the benchmark's
    spans read from it."""
    cpu, dev = _events(prof)
    spans = sorted((s, e, n) for s, e, n, _ in cpu if n in SPANS)
    if not spans:
        return {"busy_s": None, "window_s": None, "device_by_name": {},
                "device_ops": [], "idle_gaps": []}
    w0, w1 = spans[0][0], max(e for _, e, _ in spans)
    inside = [(max(s, w0), min(e, w1)) for s, e, _, _ in dev
              if e > w0 and s < w1]
    busy = _merge(inside)
    by_name: dict = {}
    for s, e, name, _ in dev:
        if e > w0 and s < w1:
            d = by_name.setdefault(name, [0.0, 0])
            d[0] += (min(e, w1) - max(s, w0)) * 1e-9
            d[1] += 1
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    cover = _Covering(cpu)
    span_starts = [s for s, _, _ in spans]
    idle: dict = collections.defaultdict(float)
    for g0, g1 in gaps:
        j = bisect.bisect_right(span_starts, g0) - 1
        span = spans[j][2] if j >= 0 and spans[j][1] > g0 else "none"
        op = cover.at(g0)
        label = f"{span}/{op[2] if op else 'none'}"[:100]
        idle[label] += (g1 - g0) * 1e-9
    busy_s = sum(e - s for s, e in busy) * 1e-9
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy_s, "window_s": (w1 - w0) * 1e-9,
        "device_by_name": by_name,
        "device_ops": [[n[:200], v[0]] for n, v in top_ops],
        "idle_gaps": [[k, v] for k, v in sorted(idle.items(),
                                                key=lambda kv: -kv[1])[:TOP]],
    }


@contextlib.contextmanager
def traced(box: dict):
    """Profile the block; ``box["prof"]`` holds the profile until
    ``finish`` reduces it (after the window, so the reduction's host
    time falls outside it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield
        torch.cuda.synchronize()
    box["prof"] = prof


def finish(box: dict) -> None:
    """Reduce a held profile into ``box`` (and ``reduce_s``, the seconds
    the reduction took)."""
    prof = box.pop("prof", None)
    if prof is None:
        return
    t0 = time.perf_counter()
    box.update(reduce(prof))
    box["reduce_s"] = time.perf_counter() - t0


@contextlib.contextmanager
def span(name: str, on: bool):
    """A benchmark span around a call into a layer (only in traced runs)."""
    if not on:
        yield
        return
    import torch
    with torch.profiler.record_function(name):
        yield
