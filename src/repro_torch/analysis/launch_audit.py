"""Launch audit: the invariants of ``repro.analysis.jaxpr_audit``, checked
on what runs.

The reference traces its programs to jaxprs and counts equations; eager
PyTorch has no program to trace, so this pass runs the real entry points
-- ``AggregationEngine.aggregate`` / ``aggregate_batched`` /
``aggregate_tree``, one step of the scenario runner's lowering, and a
small streaming service -- on the current device and checks what they
launched:

  launch-count    exactly one MM kernel launch per engine call (one
                  tree layout) and per scenario step.  On the CPU the
                  launches are the wrappers' ``mm_aggregate.record_calls``
                  (the plain versions run where the kernels would
                  launch); on the card torch.profiler counts the kernels
                  by name.
  host-sync       (card only; the reference's ``callback``) the steady
                  engine call and the scenario step run under
                  ``torch.cuda.set_sync_debug_mode("error")`` without a
                  host synchronization.
  bf16-stream     a bf16 update stream reaches the kernel as bf16 (the
                  recorded call's x operand and output), and the tree
                  path hands the kernel its staging buffer
                  (``ops.stage_leaves``) as it is, with no second cast.
  serve-retrace   a steady service session captures its launch program
                  once and hits the executable cache on every later
                  cohort; N tenants sharing one ``ExecutableCache``
                  capture once per distinct geometry, never once per
                  tenant.

The reference's ``donation`` rule has no counterpart yet: the port has
no ``lower_tree`` or leaf donation.  Every launch the audit makes runs
inside ``mm_aggregate.uncounted()``, so the launch counts are left as
they were.
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import mm_aggregate as mk

# the kernels' names as torch.profiler reports them
KERNEL_NAMES = ("mm_regs", "mm_warp", "mm_smem", "mm_two_pass")
# windows traced before a card count that saw no kernel at all is trusted
_PROFILER_WINDOWS = 5


def audit_device() -> torch.device:
    """The card where there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def unchecked(device: Optional[torch.device] = None) -> List[str]:
    """The rules this device cannot check."""
    dev = audit_device() if device is None else device
    return [] if dev.type == "cuda" else ["host-sync"]


def _profiled_launches(fn: Callable) -> int:
    """MM kernels torch.profiler sees on the card while fn runs; a
    window that recorded no kernel of any name is traced again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n = 0
    for _ in range(_PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0)]
        n = sum(e.count for e in events
                if any(name in e.key for name in KERNEL_NAMES))
        if events:
            break
    return n


def count_launches(fn: Callable, device: torch.device):
    """(MM kernel launches of one fn() call, the calls the wrappers
    recorded in it): counted by the profiler on the card, by the records
    elsewhere."""
    with mk.uncounted():
        with mk.record_calls() as calls:
            fn()
        n = _profiled_launches(fn) if device.type == "cuda" else len(calls)
    return n, list(calls)


def audit_launches(fn: Callable, *, where: str, path: str = "engine",
                   expect: int = 1,
                   device: Optional[torch.device] = None,
                   stream_dtype=None) -> List[Finding]:
    """Run fn and check its launches: ``expect`` MM launches a call
    (launch-count), none of them syncing with the host on the card
    (host-sync), and with ``stream_dtype`` every recorded call's x
    operand and output in that dtype (bf16-stream)."""
    dev = audit_device() if device is None else device
    out: List[Finding] = []
    n, calls = count_launches(fn, dev)
    if n != expect:
        out.append(Finding(
            rule="launch-count", path=path, where=where,
            detail=f"{n} MM kernel launch(es), expected {expect} (one "
                   "launch per engine call / tree layout / scenario step; "
                   "more means batching regressed, zero means the kernel "
                   "path silently fell back)"))
    if dev.type == "cuda":
        out.extend(_host_sync(fn, where=where, path=path))
    if stream_dtype is not None:
        want = mk.dtype_name(stream_dtype)
        for call in calls:
            x, est = call.operands[0], call.outputs[0]
            if x.dtype != want:
                out.append(Finding(
                    rule="bf16-stream", path=path, where=where,
                    detail=f"the kernel reads x as {x.dtype}: the {want} "
                           "update stream was upcast before the kernel, "
                           "re-inflating HBM input traffic",
                    ident="input"))
            if est.dtype != want:
                out.append(Finding(
                    rule="bf16-stream", path=path, where=where,
                    detail=f"the kernel writes {est.dtype} back instead "
                           f"of the stream dtype {want}", ident="output"))
    return out


def _host_sync(fn: Callable, *, where: str, path: str) -> List[Finding]:
    """fn under torch.cuda.set_sync_debug_mode("error"): any host
    synchronization raises, and becomes the finding."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.synchronize()
    try:
        with mk.uncounted():
            torch.cuda.set_sync_debug_mode("error")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
    except RuntimeError as exc:
        return [Finding(rule="host-sync", path=path, where=where,
                        detail=f"a steady call synchronized with the host: "
                               f"{str(exc).splitlines()[0][:200]}")]
    torch.cuda.synchronize()
    return []


# ---------------------------------------------------------------------------
# the audited targets
# ---------------------------------------------------------------------------

def _engine(**kw):
    from repro_torch.kernels import ops
    return ops.AggregationEngine(**kw)


def check_engine(device: Optional[torch.device] = None) -> List[Finding]:
    """The engine's three entry points, f32 and bf16 streams, and the
    two-pass path."""
    dev = audit_device() if device is None else device
    out: List[Finding] = []
    eng = _engine()
    x32 = torch.zeros((8, 300), dtype=torch.float32, device=dev)
    out.extend(audit_launches(lambda: eng.aggregate(x32),
                              where="aggregate/K8xM300xf32", device=dev))
    a = torch.full((8, 4), 0.25, dtype=torch.float32, device=dev)
    out.extend(audit_launches(lambda: eng.aggregate_batched(x32, a),
                              where="aggregate_batched/K8xM300xN4",
                              device=dev))
    x16 = torch.zeros((8, 300), dtype=torch.bfloat16, device=dev)
    out.extend(audit_launches(lambda: eng.aggregate(x16),
                              where="aggregate/K8xM300xbf16", device=dev,
                              stream_dtype=torch.bfloat16))
    tree = {"w": torch.zeros((8, 32), device=dev),
            "b": torch.zeros((8, 7, 3), device=dev)}
    out.extend(audit_launches(lambda: eng.aggregate_tree(tree),
                              where="aggregate_tree/2-leaves", device=dev))
    out.extend(check_tree_stream(eng, device=dev))
    eng2 = _engine(path="two_pass")
    x2 = torch.zeros((128, 256), dtype=torch.float32, device=dev)
    out.extend(audit_launches(lambda: eng2.aggregate(x2),
                              where="aggregate/K128/two_pass", device=dev))
    return out


def check_tree_stream(engine, device: Optional[torch.device] = None
                      ) -> List[Finding]:
    """bf16 leaves through ``aggregate_tree``: the kernel reads the
    staging buffer ``ops.stage_leaves`` lays out, in its dtype, with no
    cast between the two."""
    from repro_torch.kernels import ops
    dev = audit_device() if device is None else device
    tree = {"w": torch.zeros((8, 32), dtype=torch.bfloat16, device=dev),
            "b": torch.zeros((8, 7, 3), dtype=torch.bfloat16, device=dev)}
    staged = ops.stage_leaves([tree["b"], tree["w"]])
    with mk.uncounted(), mk.record_calls() as calls:
        engine.aggregate_tree(tree)
    want = mk.dtype_name(staged.dtype)
    got = [c.operands[0].dtype for c in calls]
    if got != [want]:
        return [Finding(
            rule="bf16-stream", path="engine", where="aggregate_tree/bf16",
            detail=f"the tree launch reads x as {got}; its staging buffer "
                   f"is {want}: the staged stream was cast again before "
                   "the kernel", ident="tree")]
    return []


def scenario_specs():
    """Tiny kernel-backend specs covering the linear steady paths."""
    from repro_torch.scenarios.spec import ScenarioSpec
    return (
        ScenarioSpec(paradigm="diffusion", backend="pallas",
                     num_agents=5, dim=4, num_steps=2,
                     attack="additive", num_malicious=1),
        ScenarioSpec(paradigm="federated", backend="pallas",
                     num_agents=6, dim=4, num_steps=2,
                     attack="sign_flip", num_malicious=1),
    )


def check_scenarios(specs=None, device: Optional[torch.device] = None
                    ) -> List[Finding]:
    """One step of each spec's lowering (the runner's step function on
    its initial state): one launch per engine layout the step resolves."""
    from repro_torch.kernels import ops
    from repro_torch.scenarios import runner
    dev = audit_device() if device is None else device
    out: List[Finding] = []
    for spec in (scenario_specs() if specs is None else specs):
        low, state, gen = runner._lowered_state(spec, dev)
        with mk.uncounted(), ops.record_workloads() as records:
            low.step_fn(state, gen, 0)
        layouts = [r for r in records if r["backend"] == "pallas"]
        if not layouts:
            out.append(Finding(
                rule="launch-count", path="scenario", where=spec.label(),
                detail="the step resolved no engine workload: the spec's "
                       "aggregation bypassed the engine entirely",
                ident="no-workloads"))
        out.extend(audit_launches(
            lambda: low.step_fn(state, gen, 1), path="scenario",
            where=spec.label(), expect=max(len(layouts), 1), device=dev))
    return out


def _serve_session(device: Optional[torch.device] = None):
    """Three cohorts of identical geometry through one service on the
    kernel backend."""
    from repro_torch.serve.buffer import AgentUpdate
    from repro_torch.serve.clock import SimClock
    from repro_torch.serve.service import AggregationService, ServeConfig
    dev = audit_device() if device is None else device
    svc = AggregationService(
        np.zeros(16, np.float32),
        config=ServeConfig(k_min=4, deadline_s=1.0, backend="pallas"),
        clock=SimClock(), device=dev)
    seq = 0
    for _ in range(3):
        for agent in range(4):
            seq += 1
            svc.submit(AgentUpdate(
                agent_id=agent, round=svc.round,
                payload=torch.full((16,), 0.1, device=dev), seq=seq))
    return svc


def check_serve(session=None) -> List[Finding]:
    """A steady serve session never captures again: cohorts of identical
    geometry after the first all hit the executable cache (``session``
    overrides the default 3-cohort session; the mutation tests inject
    broken ones)."""
    out: List[Finding] = []
    if session is None:
        with mk.uncounted():
            session = _serve_session()
    c = session.telemetry.counters
    commits = int(c["commits"])
    misses = int(c["exec_cache_misses"])
    hits = int(c["exec_cache_hits"])
    if (commits < 3 or misses != 1 or hits != commits - 1
            or session.telemetry.post_warmup_misses):
        out.append(Finding(
            rule="serve-retrace", path="serve", where="session/3xK4",
            detail=f"steady serve session: {commits} identical-geometry "
                   f"cohorts -> {misses} capture(s), {hits} cache hit(s), "
                   f"{session.telemetry.post_warmup_misses} post-warmup "
                   "miss(es); expected exactly one warmup capture and "
                   "hits on every later cohort"))
    return out


def _multitenant_front(tenants: int = 3,
                       device: Optional[torch.device] = None):
    """Tenants of identical cohort geometry behind one transport front,
    two cohorts each, on the kernel backend."""
    from repro_torch.serve.buffer import AgentUpdate
    from repro_torch.serve.clock import SimClock
    from repro_torch.serve.service import ServeConfig
    from repro_torch.serve.transport import TransportFront
    dev = audit_device() if device is None else device
    front = TransportFront(clock=SimClock(), device=dev)
    cfg = ServeConfig(k_min=4, deadline_s=1.0, backend="pallas")
    for i in range(tenants):
        front.add_tenant(f"t{i}", np.zeros(16, np.float32), config=cfg)
    seq = 0
    for _ in range(2):
        for i in range(tenants):
            for agent in range(4):
                seq += 1
                front.offer(f"t{i}", AgentUpdate(
                    agent_id=agent, round=front.tenant(f"t{i}").round,
                    payload=torch.full((16,), 0.1, device=dev), seq=seq))
            front.pump()
    return front


def check_serve_multitenant(front=None) -> List[Finding]:
    """N tenant sessions sharing one executable cache capture exactly
    once per distinct cohort geometry, never once per tenant.  Summing
    the per-key capture counts across every cache object the tenants
    hold exposes the classic regression: each tenant owning its own
    cache still captures each key N times (``front`` overrides the
    default session; the mutation tests inject broken ones)."""
    out: List[Finding] = []
    if front is None:
        with mk.uncounted():
            front = _multitenant_front()
    services = list(front.tenants.values())
    n_tenants = len(services)
    caches = {id(svc.exec_cache): svc.exec_cache for svc in services}
    compiles = collections.Counter()
    hits = 0
    for cache in caches.values():
        compiles.update(cache.compiles)
        hits += cache.hits
    n_keys = len(compiles)
    n_compiles = sum(compiles.values())
    commits = sum(int(svc.telemetry.counters["commits"])
                  for svc in services)
    where = f"multitenant/{n_tenants}xK4"
    recompiled = {k: c for k, c in compiles.items() if c > 1}
    if recompiled:
        out.append(Finding(
            rule="serve-retrace", path="serve", where=where,
            detail=f"{len(recompiled)} geometry key(s) captured up to "
                   f"{max(recompiled.values())}x across {n_tenants} "
                   "tenants (one capture per geometry, never one per "
                   "tenant)", ident="per-tenant-compile"))
    if n_compiles != n_keys:
        out.append(Finding(
            rule="serve-retrace", path="serve", where=where,
            detail=f"{n_compiles} capture(s) for {n_keys} distinct "
                   f"geometry key(s) across {n_tenants} tenants",
            ident="compile-total"))
    if commits < 2 * n_tenants or (not recompiled
                                   and hits < commits - n_keys):
        out.append(Finding(
            rule="serve-retrace", path="serve", where=where,
            detail=f"{commits} commits across {n_tenants} tenants with "
                   f"{hits} shared-cache hit(s) (expected >= "
                   f"{max(commits - n_keys, 0)}): cross-tenant sharing of "
                   "launch programs was not exercised",
            ident="no-sharing"))
    return out


def check_all() -> List[Finding]:
    """The launch pass, on the card where there is one."""
    return (check_engine() + check_scenarios() + check_serve()
            + check_serve_multitenant())
