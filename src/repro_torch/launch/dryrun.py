"""Dry run on meta tensors: trace one rank's step of every (arch x shape)
pair at the full published width, computing nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  ... writes one JSON per pair under experiments/dryrun_torch/.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
pair with XLA on 512 placeholder devices.  Eager PyTorch has no program
to compile, so the step itself runs, on tensors of the meta device:
every operator computes its output's shape and dtype and nothing else,
the MM kernel wrappers record their launch and return an empty estimate
(``mm_aggregate.record_calls``), and Mode B's collectives run on a
process group that moves nothing (``torch.distributed``'s ``fake``
backend, at the mesh's world size, this process its rank 0).  No card is
needed.

The mesh is 16 agent ranks (``--ranks``; 2 x 16 with ``--multi-pod``),
with no model axis (``model_axis: 1``: the port has no tensor
parallelism).  The step is the one ``arch.parallel_for(shape)`` names,
with the kernels on (``use_kernel``):

  train, fsdp=False   Mode A (``make_train_step_gspmd``) as its default
                      places it on a mesh: one card is one agent, the
                      rank's step its agent's rows (the card-side check
                      traces K agents on one card the same way).
  train, fsdp=True    Mode B (``make_train_step_fsdp``) on rank 0: its
                      shards, its optimizer state and its rows.
  prefill / decode    the serve steps on rank 0's rows of the batch and
                      of the cache (sharded weights with fsdp).

Each record holds what can be counted without computing: ``params`` and
``active_params`` (the config's counts) beside ``param_numel`` (the
leaves'), ``flops_per_rank`` (``torch.utils.flop_counter``),
``bytes_accessed_per_rank`` and ``aten_ops`` (every operator's input and
output bytes, which eager PyTorch moves unfused; views move nothing),
``mm_launches`` (each distinct kernel call with its count, modeled bytes
and operations), ``collectives`` by kind (count, and the bytes this rank
sends, ``core.sharded.TRAFFIC``), and ``memory``: the arguments
(parameters, optimizer state, batch or cache; ``argument_alloc_bytes``
rounds each to the caching allocator's 512-byte granule, as
``torch.cuda.memory_allocated`` counts them), the step's new outputs,
the tensors saved for backward (``saved_tensors_hooks``; at most those of
one backward at a time), and the most bytes live at once (arguments and
every operator's new storage until it is freed).  ``trace_s`` replaces
the reference's ``lower_s``/``compile_s``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import datetime
import json
import os
import time
import traceback
import weakref
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs, pytree
from repro_torch.core import sharded
from repro_torch.kernels import mm_aggregate as mk
from repro_torch.launch import steps
from repro_torch.launch.mesh import AgentMesh
from repro_torch.models import model as M
from repro_torch.optim import optimizers

AGENT_RANKS = 16
PODS = 2               # --multi-pod
ALLOC_GRANULE = 512    # the CUDA caching allocator rounds every block to this
CARD_BYTES = 80e9      # one H100's memory
# c10d operators as the dispatcher names them -> sharded.TRAFFIC's kinds
_COLLECTIVES = {"alltoall": "all_to_all", "allgather": "all_gather",
                "reduce_scatter": "reduce_scatter", "allreduce": "all_reduce"}


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts (the dispatcher's
    arguments and results, a step's pytrees)."""
    out, stack = [], [tree]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _alloc(nbytes: int) -> int:
    return max(ALLOC_GRANULE, -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE)


def storage_bytes(tensors, *, rounded: bool = False) -> int:
    """Bytes of the distinct storages behind ``tensors`` (each rounded to
    the allocator's granule with ``rounded``)."""
    seen = {}
    for t in tensors:
        seen[_key(t)] = t.untyped_storage().nbytes()
    return sum(_alloc(n) if rounded else n for n in seen.values())


class OpMeter(TorchDispatchMode):
    """Every operator the step dispatches: its count by name, the bytes
    of its tensor inputs and outputs (views, which move nothing, count
    none), the collectives by kind, and the bytes live at once: the
    arguments' storages plus every new storage an operator makes, until
    Python frees it."""

    def __init__(self, arguments=()):
        super().__init__()
        self.ops = collections.Counter()
        self.bytes = 0
        self.collectives = collections.Counter()
        self._live: dict = {}
        self._skip = {_key(t) for t in arguments}
        self._info: dict = {}           # operator -> (name, is_view, kind)
        self.current = storage_bytes(arguments, rounded=True)
        self.peak = self.current

    def _release(self, key: int) -> None:
        entry = self._live.pop(key, None)
        if entry is not None:
            self.current -= entry[0]

    def _operator(self, func) -> tuple:
        info = self._info.get(func)
        if info is None:
            name = str(func.overloadpacket)
            kind = next((k for tag, k in _COLLECTIVES.items()
                         if name.startswith("c10d.") and tag in name), None)
            info = self._info[func] = (name, func.is_view, kind)
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name, is_view, kind = self._operator(func)
        self.ops[name] += 1
        if kind is not None:
            self.collectives[kind] += 1
        if is_view:
            return out
        outs = _tensors(out)
        self.bytes += sum(t.numel() * t.element_size()
                          for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._skip or key in self._live:
                continue
            n = _alloc(st.nbytes())
            # the storage's own weak reference: its release when freed
            self._live[key] = (n, weakref.ref(
                st, lambda _, key=key: self._release(key)))
            self.current += n
            if self.current > self.peak:
                self.peak = self.current
        return out


class SavedMeter:
    """Bytes saved for backward (``torch.autograd.graph.
    saved_tensors_hooks``): distinct storages that are not arguments,
    held from the save until autograd frees them; ``peak`` is the most
    held at once (Mode A runs one agent's backward at a time)."""

    def __init__(self, arguments=()):
        self._skip = {_key(t) for t in arguments}
        self._held: dict = {}
        self.current = 0
        self.peak = 0

    def _release(self, key: int) -> None:
        entry = self._held.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.current -= entry[1]
            del self._held[key]

    def pack(self, t: torch.Tensor):
        key = _key(t)
        if key not in self._skip:
            entry = self._held.get(key)
            if entry is None:
                entry = self._held[key] = [0, t.untyped_storage().nbytes()]
                self.current += entry[1]
                self.peak = max(self.peak, self.current)
            entry[0] += 1
            weakref.finalize(t, self._release, key)
        return t

    @staticmethod
    def unpack(t):
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack,
                                                        self.unpack)


def trace(fn: Callable, arguments) -> dict:
    """Run ``fn()`` once under the meters: its flops, operator bytes and
    counts, MM kernel calls, collectives and memory."""
    args = _tensors(arguments)
    traffic0 = dict(sharded.TRAFFIC)
    flops = FlopCounterMode(display=False)
    saved = SavedMeter(args)
    t0 = time.perf_counter()
    with mk.record_calls() as calls, flops, saved.hooks():
        meter = OpMeter(args)
        with meter:
            out = fn()
    seconds = time.perf_counter() - t0
    outs = [t for t in _tensors(out) if _key(t) not in meter._skip]
    sent = {k: sharded.TRAFFIC[k] - traffic0[k] for k in sharded.TRAFFIC}
    groups: dict = {}
    for c in calls:
        d = c.to_dict()
        g = groups.setdefault((d["kernel"], tuple(d["key"]), d["dtype"],
                               d["weighted"]), dict(d, count=0))
        g["count"] += 1
    arg_bytes = storage_bytes(args)
    return {
        "trace_s": seconds,
        "flops_per_rank": int(flops.get_total_flops()),
        "bytes_accessed_per_rank": int(meter.bytes),
        "aten_ops": dict(sorted(meter.ops.items())),
        "mm_launches": list(groups.values()),
        "mm_launch_count": len(calls),
        "collectives": {k: {"count": meter.collectives.get(k, 0),
                            "bytes": sent[k]}
                        for k in sharded.TRAFFIC
                        if sent[k] or meter.collectives.get(k, 0)},
        "memory": {
            "argument_bytes": arg_bytes,
            "argument_alloc_bytes": storage_bytes(args, rounded=True),
            "output_bytes": storage_bytes(outs),
            "saved_for_backward_bytes": saved.peak,
            "predicted_peak_bytes": arg_bytes + saved.peak,
            "live_peak_bytes": meter.peak,
        },
    }


# ---------------------------------------------------------------------------
# the process group that moves nothing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """``torch.distributed``'s ``fake`` backend over ``world`` ranks, this
    process rank ``rank``: every collective completes at once and moves
    nothing (tensors keep what they held; on the meta device they hold
    nothing)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process without a "
                           "process group of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------

def _rows(n: int, world: int) -> int:
    """A rank's rows of an n-row batch: an equal share, or all of them
    where the ranks do not divide it (the batch is replicated)."""
    return n // world if n % world == 0 else n


def _filled(tree):
    """The rank's own copy of its inputs (a rank's rows are not a view of
    the whole batch); off the meta device made real, as zeros (token 0,
    zero frames, caches and prefixes)."""
    return pytree.tree_map(
        lambda t: t.clone() if t.device.type == "meta"
        else torch.zeros_like(t), tree)


def _as(tree, dtype):
    return pytree.tree_map(lambda t: t.detach().to(dtype), tree)


def step_and_arguments(model_cfg, par, opt_cfg, shape, world: int,
                       mesh: Optional[AgentMesh], device="meta",
                       agents: int = 1):
    """(mode, fn running one rank's step, its arguments) for ``shape``'s
    kind and ``par``: Mode A for ``agents`` agents on one card, each
    with its rank's rows of the batch (``world`` ranks share it), Mode B
    on ``mesh``'s rank (its shards, state and rows), or a serve step on
    the rank's rows.  ``device`` "cuda" gives the same step on the card,
    its parameters randomly initialised and its tokens zeros."""
    model_cfg = configs.model_for_shape(model_cfg, shape)
    template = M.init_model(model_cfg, generator=torch.Generator(
        device=device if device != "meta" else "cpu"), device=device).tree()
    if shape.kind == "train" and not par.fsdp:
        local = dataclasses.replace(
            shape, global_batch=agents * _rows(shape.global_batch, world))
        batch = configs.input_specs(model_cfg, local, device=device)["batch"]
        batch = _filled(batch)
        opt = optimizers.init(opt_cfg, template)
        step = steps.make_train_step_gspmd(model_cfg, par, opt_cfg, device,
                                           k_agents=agents)
        return "A", (lambda: step(template, opt, batch)[2]), \
            (template, opt, batch)
    if shape.kind == "train":
        batch = configs.input_specs(model_cfg, shape, device=device)["batch"]
        params = steps.shard_params(template, world, mesh.agent_index)
        del template
        opt = optimizers.init(opt_cfg, params)
        batch = _filled(steps.local_rows(batch, mesh))
        step = steps.make_train_step_fsdp(model_cfg, par, opt_cfg, mesh,
                                          device=device)
        return "B", (lambda: step(params, opt, batch)[2]), \
            (params, opt, batch)
    act = M.act_dtype(model_cfg)
    params = steps.shard_params(template, world, mesh.agent_index) \
        if par.fsdp else template
    params = _as(params, act)
    del template
    local = dataclasses.replace(
        shape, global_batch=_rows(shape.global_batch, world))
    ins = _filled(configs.input_specs(model_cfg, local, device=device))
    if shape.kind == "prefill":
        step = steps.make_prefill_step(model_cfg, device, fsdp=par.fsdp,
                                       mesh=mesh)
        return "prefill", (lambda: step(params, ins["batch"])), \
            (params, ins["batch"])
    step = steps.make_decode_step(model_cfg, device, fsdp=par.fsdp,
                                  mesh=mesh)
    return "decode", (lambda: step(params, ins["tokens"], ins["cache"])), \
        (params, ins["tokens"], ins["cache"])


def trace_step(model_cfg, par, shape, *, ranks: int = AGENT_RANKS,
               pods: int = 1, agents: int = 1) -> dict:
    """Trace one rank's step of ``model_cfg`` at ``shape`` under ``par``
    on meta tensors, in a process group of ``ranks * pods`` ranks that
    moves nothing; the record's counted part (``trace``) with the step's
    mode and its parameters' count."""
    opt_cfg = optimizers.OptimizerConfig(state_dtype=par.opt_state_dtype)
    world = ranks * pods
    with fake_group(world):
        mesh = AgentMesh(pods)
        mode, fn, arguments = step_and_arguments(
            model_cfg, par, opt_cfg, shape, world, mesh, agents=agents)
        counted = trace(fn, arguments)
    numel = sum(t.numel() for t in pytree.flatten(
        steps.param_template(model_cfg))[0])
    return dict(counted, mode=mode, param_numel=numel)


def trace_pair(arch_id: str, shape_name: str, multi_pod: bool = False,
               aggregation: Optional[str] = None,
               ranks: int = AGENT_RANKS) -> dict:
    """Trace one (arch, shape, mesh) pair on meta tensors; its record."""
    arch = configs.load_arch(arch_id)
    shape = configs.INPUT_SHAPES[shape_name]
    model_cfg = configs.model_for_shape(arch.model, shape)
    par = dataclasses.replace(arch.parallel_for(shape.name), use_kernel=True)
    if aggregation:
        par = dataclasses.replace(par, aggregation=aggregation)
    pods = PODS if multi_pod else 1
    counted = trace_step(model_cfg, par, shape, ranks=ranks, pods=pods)
    rec = {
        "arch": arch_id,
        "shape": shape_name,
        "mesh": f"{pods}x{ranks}" if multi_pod else f"{ranks}",
        "ranks": ranks * pods,
        "model_axis": 1,
        "kind": shape.kind,
        "mode": counted.pop("mode"),
        "aggregation": par.aggregation if shape.kind == "train" else None,
        "use_kernel": True,
        "fsdp": par.fsdp,
        "microbatches": par.microbatches if shape.kind == "train" else None,
        "agents_on_card": 1,
        "params": model_cfg.param_count(),
        "active_params": model_cfg.active_param_count(),
    }
    rec.update(counted)
    rec["fits_80gb"] = rec["memory"]["live_peak_bytes"] <= CARD_BYTES
    return rec


def pairs(arch: str = "all", shape: str = "all") -> list:
    archs = list(configs.ARCH_IDS) if arch == "all" \
        else [configs.resolve_arch(arch)]
    shapes = list(configs.INPUT_SHAPES) if shape == "all" else [shape]
    return [(a, s) for a in archs for s in shapes]


def _traced(job: tuple) -> tuple:
    """One pair in a worker process: (pair, record or the failure)."""
    arch, shape, multi_pod, aggregation, ranks = job
    t0 = time.perf_counter()
    try:
        return (arch, shape), trace_pair(arch, shape, multi_pod,
                                         aggregation, ranks), None
    except Exception as e:  # noqa: BLE001 -- report and continue
        return (arch, shape), None, (
            f"({time.perf_counter() - t0:.0f}s): {type(e).__name__}: "
            f"{str(e)[:200]}\n{traceback.format_exc()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="trace one rank's step of each (arch x shape) pair on "
                    "meta tensors at full width")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--aggregation", default=None,
                    help="override train aggregation "
                         "(mean|gather_mm|rs_mm|hier_mm)")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--ranks", type=int, default=AGENT_RANKS,
                    help="agent ranks of the mesh (of a pod with "
                         "--multi-pod)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs traced at once, each in its own process "
                         "(a pair's trace is one core's work)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshname = f"{PODS}x{args.ranks}" if args.multi_pod else str(args.ranks)
    todo = [(a, s, args.multi_pod, args.aggregation, args.ranks)
            for a, s in pairs(args.arch, args.shape)]
    failures = []
    t_all = time.perf_counter()
    if args.jobs > 1:
        ctx = torch.multiprocessing.get_context("spawn")
        pool = ctx.Pool(min(args.jobs, len(todo)), maxtasksperchild=1)
        results = pool.imap_unordered(_traced, todo)
    else:
        pool, results = None, map(_traced, todo)
    try:
        for (a, s), rec, err in results:
            if err is not None:
                failures.append((a, s))
                print(f"FAIL {a:24s} {s:12s} {meshname:6s} {err}",
                      flush=True)
                continue
            tag = f"_{args.tag}" if args.tag else ""
            path = os.path.join(args.out, f"{a}_{s}_{meshname}{tag}.json")
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            mem = rec["memory"]
            print(f"OK   {a:24s} {s:12s} {meshname:6s} mode={rec['mode']:7s} "
                  f"trace={rec['trace_s']:7.1f}s "
                  f"flops/rank={rec['flops_per_rank']:.3e} "
                  f"mm={rec['mm_launch_count']:6d} "
                  f"peak={mem['live_peak_bytes'] / 1e9:8.2f}GB", flush=True)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    print(f"\n{len(todo) - len(failures)} pair(s) traced in "
          f"{time.perf_counter() - t_all:.1f}s")
    if failures:
        print(f"{len(failures)} FAILURES: {failures}")
        return 1
    print("all pairs traced OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
