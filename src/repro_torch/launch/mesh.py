"""Agent meshes over ``torch.distributed`` (``repro.launch.mesh``).

The reference names mesh axes: ``data`` carries the K aggregation agents,
``pod`` (multi-pod meshes only) groups them, and the agents are the
product ``pod x data``.  Here one rank is one agent and an ``AgentMesh``
is built over an initialised process group: agent r is rank r, in pod
``r // data`` at data index ``r % data``.  ``axis("data")`` is the
process group of this rank's pod (its ``data`` axis), ``axis("pod")``
the group of the ranks that share its data index across pods, and
``axis(("pod", "data"))`` every agent.

``run_ranks`` runs a function on K spawned ranks, each with its own
process group and its ``AgentMesh``.  Ranks that share one card all set
``cuda:0`` (``rank % device_count``); gloo takes several ranks on one
card, NCCL does not.

The reference's ``make_production_mesh`` (a TPU v5e pod layout) has no
counterpart: a GPU job's ranks come from its launcher.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence, Union

import torch
import torch.distributed as dist

AGENT_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of an ``AgentMesh`` (or the product of several): its
    process group, its size and this rank's index along it."""

    name: str
    group: Any = dataclasses.field(compare=False)
    size: int
    index: int


class AgentMesh:
    """The K agents of the reference's ``(pod, data)`` mesh over the
    default process group; ``pods`` > 1 adds the ``pod`` axis and builds
    the subgroups of both axes (``dist.new_group``, which every rank
    calls for every group)."""

    def __init__(self, pods: int = 1):
        if not dist.is_initialized():
            raise RuntimeError("AgentMesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        world, rank = dist.get_world_size(), dist.get_rank()
        if pods < 1 or world % pods:
            raise ValueError(f"{world} ranks do not split into {pods} pods")
        data = world // pods
        self.shape = {"pod": pods, "data": data} if pods > 1 \
            else {"data": data}
        self.rank = rank
        world_group = dist.group.WORLD
        self._axes = {"pod,data" if pods > 1 else "data":
                      Axis("pod,data" if pods > 1 else "data", world_group,
                           world, rank)}
        if pods > 1:
            for p in range(pods):        # each pod's data axis
                g = dist.new_group(list(range(p * data, (p + 1) * data)))
                if rank // data == p:
                    self._axes["data"] = Axis("data", g, data, rank % data)
            for d in range(data):        # each data index's pod axis
                g = dist.new_group(list(range(d, world, data)))
                if rank % data == d:
                    self._axes["pod"] = Axis("pod", g, pods, rank // data)

    @property
    def agent_index(self) -> int:
        """This rank's agent: its index along ``pod x data``."""
        return self.rank

    def axis(self, names: Union[str, Sequence[str]]) -> Axis:
        """The axis ``names`` (one name, or a tuple whose product it is)."""
        if not isinstance(names, str):
            names = ",".join(n for n in AGENT_AXES if n in tuple(names))
        if names == "pod,data" and "pod" not in self.shape:
            names = "data"
        try:
            return self._axes[names]
        except KeyError:
            raise ValueError(f"mesh {self.shape} has no axis {names!r}") \
                from None

    @property
    def agents(self) -> Axis:
        """Every agent: the ``pod x data`` product."""
        return self.axis(agent_axes(self))


def agent_axes(mesh: AgentMesh) -> tuple:
    """The mesh axes whose product forms the K aggregation agents."""
    return tuple(a for a in AGENT_AXES if a in mesh.shape)


def num_agents(mesh: AgentMesh) -> int:
    k = 1
    for a in agent_axes(mesh):
        k *= mesh.shape[a]
    return k


def resolve_axis(axis) -> Axis:
    """An ``Axis`` from what the collectives accept: an ``Axis``, an
    ``AgentMesh`` (all its agents), a process group, or None (the default
    group)."""
    if isinstance(axis, Axis):
        return axis
    if isinstance(axis, AgentMesh):
        return axis.agents
    group = dist.group.WORLD if axis is None else axis
    return Axis("group", group, dist.get_world_size(group),
                dist.get_rank(group))


# ===========================================================================
# K ranks in spawned processes
# ===========================================================================

def _rank_main(rank: int, world: int, init_file: str, backend: str,
               timeout_s: float, pods: int, cuda: bool, fn: Callable,
               args: tuple, out_dir: str) -> None:
    """One rank: its process group and mesh, ``fn(mesh, *args)``, and its
    result (``torch.save``) or traceback written under ``out_dir``."""
    try:
        torch.set_num_threads(1)
        if cuda:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = fn(AgentMesh(pods), *args)
            torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, *args, pods: int = 1,
              backend: str = "gloo", cuda: bool = False,
              timeout_s: float = 120.0) -> list:
    """``fn(mesh, *args)`` on ``world`` ranks, each a spawned process with
    its process group (``backend``, initialised through a file in a fresh
    temporary directory, so concurrent callers never share a port) and
    its ``AgentMesh(pods)``; each rank's result in rank order.

    ``fn`` and ``args`` cross by pickling (``fn`` by its import path);
    results come back through ``torch.save``, so a rank should return
    CPU tensors.  ``cuda`` sets each rank's card before the group starts.
    Every rank must end within ``timeout_s`` seconds (the collectives'
    timeout too): a rank that fails or a deadline that passes stops
    every rank and raises, with the failing ranks' tracebacks."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    procs = []
    try:
        for rank in range(world):
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world, os.path.join(tmp, "init"), backend, timeout_s,
                pods, cuda, fn, args, tmp))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            errs = []
            for rank in range(world):
                path = os.path.join(tmp, f"rank{rank}.err")
                if os.path.exists(path):
                    with open(path) as f:
                        errs.append(f"rank {rank}:\n{f.read()}")
            what = ("timed out after %.0f s" % timeout_s
                    if all(c in (None, 0) for c in codes) else "failed")
            raise RuntimeError(f"ranks {what}; exit codes {codes}\n"
                               + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
