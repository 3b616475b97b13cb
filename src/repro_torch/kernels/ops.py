"""The aggregation engine: one entry point for every MM aggregation.

Counterpart of ``repro.kernels.ops``.  ``AggregationEngine`` puts the
Hopper kernels (``backend="pallas"``, the reference's name for its fused
kernel) or the plain estimator of ``core.location`` (``backend="jnp"``)
behind one API:

  aggregate(x, a=None)          -- (K, ...) tensor -> (...)
  aggregate_batched(x, A)       -- (K, ...) x (K, N) weight columns -> (N, ...)
  aggregate_tree(tree, a=None)  -- whole gradient pytree, ONE kernel launch

Tree path: every leaf is copied into one preallocated (K, M_total) f32
staging buffer, one kernel launch aggregates it, and the (M_total,)
estimate is split back into views shaped like the leaves, cast to each
leaf's dtype.  The kernel masks its ragged last tile, so the staging
buffer is the only copy of the tree that the launch makes.

Inside a ``record_workloads()`` scope every launch appends its resolved
workload (K, M, N, dtype, backend, block sizes, path) once; the scenario
runner builds its launch audit from those records.

Standalone launches (``lower_launch``): the launch half of ``aggregate``
for one fixed cohort geometry, with cohort assembly left to the caller
(the streaming service).  ``lower_launch(k, m, dtype).compile()`` gives
a ``LaunchProgram``: on a CUDA device the launch is warmed up once and
captured into a CUDA graph over a static (k, m) cohort buffer and a
(k,) weight buffer, and every call copies a cohort into them and
replays the graph -- one capture per geometry, no per-cohort host work
in the launch.  ``lower_tree`` and leaf donation are not ported yet.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch

from repro_torch import devices, pytree
from repro_torch.core import location, mestimators
from repro_torch.kernels import mm_aggregate as _k

BACKENDS = ("pallas", "jnp")

_ACTIVE_RECORDERS: list = []


@contextlib.contextmanager
def record_workloads():
    """Collect {k, m, n, dtype, backend, block_m, block_k, path} dicts for
    every distinct engine workload launched inside the scope."""
    records: list = []
    _ACTIVE_RECORDERS.append(records)
    try:
        yield records
    finally:
        for i, r in enumerate(_ACTIVE_RECORDERS):
            if r is records:
                del _ACTIVE_RECORDERS[i]
                break


def _record_workload(entry: dict) -> None:
    for records in _ACTIVE_RECORDERS:
        if entry not in records:
            records.append(dict(entry))


class AggregationEngine:
    """Weighted, batched MM aggregation around the Hopper kernels.

    ``block_m``/``block_k``/``path`` of None resolve per launch through
    ``mm_aggregate.launch_plan`` (the tuning cache or its heuristic, and
    ``auto_path``).  The engine runs on whatever device its inputs are
    on: CUDA tensors launch the kernels, CPU tensors take their plain
    versions.
    """

    def __init__(self, *, num_iters: int = 10,
                 c: float = mestimators.TUKEY_C95,
                 block_m: Optional[int] = None,
                 block_k: Optional[int] = None,
                 backend: str = "pallas",
                 path: Optional[str] = None):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if path is not None and path not in _k.PATHS:
            raise ValueError(f"unknown kernel path {path!r}; known: {_k.PATHS}")
        self.num_iters = num_iters
        self.c = c
        self.block_m = block_m
        self.block_k = block_k
        self.backend = backend
        self.path = path

    def _plan(self, k: int, m: int, n: int = 1, dtype=torch.float32):
        """The launch plan of a (k, m) x (k, n) launch of this engine (None
        on the ``jnp`` backend, which launches no kernel)."""
        if self.backend != "pallas":
            return None
        return _k.launch_plan(k, m, n, dtype=dtype, block_m=self.block_m,
                              block_k=self.block_k, path=self.path)

    def _record(self, x: torch.Tensor, k: int, m: int, n: int = 1) -> None:
        entry = {"k": int(k), "m": int(m), "n": int(n),
                 "dtype": _k.dtype_name(x.dtype), "backend": self.backend}
        plan = self._plan(k, m, n, x.dtype)
        if plan is not None:
            entry.update(block_m=plan.block_m, block_k=plan.block_k,
                         path=plan.path)
        else:
            entry.update(block_m=None, block_k=None, path=None)
        _record_workload(entry)

    def _kernel_opts(self) -> dict:
        return dict(num_iters=self.num_iters, c=self.c, block_m=self.block_m,
                    block_k=self.block_k, path=self.path)

    # -- tensors -----------------------------------------------------------

    def aggregate(self, x: torch.Tensor,
                  a: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MM location estimate along axis 0: (K, ...) -> (...)."""
        k = x.shape[0]
        m = x.numel() // max(k, 1)
        self._record(x, k, m)
        if self.backend == "jnp":
            af = None if a is None else a.to(torch.float32)
            out = location.mm_estimate(
                x.to(torch.float32), a=af, loss=mestimators.tukey(self.c),
                num_iters=self.num_iters).estimate
            return out.to(x.dtype)
        out = _k.mm_aggregate_2d(x.reshape(k, -1), a, **self._kernel_opts())
        return out.reshape(x.shape[1:])

    def aggregate_batched(self, x: torch.Tensor,
                          a: torch.Tensor) -> torch.Tensor:
        """(K, ...) values x (K, N) weight columns -> (N, ...): every
        neighborhood of a combination matrix in one kernel launch."""
        k = x.shape[0]
        n = a.shape[1]
        flat = x.reshape(k, -1)
        self._record(x, k, flat.shape[1], n)
        if self.backend == "jnp":
            xb = flat.to(torch.float32).unsqueeze(1).expand(k, n, flat.shape[1])
            out = location.mm_estimate(
                xb, a=a.to(torch.float32), loss=mestimators.tukey(self.c),
                num_iters=self.num_iters).estimate.to(x.dtype)
        else:
            out = _k.mm_aggregate_batched_2d(flat, a, **self._kernel_opts())
        return out.reshape((n,) + tuple(x.shape[1:]))

    # -- pytrees -----------------------------------------------------------

    def aggregate_tree(self, tree, a: Optional[torch.Tensor] = None):
        """Aggregate a pytree of stacked (K, ...) leaves in ONE launch."""
        leaves, treedef = pytree.flatten(tree)
        if not leaves:
            return tree
        agg = self.aggregate(stage_leaves(leaves), a)
        outs, off = [], 0
        for leaf in leaves:
            n = leaf[0].numel()
            outs.append(agg[off:off + n].reshape(leaf.shape[1:]).to(leaf.dtype))
            off += n
        return pytree.unflatten(treedef, outs)

    # -- standalone launches (cohort assembly decoupled) -------------------

    def lower_launch(self, k: int, m: int, dtype=torch.float32, *,
                     weighted: bool = True, donate: bool = False,
                     device="cuda") -> "LoweredLaunch":
        """The one-cohort launch for a fixed geometry, not yet compiled:
        ``(x (k, m) dtype, a (k,) f32) -> (m,) dtype``.

        The caller stages each cohort into the program's static buffers
        and launches the compiled program for every admitted cohort.  The
        workload resolution (tuning-cache winner or heuristic, the
        single<->two-pass path) is ``aggregate``'s, and the compile
        records it for launch audits.  ``donate`` is the reference's flag
        for handing the cohort buffer to the launch; here the cohort
        buffer is always the program's own static input, which the
        caller re-stages on every attempt, so the flag changes nothing
        and is kept so that one call means the same in both packages."""
        del donate
        dev = devices.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return LoweredLaunch(self, int(k), int(m), _k._as_dtype(dtype),
                             weighted=weighted, device=dev)


class LaunchProgram:
    """A compiled one-cohort launch (``AggregationEngine.lower_launch``).

    ``x`` (k, m) and ``a`` (k,) are its static inputs.  ``stage`` copies
    a cohort into them; ``replay`` runs the launch on them and returns
    the (m,) estimate.  On a CUDA device the launch is a captured CUDA
    graph and the estimate is the graph's own output tensor, overwritten
    by the next replay of this program: a caller that keeps it clones it
    first.  The wrappers do not count the launch they make while the
    graph is captured; each replay adds its kernel launch to their
    counts (``mm_aggregate.LAUNCHES``).  On the CPU the program calls the
    engine's launch (the kernels' plain versions) on the static inputs.
    """

    def __init__(self, launch, x: torch.Tensor, a: torch.Tensor, plan):
        self._launch = launch
        self.x = x
        self.a = a
        self.plan = plan
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.replays = 0

    def stage(self, rows, a: Optional[torch.Tensor] = None) -> None:
        """Copy k rows (a (k, m) tensor, or k tensors of m values each)
        and, for a weighted program, the (k,) weights into the static
        inputs."""
        if len(rows) != self.x.shape[0]:
            raise ValueError(f"the program takes {self.x.shape[0]} rows, "
                             f"got {len(rows)}")
        for dst, row in zip(self.x, rows):
            dst.copy_(row.reshape(-1))
        if a is not None:
            self.a.copy_(a.reshape(-1))

    def replay(self) -> torch.Tensor:
        """Run the launch on the staged inputs; asynchronous on the card."""
        if self.graph is None:
            out = self._launch()
        else:
            self.graph.replay()
            out = self.out
            if self.plan is not None:
                _k.count_launch(self.plan)
        self.replays += 1
        return out

    def __call__(self, x, a: Optional[torch.Tensor] = None) -> torch.Tensor:
        self.stage(x, a)
        return self.replay()


class LoweredLaunch:
    """``lower_launch``'s result; ``compile`` builds the program."""

    def __init__(self, engine: AggregationEngine, k: int, m: int,
                 dtype: torch.dtype, *, weighted: bool,
                 device: torch.device):
        self.engine = engine
        self.k, self.m, self.dtype = k, m, dtype
        self.weighted = weighted
        self.device = device

    def static_inputs(self):
        """Fresh zeroed (x (k, m), a (k,)) buffers for this geometry."""
        return (torch.zeros((self.k, self.m), dtype=self.dtype,
                            device=self.device),
                torch.ones((self.k,), dtype=torch.float32,
                           device=self.device))

    def compile(self, inputs=None) -> LaunchProgram:
        """The launch program over ``inputs`` (x, a) -- buffers of this
        geometry on this device, which several programs may share (the
        service shares them between the engines of one geometry) -- or
        over fresh ones.  On a CUDA device: one warm-up launch on a side
        stream (it loads the kernel library, opts the kernel in to its
        shared memory and asks its occupancy, none of which may happen
        during a capture), then the capture."""
        engine = self.engine
        x, a = inputs if inputs is not None else self.static_inputs()
        if tuple(x.shape) != (self.k, self.m) or x.dtype != self.dtype \
                or tuple(a.shape) != (self.k,) or x.device != self.device:
            raise ValueError(
                f"static inputs must be x ({self.k}, {self.m}) {self.dtype} "
                f"and a ({self.k},) on {self.device}")
        engine._record(x, self.k, self.m)
        weights = a if self.weighted else None
        program = LaunchProgram(lambda: engine.aggregate(x, weights), x, a,
                                engine._plan(self.k, self.m, 1, self.dtype))
        if self.device.type != "cuda":
            return program
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            program._launch()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = program._launch()
        program.graph, program.out = graph, out
        return program


def stage_leaves(leaves) -> torch.Tensor:
    """Copy stacked (K, ...) leaves into one preallocated (K, M_total) f32
    buffer, leaf after leaf along M (the tree path's staging layout)."""
    k = leaves[0].shape[0]
    sizes = [leaf.numel() // k for leaf in leaves]
    buf = torch.empty((k, sum(sizes)), dtype=torch.float32,
                      device=leaves[0].device)
    off = 0
    for leaf, n in zip(leaves, sizes):
        buf[:, off:off + n].copy_(leaf.reshape(k, n))
        off += n
    return buf


@functools.lru_cache(maxsize=None)
def get_engine(**kwargs) -> AggregationEngine:
    """Shared engines, memoized by configuration."""
    return AggregationEngine(**kwargs)


def _engine(num_iters, c, block_m, block_k, backend, path):
    return get_engine(num_iters=num_iters, c=c, block_m=block_m,
                      block_k=block_k, backend=backend, path=path)


def mm_aggregate(x: torch.Tensor, a: Optional[torch.Tensor] = None, *,
                 num_iters: int = 10, c: float = mestimators.TUKEY_C95,
                 block_m: Optional[int] = None, block_k: Optional[int] = None,
                 backend: str = "pallas",
                 path: Optional[str] = None) -> torch.Tensor:
    """MM location estimate along axis 0: (K, ...) -> (...)."""
    return _engine(num_iters, c, block_m, block_k, backend,
                   path).aggregate(x, a)


def mm_aggregate_batched(x: torch.Tensor, a: torch.Tensor, *,
                         num_iters: int = 10,
                         c: float = mestimators.TUKEY_C95,
                         block_m: Optional[int] = None,
                         block_k: Optional[int] = None,
                         backend: str = "pallas",
                         path: Optional[str] = None) -> torch.Tensor:
    """Batched weighted aggregation: (K, ...) x (K, N) -> (N, ...)."""
    return _engine(num_iters, c, block_m, block_k, backend,
                   path).aggregate_batched(x, a)


def mm_aggregate_tree(tree, a: Optional[torch.Tensor] = None, *,
                      num_iters: int = 10, c: float = mestimators.TUKEY_C95,
                      block_m: Optional[int] = None,
                      block_k: Optional[int] = None,
                      backend: str = "pallas", path: Optional[str] = None):
    """Aggregate a pytree of stacked (K, ...) leaves in ONE kernel launch."""
    return _engine(num_iters, c, block_m, block_k, backend,
                   path).aggregate_tree(tree, a)
