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
buffer is the only copy of the tree that the launch makes.  The layout
(treedef, shapes, dtypes, per-leaf sizes and offsets, K) is computed
once per tree structure and cached on the engine (``_TreeLayout``,
``engine._layouts``), as the reference caches it.

Donation: with ``donate_leaves=True`` the tree path hands the leaves
over to the aggregation.  Each leaf's storage is released
(``untyped_storage().resize_(0)``) as soon as it is staged, before the
kernel and the split allocate, and the leaf becomes a ``DonatedTensor``,
whose reads raise, as a re-read of a donated buffer raises in jax.  A
leaf whose storage another leaf still needs is released only after the
last of them is staged.  A leaf whose storage torch does not own (a
numpy array's) cannot be released, and the call raises ``ValueError``
before it stages anything.  The estimate is the plain path's, bit for
bit; the peak is lower by the estimate's bytes.

Compiled programs.  On a CUDA device "compile" means "capture a CUDA
graph" and "execute" means "replay it"; on the CPU the same objects run
the engine's eager code (the kernels' plain versions).

- ``lower_launch(k, m, dtype).compile()`` gives a ``LaunchProgram``, the
  launch half of ``aggregate`` for one fixed cohort geometry (the
  streaming service assembles cohorts itself): a static (k,) table of
  row addresses and (k,) weight buffer, one capture per geometry; each
  cohort's row addresses are written into the table and the kernel
  reads the rows where they lie.
- ``lower_tree(tree, a).compile()`` gives a ``TreeProgram``, the
  counterpart of the reference's jitted stage->kernel->split program of
  one tree layout: a static (K, M_total) staging buffer and weights,
  static outputs shaped like the leaves; each call stages a tree of that
  layout (donating its leaves where the engine does) and replays the
  captured kernel->split.  ``LoweredTree.donated`` mirrors the donated
  flags of the reference's ``Lowered.args_info``.

Both warm up once on a side stream before the capture (it loads the
kernel library, opts the kernel in to its shared memory and asks its
occupancy, none of which may happen during a capture); ``capture_graph``
and ``warm_up`` are shared with the scenario runner, which captures
whole trajectories.  ``capture_graph`` returns the keys of the launches
it captured, which ``launches.COUNTS`` does not count; a program counts
them on every replay (``launches.replay``).

Inside a ``record_workloads()`` scope every launch appends its resolved
workload (K, M, N, dtype, backend, block sizes, path) once; the scenario
runner builds its launch audit from those records.

``any_nonfinite(x)`` is the finiteness check of the streaming service
(its admission gate, its estimate guard and its initial model): one read
of a CUDA tensor by the kernel of ``csrc/finite.cu``, one 4-byte flag.
``residual_norms(rows, center)`` gives the service's norms after a
commit, ``||row - center||`` for each row, from one read of each row by
the kernel of ``csrc/residual.cu``.  Both count their launches on the
card in ``launches.COUNTS``, as the MM wrappers do.

``autotune=True`` runs ``tuning.autotune``'s sweep the first time the
engine meets a (K, M, N, dtype) on a device (never while a CUDA graph
is being captured), so the plan each launch takes, and records, is the
measured winner's.
"""

from __future__ import annotations

import collections
import contextlib
import functools
from typing import Callable, Optional, Sequence

import torch

from repro_torch import devices, pytree
from repro_torch.core import location, mestimators
from repro_torch.kernels import build, launches
from repro_torch.kernels import mm_aggregate as _k
from repro_torch.kernels import tuning

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


# ---------------------------------------------------------------------------
# donation
# ---------------------------------------------------------------------------

class DonatedTensor(torch.Tensor):
    """A leaf the tree path has taken over (``donate_leaves=True``): its
    storage is released and every read of its values raises.  Its
    shape, dtype, device and (empty) storage stay readable."""

    _METADATA = frozenset((
        torch.Tensor.size, torch.Tensor.dim, torch.Tensor.numel,
        torch.Tensor.untyped_storage, torch.Tensor.shape.__get__,
        torch.Tensor.dtype.__get__, torch.Tensor.device.__get__,
        torch.Tensor.ndim.__get__, torch.Tensor.requires_grad.__get__,
        torch.Tensor.is_cuda.__get__))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in cls._METADATA:
            with torch._C.DisableTorchFunctionSubclass():
                return func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", str(func))
        raise RuntimeError(
            f"{name}: this tensor was donated to a tree aggregation "
            "(donate_leaves=True) and its storage has been released")

    def __repr__(self):
        return (f"DonatedTensor(shape={tuple(self.shape)}, "
                f"dtype={self.dtype}, device={self.device}, released)")


def _storage_key(leaf: torch.Tensor) -> tuple:
    return (str(leaf.device), leaf.untyped_storage().data_ptr())


def _donate(leaf: torch.Tensor) -> None:
    """Release a staged leaf's storage and mark it donated."""
    if isinstance(leaf, DonatedTensor):
        return
    leaf.untyped_storage().resize_(0)
    leaf.__class__ = DonatedTensor


def _check_donatable(leaves) -> None:
    """Raise ``ValueError`` before anything is staged when a leaf's
    storage cannot be released (storage torch does not own, a numpy
    array's): donating it would free nothing."""
    for i, leaf in enumerate(leaves):
        if not leaf.untyped_storage().resizable():
            raise ValueError(
                f"leaf {i} (shape {tuple(leaf.shape)}) cannot be donated: "
                "its storage is not torch's own (torch.from_numpy?) and "
                "cannot be released; copy it or use donate_leaves=False")


def _layout_key(leaves, treedef) -> tuple:
    return (treedef, tuple(tuple(leaf.shape) for leaf in leaves),
            tuple(leaf.dtype for leaf in leaves))


class _TreeLayout:
    """Cached flatten plan for one pytree structure."""

    __slots__ = ("treedef", "shapes", "dtypes", "sizes", "offsets", "k")

    def __init__(self, treedef, leaves):
        self.treedef = treedef
        self.k = leaves[0].shape[0]
        self.shapes = tuple(tuple(leaf.shape) for leaf in leaves)
        self.dtypes = tuple(leaf.dtype for leaf in leaves)
        self.sizes = tuple(leaf.numel() // max(self.k, 1) for leaf in leaves)
        offs, off = [], 0
        for n in self.sizes:
            offs.append(off)
            off += n
        self.offsets = tuple(offs)

    @property
    def m_total(self) -> int:
        return sum(self.sizes)

    def key(self):
        return (self.treedef, self.shapes, self.dtypes)

    def split(self, agg: torch.Tensor) -> list:
        """The (M_total,) estimate as views shaped like the leaves, each
        cast to its leaf's dtype."""
        return [agg[off:off + n].reshape(shape[1:]).to(dtype)
                for off, n, shape, dtype in zip(self.offsets, self.sizes,
                                                self.shapes, self.dtypes)]


class AggregationEngine:
    """Weighted, batched MM aggregation around the Hopper kernels.

    ``block_m``/``block_k``/``path`` of None resolve per launch through
    ``mm_aggregate.launch_plan`` (the tuning cache or its heuristic, and
    ``auto_path``); ``autotune=True`` first times the candidates of a
    workload the engine has not met (outside CUDA-graph capture, where
    the cache or heuristic decides).  ``donate_leaves=True`` makes the
    tree path take over the leaves it stages (module docstring).  The
    engine runs on whatever device its inputs are on: CUDA tensors
    launch the kernels, CPU tensors take their plain versions.
    """

    def __init__(self, *, num_iters: int = 10,
                 c: float = mestimators.TUKEY_C95,
                 block_m: Optional[int] = None,
                 block_k: Optional[int] = None,
                 backend: str = "pallas",
                 autotune: bool = False,
                 donate_leaves: bool = False,
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
        self.autotune = autotune
        self.donate_leaves = donate_leaves
        self.path = path
        self._layouts: dict = {}

    def _plan(self, k: int, m: int, n: int = 1, dtype=torch.float32, *,
              table: bool = False):
        """The launch plan of a (k, m) x (k, n) launch of this engine (None
        on the ``jnp`` backend, which launches no kernel); ``table``: over
        rows given by a ``RowTable``."""
        if self.backend != "pallas":
            return None
        return _k.launch_plan(k, m, n, dtype=dtype, block_m=self.block_m,
                              block_k=self.block_k, path=self.path,
                              table=table)

    def _record(self, x: torch.Tensor, k: int, m: int, n: int = 1) -> None:
        """Tune the workload where asked (before its plan is resolved),
        then record the plan its launch takes."""
        if self.autotune and self.backend == "pallas" \
                and self.block_m is None and not (
                    x.device.type == "cuda"
                    and torch.cuda.is_current_stream_capturing()):
            tuning.autotune(k, m, n, x.dtype, num_iters=self.num_iters,
                            device=x.device)
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

    def _layout_for(self, leaves, treedef) -> _TreeLayout:
        # unbounded, as the reference's: one entry per tree structure
        key = _layout_key(leaves, treedef)
        layout = self._layouts.get(key)
        if layout is None:
            layout = self._layouts[key] = _TreeLayout(treedef, leaves)
        return layout

    def aggregate_tree(self, tree, a: Optional[torch.Tensor] = None):
        """Aggregate a pytree of stacked (K, ...) leaves in ONE launch:
        stage into the cached layout, launch, split.  With
        ``donate_leaves`` the leaves are released as they are staged."""
        leaves, treedef = pytree.flatten(tree)
        if not leaves:
            return tree
        layout = self._layout_for(leaves, treedef)
        buf = stage_leaves(leaves, layout=layout, donate=self.donate_leaves)
        return pytree.unflatten(treedef, layout.split(self.aggregate(buf, a)))

    def lower_tree(self, tree, a: Optional[torch.Tensor] = None
                   ) -> "LoweredTree":
        """The stage->kernel->split program ``aggregate_tree`` runs for
        this tree's layout, with this engine's donation setting, not yet
        compiled or run (a weighted program when ``a`` is given)."""
        leaves, treedef = pytree.flatten(tree)
        if not leaves:
            raise ValueError("an empty tree has no tree program")
        dev = leaves[0].device
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return LoweredTree(self, self._layout_for(leaves, treedef),
                           weighted=a is not None, device=dev)

    # -- standalone launches (cohort assembly decoupled) -------------------

    def lower_launch(self, k: int, m: int, dtype=torch.float32, *,
                     weighted: bool = True, device="cuda") -> "LoweredLaunch":
        """The one-cohort launch for a fixed geometry, not yet compiled:
        ``(k rows of m dtype values, a (k,) f32) -> (m,) dtype``.

        The caller stages each cohort's rows into the program (their
        addresses into its static table) and launches the compiled
        program for every admitted cohort.  The workload resolution
        (tuning-cache winner or heuristic, the single<->two-pass path) is
        ``aggregate``'s, and the compile records it for launch audits.
        The table and weights are the program's static inputs, which the
        caller re-stages on every attempt.  On the card the kernels read
        a row table in weighted launches only, so an unweighted program
        there raises ``ValueError``."""
        dev = devices.resolve(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.type == "cuda" and self.backend == "pallas" and not weighted:
            raise ValueError("on the card a launch program reads its rows "
                             "through a table, which only weighted kernel "
                             "launches take: lower it weighted")
        return LoweredLaunch(self, int(k), int(m), _k._as_dtype(dtype),
                             weighted=weighted, device=dev)


class LaunchProgram:
    """A compiled one-cohort launch (``AggregationEngine.lower_launch``).

    Its static inputs are ``table``, a (k,) int64 tensor of row addresses
    on the program's device, and the (k,) weights ``a``.  ``stage(rows,
    a)`` takes k rows, each a contiguous tensor of m values of the
    program's dtype on its device (a (k, m) tensor gives its rows), and,
    for a weighted program, the weights into ``a``; ``replay`` runs the
    launch on them and returns the (m,) estimate.  The program holds the
    staged rows (``rows``) until ``release`` or its next stage, and
    refuses a replay while it holds none: the caller releases them once
    the replays that read them have run (the service does after its
    wait), and until then the table never points at freed memory.

    On the card (the kernel backend) the launch is a captured CUDA graph
    whose kernel reads each row where it lies, through ``table``, which
    ``stage`` fills: nothing of a row is copied.  The estimate is the
    graph's own output tensor, overwritten by the next replay of this
    program: a caller that keeps it clones it first.  Each replay counts
    the graph's captured launches (``launches.replay``).  On the CPU, and
    on the ``jnp`` backend, which launches no kernel, the program runs
    the engine's launch on the rows stacked, and ``table`` is not read.
    """

    def __init__(self, launch, table: torch.Tensor, a: torch.Tensor, plan,
                 *, m: int, dtype: torch.dtype = torch.float32,
                 reads_table: bool = False):
        self._launch = launch
        self.table = table
        self.a = a
        self.plan = plan
        self.m = int(m)
        self.dtype = dtype
        self.reads_table = reads_table  # the kernel reads the rows' table
        self.rows: tuple = ()
        self._host: Optional[torch.Tensor] = None  # pinned (k,) addresses
        self._copied: Optional[torch.cuda.Event] = None  # _host read
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches = collections.Counter()  # launch keys a replay
        self.replays = 0

    @property
    def k(self) -> int:
        return self.table.shape[0]

    def stage(self, rows, a: Optional[torch.Tensor] = None) -> None:
        """Take k rows (a (k, m) tensor, or k tensors of m values each)
        and, for a weighted program, the (k,) weights.  A program whose
        kernel reads the table writes the rows' addresses into it through
        a pinned host buffer of its own, in one copy on the current
        stream that nothing waits for.  A row that is not a contiguous
        tensor of the program's m values, dtype and device raises
        ``ValueError``, and nothing is staged."""
        if len(rows) != self.k:
            raise ValueError(f"the program takes {self.k} rows, "
                             f"got {len(rows)}")
        rows = tuple(rows)
        _check_rows(((f"row {i}", r) for i, r in enumerate(rows)), self.m,
                    self.dtype, self.table.device, "the launch program",
                    "the program")
        if self.reads_table:
            if self._host is None:
                self._host = torch.empty(self.k, dtype=torch.int64,
                                         pin_memory=True)
                self._copied = torch.cuda.Event()
            self._copied.synchronize()  # the last copy has read _host
            _write_row_table(rows, self.table, self._host)
            self._copied.record(torch.cuda.current_stream(self.table.device))
        self.rows = rows
        if a is not None:
            self.a.copy_(a.reshape(-1))

    def release(self) -> None:
        """Let go of the staged rows; call it once the replays that read
        them have run."""
        self.rows = ()

    def replay(self) -> torch.Tensor:
        """Run the launch on the staged inputs; asynchronous on the card.
        Raises ``RuntimeError`` while no rows are staged."""
        if not self.rows:
            raise RuntimeError("the launch program holds no rows: stage a "
                               "cohort before each replay")
        if self.graph is None:
            out = self._launch()
        else:
            self.graph.replay()
            out = self.out
            launches.replay(self.launches)
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
        """Fresh (table (k,) int64, a (k,) ones) buffers for this
        geometry."""
        return (torch.zeros((self.k,), dtype=torch.int64, device=self.device),
                torch.ones((self.k,), dtype=torch.float32,
                           device=self.device))

    def compile(self, inputs=None) -> LaunchProgram:
        """The launch program over ``inputs`` (table, a) -- buffers of
        this geometry on this device, which several programs may share
        (the service shares them between the engines of one geometry) --
        or over fresh ones.  On a CUDA device with the kernel backend:
        one warm-up launch on a side stream (it loads the kernel library,
        opts the kernel in to its shared memory and asks its occupancy,
        none of which may happen during a capture), then the capture of
        the launch over the table, both over k copies of one zero row
        lent for the compile alone: the program holds no rows after it."""
        engine = self.engine
        table, a = inputs if inputs is not None else self.static_inputs()
        if tuple(table.shape) != (self.k,) or table.dtype != torch.int64 \
                or tuple(a.shape) != (self.k,) or table.device != self.device:
            raise ValueError(
                f"static inputs must be a table ({self.k},) int64 and a "
                f"({self.k},) on {self.device}")
        source = _k.RowTable(table, self.m, self.dtype)
        engine._record(source, self.k, self.m)
        weights = a if self.weighted else None
        kernel = self.device.type == "cuda" and engine.backend == "pallas"

        def launch() -> torch.Tensor:
            if kernel:
                return _k.mm_aggregate_2d(source, weights,
                                          **engine._kernel_opts())
            return engine.aggregate(
                torch.stack([r.reshape(-1) for r in program.rows]), weights)

        program = LaunchProgram(
            launch, table, a,
            engine._plan(self.k, self.m, 1, self.dtype, table=kernel),
            m=self.m, dtype=self.dtype, reads_table=kernel)
        if not kernel:
            return program
        program.stage([torch.zeros(self.m, dtype=self.dtype,
                                   device=self.device)] * self.k)
        warm_up(program._launch, self.device)  # synchronizes
        program.graph, program.out, program.launches = capture_graph(
            program._launch)
        program.release()
        return program


class TreeProgram:
    """A compiled tree aggregation (``AggregationEngine.lower_tree``).

    Its static inputs are the (K, M_total) f32 staging buffer ``x`` and,
    for a weighted program, the (K,) weights ``a``; its static outputs
    are views shaped like the leaves.  ``program(tree, a)`` stages the
    leaves into ``x`` as ``stage_leaves`` does (releasing each one as it
    is staged when the engine donates leaves), copies ``a`` and replays
    the kernel->split program, returning a tree of the outputs.  A tree
    of another layout raises ``ValueError``.  On a CUDA device the
    program is a captured CUDA graph and the returned tree holds the
    graph's own output tensors, overwritten by the next replay of this
    program: a caller that keeps them clones them first.  Each replay
    counts the graph's captured launches (``launches.replay``).  On the
    CPU the program
    runs the engine's launch and split (the kernels' plain versions) on
    the static inputs.
    """

    def __init__(self, lowered: "LoweredTree", x: torch.Tensor,
                 a: Optional[torch.Tensor], run: Callable[[], list]):
        self.layout = lowered.layout
        self.donate = lowered.engine.donate_leaves
        self.x = x
        self.a = a
        self._run = run
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs: Optional[list] = None
        self.launches = collections.Counter()  # launch keys a replay
        self.replays = 0

    def stage(self, tree, a: Optional[torch.Tensor] = None) -> None:
        """Copy the tree's leaves (and the weights) into the static
        inputs, donating the leaves where the engine does."""
        leaves, treedef = pytree.flatten(tree)
        if _layout_key(leaves, treedef) != self.layout.key():
            raise ValueError(
                "the tree program was lowered for another tree layout: "
                f"shapes {self.layout.shapes}, dtypes {self.layout.dtypes}")
        if leaves[0].device != self.x.device:
            raise ValueError(f"the tree program runs on {self.x.device}, "
                             f"the leaves are on {leaves[0].device}")
        if (a is None) != (self.a is None):
            raise ValueError("a weighted tree program takes weights a (K,), "
                             "an unweighted one none")
        stage_leaves(leaves, self.x, layout=self.layout, donate=self.donate)
        if a is not None:
            self.a.copy_(a.reshape(-1))

    def replay(self) -> list:
        """Run kernel->split on the staged inputs; the outputs in leaf
        order.  Asynchronous on the card."""
        if self.graph is None:
            outs = self._run()
        else:
            self.graph.replay()
            outs = self.outputs
            launches.replay(self.launches)
        self.replays += 1
        return outs

    def __call__(self, tree, a: Optional[torch.Tensor] = None):
        self.stage(tree, a)
        return pytree.unflatten(self.layout.treedef, self.replay())


class LoweredTree:
    """``lower_tree``'s result: the stage->kernel->split program of one
    tree layout, not yet compiled.  ``donated`` holds one flag per leaf,
    whether the program takes the leaf over (the donated flags of the
    reference's ``Lowered.args_info``)."""

    def __init__(self, engine: AggregationEngine, layout: _TreeLayout, *,
                 weighted: bool, device: torch.device):
        self.engine = engine
        self.layout = layout
        self.weighted = weighted
        self.device = device
        self.donated = (bool(engine.donate_leaves),) * len(layout.shapes)

    def compile(self) -> TreeProgram:
        """The tree program over fresh static inputs.  On a CUDA device:
        one warm-up of kernel->split on a side stream, then its capture,
        as ``LoweredLaunch.compile`` does."""
        engine, layout = self.engine, self.layout
        x = torch.zeros((layout.k, layout.m_total), dtype=torch.float32,
                        device=self.device)
        a = torch.ones((layout.k,), dtype=torch.float32,
                       device=self.device) if self.weighted else None
        engine._record(x, layout.k, layout.m_total)

        def run() -> list:
            return layout.split(engine.aggregate(x, a))

        program = TreeProgram(self, x, a, run)
        if self.device.type != "cuda":
            return program
        warm_up(run, self.device)
        program.graph, program.outputs, program.launches = capture_graph(run)
        return program


def warm_up(fn: Callable[[], object], device: torch.device) -> None:
    """fn once on a side stream, then a synchronize: what must happen
    before a capture (the kernel library's load, its shared-memory
    opt-in, the occupancy query, the tuning cache) happens here."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        fn()
    current.wait_stream(side)
    torch.cuda.synchronize(device)


def capture_graph(fn: Callable[[], object],
                  generators: Sequence[torch.Generator] = ()):
    """Capture fn into a new CUDA graph: (graph, fn's output, the keys
    of the kernel launches it captured, a Counter).  Each
    generator in ``generators`` is registered with the graph, so every
    replay draws from its state at the replay, as the eager code would.
    A failed capture raises."""
    graph = torch.cuda.CUDAGraph()
    for generator in generators:
        graph.register_generator_state(generator)
    with launches.captured() as keys:
        with torch.cuda.graph(graph):
            out = fn()
    return graph, out, collections.Counter(keys)


def stage_leaves(leaves, out: Optional[torch.Tensor] = None, *,
                 layout: Optional[_TreeLayout] = None,
                 donate: bool = False) -> torch.Tensor:
    """Copy stacked (K, ...) leaves into one (K, M_total) f32 buffer,
    leaf after leaf along M (the tree path's staging layout, ``layout``'s
    sizes and offsets where it is given): ``out``, or a new one.  With
    ``donate`` each leaf is released as soon as it and every later leaf
    on the same storage are staged; a leaf whose storage cannot be
    released raises ``ValueError`` before any is staged."""
    if layout is None:
        layout = _TreeLayout(None, leaves)
    k = layout.k
    buf = out if out is not None else torch.empty(
        (k, layout.m_total), dtype=torch.float32, device=leaves[0].device)
    if donate:
        _check_donatable(leaves)
    keys = [_storage_key(leaf) for leaf in leaves] if donate else []
    last = {key: i for i, key in enumerate(keys)}
    for i, (leaf, off, n) in enumerate(zip(leaves, layout.offsets,
                                           layout.sizes)):
        buf[:, off:off + n].copy_(leaf.reshape(k, n))
        if donate and last[keys[i]] == i:
            for shared, key in zip(leaves[:i + 1], keys):
                if key == keys[i]:
                    _donate(shared)
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


# ---------------------------------------------------------------------------
# finiteness
# ---------------------------------------------------------------------------

# the kernel's dtypes: their C codes, the integer type of their bits and
# the exponent field (all ones: NaN, +inf or -inf)
_FINITE_BITS = {torch.float32: (0, torch.int32, 0x7F800000),
                torch.bfloat16: (1, torch.int16, 0x7F80)}
# zeroed int32 flags, each handed to one check and never again, made
# _FLAG_BLOCK at a time per (device, stream): a check allocates and clears
# nothing of its own
_FLAG_BLOCK = 256
_FLAGS: dict = {}


def finite_split(ptr: int, n: int, itemsize: int) -> tuple:
    """(head, n_vec, tail): the ``n`` elements of ``itemsize`` bytes at
    address ``ptr`` as the kernel reads them, the elements before the
    first 16-byte boundary, then whole 16-byte vectors, then the rest."""
    if ptr % itemsize:
        raise ValueError(f"address {ptr:#x} is not aligned to its "
                         f"{itemsize}-byte elements")
    per_vec = 16 // itemsize
    head = min(-ptr % 16 // itemsize, n)
    n_vec = (n - head) // per_vec
    return head, n_vec, n - head - n_vec * per_vec


def any_nonfinite_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's test in plain PyTorch, for an f32 or bf16 tensor: some
    element's exponent field is all ones."""
    _, bits, exponent = _FINITE_BITS[x.dtype]
    return ((x.reshape(-1).view(bits) & exponent) == exponent).any()


def _fresh_flag(device: torch.device, stream: int) -> torch.Tensor:
    """A zeroed 0-d int32 flag on ``device`` that no other check has had;
    a new block is zeroed on ``stream``, ahead of the checks it serves."""
    flags = _FLAGS.get((device.index, stream))
    if not flags:
        flags = _FLAGS[(device.index, stream)] = list(torch.zeros(
            _FLAG_BLOCK, dtype=torch.int32, device=device).unbind())
    return flags.pop()


def any_nonfinite(x: torch.Tensor) -> torch.Tensor:
    """A 0-d int32 tensor on ``x``'s device, 1 where ``x`` holds a NaN,
    +inf or -inf and 0 where it does not: ``not torch.isfinite(x).all()``.
    Nothing waits for it; its ``bool()`` is the one host wait.

    A CUDA tensor is read once by the hand-written kernel
    (``csrc/finite.cu``), one launch that raises a 4-byte flag and writes
    nothing else; it has to be a contiguous f32 or bf16 tensor, and any
    other CUDA tensor raises.  A CPU tensor takes ``torch.isfinite``."""
    if x.device.type != "cuda":
        return torch.isfinite(x).all().logical_not().to(torch.int32)
    if x.dtype not in _FINITE_BITS or not x.is_contiguous():
        raise ValueError(
            f"the finiteness kernel reads contiguous float32 or bfloat16 "
            f"CUDA tensors, not a {'' if x.is_contiguous() else 'strided '}"
            f"{x.dtype} one")
    # the raw handle of the current stream: what
    # torch.cuda.current_stream().cuda_stream gives, without building a
    # Stream object (6-8 us a call, a sixth of a 63 MB check on the card)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    flag = _fresh_flag(x.device, stream)
    ptr, n = x.data_ptr(), x.numel()
    if n:
        err = build.library("finite").finite_check_launch(
            ptr, _FINITE_BITS[x.dtype][0],
            *finite_split(ptr, n, x.element_size()), flag.data_ptr(), stream,
            x.device.index)
        if err:
            raise RuntimeError(f"finite_check launch failed: cudaError {err}")
        launches.note(("finite_scan", 1, n, 1))
    return flag


# ---------------------------------------------------------------------------
# residual norms
# ---------------------------------------------------------------------------

def _check_rows(named, m: int, dtype: torch.dtype, device: torch.device,
                reader: str, owner: str) -> None:
    """Raise ``ValueError`` unless each (name, tensor) of ``named`` is a
    contiguous ``dtype`` tensor of ``m`` elements on ``device``: a row a
    kernel reads by its address (``owner`` names what sets m and the
    device in the messages)."""
    for name, t in named:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"{reader} reads contiguous {_k.dtype_name(dtype)} tensors; "
                f"{name} is a {'' if t.is_contiguous() else 'strided '}"
                f"{t.dtype} one")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, {owner} on {device}")
        if t.numel() != m:
            raise ValueError(f"{name} has {t.numel()} elements, {owner} {m}")


def _write_row_table(rows: Sequence[torch.Tensor], table: torch.Tensor,
                     host: torch.Tensor) -> None:
    """The rows' addresses into the device table ``table``, through the
    pinned (len(rows),) int64 host buffer ``host``: one copy on the
    current stream, which nothing waits for (``host`` must not be
    rewritten before it has run)."""
    host.numpy()[:] = [r.data_ptr() for r in rows]
    table.copy_(host, non_blocking=True)


def residual_norms_plain(rows: Sequence[torch.Tensor],
                         center: torch.Tensor) -> torch.Tensor:
    """The norms in plain PyTorch, one row at a time:
    ``vector_norm(row - center)`` of each row, as an (n,) f32 tensor."""
    return torch.stack([torch.linalg.vector_norm(r.reshape(-1)
                                                 - center.reshape(-1))
                        for r in rows])


def residual_norms(rows: Sequence[torch.Tensor],
                   center: torch.Tensor) -> torch.Tensor:
    """``||rows[r] - center||`` for each of the n rows: an (n,) f32 tensor
    on the centre's device.  Nothing waits for it.

    Every tensor is a contiguous f32 one of the centre's length, on the
    centre's device.  On the card the rows are read in place, each once,
    by the kernel of ``csrc/residual.cu``: one launch over a table of the
    rows' addresses (copied from pinned host memory on the current
    stream) and a short one that sums its partials.  The difference is
    taken in f32 and its squares summed in f64, in an order fixed by the
    card, n and M, so a repeat gives the same bits.  On the CPU it is
    ``residual_norms_plain``."""
    if not rows:
        raise ValueError("residual_norms needs at least one row")
    m, dev = center.numel(), center.device
    _check_rows((("center", center),
                 *((f"row {i}", r) for i, r in enumerate(rows))),
                m, torch.float32, dev, "residual_norms", "the centre")
    if dev.type != "cuda":
        return residual_norms_plain(rows, center)
    n = len(rows)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = build.library("residual")
    table = torch.empty(n, dtype=torch.int64, device=dev)
    _write_row_table(rows, table, torch.empty(n, dtype=torch.int64,
                                              pin_memory=True))
    capacity = n * lib.residual_max_blocks()
    partials = torch.empty(capacity, dtype=torch.float64, device=dev)
    ptr = center.data_ptr()
    err = lib.residual_norms_launch(
        table.data_ptr(), n, ptr, *finite_split(ptr, m, 4),
        partials.data_ptr(), capacity, out.data_ptr(),
        torch._C._cuda_getCurrentRawStream(dev.index), dev.index)
    if err:
        raise RuntimeError(f"residual_norms launch failed: cudaError {err}")
    launches.note(("residual", n, m, 1))
    return out
